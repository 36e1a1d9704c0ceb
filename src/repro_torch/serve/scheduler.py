"""Continuous-batching scheduler: a slot-pool KV cache serving ragged traffic.

The PyTorch counterpart of ``repro.serve.scheduler``'s ``SlotPoolEngine``
for every family.  Three pieces, as in the JAX package:

  slot pool    — the KV cache is allocated once with a fixed batch (slot)
                 dimension ``n_slots`` (dense or paged, float or fp2fx8);
                 host mirrors track each slot's ``length`` (next write
                 position), ``active``, ``prefilling`` and token ``budget``.
  chunked prefill — admission is host bookkeeping only (the recurrent
                 families' and encdec's admitted rows are also reset to
                 fresh state, and encdec's get their encoder memory);
                 prompt tokens go through ``engine.build_prefill_chunk`` in
                 place over the slot's own cache rows, up to
                 ``prefill_chunk`` tokens per row per call, every
                 prefilling slot packed into one call (``pack_prefill``),
                 one call between decode bursts.
  masked burst — ``decode_burst`` masked decode steps over all slots: each
                 writes KV at per-slot positions (paged: through the block
                 tables), samples, and detects EOS, budget and deadline TTL
                 on the device, so a finished slot stops writing its cache
                 mid-burst.  Nothing is read back inside the burst; the host
                 reads the emitted tokens and the slot state once after it.

``ServeConfig.scheduler``: ``continuous`` admits into freed slots
mid-decode and honours ``eos_id``; ``lockstep`` drains the pool before the
next group and ignores EOS; ``spec`` admits as ``continuous`` does and
replaces each burst by one speculative step (``repro_torch.serve.spec``):
draft up to ``draft_k`` tokens per slot on the host (n-gram lookup, or a
small draft model with its own dense cache), verify ``draft_k + 1`` lanes
per slot in one ``prefill_chunk`` call, emit the longest accepted prefix
(EOS and budget on accepted tokens only), then roll back: dense slots by
length alone, paged slots also by giving back their tail pages.
``ServeConfig.kv_layout``: ``dense`` (one ``max_len`` stripe per slot) or
``paged`` (``serve.kvpool`` pages with per-slot block tables; decode
appends pages, exhaustion preempts the latest arrival and requeues it with
its tokens folded into the prompt; ``prefix_cache`` shares the pages of
cached prompt prefixes).

Requests end in a definite outcome: finished, cancelled, or a structured
failure (``invalid``, ``queue_full``, ``deadline``, ``numeric_fault``,
``retries_exhausted``).  A slot whose logits go non-finite (a NaN or Inf
in its KV reaches the PV products) is quarantined: its KV is scrubbed and
its request walks the ladder of ``_quarantine`` (requeue and recompute;
on a second fault, one retry on the unfused fp32 dense path; then a
``numeric_fault`` failure).  ``repro_torch.serve.chaos`` injects such
faults, and preemptions, eviction storms, pool squeezes, cancellations,
stragglers and junk drafts, at the engine's injection points.

Observability (``repro_torch.obs``): every engine owns an ``Obs`` bundle.
The scheduler's counters live in its metrics registry (``stats`` is a
read-only view with the JAX engine's keys), the tracer records the admit,
prefill, burst and verify spans and the preempt, expire and quarantine
instants, and ``ServeConfig.telemetry`` feeds the numerics monitor once a
burst.

Time is read from one injectable clock (``clock``, seconds, default
``time.perf_counter``) through ``_now``, so arrivals and deadlines can be
driven without sleeping.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import resolve_attn_mode
from repro_torch.obs import Obs
from repro_torch.obs import numerics as obs_numerics
from repro_torch.serve import engine, kvpool
from repro_torch.train.loop import StragglerMonitor
from repro_torch.tree import tree_leaves

I32 = torch.int32
PAD = -1  # emitted-token filler for slots that were idle during a burst step
TTL_NONE = 1 << 30  # "no deadline" sentinel: never decrements to zero


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` and ``deadline`` are seconds
    after ``run()`` starts (0 = already queued); ``deadline`` is a hard TTL.
    ``resume`` marks a preempted request requeued mid-generation (its
    prompt already carries the tokens generated so far)."""
    rid: int
    tokens: Any                       # (prompt_len,) int token ids
    max_new: int
    arrival: float = 0.0
    deadline: Optional[float] = None
    resume: bool = False
    frames: Any = None                # encdec: (frontend_len, frontend_dim)


@dataclasses.dataclass
class FailureInfo:
    """Why a request ended without running to EOS or its budget: one of
    ``invalid``, ``queue_full``, ``deadline``, ``numeric_fault`` (non-finite
    logits survived the quarantine -> fp32-retry ladder),
    ``retries_exhausted`` (requeued, by preemption or quarantine, more than
    ``ServeConfig.max_retries`` times).  The partial tokens stay on the
    ``Completion``."""
    reason: str
    detail: str = ""
    retries: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list                      # generated ids (includes EOS if hit)
    prompt_len: int
    finished_at: float                # seconds after run() start
    arrival: float = 0.0
    # per-token emission stamps (seconds after run() start; a burst's
    # tokens share one stamp): token_times[0] - arrival is the TTFT
    token_times: list = dataclasses.field(default_factory=list)
    cancelled: bool = False
    failure: Optional[FailureInfo] = None

    @property
    def ok(self) -> bool:
        return not self.cancelled and self.failure is None

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, or None when none was emitted."""
        if not self.token_times:
            return None
        return self.token_times[0] - self.arrival


def _bucket(n: int, lo: int = 4) -> int:
    """Next power of two >= n (>= lo): the prefill call widths."""
    b = lo
    while b < n:
        b *= 2
    return b


def build_burst(model, scfg: ServeConfig, steps: int):
    """(params, cache, tok (B, 1), lengths, active, budget, ttl, generator)
    -> (emitted (steps, B), oks (steps, B), cache, tok, lengths, active,
    budget, ttl, tstats), all device tensors.

    ``steps`` masked decode steps.  Every slot computes every step, but only
    active slots write their KV (``write_mask``), consume budget and TTL,
    advance their length or emit a token (idle rows emit PAD).  EOS (in
    continuous mode), budget exhaustion and TTL expiry clear ``active`` on
    the device.  ``oks`` is False where an active slot's logits went
    non-finite.  ``tstats`` is ``{}`` unless ``scfg.telemetry``, else the
    burst's logit exponent range and the fp2fx8 stats of the cache after
    it (``obs.numerics``).  The loop reads nothing back from the device.
    """
    eos = scfg.eos_id if scfg.scheduler == "continuous" else None

    def burst(params, cache, tok, lengths, active, budget, ttl, generator):
        emits, oks, zs = [], [], []
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, tok, lengths,
                                              write_mask=active)
            last = logits[:, -1, :]
            oks.append(torch.isfinite(last).all(-1) | ~active)
            if scfg.telemetry:
                zs.append(obs_numerics.logit_stats(last, active))
            nxt = engine._sample(last, generator, scfg.temperature,
                                 scfg.top_k, scfg.top_p).to(I32)
            emits.append(torch.where(active, nxt, PAD))
            step = active.to(I32)
            budget, lengths, ttl = budget - step, lengths + step, ttl - step
            alive = active & (budget > 0) & (ttl > 0)
            if eos is not None:
                alive = alive & (nxt != eos)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
            active = alive
        tstats = {}
        if scfg.telemetry:
            tstats = dict(obs_numerics.reduce_logit_stats(torch.stack(zs)),
                          **obs_numerics.format_stats(cache))
        return (torch.stack(emits), torch.stack(oks), cache, tok, lengths,
                active, budget, ttl, tstats)

    return burst


# the scheduler's counters and gauges, in the JAX engine's ``stats`` order;
# each lives in the Obs metrics registry as serve.<key>{scheduler, family},
# and ``SlotPoolEngine.stats`` is the dict view
_STAT_KEYS = (
    "admitted", "bursts", "prefills", "burst_steps", "slot_steps_active",
    "peak_active", "tokens_emitted", "prompt_tokens", "prefill_tokens",
    "cached_tokens", "prefix_hits", "preemptions", "pages_peak",
    "model_calls", "spec_steps", "draft_tokens", "accepted_tokens",
    "rejected", "expired", "cancelled", "quarantines", "fp32_retries",
    "failures", "stragglers", "audits")
_STAT_GAUGES = ("peak_active", "pages_peak")
_STAT_COUNTERS = tuple(k for k in _STAT_KEYS if k not in _STAT_GAUGES)


class SlotPoolEngine:
    """Host-side scheduler around the slot-pool cache and the burst.

    Slot state lives as numpy mirrors updated from each burst's outputs;
    the KV cache never leaves the device and is updated in place.
    ``device`` (None = the card) is where the cache lives; ``params`` must
    live there too.  ``generator`` draws the samples when temperature > 0.
    ``draft``: an optional (model, params) pair, the drafter of
    ``spec_mode="model"`` (its params on ``device`` too).  ``chaos``: an
    optional ``serve.chaos.ChaosMonkey``, consulted at the injection points
    (None in production).  ``obs``: the observability bundle (default: a
    fresh one with the tracer off, so engines never share counters).
    """

    def __init__(self, model, params, scfg: ServeConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 clock: Callable[[], float] = time.perf_counter, draft=None,
                 chaos=None, obs: Optional[Obs] = None):
        self.device = resolve_device(device)
        self.model = resolve_attn_mode(model, scfg.attn_mode)
        self.params = params
        self.scfg = scfg
        self.generator = generator
        self.clock = clock
        self.obs = obs if obs is not None else Obs()
        self.chaos = chaos
        n = scfg.n_slots
        if scfg.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        if scfg.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if scfg.scheduler not in ("continuous", "lockstep", "spec"):
            raise ValueError(f"unknown scheduler {scfg.scheduler!r}")
        if scfg.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {scfg.kv_layout!r}")
        self.spec = scfg.scheduler == "spec"
        self.drafter = None
        if self.spec:
            if scfg.temperature > 0:
                raise ValueError(
                    "scheduler='spec' is greedy-only (temperature == 0): "
                    "sampled speculative acceptance needs distribution-"
                    "level rejection sampling, not the top-k/top-p filters")
            if self.model.init_paged_cache is None:
                raise ValueError(
                    "scheduler='spec' needs an attention-family model "
                    "(dense/moe/vlm): SSM/hybrid/encdec state has no O(1) "
                    "rollback, so those families serve non-speculatively")
            if scfg.draft_k < 1:
                raise ValueError("draft_k must be >= 1")
            from repro_torch.serve import spec as spec_mod
            self.drafter = spec_mod.make_drafter(scfg, self.model.cfg, draft=draft,
                                                 device=self.device)
        self.paged = scfg.kv_layout == "paged"
        self.trie = None
        if self.paged:
            if self.model.init_paged_cache is None:
                raise ValueError(
                    "kv_layout='paged' needs an attention-family model "
                    "(dense/moe/vlm); SSM/hybrid/encdec serve dense")
            if scfg.page_size < 1:
                raise ValueError("page_size must be >= 1")
            self.n_blocks = -(-scfg.max_len // scfg.page_size)
            n_pages = scfg.n_pages or n * self.n_blocks
            if n_pages < self.n_blocks:
                raise ValueError(
                    f"n_pages={n_pages} cannot hold one max_len={scfg.max_len}"
                    f" request ({self.n_blocks} pages of {scfg.page_size})")
            self.pool = kvpool.PagePool(n_pages)
            if scfg.prefix_cache:
                self.trie = kvpool.RadixTrie(self.pool, scfg.page_size)
            self.slot_pages: list[list] = [[] for _ in range(n)]
            self.block_tables = np.zeros((n, self.n_blocks), np.int32)
            self.cache = self.model.init_paged_cache(
                params, n_pages, scfg.page_size, scfg.cache_dtype,
                device=self.device)
        else:
            if scfg.prefix_cache:
                raise ValueError("prefix_cache requires kv_layout='paged'")
            self.cache = self.model.init_cache(params, n, scfg.max_len,
                                               scfg.cache_dtype,
                                               device=self.device)
        if scfg.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = whole prompt)")
        self.lengths = np.zeros(n, np.int32)
        self.active = np.zeros(n, bool)
        self.prefilling = np.zeros(n, bool)   # admitted, prompt not yet fed
        self.budget = np.zeros(n, np.int32)
        self.last_tok = np.zeros(n, np.int32)
        self.slot_rid: list[Optional[int]] = [None] * n
        # the prompt a slot was admitted with (a preempted resume carries
        # its generated tokens folded in)
        self.slot_prompt: list[Optional[np.ndarray]] = [None] * n
        self.outputs: dict[int, list] = {}
        self.out_times: dict[int, list] = {}
        self.requests: dict[int, Request] = {}
        self.completions: dict[int, Completion] = {}
        self._queue: deque = deque()   # arrived, waiting (bounded)
        self._pending: deque = deque()  # submitted, not yet arrived
        # chunk prefill writes attention rows in place (the kv_index <=
        # position mask hides a previous occupant's stale KV), but the
        # recurrent families continue from the slot's stored state and
        # encdec reads the slot's memory, so their admission writes fresh
        # rows first
        self._needs_reset = self.model.init_paged_cache is None
        self._encode = (engine.build_encode(self.model)
                        if self.model.encode is not None else None)
        self._axes = None                        # each cache leaf's slot axis
        if self.spec:
            self._spec_step = spec_mod.build_spec_step(self.model, scfg, scfg.draft_k)
        else:
            self._burst = build_burst(self.model, scfg, max(1, scfg.decode_burst))
        self._eos = (scfg.eos_id if scfg.scheduler in ("continuous", "spec")
                     else None)
        self.retries: dict[int, int] = {}        # requeues per rid
        self.numeric_faults: dict[int, int] = {}  # quarantines per rid
        self._cancels: set = set()               # rids to cancel next check
        # page lists held by parties other than slots and trie (the chaos
        # harness's pool squeeze), folded into the audit
        self._extra_holders: list = []
        # burst wall-time EMA: the per-step estimate behind the device TTL
        self.straggler = StragglerMonitor()
        self._step_ema = 0.0
        self._t0: Optional[float] = None         # run() epoch
        # the fp32 fallback engine fails structurally, never recurses
        self._allow_fp32_retry = True
        labels = dict(scheduler=scfg.scheduler, family=self.model.cfg.family)
        reg = self.obs.metrics
        self._counters = {k: reg.counter(f"serve.{k}", **labels)
                          for k in _STAT_COUNTERS}
        self._gauges = {k: reg.gauge(f"serve.{k}", **labels)
                        for k in _STAT_GAUGES + ("queue_depth", "slot_occupancy",
                                                 "pages_in_use")}
        self._hists = {k: reg.histogram(f"serve.{k}", **labels)
                       for k in ("ttft_s", "tbt_s", "burst_wall_s")}
        # fp -> fx convert volume: elements quantized per KV-cache token
        # write (k + v rows of every layer), counted on the host
        self._converts_per_tok = 0
        if scfg.cache_dtype == "fp2fx8":
            cfg = self.model.cfg
            self._converts_per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head
            self.obs.numerics.kv_int8_total = obs_numerics.int8_size(self.cache)

    # -- bookkeeping helpers --------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        self._counters[key].inc(n)

    def _peak(self, key: str, v: int) -> None:
        self._gauges[key].track_max(v)

    @property
    def stats(self) -> dict:
        """The JAX scheduler's ``stats``, by its keys in its order: a
        read-only view over the metrics registry."""
        return {k: int(self._gauges[k].value) if k in _STAT_GAUGES
                else self._counters[k].value for k in _STAT_KEYS}

    def _record_completion(self, c: Completion) -> None:
        """Latency histograms at completion time, TTFT (skipping None) and
        each TBT gap, so the metrics reconcile with the Completion records
        by construction."""
        if c.ttft is not None:
            self._hists["ttft_s"].observe(c.ttft)
        tt = c.token_times
        for i in range(1, len(tt)):
            self._hists["tbt_s"].observe(tt[i] - tt[i - 1])

    def _count_converts(self, n_tokens: int) -> None:
        """The fp -> fx convert volume of ``n_tokens`` KV-cache token
        writes (no-op for an unquantized cache)."""
        if self._converts_per_tok and n_tokens > 0:
            self.obs.numerics.add_converts(n_tokens * self._converts_per_tok)

    def prewarm(self) -> None:
        """Build the CUDA kernels before serving, under the tracer's
        "compile" span: the port's counterpart of the JAX engine's
        prewarm, which compiles every executable a run can hit.  Eager
        PyTorch compiles nothing else; on the CPU there is nothing to
        build."""
        if not self.paged and self._needs_reset:
            self._reset_rows(range(self.scfg.n_slots))
        if self.device.type != "cuda":
            return
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.load()
        self.obs.tracer.compile_span("hyft_kernels", time.perf_counter() - t0, "nvcc")

    def _now(self) -> float:
        """Seconds since run() started (0 before/outside a run), from the
        engine's clock."""
        return self.clock() - self._t0 if self._t0 is not None else 0.0

    def _to_device(self, arr) -> torch.Tensor:
        """A copy of a host mirror on the cache's device."""
        return torch.tensor(np.asarray(arr), device=self.device)

    # -- admission -----------------------------------------------------

    def _register(self, r: Request) -> None:
        """First sighting of a request (a resume keeps the original)."""
        if r.rid not in self.requests:
            self.requests[r.rid] = r
            self.outputs[r.rid] = []
            self.out_times[r.rid] = []

    def _start_prefill(self, s: int, r: Request, start: int) -> None:
        """Put ``r`` into slot ``s`` in the ``prefilling`` state with
        ``start`` tokens already cached (prefix hits)."""
        if not r.resume:
            self._register(r)
            self._count("admitted")
        self.slot_rid[s] = r.rid
        self.slot_prompt[s] = np.asarray(r.tokens, np.int32)
        self.lengths[s] = start
        self.active[s] = False
        self.prefilling[s] = True
        self.budget[s] = r.max_new
        self._drafter_reset(s)
        self._count("prompt_tokens", len(r.tokens))
        self._count("prefill_tokens", len(r.tokens) - start)
        self._count_converts(len(r.tokens) - start)

    def _drafter_reset(self, s: int) -> None:
        """Slot ``s`` changed owner: wipe the drafter's state tied to it (the
        model drafter's synced length; the n-gram drafter has none)."""
        if self.drafter is not None:
            self.drafter.reset_slot(s)

    def admit(self, reqs: list[Request], now: float) -> None:
        """Admit ``reqs`` into free slots: host bookkeeping only (paged:
        page allocation and prefix matching).  The prompts are then fed by
        ``_prefill_step`` calls interleaved with decode bursts."""
        if not reqs:
            return
        with self.obs.tracer.span("admit", n=len(reqs), rids=[r.rid for r in reqs]):
            free = [s for s in range(self.scfg.n_slots) if self.slot_rid[s] is None]
            assert len(reqs) <= len(free), "admitting more requests than slots"
            if self.paged:
                self._admit_paged(reqs, free)
            else:
                self._admit_dense(reqs, free)

    def _admit_dense(self, reqs, free):
        """The recurrent families and encdec chunk-prefill through gated
        decode steps, which continue from the slot's stored state and read
        its memory: the admitted rows start fresh, and encdec's get the
        encoder memory of their frames before the first chunk.  The
        encoder runs on the admitted rows alone (eager PyTorch has no
        compile to bucket the group for, as the JAX engine does).
        Attention rows need no reset: the kv_index <= position mask hides a
        previous occupant's stale KV."""
        if self._needs_reset:
            slots = free[:len(reqs)]
            self._reset_rows(slots)
            if reqs[0].frames is not None:
                if any(r.frames is None for r in reqs):
                    raise ValueError("mixed group: some requests carry "
                                     "encoder frames and some do not")
                fr = np.stack([np.asarray(r.frames) for r in reqs])
                mem = self._encode(self.params, self._to_device(fr))
                buf = self.cache["memory"]
                idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
                buf[idx] = mem.to(buf.dtype)
        for j, r in enumerate(reqs):
            self._start_prefill(free[j], r, 0)

    def _cache_batch_axes(self) -> list:
        """Each cache leaf's slot axis (``tree_leaves`` order), found by
        comparing ``init_cache``'s shapes at one and two slots on the meta
        device: 1 for layer-stacked leaves (after the layer or invocation
        axis), 0 for the encoder memory."""
        if self._axes is None:
            shapes = [[tuple(t.shape) for t in tree_leaves(self.model.init_cache(
                self.params, n, self.scfg.max_len, self.scfg.cache_dtype, device="meta"))]
                for n in (1, 2)]
            self._axes = [next(i for i, (a, b) in enumerate(zip(s1, s2)) if a != b)
                          for s1, s2 in zip(*shapes)]
        return self._axes

    def _reset_rows(self, slots) -> None:
        """Rewrite the dense cache's rows of ``slots`` with ``init_cache``'s
        values, in every leaf, along its slot axis (``_cache_batch_axes``)."""
        fresh = self.model.init_cache(self.params, 1, self.scfg.max_len,
                                      self.scfg.cache_dtype, device=self.device)
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        for leaf, row, ax in zip(tree_leaves(self.cache), tree_leaves(fresh),
                                 self._cache_batch_axes()):
            leaf.movedim(ax, 0)[idx] = row.movedim(ax, 0)

    def _alloc_pages(self, n: int) -> Optional[list]:
        """``n`` pages from the pool, evicting prefix-cache LRU leaves on
        shortage; None when even eviction cannot meet the demand."""
        if n <= 0:
            return []
        pages = self.pool.alloc(n)
        if pages is None and self.trie is not None:
            with self.obs.tracer.span("evict", short=n - self.pool.free_pages):
                self.trie.evict(n - self.pool.free_pages)
            pages = self.pool.alloc(n)
        return pages

    def _release_slot_pages(self, s: int) -> None:
        for p in self.slot_pages[s]:
            self.pool.decref(p)
        self.slot_pages[s] = []
        self.block_tables[s, :] = 0

    def _admit_paged(self, reqs, free):
        """Allocate each prompt's pages (reusing cached prefix pages on a
        trie match) and install the block table.  Hit rows start their
        chunked prefill at the matched length; page exhaustion requeues the
        rest at the queue front."""
        ps = self.scfg.page_size
        plans, leftover = [], []
        for i, r in enumerate(reqs):
            toks = np.asarray(r.tokens, np.int32)
            matched_pages: list = []
            matched = 0
            if self.trie is not None:
                # match on tokens[:-1]: one suffix token always remains to
                # produce the first generated token's logits
                matched_pages, matched = self.trie.match(toks[:-1].tolist())
                for p in matched_pages:
                    # pin before _alloc_pages, whose eviction could free the
                    # just-matched pages and hand them back as the tail
                    self.pool.incref(p)
            need = -(-len(toks) // ps)
            new = self._alloc_pages(need - len(matched_pages))
            if new is None and matched_pages:
                # the pinned prefix may be the only memory left: drop the
                # match and admit cold
                for p in matched_pages:
                    self.pool.decref(p)
                matched_pages, matched = [], 0
                new = self._alloc_pages(need)
            if new is None:
                leftover = reqs[i:]
                break
            plans.append((r, matched, list(matched_pages) + new))
        if leftover:
            self._queue.extendleft(reversed(leftover))
        for j, (r, matched, pages) in enumerate(plans):
            s = free[j]
            self._start_prefill(s, r, matched)
            self.slot_pages[s] = list(pages)
            self.block_tables[s, :] = 0
            self.block_tables[s, :len(pages)] = pages
            self._count("cached_tokens", matched)
            if matched:
                self._count("prefix_hits")
        self._peak("pages_peak", self.pool.pages_in_use)

    # -- chunked prefill ------------------------------------------------

    def _prefill_step(self, now: float) -> None:
        """Feed every prefilling slot its next chunk through one
        ``build_prefill_chunk`` call (``pack_prefill=False``: only the
        earliest arrival).  Width: ``prefill_chunk`` (0 = whole remainder)
        capped to the bucketed longest remainder.  Rows that finish take
        their first token from the returned logits."""
        scfg = self.scfg
        n = scfg.n_slots
        rows = [s for s in range(n) if self.prefilling[s]]
        if not rows:
            return
        if not scfg.pack_prefill:
            rows = [min(rows, key=lambda s: (
                self.requests[self.slot_rid[s]].arrival, self.slot_rid[s]))]
        rem = {s: len(self.slot_prompt[s]) - int(self.lengths[s]) for s in rows}
        cap = min(_bucket(max(rem.values())), scfg.max_len)
        width = min(scfg.prefill_chunk, cap) if scfg.prefill_chunk > 0 else cap
        toks = np.zeros((n, width), np.int32)
        n_valid = np.ones(n, np.int32)
        gate = np.zeros(n, bool)
        for s in rows:
            part = self.slot_prompt[s][int(self.lengths[s]):
                                       int(self.lengths[s]) + width]
            toks[s, :len(part)] = part
            n_valid[s] = len(part)
            gate[s] = True
        if self.paged:
            self.cache["block_tables"] = self._to_device(self.block_tables)
        with self.obs.tracer.span("prefill_chunk", width=width, rows=len(rows)):
            pc = engine.build_prefill_chunk(self.model, scfg, width)
            last, self.cache = pc(self.params, self.cache, self._to_device(toks),
                                  self._to_device(self.lengths),
                                  self._to_device(n_valid), self._to_device(gate))
            fin = [s for s in rows if rem[s] <= width]
            # one read back: every gated row's finiteness, and the first
            # token of the rows whose prompt is now cached
            flags = torch.isfinite(last).all(-1).to(I32)[None]
            if fin:
                flags = torch.cat([flags, self._first_token(last).to(I32)[None]])
            flags = flags.cpu().numpy()
        self._count("prefills")
        for s in rows:
            self.lengths[s] += min(rem[s], width)
        # numeric health: a poisoned page or fp2fx8 scale row shows here
        # before the slot ever decodes, and the quarantine ladder takes it
        bad = [s for s in rows if not flags[0, s]]
        for s in bad:
            self._quarantine(s, now, where="prefill")
        for s in fin:
            if s not in bad:
                self._finish_prefill(s, int(flags[1, s]), now)
        self._peak("peak_active", int(self.active.sum()))
        self._audit_check()

    def _first_token(self, last):
        """The first generated token from the (B, V) next-token logits of
        a completed prefill, as ``engine.generate`` draws it."""
        return engine._sample(last, self.generator, self.scfg.temperature,
                              self.scfg.top_k, self.scfg.top_p)

    def _finish_prefill(self, s: int, tok0: int, now: float) -> None:
        """Slot ``s``'s prompt is cached and its first token in hand:
        publish the prompt's full pages to the prefix cache, emit the
        token, then decode or free (EOS / budget 1)."""
        self.prefilling[s] = False
        rid = self.slot_rid[s]
        if self.trie is not None:
            # full pages only: decode writes into the partial tail page
            ptoks = self.slot_prompt[s]
            nfull = len(ptoks) // self.scfg.page_size
            if nfull:
                self.trie.insert(
                    [int(t) for t in ptoks[:nfull * self.scfg.page_size]],
                    self.slot_pages[s][:nfull])
            self._peak("pages_peak", self.pool.pages_in_use)
        self.outputs[rid].append(tok0)
        self.out_times[rid].append(now)
        self._count("tokens_emitted")
        done = (self.budget[s] <= 1
                or (self._eos is not None and tok0 == self._eos))
        if done:
            self._finish(rid, now)
            self._free_slot(s)
            return
        self.budget[s] -= 1
        self.last_tok[s] = tok0
        self.active[s] = True

    def _free_slot(self, s: int) -> None:
        """Detach slot ``s`` from its request and return its resources."""
        self.active[s] = False
        self.prefilling[s] = False
        self.slot_rid[s] = None
        self.slot_prompt[s] = None
        if self.paged:
            self._release_slot_pages(s)

    def _fail(self, rid: int, reason: str, now: float, detail: str = "") -> None:
        """Terminate ``rid`` with a structured failure; its partial tokens
        stay on the Completion."""
        r = self.requests[rid]
        self.completions[rid] = Completion(
            rid=rid, tokens=self.outputs.get(rid, []),
            prompt_len=len(r.tokens), finished_at=now, arrival=r.arrival,
            token_times=list(self.out_times.get(rid, [])),
            failure=FailureInfo(reason=reason, detail=detail,
                                retries=self.retries.get(rid, 0)))
        self._count("failures")
        self._record_completion(self.completions[rid])

    def _requeue(self, s: int, now: float) -> bool:
        """Push slot ``s``'s request back to the queue front with its
        generated tokens folded into the prompt (greedy continuation is
        identical); past ``max_retries`` it fails instead.  The slot itself
        is not freed here."""
        rid = self.slot_rid[s]
        nret = self.retries.get(rid, 0) + 1
        self.retries[rid] = nret
        if nret > self.scfg.max_retries:
            self._fail(rid, "retries_exhausted", now,
                       detail=f"requeued {nret} times")
            return False
        orig = self.requests[rid]
        done = self.outputs[rid]
        toks = np.concatenate([np.asarray(orig.tokens, np.int32),
                               np.asarray(done, np.int32)])
        # the remaining budget from the host's tokens, not the device
        # budget: a quarantined slot's non-finite steps used budget that
        # the request never received tokens for
        self._queue.appendleft(Request(
            rid=rid, tokens=toks, max_new=orig.max_new - len(done),
            frames=orig.frames, arrival=orig.arrival, deadline=orig.deadline,
            resume=True))
        return True

    def _preempt_latest(self) -> bool:
        """Page exhaustion: free the latest-arrival occupied slot (ties by
        rid) and requeue its request.  Returns True if a slot was freed."""
        cands = [s for s in range(self.scfg.n_slots)
                 if self.active[s] or self.prefilling[s]]
        if not cands:
            return False
        s = max(cands, key=lambda c: (self.requests[self.slot_rid[c]].arrival,
                                      self.slot_rid[c]))
        self.obs.tracer.instant("preempt", rid=self.slot_rid[s], slot=s)
        self._requeue(s, self._now())
        self._free_slot(s)
        self._count("preemptions")
        self._audit_check()
        return True

    def _ensure_burst_pages(self, steps: int) -> None:
        """Grow every active slot's block table to cover its next ``steps``
        writes; on exhaustion evict (inside ``_alloc_pages``), then preempt
        the latest arrival and retry."""
        while True:
            short = False
            for s in range(self.scfg.n_slots):
                if not self.active[s]:
                    continue
                horizon = int(self.lengths[s]) + min(steps, int(self.budget[s]))
                nb_need = min(-(-horizon // self.scfg.page_size), self.n_blocks)
                have = len(self.slot_pages[s])
                new = self._alloc_pages(nb_need - have)
                if new is None:
                    short = True
                    break
                if new:
                    self.block_tables[s, have:have + len(new)] = new
                    self.slot_pages[s].extend(new)
            if not short:
                self._peak("pages_peak", self.pool.pages_in_use)
                return
            if not self._preempt_latest():
                return

    def _finish(self, rid: int, now: float) -> None:
        r = self.requests[rid]
        self.completions[rid] = Completion(
            rid=rid, tokens=self.outputs[rid], prompt_len=len(r.tokens),
            finished_at=now, arrival=r.arrival,
            token_times=list(self.out_times[rid]))
        self._record_completion(self.completions[rid])

    # -- decode --------------------------------------------------------

    def _ttl_vector(self, now: float) -> np.ndarray:
        """Per-slot decode-step allowance from the deadlines: with a warm
        per-step time estimate, ``floor(remaining / estimate)`` steps (min
        1); without one, ``TTL_NONE`` and the host sweep expires between
        bursts."""
        n = self.scfg.n_slots
        ttl = np.full(n, TTL_NONE, np.int32)
        if self._step_ema <= 0:
            return ttl
        for s in range(n):
            rid = self.slot_rid[s]
            if rid is None or not self.active[s]:
                continue
            d = self.requests[rid].deadline
            if d is not None:
                ttl[s] = int(np.clip((d - now) / self._step_ema, 1, TTL_NONE))
        return ttl

    def _observe_burst(self, dt: float, steps: int) -> None:
        """Burst wall time into its histogram and the straggler monitor
        (an outlier is flagged, not folded into the EMA); refresh the
        per-step estimate behind the deadline TTL."""
        self._hists["burst_wall_s"].observe(dt)
        if self.straggler.observe(dt):
            self._count("stragglers")
        if self.straggler.ema > 0 and steps > 0:
            self._step_ema = self.straggler.ema / steps

    def _expire_slot(self, s: int, now: float) -> None:
        rid = self.slot_rid[s]
        d = self.requests[rid].deadline
        self.obs.tracer.instant("expire", rid=rid, slot=s)
        self._fail(rid, "deadline", now, detail=f"deadline {d:.3f}s")
        self._free_slot(s)
        self._count("expired")

    def burst(self, now: float) -> None:
        """One burst of ``decode_burst`` masked steps, then host
        bookkeeping: append emitted tokens, finish freed slots.  Paged mode
        first appends the pages the burst will write (possibly preempting)
        and refreshes the device block tables.  In spec mode the burst is
        ONE speculative step (``_spec_burst``).  A slot whose logits went
        non-finite keeps only its tokens from before the first such step
        and is quarantined."""
        if self.chaos is not None:
            self.chaos.fire(self, "pre_burst")
        if self.spec:
            self._spec_burst(now)
            return
        if self.paged:
            self._ensure_burst_pages(max(1, self.scfg.decode_burst))
            if not self.active.any():  # everyone preempted: nothing to run
                return
            self.cache["block_tables"] = self._to_device(self.block_tables)
        was_active = self.active.copy()
        n = self.scfg.n_slots
        with self.obs.tracer.span("decode_burst", active=int(self.active.sum())):
            t_in = self._now()
            emits, oks, self.cache, tok, lengths, active, budget, ttl, tstats = \
                self._burst(self.params, self.cache,
                            self._to_device(self.last_tok)[:, None],
                            self._to_device(self.lengths), self._to_device(self.active),
                            self._to_device(self.budget),
                            self._to_device(self._ttl_vector(now)), self.generator)
            steps = emits.shape[0]
            # one read back for the whole burst
            host = torch.cat([emits.reshape(-1), oks.to(I32).reshape(-1), tok[:, 0],
                              lengths, active.to(I32), budget, ttl]).cpu().numpy()
            emits = host[:steps * n].reshape(steps, n)
            oks = host[steps * n:2 * steps * n].reshape(steps, n).astype(bool)
            tail = host[2 * steps * n:].reshape(5, n)
            self.last_tok = tail[0].copy()
            self.lengths = tail[1].copy()
            self.active = tail[2].astype(bool)
            self.budget = tail[3].copy()
            ttl_out = tail[4]
            self._observe_burst(self._now() - t_in, steps)
        if tstats:
            self.obs.numerics.update(tstats)
        self._count("bursts")
        self._count("burst_steps", steps)
        self._count("model_calls", steps)
        n_active_steps = int((emits != PAD).sum())
        self._count("slot_steps_active", n_active_steps)
        self._count_converts(n_active_steps)
        for s in np.nonzero(was_active)[0]:
            col = emits[:, s]
            bad = np.nonzero(~oks[:, s])[0]
            # the first non-finite step's sample and all after it are garbage
            col = col[:int(bad[0])] if bad.size else col
            toks = col[col != PAD].tolist()
            rid = self.slot_rid[s]
            self.outputs[rid].extend(toks)
            self.out_times[rid].extend([now] * len(toks))
            self._count("tokens_emitted", len(toks))
            if bad.size:
                self._quarantine(s, now, where="burst")
                continue
            if not self.active[s]:                      # freed on the device
                hit_eos = (self._eos is not None and toks
                           and toks[-1] == self._eos)
                if ttl_out[s] <= 0 and self.budget[s] > 0 and not hit_eos:
                    self._expire_slot(s, now)           # deadline TTL
                else:
                    self._finish(rid, now)
                    self._free_slot(s)
        self._audit_check()

    # -- speculative decode (repro_torch/serve/spec.py) -----------------

    def _spec_burst(self, now: float) -> None:
        """One speculative step over the whole pool: host-side drafting
        (ragged per slot), ONE verify call scoring ``draft_k + 1`` lanes per
        slot, longest-accepted-prefix emission with EOS and budget on
        accepted tokens only, then the rollback: dense slots rewind by
        length alone; paged slots also give back the tail pages the
        rejected lanes wrote into."""
        scfg = self.scfg
        K = scfg.draft_k
        if self.paged:
            # verify writes lanes L..L+m (m <= min(K, budget - 1)): cover the
            # worst case before the call, preempting on pool exhaustion
            self._ensure_burst_pages(K + 1)
            if not self.active.any():  # everyone preempted: nothing to run
                return
            self.cache["block_tables"] = self._to_device(self.block_tables)
        n = scfg.n_slots
        want = np.zeros(n, np.int32)
        contexts: list = [None] * n
        for s in range(n):
            if not self.active[s]:
                continue
            # drafts past budget - 1 can never be emitted, and the verify
            # write frontier must stay inside max_len
            want[s] = max(0, min(K, int(self.budget[s]) - 1,
                                 scfg.max_len - 1 - int(self.lengths[s])))
            rid = self.slot_rid[s]
            contexts[s] = np.concatenate(
                [np.asarray(self.requests[rid].tokens, np.int32),
                 np.asarray(self.outputs[rid], np.int32)])
        calls0 = self.drafter.model_calls
        draft, n_draft = self.drafter.draft_batch(contexts, want, K)
        # the model drafter's syncs and draft loops count too, so tokens per
        # model call never overstates the amortization
        self._count("model_calls", self.drafter.model_calls - calls0)
        if self.chaos is not None:
            # drafter desync: exact verification rejects junk drafts, so
            # the outputs cannot change
            draft, n_draft = self.chaos.corrupt_drafts(self, draft, n_draft, want)

        was_active = self.active.copy()
        with self.obs.tracer.span("spec_verify", active=int(self.active.sum())):
            t_in = self._now()
            emitted, self.cache, tok, lengths, active, budget, n_acc, ok, tstats = \
                self._spec_step(self.params, self.cache,
                                self._to_device(self.last_tok)[:, None],
                                self._to_device(draft), self._to_device(n_draft),
                                self._to_device(self.lengths), self._to_device(self.active),
                                self._to_device(self.budget))
            # one read back for the whole step
            host = torch.cat([emitted.reshape(-1), tok[:, 0], lengths, active.to(I32),
                              budget, n_acc, ok.to(I32)]).cpu().numpy()
            emitted = host[:n * (K + 1)].reshape(n, K + 1)
            tail = host[n * (K + 1):].reshape(6, n)
            self.last_tok = tail[0].copy()
            self.lengths = tail[1].copy()
            self.active = tail[2].astype(bool)
            self.budget = tail[3].copy()
            n_acc, ok = tail[4], tail[5].astype(bool)
            self._observe_burst(self._now() - t_in, 1)
        if tstats:
            self.obs.numerics.update(tstats)
        self._count("bursts")
        self._count("burst_steps")
        self._count("spec_steps")
        self._count("model_calls")
        for s in np.nonzero(was_active)[0]:
            if not ok[s]:
                # non-finite verify logits poison every lane's argmax: no
                # token of this step can be trusted, so emit nothing and
                # quarantine (the finite prefix already emitted stands)
                self._quarantine(s, now, where="spec")
                continue
            row = emitted[s]
            row = row[row != PAD].tolist()
            rid = self.slot_rid[s]
            self.outputs[rid].extend(row)
            self.out_times[rid].extend([now] * len(row))
            self._count("tokens_emitted", len(row))
            self._count("draft_tokens", int(n_draft[s]))
            self._count("accepted_tokens", int(n_acc[s]))
            self._count_converts(len(row))
            if row:
                self._count("slot_steps_active")
            if not self.active[s]:                      # freed on the device
                self._finish(rid, now)
                self._free_slot(s)
        if self.paged:
            self._rollback_spec_pages()
        self._audit_check()

    def _rollback_spec_pages(self) -> None:
        """Give back the tail pages past each active slot's length after
        acceptance: the rejected verify lanes' pages.  Only pages popped off
        the slot's OWN table are decref'd, so a page the radix trie also
        holds keeps the trie's count; and since lengths never shrink, the
        keep point never reaches back into the prompt's (possibly shared)
        pages, only into this step's fresh appends."""
        ps = self.scfg.page_size
        for s in range(self.scfg.n_slots):
            if not self.active[s]:
                continue
            keep = -(-int(self.lengths[s]) // ps)
            while len(self.slot_pages[s]) > keep:
                p = self.slot_pages[s].pop()
                self.block_tables[s, len(self.slot_pages[s])] = 0
                self.pool.decref(p)

    # -- robustness: quarantine, scrub, the fp32 retry ------------------

    def _scrub_dense_slot(self, s: int) -> None:
        """Rewrite slot ``s``'s dense cache rows with ``init_cache``'s
        values, every leaf's (the recurrent state, the hybrid's shared KV
        and encdec's memory too, which re-admission encodes anew): a NaN or
        Inf left there would reach the slot's next occupant, through the PV
        products of masked keys (0 * NaN) or the state it continues
        from."""
        self._reset_rows([s])

    def _scrub_slot_pages(self, s: int) -> None:
        """Zero slot ``s``'s exclusive pages (refcount 1) before they go
        back to the pool, so a poisoned row cannot reach the page's next
        owner.  Pages the trie shares (refcount > 1) hold clean prefill
        writes that other requests replay: they stay."""
        pages = [p for p in self.slot_pages[s] if self.pool.refs[p] == 1]
        if not pages:
            return
        # padded to n_blocks with the null page, which then holds zeros
        idx = np.full(self.n_blocks, kvpool.NULL_PAGE, np.int64)
        idx[:len(pages)] = pages
        idx = self._to_device(idx)
        for leaf in self.cache["blocks"].values():
            leaf.index_fill_(1, idx, 0)

    def _quarantine(self, s: int, now: float, where: str = "") -> None:
        """Slot ``s`` gave non-finite logits: scrub its KV, free it, and walk
        the ladder.  First fault: requeue and recompute from the prompt and
        the tokens emitted before it (greedy outputs unchanged); second: ONE
        retry on the unfused fp32 dense path; past that, a structured
        ``numeric_fault``.  fp2fx conversion maps NaN to 0 and saturates
        +-inf, so a bad scale row degrades a score quietly while the logits
        go non-finite through the PV products: this is where that shows."""
        rid = self.slot_rid[s]
        nf = self.numeric_faults.get(rid, 0) + 1
        self.numeric_faults[rid] = nf
        self._count("quarantines")
        # annotated with the latest telemetry burst's readings
        ev = self.obs.numerics.record_quarantine(rid, where or "burst")
        self.obs.tracer.instant("quarantine", slot=int(s), fault=nf, **ev)
        if self.paged:
            self._scrub_slot_pages(s)
        else:
            self._scrub_dense_slot(s)
        if nf == 1:
            self._requeue(s, now)  # may fail on the retry budget
        elif nf == 2 and self._allow_fp32_retry:
            self._fp32_retry(rid, now)
        else:
            self._fail(rid, "numeric_fault", now,
                       detail=f"non-finite logits at {where} (fault {nf})")
        self._free_slot(s)
        self._audit_check()

    def _fp32_retry(self, rid: int, now: float) -> None:
        """Second numeric fault of ``rid``: run it alone on the unfused fp32
        dense path (a fresh engine and cache, no prefix cache, no chaos),
        continuing from the tokens already emitted.  A clean retry completes
        the request; one that faults again fails with ``numeric_fault``."""
        self._count("fp32_retries")
        orig = self.requests[rid]
        done = list(self.outputs[rid])
        sched = ("continuous" if self.scfg.scheduler in ("continuous", "spec")
                 else "lockstep")
        sub = dataclasses.replace(
            self.scfg, cache_dtype="float32", attn_mode="unfused",
            kv_layout="dense", prefix_cache=False, n_slots=1, scheduler=sched,
            audit=False, max_queue=0, n_pages=0)
        eng = SlotPoolEngine(self.model, self.params, sub, generator=self.generator,
                             device=self.device, clock=self.clock)
        eng._allow_fp32_retry = False   # the fallback never recurses
        toks = np.concatenate([np.asarray(orig.tokens, np.int32),
                               np.asarray(done, np.int32)])
        rem = (orig.deadline - now) if orig.deadline is not None else None
        comp = eng.run([Request(rid=rid, tokens=toks, max_new=orig.max_new - len(done),
                                frames=orig.frames, deadline=rem)])[rid]
        fin = self._now()
        self.outputs[rid].extend(comp.tokens)
        self.out_times[rid].extend([fin] * len(comp.tokens))
        if comp.failure is None:
            self._finish(rid, fin)
        else:
            reason = ("deadline" if comp.failure.reason == "deadline"
                      else "numeric_fault")
            self._fail(rid, reason, fin, detail=f"fp32 retry: {comp.failure.reason}")

    # -- cancellation, deadlines, shutdown, audits ---------------------

    def cancel(self, rid: int) -> None:
        """Cancel ``rid`` at the next scheduling checkpoint (between
        bursts): a partial Completion with ``cancelled=True``."""
        self._cancels.add(rid)

    def _cancel_done(self, rid: int, now: float) -> None:
        r = self.requests[rid]
        self.completions[rid] = Completion(
            rid=rid, tokens=self.outputs.get(rid, []),
            prompt_len=len(r.tokens), finished_at=now, arrival=r.arrival,
            token_times=list(self.out_times.get(rid, [])), cancelled=True)
        self._count("cancelled")
        self._record_completion(self.completions[rid])

    def _apply_cancels(self, now: float) -> None:
        if not self._cancels:
            return
        todo, self._cancels = self._cancels, set()
        for rid in todo:
            if rid in self.completions or rid not in self.requests:
                continue  # already terminal / never submitted
            for s in range(self.scfg.n_slots):
                if self.slot_rid[s] == rid:
                    self._free_slot(s)
                    break
            self._queue = deque(r for r in self._queue if r.rid != rid)
            self._pending = deque(r for r in self._pending if r.rid != rid)
            self._cancel_done(rid, now)
        self._audit_check()

    def _expire(self, now: float) -> None:
        """Host deadline sweep over slots and the waiting queue: an
        already-late request expires at the next checkpoint even when the
        step-time estimate is cold."""
        for s in range(self.scfg.n_slots):
            rid = self.slot_rid[s]
            if rid is None:
                continue
            d = self.requests[rid].deadline
            if d is not None and now >= d:
                self._expire_slot(s, now)
        late = [r for r in self._queue
                if r.deadline is not None and now >= r.deadline]
        if late:
            gone = {r.rid for r in late}
            self._queue = deque(r for r in self._queue if r.rid not in gone)
            for r in late:
                self._register(r)
                self._fail(r.rid, "deadline", now, detail="expired in queue")
                self._count("expired")
        self._audit_check()

    def shutdown(self) -> dict[int, Completion]:
        """Drain: every in-flight or queued request without a completion
        ends cancelled with its partial tokens; all slots and pages are
        freed.  Idempotent; returns the completions."""
        now = self._now()
        for s in range(self.scfg.n_slots):
            rid = self.slot_rid[s]
            if rid is not None:
                self._free_slot(s)
                if rid not in self.completions:
                    self._cancel_done(rid, now)
        for r in list(self._queue) + list(self._pending):
            if r.rid not in self.completions:
                self._register(r)
                self._cancel_done(r.rid, now)
        self._queue.clear()
        self._pending.clear()
        self._audit_check()
        return self.completions

    def _audit_check(self) -> None:
        """With ``ServeConfig.audit`` (paged): recompute the pool and trie
        refcounts from the live slots, the trie edges and the chaos
        harness's squeezed pages, and cross-check the free list
        (``kvpool.PagePool.audit``)."""
        if not self.scfg.audit or not self.paged:
            return
        self._count("audits")
        for s in range(self.scfg.n_slots):
            if self.slot_rid[s] is None and self.slot_pages[s]:
                raise kvpool.AuditError(
                    f"freed slot {s} still holds pages {self.slot_pages[s]}")
        self.pool.audit(list(self.slot_pages) + list(self._extra_holders), self.trie)

    # -- the serving loop ----------------------------------------------

    def run(self, requests: list[Request]) -> dict[int, Completion]:
        """Serve ``requests`` until every one has a definite outcome.
        Malformed requests fail one by one with reason ``invalid``."""
        ok_reqs = []
        for r in sorted(requests, key=lambda r: r.arrival):
            self._register(r)
            if r.max_new < 1:
                self._fail(r.rid, "invalid", 0.0,
                           detail=f"max_new {r.max_new} < 1")
            elif len(r.tokens) + r.max_new > self.scfg.max_len:
                self._fail(r.rid, "invalid", 0.0,
                           detail=f"prompt {len(r.tokens)} + max_new "
                                  f"{r.max_new} exceeds max_len "
                                  f"{self.scfg.max_len}")
            else:
                ok_reqs.append(r)
        self._pending = deque(ok_reqs)
        self._queue = deque()
        self._t0 = self.clock()
        continuous = self.scfg.scheduler in ("continuous", "spec")
        while (self._pending or self._queue or self.active.any()
               or self.prefilling.any()):
            now = self._now()
            if self.chaos is not None:
                self.chaos.fire(self, "tick")
            self._apply_cancels(now)
            self._expire(now)
            # arrivals enter the bounded queue; requeues bypass the bound
            while self._pending and self._pending[0].arrival <= now:
                r = self._pending.popleft()
                if self.scfg.max_queue and len(self._queue) >= self.scfg.max_queue:
                    self._fail(r.rid, "queue_full", now,
                               detail=f"{len(self._queue)} waiting")
                    self._count("rejected")
                else:
                    self._queue.append(r)
            free = sum(1 for rid in self.slot_rid if rid is None)
            busy = self.active.any() or self.prefilling.any()
            batch = []
            while (continuous or not busy) and self._queue and len(batch) < free:
                batch.append(self._queue.popleft())
            if batch:
                self.admit(batch, self._now())
                self._audit_check()
            # load gauges and the periodic metrics snapshot
            self._gauges["queue_depth"].set(len(self._queue))
            self._gauges["slot_occupancy"].set(
                sum(1 for rid in self.slot_rid if rid is not None))
            if self.paged:
                self._gauges["pages_in_use"].set(self.pool.pages_in_use)
            self.obs.maybe_snapshot()
            if self.prefilling.any():
                # one chunk per iteration: a long prompt interleaves with
                # the decode bursts instead of stalling them
                self._prefill_step(self._now())
            if self.active.any():
                self.burst(self._now())
            elif (not self.prefilling.any() and not self._queue
                    and self._pending):
                # idle: wait for the next arrival
                time.sleep(max(0.0, min(self._pending[0].arrival - self._now(),
                                        0.01)))
        self.obs.maybe_snapshot(force=True)
        return self.completions


def serve(model, params, requests: list[Request], scfg: ServeConfig,
          generator=None, device=None, draft=None, chaos=None) -> dict[int, Completion]:
    """One-shot entry: build a slot-pool engine, serve, return completions.
    ``draft``: optional (model, params) pair for ``spec_mode="model"``;
    ``chaos``: optional ``serve.chaos.ChaosMonkey`` fault injector."""
    eng = SlotPoolEngine(model, params, scfg, generator=generator, device=device,
                         draft=draft, chaos=chaos)
    return eng.run(requests)
