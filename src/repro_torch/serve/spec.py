"""Speculative decoding: self-drafting, batched Hyft verify, KV rollback.

The PyTorch counterpart of ``repro.serve.spec``.  Decode is latency-bound on
one-token steps; speculative decoding turns them into one verify call per
step: draft K cheap tokens per slot, score ``[last_token, draft_1..K]`` in
ONE ``model.prefill_chunk`` call (the chunk attention of the split-K verify
kernel under ``attn_mode="kernel"``: ``hyft_splitk_verify`` over a dense
cache, ``hyft_paged_verify`` over a paged pool, at Sq = K + 1), and keep the
longest accepted prefix.  Verification is exact: a drafter moves only the
acceptance rate, never the output.

Three pieces, as in the JAX package:

  drafters  ``NgramDrafter``: prompt-lookup self-drafting on the host (no
            second model).  ``ModelDrafter``: a small zoo model over the
            same slot ids with its own dense fp32 KV cache, synced lazily by
            teacher-forcing the tokens the target accepted since the last
            draft (``engine.build_prefill_chunk``), then K - 1 greedy
            ``decode_step`` calls.
  verify    ``build_spec_step``: the one ``prefill_chunk`` call, then the
            longest accepted prefix (a cumprod of matches) with EOS and the
            budget applied to ACCEPTED tokens only, all on the device.
  rollback  rejected lanes need no KV undo: they sit past the slot's new
            length, hidden by the ``kv_index <= position`` mask until
            overwritten.  Paged slots also give back the tail pages past it
            (``SlotPoolEngine._rollback_spec_pages``).

The scheduler integration (``ServeConfig.scheduler = "spec"``) lives in
``repro_torch.serve.scheduler``.  The per-step telemetry of the JAX step
(``tstats``) belongs to the obs layer, not ported yet: the step returns
``{}`` there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.models.model_zoo import resolve_attn_mode
from repro_torch.serve import engine
from repro_torch.serve.scheduler import PAD, _bucket  # one emitted-lane filler

I32 = torch.int32


# --------------------------------------------------------------------------
# drafters
# --------------------------------------------------------------------------


class NgramDrafter:
    """Prompt-lookup / n-gram self-drafting (no second model).

    The draft for a context is the continuation of the most recent earlier
    occurrence of the context's longest trailing n-gram (n from
    ``ngram_max`` down to 1, recency winning ties).  Deterministic and
    model-free: every draft is a literal continuation of the context, and a
    wrong draft costs only its rejected verify lanes.
    """

    model_calls = 0  # drafting never invokes a model

    def __init__(self, ngram_max: int = 3, window: int = 1024):
        if ngram_max < 1:
            raise ValueError("ngram_max must be >= 1")
        self.ngram_max = ngram_max
        # the lookup scans only the most recent ``window`` tokens: recency
        # wins anyway, and an unbounded scan would make host drafting
        # O(L^2) over a long request's lifetime
        self.window = window

    def draft(self, context, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``context`` ((L,) ints);
        empty when no trailing n-gram recurs earlier in the context.

        Among occurrences of the trailing n-gram, the most recent one with
        a FULL ``k``-token continuation wins; if every recent occurrence is
        cut off by the context end, the most recent one is used anyway.
        """
        ctx = np.asarray(context, np.int64)[-self.window:]
        L = len(ctx)
        if k <= 0 or L < 2:
            return np.empty(0, np.int32)
        for n in range(min(self.ngram_max, L - 1), 0, -1):
            pat = ctx[L - n:]
            # one vectorized sliding-window match per n: this runs on the
            # host every spec step for every slot
            win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((win == pat).all(axis=1))
            if hits.size == 0:
                continue
            full = hits[hits + n + k <= L]
            best = int(full[-1]) if full.size else int(hits[-1])
            return ctx[best + n:best + n + k].astype(np.int32)
        return np.empty(0, np.int32)

    def reset_slot(self, s: int) -> None:  # stateless: nothing to reset
        pass

    def draft_batch(self, contexts, want, k: int):
        """Per-slot drafts.  ``contexts``: per-slot token arrays (None = the
        slot is idle); ``want`` (n_slots,): per-slot draft budget.  Returns
        (draft (n_slots, k) int32, n_draft (n_slots,) int32), numpy."""
        n = len(contexts)
        draft = np.zeros((n, k), np.int32)
        n_draft = np.zeros(n, np.int32)
        for s, ctx in enumerate(contexts):
            if ctx is None or want[s] <= 0:
                continue
            d = self.draft(ctx, int(min(want[s], k)))
            n_draft[s] = len(d)
            draft[s, :len(d)] = d
        return draft, n_draft


def _draft_loop(model, params, cache, tok0, pos0, gate, steps: int, max_len: int):
    """``steps`` greedy draft tokens over the draft model's slot cache, one
    ``decode_step`` each: tok0 (B, 1), pos0 (B,), gate (B,) bool ->
    ((B, steps) int32 tokens, cache).  A row writes its KV only while gated
    and inside ``max_len``, so a nearly full slot can go on drafting for its
    neighbours' chunk width.  Nothing is read back."""
    toks, tok = [], tok0
    for i in range(steps):
        wm = gate & (pos0 + i < max_len)
        logits, cache = model.decode_step(params, cache, tok, pos0 + i, write_mask=wm)
        tok = torch.argmax(logits[:, -1, :], -1).to(I32)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, 1), cache


class ModelDrafter:
    """Small-model drafter sharing the slot pool.

    The draft model keeps its own dense fp32 KV cache over the SAME slot
    ids, whatever the target's layout and cache type, and syncs lazily:
    before drafting, the tokens the target accepted since the drafter's
    last sync go into its cache through ``engine.build_prefill_chunk`` (the
    chunk call admission uses), then ``k - 1`` more greedy draft tokens are
    decoded.  Draft writes past the context roll back by length (``d_len``)
    like the target's own rewind: the next sync overwrites them.  The draft
    model must share the target's vocab; its quality only moves the
    acceptance rate.
    """

    def __init__(self, model, params, scfg: ServeConfig, device):
        self.model = resolve_attn_mode(model, scfg.attn_mode)
        self.params = params
        self.scfg = scfg
        self.device = device
        n = scfg.n_slots
        self.cache = self.model.init_cache(params, n, scfg.max_len, "float32",
                                           device=device)
        self.d_len = np.zeros(n, np.int32)  # tokens synced per slot
        # draft-model calls (syncs + draft loops): the scheduler folds them
        # into stats["model_calls"], so tokens per model call stays honest
        self.model_calls = 0

    def reset_slot(self, s: int) -> None:
        self.d_len[s] = 0

    def _t(self, arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr), device=self.device)

    def draft_batch(self, contexts, want, k: int):
        n = self.scfg.n_slots
        draft = np.zeros((n, k), np.int32)
        n_draft = np.zeros(n, np.int32)
        gate = np.zeros(n, bool)
        delta = np.ones(n, np.int32)
        for s, ctx in enumerate(contexts):
            if ctx is None or want[s] <= 0:
                continue
            gate[s] = True
            delta[s] = len(ctx) - self.d_len[s]
        if not gate.any() or k <= 0:
            return draft, n_draft
        assert delta.min() >= 1, "drafter context shrank or did not grow"

        # ---- sync: teacher-force the un-synced context suffix
        m = _bucket(int(delta.max()), lo=1)
        toks = np.zeros((n, m), np.int32)
        start = np.array(self.d_len, np.int32)
        nv = np.ones(n, np.int32)
        for s, ctx in enumerate(contexts):
            if not gate[s]:
                continue
            suf = np.asarray(ctx, np.int32)[self.d_len[s]:]
            toks[s, :len(suf)] = suf
            nv[s] = len(suf)
        sync = engine.build_prefill_chunk(self.model, self.scfg, m)
        last, self.cache = sync(self.params, self.cache, self._t(toks), self._t(start),
                                self._t(nv), self._t(gate))
        self.model_calls += 1
        row = torch.argmax(last, -1).to(I32)[:, None]

        # ---- draft: k - 1 more greedy tokens, then rewind by length
        if k > 1:
            pos0 = np.array([len(ctx) if gate[s] else 0
                             for s, ctx in enumerate(contexts)], np.int32)
            rest, self.cache = _draft_loop(self.model, self.params, self.cache, row,
                                           self._t(pos0), self._t(gate), k - 1,
                                           self.scfg.max_len)
            self.model_calls += 1
            row = torch.cat([row, rest], 1)
        row = row.cpu().numpy()                      # the one read back
        for s in range(n):
            if not gate[s]:
                continue
            w = int(min(want[s], k))
            n_draft[s] = w
            draft[s, :w] = row[s, :w]
            self.d_len[s] = len(contexts[s])  # rollback: drafts are not kept
        return draft, n_draft


# --------------------------------------------------------------------------
# verify + longest accepted prefix, on the device
# --------------------------------------------------------------------------


def build_spec_step(model, scfg: ServeConfig, k: int):
    """(params, cache, last_tok (B, 1), draft (B, k), n_draft (B,), lengths
    (B,), active (B,), budget (B,)) -> (emitted (B, k + 1) PAD-padded,
    cache, last_tok, lengths, active, budget, n_acc (B,), ok (B,), tstats),
    device tensors.  ``ok`` is False where a valid verify lane of an active
    slot gave non-finite logits (idle slots and padding lanes report True);
    ``tstats`` is ``{}`` (the telemetry of the obs layer, not ported).

    One ``model.prefill_chunk`` call scores ``[last_tok, draft_1..k]``:
    lane ``j``'s argmax is the token greedy decode would emit after ``j``
    accepted drafts, so the longest prefix with ``draft[j] == argmax[j -
    1]`` (a cumprod of matches) IS the greedy continuation, and one bonus
    token comes free from the lane after it.  EOS and the budget act on
    ACCEPTED tokens only; each slot's length advances by its emitted count
    (rejected lanes sit past the new length, masked until overwritten), and
    ``active`` drops on the device as in the plain burst.  Greedy only.
    """
    eos = scfg.eos_id
    S = k + 1

    def step(params, cache, last_tok, draft, n_draft, lengths, active, budget):
        dev = last_tok.device
        toks = torch.cat([last_tok, draft], 1)                         # (B, S)
        n_valid = torch.where(active, n_draft + 1, 1).to(I32)
        logits, cache = model.prefill_chunk(params, cache, toks, lengths,
                                            lengths=n_valid, write_mask=active)
        greedy = torch.argmax(logits, -1).to(I32)                      # (B, S)
        lane = torch.arange(S, dtype=I32, device=dev)[None]
        lane_ok = torch.isfinite(logits).all(-1)
        ok = (lane_ok | (lane >= n_valid[:, None])).all(1) | ~active
        dmask = torch.arange(k, dtype=I32, device=dev)[None] < n_draft[:, None]
        match = (draft == greedy[:, :-1]) & dmask
        n_acc = torch.cumprod(match.to(I32), 1).sum(1).to(I32)
        n_emit = torch.minimum(n_acc + 1, budget)
        if eos is not None:
            is_eos = (greedy == eos) & (lane < n_emit[:, None])
            first = torch.where(is_eos, lane, S).amin(1)
            n_emit = torch.minimum(n_emit, first + 1)
            hit_eos = first < S
        else:
            hit_eos = torch.zeros_like(active)
        n_emit = torch.where(active, n_emit, 0).to(I32)
        emitted = torch.where(lane < n_emit[:, None], greedy, PAD)
        pick = torch.clamp(n_emit - 1, min=0).to(torch.long)[:, None]
        new_last = torch.gather(greedy, 1, pick)[:, 0]
        last_tok = torch.where(active, new_last, last_tok[:, 0])[:, None]
        lengths = lengths + n_emit
        budget = budget - n_emit
        active = active & (budget > 0) & ~hit_eos
        return emitted, cache, last_tok, lengths, active, budget, n_acc, ok, {}

    return step


def make_drafter(scfg: ServeConfig, target_cfg, draft=None, device=None):
    """``scfg.spec_mode`` as a drafter.

    ``draft``: optional (model, params) pair for ``spec_mode="model"``,
    required unless ``scfg.draft_model`` names a zoo arch; then a RANDOM
    smoke drafter is built (``smoke_config`` of that arch at the target's
    vocab and softmax, weights from a generator seeded 1 on ``device``): a
    demo drafter whose acceptance floor is chance.
    """
    if scfg.spec_mode == "ngram":
        return NgramDrafter(scfg.ngram_max)
    if scfg.spec_mode == "model":
        if draft is None:
            if not scfg.draft_model:
                raise ValueError(
                    "spec_mode='model' needs draft=(model, params) or "
                    "ServeConfig.draft_model naming a zoo arch")
            from repro_torch.configs import get_config, smoke_config
            from repro_torch.models import build_model
            dcfg = smoke_config(get_config(scfg.draft_model)).with_(
                vocab=target_cfg.vocab, softmax_impl=target_cfg.softmax_impl)
            dmodel = build_model(dcfg)
            draft = (dmodel, dmodel.init(1, device=device))
        dmodel, dparams = draft
        if dmodel.cfg.vocab != target_cfg.vocab:
            raise ValueError(
                f"draft model vocab {dmodel.cfg.vocab} != target vocab "
                f"{target_cfg.vocab}")
        return ModelDrafter(dmodel, dparams, scfg, device)
    raise ValueError(f"unknown spec_mode {scfg.spec_mode!r}")
