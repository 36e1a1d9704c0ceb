"""Deterministic fault injection for the serving stack.

The PyTorch counterpart of ``repro.serve.chaos``.  The robustness contract
(every request ends with a definite outcome, audits stay clean, greedy
outputs of requests never poisoned do not change) is worth something only
if it survives the faults that happen.  This module injects them, seeded
and reproducible:

  forced preemption   — ``SlotPoolEngine._preempt_latest`` fires without
                        page pressure (the requeue and resume path).
  trie-eviction storm — every evictable prefix-cache leaf goes at once.
  page-pool squeeze   — a fraction of the free pages is allocated and held
                        for a few scheduler ticks: admissions and decode
                        page appends see exhaustion.  The held pages are
                        an extra audit holder, so the refcounts balance.
  NaN/Inf KV poison   — a non-finite payload in a slot's exclusive KV page
                        (paged) or cache row (dense), the silent-corruption
                        shape of a hybrid-format datapath: fp2fx maps NaN
                        to 0 and saturates +-inf, so a bad scale row moves
                        a score quietly while the PV products turn the
                        logits non-finite.  The scheduler must quarantine
                        exactly that slot.
  drafter desync      — one speculative slot's draft row becomes junk:
                        exact verification rejects it, outputs unchanged.
  burst straggler     — a stall before a burst, which the scheduler's
                        ``StragglerMonitor`` flags.
  cancellation        — a random in-flight or queued request is cancelled
                        through ``cancel(rid)``.

Injection points (``ChaosMonkey.fire(eng, point)``): "tick", the top of
every scheduling-loop iteration before admission (squeeze and release,
eviction storms, cancellations); "pre_burst", just before a decode or spec
burst (forced preemptions, KV poison, stragglers).  Spec drafting consults
``corrupt_drafts`` directly.

Determinism: one ``numpy`` Generator seeded by ``FaultPlan.seed`` drives
every decision with the JAX module's draws in the JAX module's order (one
uniform per consult, even where the fault cannot fire), so one seed over
one scheduling sequence gives the JAX harness's ``log``.  The sequence is
free of the wall clock when every request arrives at 0 with no deadline.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-injection-point fault probabilities (all in [0, 1]).

    A zero plan injects nothing; ``max_faults`` caps the injected faults so
    a high-rate plan still lets the run finish its tail quietly."""
    seed: int = 0
    preempt_rate: float = 0.0       # pre_burst: force-preempt latest slot
    evict_storm_rate: float = 0.0   # tick: evict every prefix-cache leaf
    squeeze_rate: float = 0.0       # tick: hold free pages hostage
    squeeze_frac: float = 0.5       # fraction of free pages a squeeze takes
    squeeze_hold: int = 3           # scheduler ticks a squeeze lasts
    nan_kv_rate: float = 0.0        # pre_burst: poison exclusive KV
    nan_kind: str = "nan"           # "nan" | "inf" payload
    drafter_junk_rate: float = 0.0  # spec drafting: junk one slot's draft
    straggle_rate: float = 0.0      # pre_burst: artificial stall
    straggle_s: float = 0.0         # stall duration (seconds)
    cancel_rate: float = 0.0        # tick: cancel a random live request
    max_faults: int = 1 << 30


class ChaosMonkey:
    """Consults a :class:`FaultPlan` at the scheduler's injection points.

    Attach with ``SlotPoolEngine(..., chaos=ChaosMonkey(plan))`` or
    ``serve(..., chaos=...)``.  ``faulted_rids`` collects the requests a KV
    poison touched (the one fault that may change a request's path:
    quarantine, then recompute); ``log`` records every injected fault as
    a dict."""

    def __init__(self, plan: FaultPlan):
        if plan.nan_kind not in ("nan", "inf"):
            raise ValueError(f"unknown nan_kind {plan.nan_kind!r}")
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.log: list = []
        self.n_faults = 0
        self.faulted_rids: set = set()
        self._held: list = []           # squeezed pages (an audit holder)
        self._hold_left = 0
        self._tracer = None             # the engine's tracer, set by fire()

    # -- plumbing ------------------------------------------------------

    def _maybe(self, rate: float) -> bool:
        """One uniform per consult; fires iff under ``rate`` with fault
        budget left."""
        u = self.rng.random()
        return u < rate and self.n_faults < self.plan.max_faults

    def _log(self, point: str, kind: str, **detail) -> None:
        self.n_faults += 1
        self.log.append(dict(point=point, kind=kind, **detail))
        if self._tracer is not None:
            # injected faults sit in the trace beside the spans they perturb
            self._tracer.instant(f"chaos.{kind}", cat="chaos", point=point, **detail)

    def summary(self) -> dict:
        by_kind: dict = {}
        for e in self.log:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {"faults": self.n_faults, "by_kind": by_kind,
                "faulted_rids": sorted(self.faulted_rids)}

    # -- injection points ----------------------------------------------

    def fire(self, eng, point: str) -> None:
        self._tracer = eng.obs.tracer
        if point == "tick":
            self._tick(eng)
        elif point == "pre_burst":
            self._pre_burst(eng)
        else:
            raise ValueError(f"unknown injection point {point!r}")

    def _tick(self, eng) -> None:
        self._squeeze_step(eng)
        if self._maybe(self.plan.evict_storm_rate) and eng.trie is not None:
            freed = eng.trie.evict(1 << 30)
            if freed:
                self._log("tick", "evict_storm", pages=freed)
        if self._maybe(self.plan.squeeze_rate) and eng.paged and not self._held:
            take = int(eng.pool.free_pages * self.plan.squeeze_frac)
            pages = eng.pool.alloc(take) if take > 0 else None
            if pages:
                self._held = pages
                self._hold_left = max(1, self.plan.squeeze_hold)
                eng._extra_holders.append(self._held)
                self._log("tick", "squeeze", pages=len(pages))
        if self._maybe(self.plan.cancel_rate):
            u = self.rng.random()
            cands = sorted({rid for rid in eng.slot_rid if rid is not None}
                           | {r.rid for r in eng._queue})
            if cands:
                rid = cands[int(u * len(cands)) % len(cands)]
                eng.cancel(rid)
                self._log("tick", "cancel", rid=rid)

    def _pre_burst(self, eng) -> None:
        if self._maybe(self.plan.preempt_rate):
            if eng._preempt_latest():
                self._log("pre_burst", "preempt")
        if self._maybe(self.plan.nan_kv_rate):
            self._poison(eng)
        if self._maybe(self.plan.straggle_rate) and self.plan.straggle_s > 0:
            time.sleep(self.plan.straggle_s)
            self._log("pre_burst", "straggle", seconds=self.plan.straggle_s)

    # -- fault payloads ------------------------------------------------

    def _squeeze_step(self, eng) -> None:
        """Count a held squeeze down one tick; release its pages when it
        expires (through the normal decref path)."""
        if not self._held:
            return
        self._hold_left -= 1
        if self._hold_left > 0:
            return
        eng._extra_holders.remove(self._held)
        for p in self._held:
            eng.pool.decref(p)
        self._log("tick", "squeeze_release", pages=len(self._held))
        self._held = []

    def _poison(self, eng) -> bool:
        """Write a non-finite payload, in place, into one active slot's KV.

        Paged: every float leaf of the slot-exclusive (refcount 1) page
        holding the read frontier (position ``length - 1``): decode writes
        land only in exclusive tail pages, and a trie-shared page would
        poison other requests, which even the harness never does.  Dense:
        every float leaf row of the slot (for fp2fx8 the int8 raws cannot
        hold a NaN: the fp32 scale rows carry it).  Every leaf of the
        port's cache has the slot or page on axis 1 (axis 0 the layers)."""
        val = float("nan") if self.plan.nan_kind == "nan" else float("inf")
        u = self.rng.random()
        blocks = eng.cache["blocks"]
        if eng.paged:
            ps = eng.scfg.page_size
            cands = []
            for s in range(eng.scfg.n_slots):
                if not eng.active[s]:
                    continue
                bi = (int(eng.lengths[s]) - 1) // ps
                if bi < len(eng.slot_pages[s]):
                    p = eng.slot_pages[s][bi]
                    if eng.pool.refs[p] == 1:
                        cands.append((s, p))
            if not cands:
                return False
            s, row = cands[int(u * len(cands)) % len(cands)]
        else:
            live = [s for s in range(eng.scfg.n_slots) if eng.active[s]]
            if not live:
                return False
            s = row = live[int(u * len(live)) % len(live)]
        for leaf in blocks.values():
            if torch.is_floating_point(leaf):
                leaf[:, row] = val
        rid = eng.slot_rid[s]
        self.faulted_rids.add(rid)
        self._log("pre_burst", "nan_kv", rid=rid, slot=int(s), payload=self.plan.nan_kind)
        return True

    def corrupt_drafts(self, eng, draft, n_draft, want):
        """Drafter desync: replace one drafting slot's row with junk tokens
        at the full draft width.  Exact verification rejects every lane
        that mismatches, so outputs cannot change; the slot loses its
        speculative gain for one step."""
        if not self._maybe(self.plan.drafter_junk_rate):
            return draft, n_draft
        u = self.rng.random()
        cands = [s for s in range(eng.scfg.n_slots) if want[s] > 0]
        if not cands:
            return draft, n_draft
        s = cands[int(u * len(cands)) % len(cands)]
        k = draft.shape[1]
        draft = np.array(draft)
        n_draft = np.array(n_draft)
        draft[s, :] = eng.model.cfg.vocab - 1 - np.arange(k, dtype=np.int32) % 2
        n_draft[s] = int(min(want[s], k))
        self._log("draft", "drafter_junk", rid=eng.slot_rid[s], slot=int(s))
        return draft, n_draft
