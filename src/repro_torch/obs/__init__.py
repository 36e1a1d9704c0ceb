"""Observability bundle: span tracing, metrics registry, numeric telemetry.

The PyTorch counterpart of ``repro.obs``.  One ``Obs`` object threads the
three through an engine:

  tracer   — host-side span tracer emitting Chrome trace-event JSON
             (``obs.trace``; load the file in Perfetto / chrome://tracing)
  metrics  — typed counters / gauges / streaming-percentile histograms
             (``obs.metrics``); the scheduler's ``stats`` dict is a
             read-only view over this registry
  numerics — hybrid-format telemetry (``obs.numerics``): softmax-input
             exponent range, fp2fx8 scale histogram, int8 saturation,
             convert volume, fed per burst when ``ServeConfig.telemetry``
             is on
  profile  — the per-executable cost book (``obs.profile``): FLOPs and
             bytes counted up front, joined with measured dispatch walls
             into achieved GFLOP/s, GB/s and roofline-fraction gauges
             against the H100's bound, and ``roofline.<name>`` counter
             tracks.  Counting is gated on ``profile.enabled`` (on for the
             ``--trace`` bundle), so plain engines never pay the extra
             counted call.

Not ported: ``repro.obs.trace``'s ``compile_watch`` and
``CompileListener``, which read JAX's compile log; eager PyTorch retraces
nothing, and the port's one compile, the kernel build, is a
``compile_span`` of the engine's prewarm.  ``repro.obs.ledger`` comes with
the port's benchmark (ROADMAP queue 1).

Every ``SlotPoolEngine`` owns an Obs (a fresh one with the tracer off by
default, so two engines never share counters unless the caller passes a
shared bundle).  ``metrics_path`` + ``snapshot_every_s`` turn on periodic
JSONL snapshots from inside the serving loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.obs.metrics import Registry
from repro_torch.obs.numerics import NumericsMonitor
from repro_torch.obs.profile import CostBook
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: F401


@dataclasses.dataclass
class Obs:
    tracer: Tracer = dataclasses.field(
        default_factory=lambda: Tracer(enabled=False))
    metrics: Registry = dataclasses.field(default_factory=Registry)
    numerics: NumericsMonitor = dataclasses.field(
        default_factory=NumericsMonitor)
    profile: CostBook = dataclasses.field(default_factory=CostBook)
    # periodic metrics JSONL export (None = no export); snapshots are
    # appended from the serving loop every ``snapshot_every_s`` seconds and
    # once more at the end of every run
    metrics_path: Optional[str] = None
    snapshot_every_s: float = 1.0
    _last_snapshot: float = dataclasses.field(default=0.0, repr=False)

    def __post_init__(self):
        # the cost book emits through THIS bundle's registry and tracer
        self.profile.bind(self.metrics, self.tracer)

    @classmethod
    def enabled(cls, metrics_path: Optional[str] = None,
                snapshot_every_s: float = 1.0) -> "Obs":
        """An Obs with the tracer and the cost book on (the ``--trace``
        bundle)."""
        return cls(tracer=Tracer(enabled=True), profile=CostBook(enabled=True),
                   metrics_path=metrics_path, snapshot_every_s=snapshot_every_s)

    def maybe_snapshot(self, force: bool = False) -> None:
        """Append a metrics snapshot line to ``metrics_path`` if the export
        cadence (or ``force``) says so.  No-op without a path."""
        if self.metrics_path is None:
            return
        now = time.monotonic()
        if force or now - self._last_snapshot >= self.snapshot_every_s:
            self._last_snapshot = now
            self.metrics.write_jsonl(self.metrics_path)
