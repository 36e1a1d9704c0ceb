"""Fault tolerance: restart manager, straggler monitor, elastic re-meshing.

Own copy of ``repro.distributed.fault_tolerance``:
  * RestartManager supervises the train loop; on failure it reloads the
    latest atomic checkpoint and retries, a bounded number of times.
    ``KeyboardInterrupt`` and ``SystemExit`` pass through.
  * StragglerMonitor keeps a per-step wall-time EMA and flags a step above
    ``threshold`` times it (after ``warm`` steps); a flagged step stays out
    of the EMA.
  * elastic_remesh rebuilds a (data, model) mesh over the ranks still
    alive: the data axis shrinks, the model axis is kept whole (a TP group
    must stay whole), and ``checkpointer.restore(shardings=)`` re-places a
    checkpoint on the new mesh: that is elastic scaling.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch.distributed as dist

from repro_torch.checkpoint import checkpointer
from repro_torch.launch.mesh import mesh_over


@dataclasses.dataclass
class StragglerMonitor:
    ema: float = 0.0
    beta: float = 0.9
    threshold: float = 3.0
    warm: int = 5
    seen: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warm:
            self.ema = dt if self.ema == 0 else (self.beta * self.ema
                                                 + (1 - self.beta) * dt)
            return False
        is_straggler = dt > self.threshold * max(self.ema, 1e-9)
        if is_straggler:
            self.flagged += 1
        else:  # don't pollute the EMA with outliers
            self.ema = self.beta * self.ema + (1 - self.beta) * dt
        return is_straggler


def elastic_remesh(model_size: int, axes=("data", "model"), ranks=None,
                   device=None):
    """A mesh over the ranks still alive (``ranks``; None: every rank of the
    process group); the data axis absorbs the loss, dropping the ranks past
    the last whole model group.  Every rank of the group calls it, the
    dropped ones too (the mesh's process groups are made collectively)."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = (len(ranks) // model_size) * model_size
    if n == 0:
        raise RuntimeError("not enough ranks to keep a model-parallel group")
    return mesh_over(ranks[:n], (n // model_size, model_size), axes, device)


@dataclasses.dataclass
class RestartManager:
    ckpt_dir: str
    max_restarts: int = 3
    on_restart: Optional[Callable[[int], None]] = None

    def run(self, body: Callable[[int], int]) -> int:
        """``body(start_step) -> final_step``, rerun from the latest
        checkpoint on failure."""
        restarts = 0
        while True:
            start = checkpointer.latest_step(self.ckpt_dir)
            start = 0 if start is None else start
            try:
                return body(start)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — any node failure mode
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                if self.on_restart:
                    self.on_restart(restarts)
                time.sleep(0.01)
