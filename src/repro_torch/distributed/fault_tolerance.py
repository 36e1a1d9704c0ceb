"""Fault tolerance: restart manager and straggler monitor.

Own copy of ``repro.distributed.fault_tolerance``:
  * RestartManager supervises the train loop; on failure it reloads the
    latest atomic checkpoint and retries, a bounded number of times.
    ``KeyboardInterrupt`` and ``SystemExit`` pass through.
  * StragglerMonitor keeps a per-step wall-time EMA and flags a step above
    ``threshold`` times it (after ``warm`` steps); a flagged step stays out
    of the EMA.
``elastic_remesh`` (re-meshing over the devices still alive) comes with the
mesh (ROADMAP queue 1, distributed and the mesh).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpointer


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
