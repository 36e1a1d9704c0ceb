"""Training loop with straggler monitoring (own copy of ``repro.train.loop``).

Checkpoint/restart (``ckpt_dir``) needs ``checkpoint/``, which is not
ported yet (ROADMAP queue 1, remat='dots' and checkpointing).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time EMA; a step above ``threshold`` times the EMA
    (after ``warm`` steps) is a straggler and is kept out of the EMA."""

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


def run_train(state, train_step, batch_fn: Callable[[int], dict],
              tcfg: TrainConfig, ckpt_dir: Optional[str] = None,
              log_every: int = 10,
              fail_at: Optional[Callable[[int], None]] = None,
              log_fn=print) -> tuple[dict, list]:
    """Run ``tcfg.total_steps`` steps; ``fail_at`` injects faults (tests).

    Returns (final state, metric history).  Metrics are read back (one host
    sync) only on logged steps.
    """
    if ckpt_dir:
        raise NotImplementedError(
            "checkpoint/restart is not ported yet: ROADMAP queue 1, "
            "remat='dots' and checkpointing")
    history: list = []
    monitor = StragglerMonitor()
    for step in range(tcfg.total_steps):
        if fail_at is not None:
            fail_at(step)  # may raise (fault injection)
        t0 = time.monotonic()
        batch = batch_fn(step)
        state, metrics = train_step(state, batch)
        if step % log_every == 0 or step == tcfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log_fn(f"step {step:5d} " +
                   " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        dt = time.monotonic() - t0
        if monitor.observe(dt):
            log_fn(f"[straggler] step {step} took {dt:.3f}s "
                   f"(ema {monitor.ema:.3f}s)")
    return state, history
