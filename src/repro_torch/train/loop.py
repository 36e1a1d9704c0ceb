"""Training loop: checkpoint/restart, straggler monitoring, metrics (own
copy of ``repro.train.loop``)."""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.fault_tolerance import (  # noqa: F401 (re-exported)
    RestartManager, StragglerMonitor)


def run_train(state, train_step, batch_fn: Callable[[int], dict],
              tcfg: TrainConfig, ckpt_dir: Optional[str] = None,
              state_sh=None, log_every: int = 10,
              fail_at: Optional[Callable[[int], None]] = None,
              log_fn=print) -> tuple[dict, list]:
    """Run ``tcfg.total_steps`` steps; ``fail_at`` injects faults (tests).

    Returns (final state, metric history).  Metrics are read back (one host
    sync) only on logged steps.  With ``ckpt_dir`` the loop runs under
    ``RestartManager``: it saves every ``tcfg.checkpoint_every`` steps
    (keeping ``tcfg.keep_checkpoints``), and on start and after any
    exception it restores the latest checkpoint into the state's structure,
    placed by ``state_sh`` where given (a resized mesh), and resumes at its
    step (the data stream is keyed by step).
    """
    history: list = []
    monitor = StragglerMonitor()
    box = {"state": state}

    def body(start_step: int) -> int:
        latest = checkpointer.latest_step(ckpt_dir) if ckpt_dir else None
        if latest is not None:
            box["state"], start_step = checkpointer.restore(
                ckpt_dir, latest, box["state"], shardings=state_sh)
        for step in range(start_step, tcfg.total_steps):
            if fail_at is not None:
                fail_at(step)  # may raise (fault injection)
            t0 = time.monotonic()
            batch = batch_fn(step)
            box["state"], metrics = train_step(box["state"], batch)
            if step % log_every == 0 or step == tcfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                log_fn(f"step {step:5d} " +
                       " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            dt = time.monotonic() - t0
            if monitor.observe(dt):
                log_fn(f"[straggler] step {step} took {dt:.3f}s "
                       f"(ema {monitor.ema:.3f}s)")
            if ckpt_dir and (step + 1) % tcfg.checkpoint_every == 0:
                checkpointer.save(ckpt_dir, step + 1, box["state"],
                                  keep=tcfg.keep_checkpoints)
        return tcfg.total_steps

    if ckpt_dir:
        RestartManager(ckpt_dir).run(body)
    else:
        body(0)
    return box["state"], history
