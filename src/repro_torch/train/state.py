"""Train state construction (own copy of ``repro.train.state``, without the
sharding: one device)."""
from __future__ import annotations

import torch

from repro_torch import optim


def init_state(model, opt_cfg: optim.OptConfig, seed: int = 0, device=None) -> dict:
    """{"params", "opt", "step"}: fresh weights from ``seed`` on ``device``
    (None means the card), the optimizer state, and the int32 step."""
    params = model.init(seed, device=device)
    opt = optim.init(opt_cfg, params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=opt["step"].device)}
