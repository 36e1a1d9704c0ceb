"""Optimizers and learning-rate schedules (own copies of ``repro.optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    clip_by_global_norm,
    global_norm,
    init,
    update,
)
from repro_torch.optim.schedules import SCHEDULES, constant, warmup_cosine  # noqa: F401
