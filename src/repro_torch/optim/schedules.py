"""LR schedules (as scale factors applied to the base lr), on 0-d tensors."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def warmup_cosine(step, warmup: int, total: int, final_frac: float = 0.1):
    """Linear warm-up, then cosine decay to ``final_frac``; 0 at step 0."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, **_):
    return torch.ones_like(torch.as_tensor(step), dtype=F32)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
