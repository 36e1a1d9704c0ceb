"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and asking for CUDA on a machine without
a card raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
