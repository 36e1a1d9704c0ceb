"""Softmax-implementation registry: one string selects the softmax everywhere.

Models take ``softmax_impl: str`` in their config; attention blocks resolve
it here.  ``hyft16/hyft32/hyft16b`` run the accelerator emulation
(differentiable, with the accelerator's own backward); ``hyft*_kernel``
route through the standalone softmax kernels (``kernels/ops.py``: the CUDA
kernels on the card, their plain versions on the CPU); the rest are
baselines for the paper's comparison tables.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import baselines
from repro_torch.core.hyft import HYFT16, HYFT16B, HYFT32, HyftConfig, hyft_softmax


def _hyft(cfg: HyftConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(z: torch.Tensor) -> torch.Tensor:
        return hyft_softmax(z, cfg).to(z.dtype)
    return fn


def _hyft_kernel(cfg: HyftConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(z: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops
        return ops.hyft_softmax(z, cfg).to(z.dtype)
    return fn


_REGISTRY: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "exact": baselines.BASELINES["exact"],
    "base2": baselines.BASELINES["base2"],
    "koca": baselines.BASELINES["koca"],
    "lut8": baselines.BASELINES["lut8"],
    "softermax": baselines.BASELINES["softermax"],
    "hyft16": _hyft(HYFT16),
    "hyft32": _hyft(HYFT32),
    "hyft16b": _hyft(HYFT16B),
    "hyft16_kernel": _hyft_kernel(HYFT16),
    "hyft32_kernel": _hyft_kernel(HYFT32),
}


def get_softmax(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve a softmax implementation by name (last-axis softmax)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown softmax impl {name!r}; have {sorted(_REGISTRY)}") from None


def register_softmax(name: str, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    _REGISTRY[name] = fn


def available() -> list[str]:
    return sorted(_REGISTRY)


def hyft_config_for(name: str) -> HyftConfig | None:
    return {
        "hyft16": HYFT16, "hyft32": HYFT32, "hyft16b": HYFT16B,
        "hyft16_kernel": HYFT16, "hyft32_kernel": HYFT32,
    }.get(name)
