"""Softmax-implementation registry: one string selects the softmax everywhere.

The port carries the entries the unfused reference attention mode needs:
``hyft16/hyft32/hyft16b`` (the accelerator emulation) and ``exact``.  The
other baselines of ``repro.core.baselines`` and the ``hyft*_kernel``
softmax kernels come with later slices (ROADMAP queue 1 item 1, queue 2).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.hyft import HYFT16, HYFT16B, HYFT32, HyftConfig, hyft_softmax

F32 = torch.float32


def _hyft(cfg: HyftConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(z: torch.Tensor) -> torch.Tensor:
        return hyft_softmax(z, cfg).to(z.dtype)
    return fn


def _exact(z: torch.Tensor) -> torch.Tensor:
    return torch.softmax(z.to(F32), dim=-1).to(z.dtype)


_REGISTRY: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "exact": _exact,
    "hyft16": _hyft(HYFT16),
    "hyft32": _hyft(HYFT32),
    "hyft16b": _hyft(HYFT16B),
}


def get_softmax(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve a softmax implementation by name (last-axis softmax)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"softmax impl {name!r} is not ported yet; "
                       f"have {sorted(_REGISTRY)}") from None


def hyft_config_for(name: str) -> HyftConfig | None:
    return {"hyft16": HYFT16, "hyft32": HYFT32, "hyft16b": HYFT16B}.get(name)
