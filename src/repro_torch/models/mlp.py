"""MLP blocks: gated (SwiGLU-family) and plain (squared-ReLU / GeLU)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import ACTIVATIONS


def mlp_apply(p, x, cfg):
    act = ACTIVATIONS[cfg.act]
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    if "w_gate" in p:
        h = act(torch.matmul(x, p["w_gate"].to(x.dtype))) * up
    else:
        h = act(up)
    return torch.matmul(h, p["w_down"].to(x.dtype))
