"""Model building blocks: logical axes, norms, rotary, activations,
embedding.

The PyTorch counterpart of ``repro.models.layers``.  Parameters are plain
tensors in nested dicts with the JAX package's keys and shapes (its
``unbox(model.init(key))`` tree), so the weights bridge is a key-for-key
copy.  Where JAX boxes a leaf as ``Param(value, axes)``, the port's init
sites pass the fresh tensor through ``param(t, axes)``, which tags it with
the same logical axes (without the stacked layer axis, as in JAX);
``param_axes`` reads them back as JAX's ``boxed_axes`` tree, the input of
``distributed.sharding.param_shardings``.  Norms compute in fp32, as in
the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor

F32 = torch.float32


# --------------------------------------------------------------------------
# logical axes
# --------------------------------------------------------------------------


def param(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``t``, tagged with its logical axes (JAX's ``Param`` box)."""
    t.logical_axes = tuple(axes)
    return t


def param_axes(tree):
    """The logical-axes tree of a tree fresh from an init (JAX's
    ``boxed_axes``)."""
    if isinstance(tree, dict):
        return {k: param_axes(v) for k, v in tree.items()}
    return tree.logical_axes


# --------------------------------------------------------------------------
# norms — always computed in fp32
# --------------------------------------------------------------------------


def rmsnorm(p, x, eps=1e-6):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32)).to(x.dtype)


def layernorm(p, x, eps=1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(F32)
    if "bias" in p:
        y = y + p["bias"].to(F32)
    return y.to(x.dtype)


def np_layernorm(x, eps=1e-5):
    """Non-parametric LayerNorm (OLMo): no scale, no bias."""
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


NORMS: dict[str, Callable] = {
    "rms": rmsnorm,
    "ln": layernorm,
    "np_ln": lambda p, x: np_layernorm(x),
}


def make_norm(kind: str, dm: int, dtype, device=None):
    """Returns (init_params, apply_fn)."""
    if kind not in NORMS:
        raise ValueError(kind)
    p = {}
    if kind in ("rms", "ln"):
        p["scale"] = param(torch.ones(dm, dtype=dtype, device=device), ("embed",))
    if kind == "ln":
        p["bias"] = param(torch.zeros(dm, dtype=dtype, device=device), ("embed",))
    return p, NORMS[kind]


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(F32) * freqs          # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2].to(F32), x[..., d // 2:].to(F32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
    "squared_relu": squared_relu,
}


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------


def embed_lookup(p, tokens):
    if is_dtensor(p["table"]):
        return _sharded_lookup(p["table"], tokens)
    return p["table"][tokens]


def _sharded_lookup(table, tokens):
    """``table[tokens]`` on DTensors, through ``local_map``: the table made
    whole, each rank looks up its own tokens (the output takes the tokens'
    placements), and the table's gradient is a partial sum over the ranks
    that split the tokens.  DTensor's own strategies for the index and its
    backward are not relied on."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    whole = (Replicate(),) * mesh.ndim
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, whole, src_data_rank=None)
    tp = tuple(p if p == Shard(0) else Replicate() for p in tokens.placements)
    grad = tuple(Partial() if p == Shard(0) else Replicate() for p in tp)
    run = local_map(lambda t, ids: (t[ids],), out_placements=(tp,),
                    in_placements=(whole, tp), in_grad_placements=(grad, tp),
                    device_mesh=mesh)
    return run(table.redistribute(mesh, whole), tokens.redistribute(mesh, tp))[0]


def unembed(p, x):
    """Project to vocab logits (tied or untied table of shape (V, dm))."""
    return torch.matmul(x, p["table"].to(x.dtype).T)
