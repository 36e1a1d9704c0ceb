"""Optimizers: AdamW (fp32 master weights), SGD-momentum, Adafactor.

Own copies of ``repro.optim.adamw``: the same update formulas, in the same
order of operations.  The optimizer keeps an fp32 master copy of every
parameter, a separate buffer even when the parameter is fp32 itself, and
re-casts the parameter from it after each update.  Adafactor factors the
second moment of >= 2-D parameters (row and column statistics).

Unlike the functional JAX version, ``update`` works in place: it overwrites
the optimizer state and the parameters and returns the same trees, so a
step never holds two copies of either (at qwen2-1.5b each is 6.2 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    master_dtype: str = "float32"


def init(cfg: OptConfig, params) -> dict[str, Any]:
    def master(p):
        return p.detach().to(torch_dtype(cfg.master_dtype)).clone()

    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    if cfg.name == "sgd":
        return {"step": step, "master": tree_map(master, params),
                "mom": tree_map(zeros, params)}
    if cfg.name == "adafactor":
        def vrow(p):
            return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
                    if p.ndim >= 2 else zeros(p))

        def vcol(p):
            return (torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)
                    if p.ndim >= 2 else torch.zeros((0,), dtype=F32, device=p.device))
        return {"step": step, "master": tree_map(master, params),
                "vr": tree_map(vrow, params), "vc": tree_map(vcol, params)}
    if cfg.name != "adamw":
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return {"step": step, "master": tree_map(master, params),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


@torch.no_grad()
def update(cfg: OptConfig, grads, opt_state, params, lr_scale=1.0):
    """One update, in place.  Returns (params, opt_state), the trees that
    were passed, now holding the updated values."""
    step = opt_state["step"] + 1
    opt_state["step"] = step
    lr = cfg.lr * lr_scale

    if cfg.name == "sgd":
        def upd(g, mom, mst, p):
            mom.mul_(cfg.momentum).add_(g.to(F32))
            mst.sub_(lr * (mom + cfg.weight_decay * mst.to(F32)).to(mst.dtype))
            p.copy_(mst)
        tree_map(upd, grads, opt_state["mom"], opt_state["master"], params)
        return params, opt_state

    if cfg.name == "adafactor":
        def upd(g, vr, vc, mst, p):
            g32 = g.to(F32)
            if g32.ndim >= 2:
                vr.mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g32 * g32, dim=-1))
                vc.mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g32 * g32, dim=-2))
                r = vr[..., None] / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True), min=1e-30)[..., None]
                denom = torch.sqrt(r * vc[..., None, :]) + cfg.eps
            else:
                vr.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
                denom = torch.sqrt(vr) + cfg.eps
            upd_ = g32 / denom + cfg.weight_decay * mst.to(F32)
            mst.copy_(mst.to(F32) - lr * upd_)
            p.copy_(mst)
        tree_map(upd, grads, opt_state["vr"], opt_state["vc"], opt_state["master"],
                 params)
        return params, opt_state

    # adamw
    bc1 = 1 - cfg.b1 ** step.to(F32)
    bc2 = 1 - cfg.b2 ** step.to(F32)

    def upd(g, m, v, mst, p):
        g32 = g.to(F32)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step_.add_(cfg.weight_decay * mst.to(F32))
        mst.copy_(mst.to(F32) - lr * step_)
        p.copy_(mst)
    tree_map(upd, grads, opt_state["m"], opt_state["v"], opt_state["master"], params)
    return params, opt_state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in sorted-key order."""
    return torch.sqrt(sum(torch.sum(x.to(F32) ** 2) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to global norm <= ``max_norm``, its global norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(F32) * scale).to(x.dtype), tree), gn
