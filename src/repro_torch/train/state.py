"""Train state construction and its shardings (own copy of
``repro.train.state``).

The state is ``{"params", "opt", "step"}``.  ``abstract_state`` builds it
on ``device="meta"`` (JAX's ``eval_shape``: no allocation), and
``state_shardings`` derives a NamedSharding tree of the same structure
from the parameters' logical axes: the optimizer's master copy and
moments mirror the params, Adafactor's row and column statistics drop the
last and the second-last entry, and the step counters are replicated.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import param_axes
from repro_torch.tree import tree_map


def init_state(model, opt_cfg: optim.OptConfig, seed: int = 0, device=None,
               shardings=None) -> dict:
    """{"params", "opt", "step"}: fresh weights from ``seed`` on ``device``
    (None means the card), the optimizer state, and the int32 step.  With
    ``shardings`` (``state_shardings``) every leaf is placed as a DTensor:
    each rank makes the same global state and keeps its own blocks."""
    params = model.init(seed, device=device)
    opt = optim.init(opt_cfg, params)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=opt["step"].device)}
    if shardings is not None:
        state = tree_map(shd.place, state, shardings)
    return state


def abstract_state(model, opt_cfg: optim.OptConfig):
    """(the state on ``device="meta"``, the params' logical-axes tree)."""
    state = init_state(model, opt_cfg, device="meta")
    return state, param_axes(state["params"])


def state_shardings(mesh, model, opt_cfg: optim.OptConfig, rules):
    """NamedSharding tree matching init_state's structure."""
    state, axes = abstract_state(model, opt_cfg)
    psh = shd.param_shardings(mesh, state["params"], axes, rules)
    rep = shd.NamedSharding(mesh, shd.Spec())

    def padded(s, rank: int) -> list:
        return list(s.spec) + [None] * (rank - len(s.spec))

    def reduce_last(s, p):
        # adafactor vr: params of rank >= 2 lose the last dim; 1-D params
        # keep their shape (vr == zeros_like) and their sharding
        if p.ndim < 2:
            return s
        return shd.NamedSharding(mesh, shd.Spec(*padded(s, p.ndim)[:-1]))

    def reduce_second_last(s, p):
        if p.ndim < 2:
            return rep                        # vc is a zero-size stub
        spec = padded(s, p.ndim)
        return shd.NamedSharding(mesh, shd.Spec(*(spec[:-2] + spec[-1:])))

    opt_sh = {}
    for k in state["opt"]:
        if k == "step":
            opt_sh[k] = rep
        elif k == "vr":
            opt_sh[k] = tree_map(reduce_last, psh, state["params"])
        elif k == "vc":
            opt_sh[k] = tree_map(reduce_second_last, psh, state["params"])
        else:  # master / m / v / mom mirror the params
            opt_sh[k] = psh
    return {"params": psh, "opt": opt_sh, "step": rep}
