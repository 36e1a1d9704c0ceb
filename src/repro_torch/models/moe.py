"""Mixture-of-Experts block: top-k router and capacity-bounded dispatch.

The PyTorch counterpart of ``repro.models.moe``.  Expert weights are
stacked on a leading experts axis.  The router softmax goes through the
registry, so the Hyft softmax serves the router too: under
``softmax_impl="hyft16_kernel"`` its rows (one per token, ``n_experts``
columns) go through the standalone softmax kernels, forward and backward.
Top-k follows the full softmax and the chosen k are renormalised
(Mixtral / Grok).

Dispatch and combine are the reference's dense one-hot products over
(tokens x experts x capacity): each output element sums at most one
nonzero term per choice, so they give the reference's bits.  Two details
keep the reference's semantics where torch differs from JAX:

* top-k takes the lower expert index first among equal probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises
  no order among ties, and Hyft16's coarse probabilities tie often);
* the capacity slot of each (token, choice) is an int64 count, and a slot
  of -1 (not chosen, or past capacity) gives an all-zero one-hot row, as
  ``jax.nn.one_hot`` does.

The products keep the reference's contraction structure, so
``remat="dots"`` saves the router's product (``torch.matmul`` of 3-D by
2-D, an ``aten.mm``) and recomputes the experts' batched ones (``bmm``),
as JAX's ``checkpoint_dots_with_no_batch_dims`` does.  On DTensors (a
sharded training step) the router's softmax runs on each rank's rows
(``local_rows``): its expert dim is whole there, the experts axis of the
weights being what ``default_rules`` shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.registry import get_softmax
from repro_torch.distributed.sharding import is_dtensor, local_rows
from repro_torch.models.layers import ACTIVATIONS, param

F32 = torch.float32


def moe_init(generator: torch.Generator, cfg, dtype, device=None, n_layers=None):
    """The router ``(dm, E)`` in fp32 whatever ``dtype`` is; the experts
    ``(E, dm, dff)`` / ``(E, dff, dm)`` in ``dtype``; normal, with the JAX
    package's keys, shapes and scales: its ``param`` scales by the first
    axis's size to the -1/2 unless told otherwise, which for the stacked
    up and gate products is the experts axis (``E ** -0.5``); ``w_down``
    at ``dff ** -0.5``.  ``n_layers`` stacks a leading layer axis."""
    dm, dff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def rnd(shape, scale, dt):
        # one layer at a time: a stack's fp32 draws would be twice its size
        if n_layers is None:
            return torch.randn(shape, generator=generator, dtype=F32,
                               device=device).mul_(scale).to(dt)
        out = torch.empty((n_layers,) + shape, dtype=dt, device=device)
        for layer in out:
            layer.copy_(torch.randn(shape, generator=generator, dtype=F32,
                                    device=device).mul_(scale))
        return out
    p = {"router": param(rnd((dm, E), dm ** -0.5, F32), ("embed", "experts_dim")),
         "w_up": param(rnd((E, dm, dff), E ** -0.5, dtype), ("experts", "embed", "mlp")),
         "w_down": param(rnd((E, dff, dm), dff ** -0.5, dtype), ("experts", "mlp", "embed"))}
    if cfg.mlp_gated:
        p["w_gate"] = param(rnd((E, dm, dff), E ** -0.5, dtype), ("experts", "embed", "mlp"))
    return p


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, group: int) -> int:
    """Slots per expert in a dispatch group of ``group`` tokens."""
    return max(1, int(cfg.capacity_factor * group * cfg.moe_top_k / cfg.n_experts))


def _route(p, x, cfg):
    """The router of one call.  x: (ng, G, dm) in groups.  Returns
    (probs (ng, G, E) fp32, gate_vals (ng, G, k), onehot (ng, G, k, E) fp32,
    keep (ng, G, k, E) bool, slot (ng, G, k, E, cap) fp32): the chosen
    expert of each choice is ``onehot``'s argmax, and whether it was kept
    ``keep``'s any."""
    ng, G, dm = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, G)
    logits = torch.matmul(x.to(F32), p["router"])
    probs = local_rows(get_softmax(cfg.softmax_impl), logits).to(F32)  # the Hyft router
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    hot = F.one_hot(gate_idx, E)                               # (ng, G, k, E) int64
    # slot per (token, choice): a running count over (G * k) token-major,
    # choice-minor, -1 where the expert is not chosen
    pos = torch.cumsum(hot.reshape(ng, G * k, E), dim=1).reshape(ng, G, k, E) * hot - 1
    keep = (pos >= 0) & (pos < cap)
    idx = torch.where(keep, pos, -1)
    slot = (idx[..., None] == torch.arange(cap, device=x.device)).to(F32)
    return probs, gate_vals, hot.to(F32), keep, slot


def _experts(p, xe, act):
    """Every expert's FFN on its dispatched tokens: (ng, E, cap, dm) ->
    (ng, E, cap, dm)."""
    up = torch.einsum("becd,edf->becf", xe, p["w_up"].to(xe.dtype))
    if "w_gate" in p:
        gate = torch.einsum("becd,edf->becf", xe, p["w_gate"].to(xe.dtype))
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("becf,efd->becd", h, p["w_down"].to(xe.dtype))


def _experts_sharded(p, xe, act):
    """``_experts`` on DTensors, run on each rank's blocks (``local_map``).
    Over a mesh dim that shards the experts (expert parallelism) a rank
    runs its own experts on their tokens; over one that shards each
    expert's hidden dim (tensor parallelism) it runs its slice and the
    output is a partial sum; over a dim that shards the token groups
    (data parallelism) the weights are whole and their gradient a partial
    sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    R = Replicate()
    xp, yp, xg, wup, wdown = [], [], [], [], []
    for i, wp in enumerate(p["w_up"].placements):
        bp = Shard(0) if xe.placements[i] == Shard(0) else R
        if bp == R and wp == Shard(0):     # experts over this dim
            cols = (Shard(1), Shard(1), Shard(1), Shard(0), Shard(0))
        elif bp == R and wp == Shard(2):   # each expert's hidden dim
            cols = (R, Partial(), Partial(), Shard(2), Shard(1))
        else:                              # tokens over this dim, or nothing
            cols = (bp, bp, bp, R, R)
        for col, v in zip((xp, yp, xg, wup, wdown), cols):
            col.append(v)
    names = [k for k in ("w_up", "w_gate", "w_down") if k in p]
    w_pl = {"w_up": tuple(wup), "w_gate": tuple(wup), "w_down": tuple(wdown)}
    # a weight's gradient sums over the ranks that split the tokens
    w_grad = {k: tuple(Partial() if b == Shard(0) else w for b, w in zip(xp, pl))
              for k, pl in w_pl.items()}
    ws = [p[k].redistribute(xe.device_mesh, w_pl[k]) for k in names]

    def body(xl, *wl):
        return (_experts(dict(zip(names, wl)), xl, act),)
    run = local_map(body, out_placements=(tuple(yp),),
                    in_placements=(tuple(xp),) + tuple(w_pl[k] for k in names),
                    in_grad_placements=(tuple(xg),) + tuple(w_grad[k] for k in names),
                    device_mesh=xe.device_mesh)
    return run(xe.redistribute(xe.device_mesh, tuple(xp)), *ws)[0]


def moe_apply(p, x, cfg):
    """x: (B, S, dm) -> (out, aux) with the Switch load-balancing aux loss.

    Tokens are regrouped into dispatch groups of ``min(moe_group, B * S)``
    (Switch / MaxText), so the one-hot dispatch is O(tokens * E * cap) with
    ``cap`` per group.  Tokens of one group compete for capacity, padded
    and masked lanes too (batch-global coupling, as in the reference)."""
    B0, S0, dm = x.shape
    G = min(cfg.moe_group, B0 * S0)
    x = x.reshape(-1, G, dm)
    E, k = cfg.n_experts, cfg.moe_top_k
    act = ACTIVATIONS[cfg.act]

    probs, gate_vals, onehot, keep, slot = _route(p, x, cfg)
    kept = onehot * keep
    disp = torch.einsum("bske,bskec->bsec", kept, slot)       # (ng, G, E, cap)
    comb = torch.einsum("bsk,bske,bskec->bsec", gate_vals, kept, slot)

    xe = torch.einsum("bsec,bsd->becd", disp.to(x.dtype), x)  # (ng, E, cap, dm)
    ye = (_experts_sharded if is_dtensor(xe) else _experts)(p, xe, act)
    y = torch.einsum("bsec,becd->bsd", comb.to(x.dtype), ye)

    density = (torch.mean(onehot[..., 0, :], dim=(0, 1)) if k == 1 else
               torch.mean(torch.sum(onehot, dim=2), dim=(0, 1)) / k)
    router_mean = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(density * router_mean)
    return y.reshape(B0, S0, dm), aux
