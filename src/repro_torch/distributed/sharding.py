"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / SP).

Own copy of ``repro.distributed.sharding``, with the same rules and the
same divisibility guards.  Parameters carry logical axis names
(``models.layers.param``); a rules table maps them to mesh axes:

  batch       -> (pod, data)      activations' batch dim
  heads/mlp/  -> model            tensor parallelism
  vocab/experts
  embed       -> fsdp axes for big archs (ZeRO-3), replicated for small
  kv_heads    -> model only when divisible, else replicated (GQA kv<16)

DTensor is the port's ``NamedSharding``: a ``Spec`` (JAX's
``PartitionSpec``: one entry a tensor dim, each None, a mesh axis name or
a tuple of names) on a mesh gives one DTensor placement a mesh dim,
``Shard(d)`` where the dim names it and ``Replicate()`` elsewhere; two mesh
axes on one tensor dim give ``Shard(d)`` on both, the earlier mesh dim
major, as JAX lays them out.  Spec math runs on an ``AbstractMesh`` or a
``DeviceMesh`` alike; ``place`` needs a ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import mesh_axis_names, mesh_shape
from repro_torch.tree import tree_map


class Spec(tuple):
    """A tuple of entries, one per leading tensor dim (JAX's
    ``PartitionSpec``): None, a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    def placements(self) -> tuple:
        """One DTensor placement per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for dim, e in enumerate(self.spec):
            axes = e if isinstance(e, tuple) else (e,) if e else ()
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {self.spec}: the axes of one dim must "
                                 f"follow the mesh's order {names}")
            for i in pos:
                out[i] = Shard(dim)
        return tuple(out)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same global tensor on every rank) as a DTensor laid out by
    ``sharding``: each rank keeps its own block, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole_rows(x):
    """``x`` with its last dim whole: a DTensor sharded on it (or holding
    partial sums) is redistributed, any other input passes unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if isinstance(p, Shard) and p.dim % x.ndim != x.ndim - 1
               else Replicate() for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


def local_rows(fn, x, *rest, n_out: int = 1):
    """``fn(x, *rest)`` for a row-wise ``fn`` (each output row reads only its
    input row along ``x``'s last dim, and the rows of ``rest``, which share
    ``x``'s leading dims).  On a DTensor ``x`` the rows are made whole
    first, ``rest`` takes their layout, and ``fn`` runs on each rank's
    block (``local_map``): the Hyft softmax's bit arithmetic and its
    kernels see plain tensors, and DTensor's strategies for ``fn``'s ops
    are not relied on.  ``fn`` returns a tensor, or ``n_out`` of them."""
    if not is_dtensor(x):
        return fn(x, *rest)
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    x = whole_rows(x)
    mesh, pl = x.device_mesh, x.placements
    rest = [r.redistribute(mesh, pl) if is_dtensor(r)
            else distribute_tensor(r, mesh, pl, src_data_rank=None) for r in rest]
    run = local_map(lambda *a: fn(*a) if n_out > 1 else (fn(*a),),
                    out_placements=(pl,) * n_out, in_placements=(pl,) * (1 + len(rest)),
                    device_mesh=mesh)
    out = run(x, *rest)
    return out if n_out > 1 else out[0]


# ---------------------------------------------------------------------------
# activation-sharding context (Megatron-style sequence parallelism lever)
# ---------------------------------------------------------------------------

_ACT_CTX: list = []


@contextlib.contextmanager
def activation_rules(mesh, rules):
    """While active, ``constrain_acts`` pins the residual stream's sharding
    (batch over DP axes; seq over ``model`` iff rules["seq"] says so)."""
    _ACT_CTX.append((mesh, rules))
    try:
        yield
    finally:
        _ACT_CTX.pop()


def constrain_acts(x):
    """Redistribute a 3-D DTensor residual (batch, seq, embed) to the
    context's layout where the shape divides; any other input, or no active
    context, passes unchanged."""
    if not _ACT_CTX or x.ndim != 3 or not is_dtensor(x):
        return x
    mesh, rules = _ACT_CTX[-1]
    spec = _divisible(spec_for_axes(("batch", "seq", "embed"), rules), x.shape, mesh)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements())


@contextlib.contextmanager
def mesh_compute(mesh, cfg):
    """The context of a sharded model call: plain tensors made inside the
    model (positions, masks) count as replicated, and the residual stream
    is pinned by ``default_rules(mesh, cfg)``'s activation rules."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), activation_rules(mesh, default_rules(mesh, cfg)):
        yield


def default_rules(mesh, cfg=None, fsdp: bool = False) -> dict[str, Any]:
    """The logical->mesh table for a mesh whose axes are a subset of
    ("pod", "data", "model")."""
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    msize = mesh_shape(mesh).get("model", 1)
    rules: dict[str, Any] = {
        "batch": dp if len(dp) > 1 else (dp[0] if dp else None),
        "seq": None,
        "embed": dp if fsdp else None,     # ZeRO-3 over the data axes
        "heads": model,
        "kv_heads": None,                  # GQA: kv heads rarely divide 16
        "head_dim": None,
        "mlp": model,
        "vocab": model,
        "experts": model,
        "experts_dim": None,
        "layers": None,
        None: None,
    }
    if cfg is not None:
        if cfg.n_heads and model and cfg.n_heads % msize:
            rules["heads"] = None
        if cfg.n_kv_heads and model and cfg.n_kv_heads % msize == 0:
            rules["kv_heads"] = model
        if cfg.n_experts and model and cfg.n_experts % msize:
            # few experts: shard experts over what divides, mlp picks up TP
            rules["experts"] = None
        if cfg.d_ff and model and cfg.d_ff % msize:
            rules["mlp"] = None
        if cfg.vocab and model and cfg.vocab % msize:
            rules["vocab"] = None
    return rules


def spec_for_axes(axes, rules) -> Spec:
    """Logical axes tuple -> Spec; one mesh axis appears at most once."""
    if axes is None:
        return Spec()
    entries = []
    used = set()
    for a in axes:
        r = rules.get(a, None)
        flat = tuple(r) if isinstance(r, tuple) else ((r,) if r else ())
        flat = tuple(x for x in flat if x not in used)
        used.update(flat)
        entries.append(flat if len(flat) > 1 else (flat[0] if flat else None))
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def _divisible(spec, shape, mesh) -> Spec:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    sizes = mesh_shape(mesh)
    entries = []
    for i, e in enumerate(spec):
        if e is None:
            entries.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        n = math.prod(sizes[a] for a in axes)
        entries.append(e if shape[i] % n == 0 else None)
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def param_shardings(mesh, params, axes, rules):
    """Param tree (tensors, meta ones too) + its logical-axes tree ->
    NamedSharding tree.  The stacked ``layers`` axis is found by rank
    mismatch and left unsharded."""
    def one(p, ax):
        if ax is None:
            return NamedSharding(mesh, Spec())
        shape = p.shape
        if len(ax) == len(shape) - 1:         # stacked layer axis
            ax = ("layers",) + tuple(ax)
        elif len(ax) == len(shape) - 2:       # nested stacking (hybrid groups)
            ax = ("layers", "layers") + tuple(ax)
        return NamedSharding(mesh, _divisible(spec_for_axes(ax, rules), shape, mesh))
    return tree_map(one, params, axes)


def batch_shardings(mesh, batch, rules):
    """Batch tree (tensors or shapes) -> NamedSharding with the batch dim
    over the DP axes."""
    bspec = spec_for_axes(("batch",), rules)

    def one(x):
        shape = tuple(getattr(x, "shape", x))
        spec = Spec(*tuple(bspec)[:1]) if len(shape) >= 1 else Spec()
        return NamedSharding(mesh, _divisible(spec, shape, mesh))
    return tree_map(one, batch)


def cache_shardings(mesh, cache, rules):
    """KV/state cache sharding for decode (a cache made on
    ``device="meta"`` will do).

    Attention KV caches (B, Hkv, S, D) [stacked (L, ...)]: batch over DP;
    the sequence axis over ``model`` (sequence parallelism, which
    ``sp_decode_attention`` consumes).  SSM states (B, H, P, N): heads over
    model.  Conv windows (B, K, C): channels over model.  Encoder memory
    (B, T, D): batch.  A leaf is told by the keys on its path, as in JAX.
    """
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    model = "model" if "model" in names else None

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys | {k}) for k, v in tree.items()}
        shape, r = tuple(tree.shape), tree.ndim
        if keys & {"k", "v"}:        # attention KV: (L,)B,Hkv,S,D: SP on seq
            spec = [None] * r
            spec[r - 4], spec[r - 2] = dp, model
        elif "ssm" in keys:          # SSD state: (L,)B,H,P,N: TP on heads
            spec = [None] * r
            spec[r - 4], spec[r - 3] = dp, model
        elif "conv" in keys:         # conv window: (L,)B,K,C: TP on channels
            spec = [None] * r
            spec[r - 3], spec[r - 1] = dp, model
        elif "memory" in keys:       # encoder memory: B,T,D
            spec = [dp] + [None] * (r - 1)
        else:
            spec = ([dp] + [None] * (r - 1)) if r else []
        return NamedSharding(mesh, _divisible(Spec(*spec), shape, mesh))
    return walk(cache, frozenset())
