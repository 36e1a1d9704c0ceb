"""The dry-run's two meters: live device bytes and their peak, and the
collectives a step issues.

Both are ``TorchDispatchMode``s that read only shapes, dtypes and storage
identities, so they run unchanged on fake tensors (the dry-run's trace)
and on real ones (``chip_smoke.py`` holds a fake count against the card's
real one).  An op on DTensors is left to DTensor: the meters see the
per-rank ops it runs on the local blocks and the collectives it issues, so
every count is one rank's.

``MemoryMeter``: each storage an op makes is live from its first output
until the storage is freed (``weakref.finalize`` on it); storages that
exist before the metered call are declared with ``hold`` under a category.
The peak is the largest sum of live bytes, with its split by category:

  params, opt_state, inputs, cache   declared with ``hold`` (the state, the
                                     batch, the serving cache)
  activations   made while the forward pass records for autograd
  gradients     made by the backward pass (the gradients, its own
                temporaries, and what remat recomputes)
  temporaries   made elsewhere (the optimizer update, clipping, any call
                under no_grad: a serving step's intermediates)

A byte is counted by its storage's size, as the caching allocator holds a
block a storage (its 512-byte rounding aside); what the allocator keeps
cached and the libraries' workspaces are not storages and are not seen.

``CollectiveMeter``: per kind (the functional collective's name:
``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ...), the calls and their operand bytes on this
rank, the JAX dry-run's convention (the operand of each all-reduce,
all-gather, reduce-scatter, all-to-all or permute).  A real CPU mesh
replaces DTensor's all-to-all by an all-gather and a chunk (gloo has
none); the dry-run's trace issues the card's ``shard_dim_alltoall`` on
either device.
"""
from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

CATEGORIES = ("params", "opt_state", "inputs", "cache", "activations", "gradients",
              "temporaries")


def _tensors(tree):
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DTensor):
            yield leaf._local_tensor
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _phase() -> str:
    """The category of a storage made now: by the backward pass, by a
    forward pass that autograd records, or elsewhere."""
    if torch._C._current_graph_task_id() != -1:
        return "gradients"
    return "activations" if torch.is_grad_enabled() else "temporaries"


class MemoryMeter(TorchDispatchMode):
    """Live storage bytes by category and their peak (see the module)."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}                  # storage id -> (bytes, category)
        self.by_cat = dict.fromkeys(CATEGORIES, 0)
        self.total = 0
        self.peak = 0
        self.peak_by_cat = dict(self.by_cat)

    def hold(self, tree, category: str) -> None:
        """Declare the storages of ``tree`` (made before the metered call)
        as live under ``category``."""
        for t in _tensors(tree):
            self._track(t.untyped_storage(), category)

    def _track(self, st, category) -> None:
        key, n = st._cdata, st.nbytes()
        if key in self.live or not n:
            return
        self.live[key] = (n, category)
        self.by_cat[category] += n
        self.total += n
        weakref.finalize(st, self._free, key)
        if self.total > self.peak:
            self.peak = self.total
            self.peak_by_cat = dict(self.by_cat)

    def _free(self, key) -> None:
        n, category = self.live.pop(key)
        self.by_cat[category] -= n
        self.total -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        phase = None
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in self.live:
                phase = phase or _phase()
                self._track(st, phase)
        return out


# the functional collectives DTensor issues (and the c10d ones a process
# group call makes), by the name of their op; their first tensor argument
# is the operand
_COLLECTIVES = {"all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
                "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
                "reduce_scatter_tensor_coalesced", "all_to_all_single", "broadcast",
                "shard_dim_alltoall", "allreduce_", "allgather_", "_allgather_base_",
                "reduce_scatter_", "_reduce_scatter_base_", "alltoall_base_",
                "broadcast_"}
_NAMESPACES = {"_c10d_functional", "c10d_functional", "c10d", "_dtensor"}


class CollectiveMeter(TorchDispatchMode):
    """Calls and per-rank operand bytes of each collective, by kind."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        name = packet.__name__
        if packet._qualified_op_name.split("::")[0] in _NAMESPACES and name in _COLLECTIVES:
            operand = sum(t.numel() * t.element_size()
                          for t in _tensors(args[0] if args else ()))
            c = self.counts.setdefault(name, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += operand
        return func(*args, **(kwargs or {}))

    def bytes_by_kind(self) -> dict:
        return {k: v["bytes"] for k, v in self.counts.items()}
