"""Atomic, restart-safe checkpointing (numpy .npz + JSON manifest).

Own copy of ``repro.checkpoint.checkpointer``, with its guarantees and its
on-disk layout, so that a checkpoint written by either package restores in
the other:
  * atomic publish: write ``step_<n>.tmp/``, then ``os.rename`` it (atomic
    within a POSIX filesystem), so a crash never leaves a half checkpoint,
    and ``.tmp`` debris is never listed;
  * ``arrays.npz`` holds the leaves as ``a0..aN`` (bf16 as ``uint16`` bits)
    and ``manifest.json`` the step, each leaf's path in JAX's ``keystr``
    form (``"['params']['blocks']['attn']['wq']"``) and its dtype name;
    leaves go in sorted-key order, the order in which JAX flattens a dict;
  * keep-k garbage collection;
  * ``latest_step`` / ``restore`` for the restart manager
    (``repro_torch.distributed.fault_tolerance``).
Under a mesh the files hold the global arrays, in the same layout: ``save``
gathers each DTensor leaf whole on every rank (a collective, so every rank
calls it), rank 0 alone copies it to the host and writes, and a barrier
follows.  ``restore`` places each
leaf by ``shardings`` (or as the DTensor leaf of ``like``), so a checkpoint
saved on one mesh reloads on another: that is elastic resizing.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd

MANIFEST = "manifest.json"


def _leaf_paths(tree, prefix: str = "") -> list:
    """(keystr path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:   # numpy has no bf16: its bits as uint16
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write ``state`` as step ``step``; under a process group every rank
    calls it and rank 0 writes.  Returns the checkpoint's directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    writer = not grouped or dist.get_rank() == 0
    names, dtypes, arrays = [], [], {}
    for i, (kp, v) in enumerate(_leaf_paths(state)):
        if shd.is_dtensor(v):
            v = v.full_tensor()      # a collective: every rank gathers
        if writer:                   # only the writer keeps a host copy
            arrays[f"a{i}"], name = _to_numpy(v)
            dtypes.append(name)
            names.append(kp)
    if writer:
        _publish(ckpt_dir, final, step, names, dtypes, arrays, keep)
    if grouped:
        dist.barrier()
    return final


def _publish(ckpt_dir, final, step, names, dtypes, arrays, keep):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "leaf_paths": names, "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors, meta ones
    too): each leaf takes ``like``'s leaf's dtype and device, and is placed
    by the matching leaf of ``shardings`` (NamedSharding) where given, else
    as ``like``'s leaf where that is a DTensor.  Returns (tree, step)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    index = {kp: i for i, kp in enumerate(manifest["leaf_paths"])}

    def leaf(data, kp, want_like, sh):
        i = index[kp]
        arr = data[f"a{i}"]
        if arr.dtype.kind == "V":   # written by numpy with ml_dtypes' types: raw bytes
            arr = arr.view(f"u{arr.dtype.itemsize}")
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == "bfloat16":   # stored as its bits
            t = t.view(torch.int16).view(torch.bfloat16)
        if sh is not None:
            mesh, placements = sh.mesh, sh.placements()
        elif shd.is_dtensor(want_like):
            mesh, placements = want_like.device_mesh, want_like.placements
        else:
            return t.to(device=want_like.device, dtype=want_like.dtype)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.to(device=mesh.device_type, dtype=want_like.dtype),
                                 mesh, placements, src_data_rank=None)

    def build(data, tree, shs, prefix=""):
        if isinstance(tree, dict):
            return {k: build(data, tree[k], None if shs is None else shs[k],
                             f"{prefix}[{k!r}]") for k in tree}
        return leaf(data, prefix, tree, shs)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return build(data, like, shardings), manifest["step"]
