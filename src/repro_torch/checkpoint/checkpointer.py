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
One device: ``restore`` places each leaf on the device of the tree it
restores into (the mesh and re-sharding come with ROADMAP queue 1,
distributed and the mesh).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

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
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, dtypes, arrays = [], [], {}
    for i, (kp, v) in enumerate(_leaf_paths(state)):
        arrays[f"a{i}"], name = _to_numpy(v)
        dtypes.append(name)
        names.append(kp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "leaf_paths": names, "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


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


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes ``like``'s leaf's dtype and device.  Returns (tree, step)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    index = {kp: i for i, kp in enumerate(manifest["leaf_paths"])}

    def leaf(data, kp, want_like):
        i = index[kp]
        arr = data[f"a{i}"]
        if arr.dtype.kind == "V":   # written by numpy with ml_dtypes' types: raw bytes
            arr = arr.view(f"u{arr.dtype.itemsize}")
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == "bfloat16":   # stored as its bits
            t = t.view(torch.int16).view(torch.bfloat16)
        return t.to(device=want_like.device, dtype=want_like.dtype)

    def build(data, tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(data, tree[k], f"{prefix}[{k!r}]") for k in tree}
        return leaf(data, prefix, tree)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return build(data, like), manifest["step"]
