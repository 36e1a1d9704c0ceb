"""The weights bridge: numpy trees from the JAX package <-> the port's tensors.

The JAX package's ``unbox(model.init(key))`` tree, mapped to numpy
(``jax.tree.map(np.asarray, tree)``), has the same nested keys and shapes as
the port's parameter tree, with the leading layer axis under ``"blocks"``;
the cache (``{"blocks": {"k", "v"[, "k_scale", "v_scale"]}}``) likewise.
So the bridge is a key-for-key copy.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """numpy param tree -> tensors on ``device``; ``dtype`` recasts the
    floating-point leaves."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return _map(tree, leaf)


def cache_from_numpy(tree, device):
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(device))


def cache_to_numpy(tree):
    return _map(tree, lambda t: t.detach().cpu().numpy())
