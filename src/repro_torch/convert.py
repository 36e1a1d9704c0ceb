"""The weights bridge: numpy trees from the JAX package <-> the port's tensors.

The JAX package's ``unbox(model.init(key))`` tree, mapped to numpy
(``jax.tree.map(np.asarray, tree)``), has the same nested keys and shapes as
the port's parameter tree, with the leading layer axis under ``"blocks"``
(encdec: ``"enc_blocks"`` and ``"dec_blocks"``; encdec and the VLM also
``"frontend_proj"``); the cache (``{"blocks": ...}``, the hybrid's
``"shared_attn"``, encdec's ``{"self": ..., "memory": ...}``) likewise.  So
the bridge is a key-for-key copy.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# leaves the JAX package keeps in fp32 whatever the parameters' dtype (its
# ``Param``s): the MoE router and the Mamba2 block's constants
FP32_LEAVES = ("router", "A_log", "D", "dt_bias")


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """numpy param tree -> tensors on ``device``; ``dtype`` recasts the
    floating-point leaves but those of ``FP32_LEAVES``."""
    def conv(t, name):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        t = torch.from_numpy(np.array(t, copy=True))
        if dtype is not None and t.is_floating_point() and name not in FP32_LEAVES:
            t = t.to(dtype)
        return t.to(device)
    return conv(tree, None)


def cache_from_numpy(tree, device):
    return _map(tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(device))


def cache_to_numpy(tree):
    return _map(tree, lambda t: t.detach().cpu().numpy())
