"""Public wrappers around the split-K kernels + the attention mask contract.

The PyTorch counterpart of ``repro.kernels.ops`` for the entries this slice
ports.  ``kv_len_mask``: optional (B, Sk) KV validity mask, bool or float,
nonzero = valid; ``kv_pos_mask``: (B, Sq, Lk) per-token frontier for chunk
attention.  Masking happens on the float scores before FP2FX, so invalid
positions saturate to the fixed-point minimum.  ``as_mask_f`` normalizes a
mask to float32 once, at the dispatch boundary.

The fused flash attention (training, ``hyft_attention``), the paged decode
and the standalone softmax kernels come with later slices (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.hyft import HyftConfig
from repro_torch.kernels.flash_attention import flash_hyft_decode, flash_hyft_verify

F32 = torch.float32


def as_mask_f(kv_len_mask) -> torch.Tensor | None:
    """Normalize a KV validity mask (bool/int/float or None) to float32."""
    if kv_len_mask is None:
        return None
    return kv_len_mask.to(F32)


def hyft_decode_attention(q, k, v, cfg: HyftConfig, sm_scale=None,
                          block_k=256, kv_len_mask=None, k_scale=None,
                          v_scale=None):
    """Split-K fused decode attention (Sq = 1) with Hyft softmax: the
    serving fast path.  int8 ``k``/``v`` with ``k_scale``/``v_scale`` (the
    fp2fx8 cache) are dequantized inside the kernel's K/V loads."""
    return flash_hyft_decode(q, k, v, cfg, sm_scale=sm_scale, block_k=block_k,
                             kv_len_mask=as_mask_f(kv_len_mask),
                             k_scale=k_scale, v_scale=v_scale)


def hyft_verify_attention(q, k, v, kv_pos_mask, cfg: HyftConfig,
                          sm_scale=None, block_k=256, block_tables=None,
                          k_scale=None, v_scale=None):
    """Split-K fused chunk attention (Sq = token chunk) with Hyft softmax:
    the prompt path.  At Sq == 1 this is bitwise the decode kernel."""
    return flash_hyft_verify(q, k, v, as_mask_f(kv_pos_mask), cfg,
                             sm_scale=sm_scale, block_k=block_k,
                             block_tables=block_tables,
                             k_scale=k_scale, v_scale=v_scale)
