"""Public wrappers around the attention kernels + the attention mask contract.

The PyTorch counterpart of ``repro.kernels.ops`` for the entries ported so
far.  ``kv_len_mask``: optional (B, Sk) KV validity mask, bool or float,
nonzero = valid; ``kv_pos_mask``: (B, Sq, Lk) per-token frontier for chunk
attention.  Masking happens on the float scores before FP2FX, so invalid
positions saturate to the fixed-point minimum.  ``as_mask_f`` normalizes a
mask to float32 once, at the dispatch boundary, so the differentiable paths
see a float side input.  Every online mode carries per-row ``(m, l)`` stats
— the int32 fixed-point running max and the fp32 fixed-point sum — and the
fused kernel saves exactly these for its backward.

The paged decode and the standalone softmax kernels come with later slices
(ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.hyft import HyftConfig
from repro_torch.kernels.flash_attention import (
    flash_hyft_attention, flash_hyft_decode, flash_hyft_verify)

F32 = torch.float32


def as_mask_f(kv_len_mask) -> torch.Tensor | None:
    """Normalize a KV validity mask (bool/int/float or None) to float32."""
    if kv_len_mask is None:
        return None
    return kv_len_mask.to(F32)


def hyft_attention(q, k, v, cfg: HyftConfig, sm_scale=None, causal=True,
                   block_q=128, block_k=128, kv_len_mask=None, q_offset=0,
                   return_stats=False):
    """Fused flash attention with Hyft softmax — trainable and mask-aware:
    the ``attn_mode="kernel"`` path for training and whole-sequence
    forwards (differentiable through the two backward kernels)."""
    return flash_hyft_attention(q, k, v, cfg, sm_scale=sm_scale, causal=causal,
                                block_q=block_q, block_k=block_k,
                                return_stats=return_stats,
                                kv_len_mask=as_mask_f(kv_len_mask),
                                q_offset=q_offset)


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
