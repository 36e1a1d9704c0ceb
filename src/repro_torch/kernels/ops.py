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

``hyft_softmax`` is differentiable: its forward is the standalone softmax
kernel and its backward the backward kernel (the accelerator's reused
DIV/MUL datapath), whatever ``cfg.grad`` says, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.hyft import HyftConfig
from repro_torch.kernels.flash_attention import (
    flash_hyft_attention, flash_hyft_decode, flash_hyft_decode_paged,
    flash_hyft_verify)
from repro_torch.kernels.hyft_softmax import (hyft_softmax_bwd_kernel,
                                              hyft_softmax_fwd_kernel)

F32 = torch.float32


def as_mask_f(kv_len_mask) -> torch.Tensor | None:
    """Normalize a KV validity mask (bool/int/float or None) to float32."""
    if kv_len_mask is None:
        return None
    return kv_len_mask.to(F32)


class _HyftSoftmaxKernel(torch.autograd.Function):
    """Forward: the softmax kernel, output in ``cfg.dtype``.  Backward: the
    backward kernel, rounded to ``cfg.dtype`` and returned in the input's
    dtype (JAX's ``dt_marker``): the kernel stores it so where that is
    ``cfg.dtype`` or float32 (the unfused attention's fp32 scores), and a
    cast follows only for another input dtype."""

    @staticmethod
    def forward(ctx, z, cfg):
        s = hyft_softmax_fwd_kernel(z, cfg)
        ctx.save_for_backward(s)
        ctx.cfg, ctx.z_dtype = cfg, z.dtype
        return s

    @staticmethod
    def backward(ctx, dy):
        (s,) = ctx.saved_tensors
        cfg, z_dtype = ctx.cfg, ctx.z_dtype
        out = z_dtype if z_dtype in (cfg.dtype, F32) else cfg.dtype
        return hyft_softmax_bwd_kernel(s, dy, cfg, out_dtype=out).to(z_dtype), None


def hyft_softmax(z: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    """Hyft softmax over the last axis through the standalone kernels,
    differentiable: the registry's ``hyft*_kernel`` entries."""
    return _HyftSoftmaxKernel.apply(z, cfg)


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


def hyft_paged_decode_attention(q, k_pages, v_pages, block_tables,
                                cfg: HyftConfig, sm_scale=None,
                                kv_len_mask=None, k_scale=None, v_scale=None):
    """Split-K fused decode attention over a paged KV pool (Sq = 1): each
    page is one split, read through the block table on the device; bitwise
    the contiguous decode at ``block_k == page_size`` when the pages are
    laid out in order.  int8 pages with ``k_scale``/``v_scale`` pools (the
    fp2fx8 page layout) are dequantized in the page loads."""
    return flash_hyft_decode_paged(q, k_pages, v_pages, block_tables, cfg,
                                   sm_scale=sm_scale,
                                   kv_len_mask=as_mask_f(kv_len_mask),
                                   k_scale=k_scale, v_scale=v_scale)


def hyft_verify_attention(q, k, v, kv_pos_mask, cfg: HyftConfig,
                          sm_scale=None, block_k=256, block_tables=None,
                          k_scale=None, v_scale=None):
    """Split-K fused chunk attention (Sq = token chunk) with Hyft softmax:
    the prompt path.  ``block_tables`` (B, nb) switches K/V to the paged
    pool (pages as splits).  At Sq == 1 this is bitwise the decode kernel
    of the same layout."""
    return flash_hyft_verify(q, k, v, as_mask_f(kv_pos_mask), cfg,
                             sm_scale=sm_scale, block_k=block_k,
                             block_tables=block_tables,
                             k_scale=k_scale, v_scale=v_scale)
