"""Hyft softmax, forward and backward — the PyTorch counterpart of
``repro.core.hyft``.

The emulation follows the hardware blocks exactly (DESIGN.md §1-2):

  pre-processor  : strided max (STEP) + FP2FX @ ``frac_bits`` (Precision)
  exponent unit  : shift-add z*log2e -> split u,v -> 2**(u-1)(1+(1+v)) fields
  adder tree     : FP2FX @ ``acc_bits`` -> exact accumulate -> LOD refloat
  div/mul unit   : log-subtract divide; log-domain multiply for backward

The forward goes through integer raws, so autograd cannot differentiate it;
``hyft_softmax`` is a ``torch.autograd.Function`` whose backward is the
accelerator's own (``cfg.grad="hyft"``) or the exact softmax VJP.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import numerics as nm

F32 = torch.float32

_DTYPES = {"float16": torch.float16, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class HyftConfig:
    """Reconfigurable parameters of the accelerator (paper §3.1/§3.3).

    Attributes:
      io_dtype:   input/output format ("float16" = Hyft16, "float32" = Hyft32,
                  "bfloat16" = Hyft16b).
      total_bits: width W of the fixed-point input format (pre-processor).
      frac_bits:  the ``Precision`` parameter -- fractional bits of the
                  fixed-point input format.
      mant_bits:  mantissa bits carried by the intermediate float fields.
      acc_bits:   fractional bits of the hybrid adder tree (values in (0,1]).
      step:       STEP parameter of the strided max search (1 = exact max).
      grad:       "hyft" = backward via the reused div/mul unit (paper §3.5);
                  "exact" = exact softmax VJP (ablation).
      bwd_acc_bits: adder-tree precision for the backward dot product.
    """

    io_dtype: str = "float32"
    total_bits: int = 24
    frac_bits: int = 16
    mant_bits: int = 16
    acc_bits: int = 20
    step: int = 1
    grad: Literal["hyft", "exact"] = "hyft"
    bwd_acc_bits: int = 16

    def __post_init__(self):
        assert self.frac_bits < self.total_bits <= 31
        assert self.mant_bits <= self.frac_bits, "mantissa derives from v's frac bits"
        assert self.acc_bits <= 22, "adder tree addends must stay exact in fp32"
        assert self.step >= 1

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.io_dtype]


# Hyft16 / Hyft32 presets from the paper's two evaluated configurations.
HYFT16 = HyftConfig(io_dtype="float16", total_bits=16, frac_bits=10,
                    mant_bits=10, acc_bits=14, bwd_acc_bits=12)
HYFT32 = HyftConfig(io_dtype="float32", total_bits=24, frac_bits=16,
                    mant_bits=16, acc_bits=20, bwd_acc_bits=16)
# bf16 I/O keeps the wide exponent; same internal path.
HYFT16B = dataclasses.replace(HYFT16, io_dtype="bfloat16")


def strided_max(z_raw: torch.Tensor, step: int) -> torch.Tensor:
    """Approximate max search over every ``step``-th element (paper §3.1)."""
    if step > 1:
        z_raw = z_raw[..., ::step]
    return torch.amax(z_raw, dim=-1, keepdim=True)


def hyft_exp_fields(z: torch.Tensor, cfg: HyftConfig):
    """Pre-processor + exponent unit: float z -> (e, m) fields of exp(z-zmax)."""
    z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
    d = z_raw - strided_max(z_raw, cfg.step)
    return nm.exp_unit(d, cfg.frac_bits, cfg.mant_bits)


def hyft_softmax_fwd(z: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    """Forward Hyft softmax along the last axis, in ``cfg.dtype``."""
    e, m = hyft_exp_fields(z.to(F32), cfg)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    denom = torch.sum(addend, dim=-1, keepdim=True)
    e_b, m_b = nm.lod_refloat(denom, cfg.mant_bits)
    return nm.log_div(e, m, e_b, m_b, cfg.mant_bits).to(cfg.dtype)


def hyft_softmax_bwd(s: torch.Tensor, dy: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    """dz = s * (dy - <dy, s>) with Hyft's approximate arithmetic.

    Each product runs through the log-domain multiplier with the half-range
    mantissa (Eq. 10); the dot product reuses the (signed) fixed-point adder
    tree; the final elementwise product reuses the multiplier again.
    """
    s32, dy32 = s.to(F32), dy.to(F32)
    prods = nm.log_mul(dy32, s32, cfg.mant_bits, half_range=True)
    prods_q = nm.fx_quantize(prods, cfg.bwd_acc_bits)
    dot = torch.sum(prods_q, dim=-1, keepdim=True)
    diff = nm.fx_quantize(dy32, cfg.bwd_acc_bits) - dot  # exact fx subtract
    dz = nm.log_mul(diff, s32, cfg.mant_bits, half_range=True)
    return dz.to(cfg.dtype)


class _HyftSoftmax(torch.autograd.Function):
    """Forward ``hyft_softmax_fwd``; backward per ``cfg.grad``, returned in
    the input's dtype (``repro.core.hyft``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, z, cfg):
        s = hyft_softmax_fwd(z, cfg)
        ctx.save_for_backward(s)
        ctx.cfg, ctx.z_dtype = cfg, z.dtype
        return s

    @staticmethod
    def backward(ctx, dy):
        (s,) = ctx.saved_tensors
        cfg = ctx.cfg
        if cfg.grad == "exact":
            s32, dy32 = s.to(F32), dy.to(F32)
            dz = s32 * (dy32 - torch.sum(dy32 * s32, dim=-1, keepdim=True))
        else:
            dz = hyft_softmax_bwd(s, dy, cfg)
        return dz.to(ctx.z_dtype), None


def hyft_softmax(z: torch.Tensor, cfg: HyftConfig = HYFT32) -> torch.Tensor:
    """Hyft softmax over the last axis, differentiable.

    The VJP is the accelerator's own backward path when ``cfg.grad="hyft"``
    (the paper's training mode), or the exact softmax VJP for ablations.
    """
    return _HyftSoftmax.apply(z, cfg)


def hyft_jacobian(s: torch.Tensor, cfg: HyftConfig = HYFT32) -> torch.Tensor:
    """Full Jacobian  ds/dz = diag(s) - s s^T  (paper Eq. 5), via log_mul.

    The paper-faithful N x N backward block; the VJP above is the
    matrix-free form used in training.
    """
    s32 = s.to(F32)
    outer = nm.log_mul(s32[..., :, None], s32[..., None, :], cfg.mant_bits)
    diag = torch.eye(s.shape[-1], dtype=F32, device=s.device) * s32[..., None, :]
    return (diag - outer).to(cfg.dtype)
