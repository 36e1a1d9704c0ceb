"""Standalone Hyft softmax kernels, forward and backward.

The PyTorch counterpart of ``repro.kernels.hyft_softmax``:

* ``hyft_softmax_fwd_kernel`` replaces ``_fwd_kernel`` (the TPU kernel at
  ``repro/kernels/hyft_softmax.py:28``, ``pallas_call`` at ``:82``);
* ``hyft_softmax_bwd_kernel`` replaces ``_bwd_kernel`` (``:44``,
  ``pallas_call`` at ``:110``).

Each wrapper picks by the tensor's device and nothing else: a CPU tensor
runs the plain version, which is the core's ``hyft_softmax_fwd`` /
``hyft_softmax_bwd`` (the oracles that JAX's ``ref.py`` names for these
kernels); a CUDA tensor launches ``csrc/hyft_softmax.cu`` or raises; any
other device raises.  The output is in ``cfg.dtype``; the backward's may be
stored as fp32 instead (``out_dtype``: the ``cfg.dtype`` values, widened
exactly, which the kernel writes in one launch).  ``block_rows``, the TPU
kernel's tile of rows in VMEM, is checked and then ignored: the kernels
give every row its own warp (a launch of many rows of at most 1280
columns) or its own block of threads.

When kernel and plain version agree bit for bit.  Both compute the same
integer and fp32 steps; only the adder trees' sums differ in how they are
taken.  The plain version adds fp32 multiples of ``2**-acc_bits``
(forward) or ``2**-bwd_acc_bits`` (backward) in a library's order; the
kernel adds their integer counts exactly and rounds the total once.  While
a row's addends' magnitudes sum to at most ``EXACT_UNITS`` (2**24) counts,
every partial sum is exact in fp32, so both give the same bits
(``fwd_sum_units`` / ``bwd_sum_units`` measure this per row).  Under
HYFT16 a row of up to 1024 keys always qualifies (each addend is at most
2**14 counts); under HYFT32 only a sum up to 16 does.

Past that, the forward's sums differ by the plain version's rounding, a
relative error far below ``2**-mant_bits`` at these widths: the divisor's
truncated mantissa ``m_b`` moves by at most one raw (a move across a
truncation boundary), so an output moves by at most ``2**-mant_bits`` of
itself, plus one rounding of the output type and, at the very bottom of
the range, a flush to zero on one side (``softmax_errors`` holds each
element to that).
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics as nm
from repro_torch.core.hyft import (HyftConfig, hyft_exp_fields, hyft_softmax_bwd,
                                   hyft_softmax_fwd)
from repro_torch.kernels.flash_attention import _hyft_args, _launch, _ptr

F32 = torch.float32
I64 = torch.int64
EXACT_UNITS = 2 ** 24

# launches of each CUDA entry point; a plain count that callers reset and
# read to show which kernels a run went through
LAUNCHES = {"hyft_softmax_fwd": 0, "hyft_softmax_bwd": 0}

_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# per output type: its mantissa bits, and the magnitude below which an
# output may be 0 on one side only: the divide's field assembly flushes
# below 2**-125 (pow2_float), and fp16 rounds away everything below 2**-24
_OUT_ULP = {torch.float32: (23, 2.0 ** -125), torch.float16: (10, 2.0 ** -24),
            torch.bfloat16: (7, 2.0 ** -125)}


def _check_rows(x: torch.Tensor, name: str):
    if x.dtype not in _TYPES:
        raise ValueError(f"{name} dtype {x.dtype} not one of {list(_TYPES)}")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name} needs a last axis of at least 1, got {tuple(x.shape)}")


def _check_block_rows(block_rows):
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows={block_rows} must be at least 1")


def hyft_softmax_fwd_kernel(z: torch.Tensor, cfg: HyftConfig,
                            block_rows: int | None = None) -> torch.Tensor:
    """Hyft softmax over the last axis of ``z`` (..., cols), in ``cfg.dtype``."""
    _check_rows(z, "z")
    _check_block_rows(block_rows)
    if z.device.type == "cpu":
        return hyft_softmax_fwd(z, cfg)
    if z.device.type == "cuda":
        return _fwd_cuda(z, cfg)
    raise ValueError(f"no Hyft softmax kernel for device {z.device}")


def hyft_softmax_bwd_kernel(s: torch.Tensor, dy: torch.Tensor, cfg: HyftConfig,
                            block_rows: int | None = None,
                            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The Hyft softmax VJP ``dz = s * (dy - <dy, s>)`` in Hyft arithmetic,
    over the last axis of ``s`` and ``dy`` (the same shape), rounded to
    ``cfg.dtype`` and returned in ``out_dtype``: ``cfg.dtype`` (the default)
    or float32, which holds those values exactly."""
    out_dtype = cfg.dtype if out_dtype is None else out_dtype
    if out_dtype not in (cfg.dtype, F32):
        raise ValueError(f"out_dtype {out_dtype} is neither cfg.dtype ({cfg.dtype}) "
                         "nor torch.float32")
    _check_rows(s, "s")
    _check_rows(dy, "dy")
    if s.shape != dy.shape:
        raise ValueError(f"s {tuple(s.shape)} and dy {tuple(dy.shape)} differ in shape")
    if s.device != dy.device:
        raise ValueError(f"s on {s.device} and dy on {dy.device}")
    _check_block_rows(block_rows)
    if s.device.type == "cpu":
        return hyft_softmax_bwd(s, dy, cfg).to(out_dtype)
    if s.device.type == "cuda":
        return _bwd_cuda(s, dy, cfg, out_dtype)
    raise ValueError(f"no Hyft softmax kernel for device {s.device}")


def _fwd_cuda(z, cfg: HyftConfig):
    cols = z.shape[-1]
    z = z.contiguous()
    out = torch.empty(z.shape, dtype=cfg.dtype, device=z.device)
    rows = z.numel() // cols
    if rows:
        _launch("hyft_softmax_fwd", z.device, _ptr(z), _ptr(out), _TYPES[z.dtype],
                _TYPES[cfg.dtype], rows, cols, *_hyft_args(cfg), counts=LAUNCHES)
    return out


def _bwd_cuda(s, dy, cfg: HyftConfig, out_dtype: torch.dtype):
    if s.dtype != dy.dtype:   # the kernel reads one type; fp32 holds both exactly
        s, dy = s.to(F32), dy.to(F32)
    cols = s.shape[-1]
    s, dy = s.contiguous(), dy.contiguous()
    dz = torch.empty(s.shape, dtype=out_dtype, device=s.device)
    rows = s.numel() // cols
    if rows:
        _launch("hyft_softmax_bwd", s.device, _ptr(s), _ptr(dy), _ptr(dz),
                _TYPES[s.dtype], _TYPES[cfg.dtype], _TYPES[out_dtype], rows, cols,
                cfg.mant_bits, cfg.bwd_acc_bits, counts=LAUNCHES)
    return dz


# --------------------------------------------------------------------------
# the sum precondition and the bound past it (plain torch, any device)
# --------------------------------------------------------------------------


def fwd_sum_units(z: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    """Per row of ``z``, the forward adder tree's exact sum in counts of
    ``2**-acc_bits`` (int64, shape ``z.shape[:-1]``)."""
    e, m = hyft_exp_fields(z.to(F32), cfg)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    return (addend * 2.0 ** cfg.acc_bits).to(I64).sum(-1)


def bwd_sum_units(s: torch.Tensor, dy: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    """Per row, the sum of the backward dot's addend magnitudes in counts of
    ``2**-bwd_acc_bits`` (int64, shape ``s.shape[:-1]``)."""
    prods = nm.log_mul(dy.to(F32), s.to(F32), cfg.mant_bits, half_range=True)
    q = nm.fx_quantize(prods, cfg.bwd_acc_bits) * 2.0 ** cfg.bwd_acc_bits
    return q.to(I64).abs().sum(-1)


def softmax_errors(got: torch.Tensor, ref: torch.Tensor, units: torch.Tensor,
                   cfg: HyftConfig) -> dict:
    """Kernel output ``got`` against the plain version's ``ref`` (same
    shape and type), split by rows on ``units`` (``fwd_sum_units`` or
    ``bwd_sum_units`` of the inputs): ``mismatches`` counts the elements
    whose bits differ in the rows within the precondition, which must be 0;
    ``past_ratio`` is the worst |diff| over its bound in the other rows,
    ``2**-mant_bits * a + 2**-p * a + sub`` with ``a`` the larger magnitude,
    ``p`` the output type's mantissa bits and ``sub`` its flush threshold
    (forward only), which must be <= 1."""
    cols = got.shape[-1]
    g, r = got.reshape(-1, cols), ref.reshape(-1, cols)
    exact = (units.reshape(-1) <= EXACT_UNITS).to(g.device)
    bits = torch.int32 if got.dtype == F32 else torch.int16
    same = g.contiguous().view(bits) == r.contiguous().view(bits)
    g32, r32 = g.to(F32), r.to(F32)
    diff = (g32 - r32).abs()
    p, sub = _OUT_ULP[got.dtype]
    a = torch.maximum(g32.abs(), r32.abs())
    ratio = diff / ((2.0 ** -cfg.mant_bits + 2.0 ** -p) * a + sub)
    past = ratio[~exact]
    return {"rows": int(exact.numel()), "rows_past_precondition": int((~exact).sum()),
            "mismatches": int((~same[exact]).sum()),
            "past_ratio": float(past.max()) if past.numel() else 0.0,
            "max_abs_err": float(diff.max())}
