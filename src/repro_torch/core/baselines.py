"""Baseline softmax implementations the paper compares against (Table 1/3).

The PyTorch counterpart of ``repro.core.baselines``.  Each baseline is
emulated at the same bit-level fidelity as Hyft:

  exact      -- torch.softmax (fp32), the "Original" row.
  base2      -- [29] Zhang et al., TCAS-I'22: replaces e^x by 2^x entirely
                (changes the *function* -- needs fine-tuning, large drop).
  koca       -- [13] Koca et al., ISCAS'23: same 2^u(1+v/2) exponent path as
                Hyft, but the divisor is rounded to a power of two so the
                division becomes a pure shift.
  lut8       -- [23] Vasyltsov & Chang: 8-bit fixed-point LUT exp + LUT
                reciprocal.
  softermax  -- [20] Stevens et al.: base-2 with online (running) max and
                low-precision accumulation.

``base2``, ``koca`` and ``softermax`` are integer pipelines and agree with
the JAX package bit for bit; ``exact`` and ``lut8`` go through ``exp``,
``log2`` and ``exp2``, where the two libraries may differ by an ulp.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import numerics as nm
from repro_torch.core.hyft import HYFT32, HyftConfig

F32 = torch.float32
I32 = torch.int32


def exact_softmax(z: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(z.to(F32), dim=axis).to(z.dtype)


def _fixed_exp2_fields(z, cfg: HyftConfig, use_log2e: bool):
    """Shared pre-processor + exponent path; base-2 variants skip Booth."""
    z_raw = nm.fp2fx(z.to(F32), cfg.frac_bits, cfg.total_bits)
    d = z_raw - torch.amax(z_raw, dim=-1, keepdim=True)
    if use_log2e:
        return nm.exp_unit(d, cfg.frac_bits, cfg.mant_bits)
    # 2^d directly: same split/Taylor machinery on t = d
    F = cfg.frac_bits
    t = torch.clamp(d, max=0)
    u = -((-t) >> F)
    v_raw = t - (u << F)
    e = u - 1
    m_raw = (1 << F) + v_raw
    ovf = m_raw == (1 << F)
    e = torch.where(ovf, e + 1, e)
    m_raw = torch.where(ovf, torch.zeros_like(m_raw), m_raw)
    if cfg.mant_bits < F:
        m_raw = (m_raw >> (F - cfg.mant_bits)) << (F - cfg.mant_bits)
    return e.to(I32), nm._rescale(m_raw, F, cfg.mant_bits).to(I32)


def base2_softmax(z: torch.Tensor, cfg: HyftConfig = HYFT32) -> torch.Tensor:
    """[29]: s_i = 2^(z_i - zmax) / sum_j 2^(z_j - zmax)."""
    e, m = _fixed_exp2_fields(z, cfg, use_log2e=False)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    denom = torch.sum(addend, dim=-1, keepdim=True)
    e_b, m_b = nm.lod_refloat(denom, cfg.mant_bits)
    return nm.log_div(e, m, e_b, m_b, cfg.mant_bits).to(z.dtype)


def koca_softmax(z: torch.Tensor, cfg: HyftConfig = HYFT32) -> torch.Tensor:
    """[13]: Hyft-style exponent, divisor rounded to a power of two (shift div)."""
    e, m = _fixed_exp2_fields(z, cfg, use_log2e=True)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    denom = torch.sum(addend, dim=-1, keepdim=True)
    e_b, m_b = nm.lod_refloat(denom, cfg.mant_bits)
    # round divisor to power of 2: mantissa >= 0.5 rounds the exponent up
    e_b = torch.where(m_b >= (1 << (cfg.mant_bits - 1)), e_b + 1, e_b)
    out = ((1 << cfg.mant_bits) + m).to(F32) * nm.pow2_float(e - e_b - cfg.mant_bits)
    return out.to(z.dtype)


def lut8_softmax(z: torch.Tensor, lut_bits: int = 8, x_min: float = -8.0) -> torch.Tensor:
    """[23]: 8-bit fixed input, LUT exp, LUT reciprocal.

    The exp LUT spans [x_min, 0]; the reciprocal LUT spans [1, 2) of the
    normalized sum.  Both LUTs are exact at their sample points (ROM
    contents), so the error is pure quantization.
    """
    n = 1 << lut_bits
    z32 = z.to(F32)
    d = torch.clamp(z32 - torch.amax(z32, dim=-1, keepdim=True), x_min, 0.0)
    idx = torch.round((d - x_min) / (-x_min) * (n - 1)).to(I32)
    exp_lut = torch.exp(torch.linspace(x_min, 0.0, n, dtype=F32, device=z.device))
    # LUT values stored as 8-bit fixed point in (0,1]
    exp_lut = torch.round(exp_lut * (n - 1)) / (n - 1)
    ex = exp_lut[idx.long()]
    denom = torch.sum(ex, dim=-1, keepdim=True)
    # normalize denom to [1,2), 8-bit reciprocal LUT over the mantissa
    eb = torch.floor(torch.log2(denom))
    mant = denom / torch.exp2(eb)  # [1,2)
    midx = torch.clamp(((mant - 1.0) * n).to(I32), 0, n - 1)
    recip_lut = 1.0 / (1.0 + (torch.arange(n, dtype=F32, device=z.device) + 0.5) / n)
    recip_lut = torch.round(recip_lut * (n - 1)) / (n - 1)
    out = ex * recip_lut[midx.long()] * torch.exp2(-eb)
    return out.to(z.dtype)


def softermax(z: torch.Tensor, cfg: HyftConfig | None = None) -> torch.Tensor:
    """[20]: base-2, online max/sum accumulation, low-precision accumulator
    (the final result equals base-2 softmax with a quantized accumulator)."""
    cfg = cfg or dataclasses.replace(HYFT32, frac_bits=8, mant_bits=8,
                                     acc_bits=12, total_bits=16)
    return base2_softmax(z, cfg)


BASELINES = {
    "exact": lambda z: exact_softmax(z),
    "base2": lambda z: base2_softmax(z),
    "koca": lambda z: koca_softmax(z),
    "lut8": lambda z: lut8_softmax(z),
    "softermax": lambda z: softermax(z),
}
