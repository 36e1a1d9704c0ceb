"""Bit-level numeric-format emulation primitives for Hyft, in PyTorch.

The PyTorch counterpart of ``repro.core.numerics``: the exact arithmetic of
each hardware block, emulated with int32 raws and exact fp32 ops, so that the
plain attention path and the CUDA kernels agree with the JAX reference bit
for bit.  The translation rules are:

* ``jnp.rint`` -> ``torch.round`` (both round half to even);
* int32 ``>>`` is arithmetic in torch as in JAX, and a shift by 32 or more
  fills with the sign; ``<<`` wraps like two's-complement hardware;
* ``bitcast_convert_type`` -> ``Tensor.view(torch.int32 / torch.float32)``.

Conventions
-----------
* A fixed-point value with ``frac_bits=F`` is an int32 ``raw`` with value
  ``raw / 2**F`` (two's complement; arithmetic right shifts == floor division).
* A custom float is an (exponent ``e``:int32, mantissa ``m_raw``:int32) pair
  with value ``2**e * (1 + m_raw / 2**F)``, ``0 <= m_raw < 2**F`` (normalized).
* All helpers are shape-polymorphic and vectorize over leading axes.
"""
from __future__ import annotations

import torch

I32 = torch.int32
F32 = torch.float32


# --------------------------------------------------------------------------
# fixed-point <-> float conversion (the FP2FX / FX2FP blocks)
# --------------------------------------------------------------------------


def fp2fx(x: torch.Tensor, frac_bits: int, total_bits: int) -> torch.Tensor:
    """Float -> fixed point raw (int32), round-to-nearest-even, saturating.

    +-inf saturate; NaN is not special-cased (garbage in, garbage out).
    """
    lo = float(-(2 ** (total_bits - 1)))
    hi = float(2 ** (total_bits - 1) - 1)
    scaled = x.to(F32) * (2.0 ** frac_bits)
    return torch.clamp(torch.round(scaled), lo, hi).to(I32)


def fx2fp(raw: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Fixed point raw -> fp32 (exact while |raw| < 2**24)."""
    return raw.to(F32) * (2.0 ** -frac_bits)


def pow2_float(k: torch.Tensor) -> torch.Tensor:
    """The fp32 value ``2.0**k``, assembled by writing the exponent field.

    Out-of-range exponents flush to zero (k <= -127) or give +inf at the
    all-ones exponent (k >= 128), as the hardware's field assembly does.
    """
    biased = torch.clamp(k.to(I32) + 127, 0, 255)
    val = (biased << 23).view(F32)
    return torch.where(biased <= 0, torch.zeros_like(val), val)


def float_fields(x: torch.Tensor, mant_bits: int):
    """fp32 ``x`` -> (sign, exponent, mantissa raw @ mant_bits), truncating.

    Zero/subnormal inputs map to (sign, -127, m) which downstream blocks
    flush to zero.
    """
    bits = x.to(F32).contiguous().view(I32)
    sign = (bits >> 31) & 1
    e = ((bits >> 23) & 0xFF) - 127
    m = (bits >> (23 - mant_bits)) & ((1 << mant_bits) - 1)
    return sign, e, m


def assemble_float(sign, e, m_raw, mant_bits: int) -> torch.Tensor:
    """(sign, e, m_raw @ mant_bits) -> fp32 value, with FTZ on underflow."""
    mag = ((2.0 ** mant_bits) + m_raw.to(F32)) * pow2_float(e - mant_bits)
    return torch.where(sign == 1, -mag, mag)


# --------------------------------------------------------------------------
# the hybrid exponent unit (paper §3.2)
# --------------------------------------------------------------------------


def booth_log2e(d_raw: torch.Tensor) -> torch.Tensor:
    """Shift-add ``d * log2(e)``: ``d + (d >> 1) - (d >> 4)`` (1.4375)."""
    return d_raw + (d_raw >> 1) - (d_raw >> 4)


def _rescale(raw, src_bits: int, dst_bits: int):
    if dst_bits == src_bits:
        return raw
    if dst_bits < src_bits:
        return raw >> (src_bits - dst_bits)
    return raw << (dst_bits - src_bits)


def exp_unit(d_raw: torch.Tensor, frac_bits: int, mant_bits: int):
    """Fixed-point ``d = z - zmax`` (<= 0) -> float fields (e, m_raw) of
    ``exp(d) ~= 2**(u-1) (1 + (1+v))`` (paper Eq. 8), mantissa truncated."""
    F = frac_bits
    t = torch.clamp(booth_log2e(d_raw), max=0)
    u = -((-t) >> F)                     # ceil(t / 2**F) for t <= 0
    v_raw = t - (u << F)                 # in (-2**F, 0]
    e = u - 1
    m_raw = (1 << F) + v_raw             # 1 + v, in (0, 2**F]
    overflow = m_raw == (1 << F)         # v == 0: 2**(u-1) * 2 == 2**u * 1.0
    e = torch.where(overflow, e + 1, e)
    m_raw = torch.where(overflow, torch.zeros_like(m_raw), m_raw)
    if mant_bits < F:
        m_raw = (m_raw >> (F - mant_bits)) << (F - mant_bits)
    return e, _rescale(m_raw, F, mant_bits)


# --------------------------------------------------------------------------
# the hybrid adder tree (paper §3.3)
# --------------------------------------------------------------------------


def expfloat_to_fx(e, m_raw, mant_bits: int, acc_bits: int) -> torch.Tensor:
    """FP2FX at the adder-tree input: value in (0, 1] -> the fp32 multiple of
    ``2**-acc_bits`` below it (exact; sums stay exact below 2**24 ulps)."""
    shift = e + (acc_bits - mant_bits)
    base = (1 << mant_bits) + m_raw
    pos = base << torch.clamp(shift, min=0)
    neg = base >> torch.clamp(-shift, max=31)
    q = torch.where(shift >= 0, pos, neg)
    q = torch.where(shift <= -32, torch.zeros_like(q), q)
    return q.to(F32) * (2.0 ** -acc_bits)


def lod_refloat(s: torch.Tensor, mant_bits: int):
    """Leading-one detector: fp32 sum -> (e, m_raw @ mant_bits), truncating."""
    _, e, m = float_fields(s, mant_bits)
    return e, m


# --------------------------------------------------------------------------
# the hybrid DIV / MUL unit (paper §3.4 / §3.5)
# --------------------------------------------------------------------------


def log_div(e_a, m_a, e_b, m_b, mant_bits: int) -> torch.Tensor:
    """Log-subtract division ``a/b ~= 2**(e_a-e_b+m_a-m_b)`` (paper Eq. 9)."""
    diff = m_a - m_b
    neg = diff < 0
    e = e_a - e_b - neg.to(I32)
    m = torch.where(neg, (1 << mant_bits) + diff, diff)
    return ((1 << mant_bits) + m).to(F32) * pow2_float(e - mant_bits)


def log_mul(a, b, mant_bits: int, half_range: bool = True) -> torch.Tensor:
    """Hybrid float multiply ``a*b ~= 2**(ea+eb) (1 + ma + mb + ma*mb)``
    (paper Eq. 10); ``half_range`` keeps the top ``mant_bits//2`` bits of b's
    mantissa for the partial product."""
    F = mant_bits
    sa, ea, ma = float_fields(a, F)
    sb, eb, mb = float_fields(b, F)
    if half_range:
        prod = (ma * (mb >> (F - F // 2))) >> (F // 2)
    else:
        prod = (ma * mb) >> F
    num = (1 << F) + ma + mb + prod
    mag = num.to(F32) * pow2_float(ea + eb - F)
    out = torch.where((sa ^ sb) == 1, -mag, mag)
    zero = (a == 0.0) | (b == 0.0)
    return torch.where(zero, torch.zeros_like(out), out)


def fx_quantize(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Two's-complement truncation to ``frac_bits`` fractional bits, in fp32."""
    s = 2.0 ** frac_bits
    return torch.floor(x.to(F32) * s) * (1.0 / s)
