"""The port's Hyft numerics against the JAX reference, bit for bit.

Every function of ``repro.core.numerics`` and ``hyft_softmax_fwd``, plus
``fp2fx8_quantize``, ``hyft_alpha``, ``hyft_finalize`` and
``_splitk_combine``: the same numpy inputs (seeded, with +-inf, NEG_BIG,
zeros and subnormals) through both frameworks, compared on their bits.

XLA on the CPU runs with subnormals flushed to zero (DAZ/FTZ), as the TPU
does; PyTorch on the CPU keeps them.  The torch side of each test runs in the
same mode (``torch.set_flush_denormal``, set and cleared around it) so both
frameworks run the same arithmetic on subnormal inputs.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hyft as jhyft
from repro.core import numerics as jnm
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro_torch.core import hyft as thyft
from repro_torch.core import numerics as tnm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

NEG_BIG = -3.0e38
SPECIALS = [np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-42, NEG_BIG, 3e38, 1e-30,
            -1e-30, 65504.0, 1e5, -1e5]
CONFIGS = {"hyft16": (jhyft.HYFT16, thyft.HYFT16),
           "hyft32": (jhyft.HYFT32, thyft.HYFT32),
           "hyft16b": (jhyft.HYFT16B, thyft.HYFT16B)}


@contextlib.contextmanager
def _like_xla():
    """Run torch with subnormals flushed, as XLA on the CPU runs."""
    assert torch.set_flush_denormal(True), "CPU without FTZ/DAZ support"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _floats(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[:len(SPECIALS)] = SPECIALS
    return x


def _ints(seed, shape, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _same(a, b):
    """Bitwise equality of two results (tuples compared leaf by leaf)."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a = np.asarray(a)
    if b.dtype == torch.bfloat16:       # numpy has no bf16: compare bits
        b = b.view(torch.int16)
    b = b.detach().numpy()
    assert a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape
    assert np.array_equal(a.view(f"u{a.dtype.itemsize}"),
                          b.view(f"u{b.dtype.itemsize}"))


def _both(fn_name, *args, **kw):
    ja = getattr(jnm, fn_name)(*[jnp.asarray(a) for a in args], **kw)
    with _like_xla():
        ta = getattr(tnm, fn_name)(*[torch.tensor(a) for a in args], **kw)
    _same(ja, ta)


@pytest.mark.parametrize("frac,total", [(10, 16), (16, 24), (7, 8), (20, 31)])
def test_fp2fx_fx2fp(frac, total):
    x = _floats(0, (64, 33))
    _both("fp2fx", x, frac_bits=frac, total_bits=total)
    _both("fx2fp", _ints(1, (64, 33), -2 ** 24, 2 ** 24), frac_bits=frac)


def test_pow2_float():
    _both("pow2_float", np.arange(-300, 300, dtype=np.int32))


@pytest.mark.parametrize("mant", [7, 10, 16, 23])
def test_float_fields_assemble(mant):
    x = _floats(2, (50, 20))
    _both("float_fields", x, mant_bits=mant)
    _both("lod_refloat", np.abs(x), mant_bits=mant)
    sign, e, m = (np.asarray(t) for t in jnm.float_fields(jnp.asarray(x), mant))
    _both("assemble_float", sign, e, m, mant_bits=mant)


@pytest.mark.parametrize("frac,mant", [(10, 10), (16, 16), (16, 12), (10, 7)])
def test_exp_unit_and_adder_input(frac, mant):
    d = _ints(3, (4000,), -(2 ** 24), 2 ** 10)   # <= 0 mostly; > 0 saturates
    d[:4] = [0, -1, -(2 ** 24), 5]
    _both("booth_log2e", d)
    _both("exp_unit", d, frac_bits=frac, mant_bits=mant)
    e, m = (np.asarray(t) for t in jnm.exp_unit(jnp.asarray(d), frac, mant))
    for acc in (14, 20, 22):
        _both("expfloat_to_fx", e, m, mant_bits=mant, acc_bits=acc)


@pytest.mark.parametrize("mant", [10, 16])
def test_log_div(mant):
    a, b = np.abs(_floats(4, (300,))), np.abs(_floats(5, (300,))) + 1.0
    _, ea, ma = jnm.float_fields(jnp.asarray(a), mant)
    _, eb, mb = jnm.float_fields(jnp.asarray(b), mant)
    _both("log_div", *(np.asarray(t) for t in (ea, ma, eb, mb)), mant_bits=mant)


@pytest.mark.parametrize("half_range", [True, False])
@pytest.mark.parametrize("mant", [10, 16])
def test_log_mul(mant, half_range):
    _both("log_mul", _floats(6, (400,), 0.5), _floats(7, (400,), 0.5),
          mant_bits=mant, half_range=half_range)


@pytest.mark.parametrize("frac", [12, 16, 20])
def test_fx_quantize(frac):
    _both("fx_quantize", _floats(8, (500,), 10.0), frac_bits=frac)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hyft_softmax_fwd_bitexact(name, step):
    """Bit-exact where the adder tree is exact: its fp32 sum stays below
    2**24 ulps of 2**-acc_bits (the precondition ``expfloat_to_fx``
    states), so summation order cannot matter.  The data are chosen so, and
    the test checks it."""
    cj, ct = (dataclasses.replace(c, step=step) for c in CONFIGS[name])
    z = _floats(9, (96, 80), scale=4.0)
    z[1] = NEG_BIG                      # a fully masked row
    z[2, ::3] = -np.inf
    e, m = jhyft.hyft_exp_fields(jnp.asarray(z), cj)
    denom = jnp.sum(jnm.expfloat_to_fx(e, m, cj.mant_bits, cj.acc_bits), -1)
    # row 1's addends are all 1.0, so its sum is exact in any order
    assert float(jnp.delete(denom, 1).max()) < 2.0 ** (24 - cj.acc_bits)
    with _like_xla():
        out = thyft.hyft_softmax_fwd(torch.from_numpy(z), ct)
    _same(jhyft.hyft_softmax_fwd(jnp.asarray(z), cj), out)


def test_fp2fx8_quantize():
    x = _floats(10, (2, 3, 40, 16))
    x[0, 0, 0] = 0.0                    # an all-zero row: the 1e-30 floor
    x[0, 1, 1] = 1e-39                  # subnormal row
    with _like_xla():
        out = tattn.fp2fx8_quantize(torch.from_numpy(x))
    _same(jattn.fp2fx8_quantize(jnp.asarray(x)), out)


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_alpha_finalize_combine(name):
    cj, ct = CONFIGS[name]
    d = _ints(11, (500,), -(2 ** 20), 1)
    acc = _floats(12, (4, 6, 16))
    l = np.abs(_floats(13, (4, 6, 1))) + 0.5
    BH, ns, rows, D = 3, 5, 6, 16
    acc3 = np.random.default_rng(14).standard_normal((BH, ns, rows, D)).astype(np.float32)
    m_loc = _ints(15, (BH, ns, rows), -(2 ** (cj.total_bits - 1)), 2 ** 12)
    m_loc[0, 2] = -(2 ** (cj.total_bits - 1))   # a fully masked split
    l_loc = (_ints(16, (BH, ns, rows), 1, 2 ** 18) * 2.0 ** -cj.acc_bits).astype(np.float32)
    with _like_xla():
        alpha = tfa.hyft_alpha(torch.from_numpy(d), ct)
        fin = tfa.hyft_finalize(torch.from_numpy(acc), torch.from_numpy(l), ct)
        comb = tfa._splitk_combine(torch.from_numpy(acc3), torch.from_numpy(m_loc),
                                   torch.from_numpy(l_loc), ct)
    _same(jfa.hyft_alpha(jnp.asarray(d), cj), alpha)
    _same(jfa.hyft_finalize(jnp.asarray(acc), jnp.asarray(l), cj), fin)
    m_st = np.repeat(m_loc[..., None], 128, -1)   # the JAX stats' lane axis
    l_st = np.repeat(l_loc[..., None], 128, -1)
    _same(jfa._splitk_combine(jnp.asarray(acc3), jnp.asarray(m_st),
                              jnp.asarray(l_st), cj), comb)
