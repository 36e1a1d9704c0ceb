"""The port's standalone Hyft softmax against the JAX package, on the CPU.

The plain versions of the softmax kernels (``repro_torch.kernels.
hyft_softmax``), the differentiable kernel op, every softmax of the
registry, ``hyft_config_for``, ``hyft_jacobian`` and the ``ref.py``
oracles: the same numpy inputs (seeded; masked entries at -3e38) through
both frameworks, the JAX kernels in interpret mode.

Bitwise wherever the arithmetic is integer and fixed-point: the kernels
(under the sum precondition of ``kernels/hyft_softmax.py``, asserted on
every input), the op's gradient, the integer baselines and the Jacobian.
``exact`` and ``lut8`` go through exp / log2 / exp2 and a float sum, which
the two libraries may round differently by an ulp: ``exact`` is held to 4
ulps of 1; ``lut8`` to one step of its 8-bit reciprocal table (1/255 of
the output), which an ulp of the denominator can cross.  The attention
oracles sum fp32 dot products in another order, which can move a score by
one FP2FX raw: each output within ``2 * 2**-mant_bits * max|v|``.

XLA on the CPU flushes subnormals; torch's side runs under
``torch.set_flush_denormal(True)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hyft as jhyft
from repro.core import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.hyft_softmax import (hyft_softmax_bwd_kernel as jax_bwd,
                                        hyft_softmax_fwd_kernel as jax_fwd)
from repro_torch.core import hyft as thyft
from repro_torch.core import registry as treg
from repro_torch.kernels import hyft_softmax as ths
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

NEG_BIG = -3.0e38
CFGS = {"hyft16": (jhyft.HYFT16, thyft.HYFT16),
        "hyft32": (jhyft.HYFT32, thyft.HYFT32),
        "hyft16b": (jhyft.HYFT16B, thyft.HYFT16B)}
DTYPES = {"f32": (jnp.float32, torch.float32), "f16": (jnp.float16, torch.float16),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _scores(seed, shape, scale=4.0, masked=True):
    """Seeded scores with a few masked entries and, if there are at least
    three rows, one row masked past its first three entries."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape) * scale).astype(np.float32)
    if masked:
        flat = z.reshape(-1, shape[-1])
        flat[::3, 1::5] = NEG_BIG
        if flat.shape[0] >= 3:
            flat[2, 3:] = NEG_BIG
    return z


def _pair(z, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(z).astype(jdt), torch.from_numpy(z).to(tdt)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


def _same(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _within_precondition(units):
    assert int(units.max()) <= ths.EXACT_UNITS, "data past the sum precondition"


# --------------------------------------------------------------------------
# the two kernels' plain versions against the JAX kernels in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 32), (37, 200), (3, 5, 64), (1, 1024)])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_fwd_kernel_matches_jax(name, shape):
    cj, ct = CFGS[name]
    z = _scores(0, shape)
    jz, tz = _pair(z, "f32")
    _within_precondition(ths.fwd_sum_units(tz, ct))
    got = ths.hyft_softmax_fwd_kernel(tz, ct)
    assert got.dtype == ct.dtype and got.shape == tz.shape
    _same(jax_fwd(jz, cj, interpret=True), got)


@pytest.mark.parametrize("step", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_fwd_kernel_step_matches_jax(name, step):
    """The strided max (the max over every step-th column can miss the
    row's max, so exp_unit's clamp is exercised).  40 columns: every key
    above the strided max adds a whole 1, and HYFT32's sums must stay at or
    below 16."""
    cj, ct = (dataclasses.replace(c, step=step) for c in CFGS[name])
    z = _scores(1, (16, 40), scale=3.0)
    jz, tz = _pair(z, "f32")
    _within_precondition(ths.fwd_sum_units(tz, ct))
    _same(jax_fwd(jz, cj, interpret=True), ths.hyft_softmax_fwd_kernel(tz, ct))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_fwd_kernel_input_dtypes_match_jax(name, dtype):
    cj, ct = CFGS[name]
    z = _scores(2, (16, 64), scale=3.0)
    z[z < -6e4] = -6e4          # fp16 holds the masks at its own range
    jz, tz = _pair(z, dtype)
    _within_precondition(ths.fwd_sum_units(tz, ct))
    _same(jax_fwd(jz, cj, interpret=True), ths.hyft_softmax_fwd_kernel(tz, ct, block_rows=5))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_bwd_kernel_matches_jax(name, dtype):
    """s from the Hyft forward (masked entries included), a seeded dy."""
    cj, ct = CFGS[name]
    rng = np.random.default_rng(3)
    z = _scores(3, (24, 96), scale=2.0)
    s = np.asarray(jhyft.hyft_softmax_fwd(jnp.asarray(z), cj).astype(jnp.float32))
    dy = rng.standard_normal((24, 96)).astype(np.float32)
    (js, ts), (jdy, tdy) = _pair(s, dtype), _pair(dy, dtype)
    _within_precondition(ths.bwd_sum_units(ts, tdy, ct))
    got = ths.hyft_softmax_bwd_kernel(ts, tdy, ct)
    assert got.dtype == ct.dtype
    _same(jax_bwd(js, jdy, cj, interpret=True), got)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_kernels_on_rows_holding_nan_match_jax(name):
    """Rows holding NaN through both kernels' plain versions and JAX's
    kernels, bitwise.  Forward: a NaN score is FP2FX raw 0 in both (a NaN
    at key 0 of every third row, whole NaN rows).  Backward: NaN dy at a
    row's most probable key and in whole rows, +inf dy at another row's:
    the element's ``log_mul`` reads the all-ones exponent, its count is
    +-inf, and the dot (+-inf or NaN) is the same in both."""
    cj, ct = CFGS[name]
    z = _scores(4, (24, 96), scale=2.0)
    z[::3, 0] = np.nan
    z[5] = np.nan
    jz, tz = _pair(z, "f32")
    s = ths.hyft_softmax_fwd_kernel(tz, ct)
    _same(jax_fwd(jz, cj, interpret=True), s)
    assert torch.isfinite(s).all()
    s32 = s.float().numpy()
    dy = np.random.default_rng(4).standard_normal((24, 96)).astype(np.float32)
    top = s32.argmax(-1)
    dy[::4, :][np.arange(6), top[::4]] = np.nan
    dy[7] = np.nan
    dy[2, top[2]] = np.inf
    dtype = "f32" if ct.dtype == torch.float32 else ("f16" if ct.dtype == torch.float16
                                                     else "bf16")
    js, jdy = (jnp.asarray(x).astype(DTYPES[dtype][0]) for x in (s32, dy))
    # the torch inputs from the JAX arrays' bits: the two libraries' casts
    # of a NaN to bf16 give NaNs of other signs
    ts, tdy = (torch.from_numpy(np.asarray(x).view(f"i{x.dtype.itemsize}").copy())
               .view(DTYPES[dtype][1]) for x in (js, jdy))
    _same(jax_bwd(js, jdy, cj, interpret=True), ths.hyft_softmax_bwd_kernel(ts, tdy, ct))


@pytest.mark.parametrize("out", ["default", "cfg", "float32"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_bwd_kernel_out_dtype_matches_jax(name, out):
    """``out_dtype`` stores the ``cfg.dtype`` values: bitwise the plain
    version cast to it, and JAX's kernel output cast alike (fp32 holds
    fp16 and bf16 exactly)."""
    cj, ct = CFGS[name]
    rng = np.random.default_rng(11)
    z = _scores(11, (9, 70), scale=2.0)
    s = np.asarray(jhyft.hyft_softmax_fwd(jnp.asarray(z), cj).astype(jnp.float32))
    dy = rng.standard_normal((9, 70)).astype(np.float32)
    (js, ts), (jdy, tdy) = _pair(s, "f16"), _pair(dy, "f16")
    _within_precondition(ths.bwd_sum_units(ts, tdy, ct))
    kw = {"default": {}, "cfg": {"out_dtype": ct.dtype},
          "float32": {"out_dtype": torch.float32}}[out]
    got = ths.hyft_softmax_bwd_kernel(ts, tdy, ct, **kw)
    want = ct.dtype if out != "float32" else torch.float32
    assert got.dtype == want
    _same(thyft.hyft_softmax_bwd(ts, tdy, ct).to(want), got)
    _same(jax_bwd(js, jdy, cj, interpret=True).astype(
        jnp.float32 if out == "float32" else cj.dtype), got)


@pytest.mark.parametrize("name,bad", [("hyft16", torch.bfloat16), ("hyft16", torch.float64),
                                      ("hyft32", torch.float16), ("hyft16b", torch.float16)])
def test_bwd_kernel_rejects_other_out_dtypes(name, bad):
    """Only ``cfg.dtype`` and float32 hold the rounded values as they are."""
    ct = CFGS[name][1]
    s = torch.full((2, 8), 0.125, dtype=ct.dtype)
    with pytest.raises(ValueError, match="out_dtype"):
        ths.hyft_softmax_bwd_kernel(s, s, ct, out_dtype=bad)


@pytest.mark.parametrize("grad", ["hyft", "exact"])
@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_kernel_op_grad_matches_jax(name, grad):
    """ops.hyft_softmax through the registry's cast back to the input dtype
    (fp32 scores, as the unfused attention gives it): the output and the
    gradient bit for bit against jax.grad of JAX's op.  The backward is
    the backward kernel whatever cfg.grad says, in both frameworks, so a
    grad="exact" config gives the same gradient as grad="hyft"."""
    cj, ct = (dataclasses.replace(c, grad=grad) for c in CFGS[name])
    rng = np.random.default_rng(4)
    z = _scores(4, (6, 37), scale=3.0)
    w = rng.standard_normal((6, 37)).astype(np.float32)

    def f(x):
        return jnp.sum(jops.hyft_softmax(x, cj).astype(x.dtype) * w)
    s_j = jops.hyft_softmax(jnp.asarray(z), cj).astype(jnp.float32)
    dz_j = jax.jit(jax.grad(f))(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    s = tops.hyft_softmax(tz, ct).to(tz.dtype)
    (s * torch.from_numpy(w)).sum().backward()
    _same(s_j, s)
    _same(dz_j, tz.grad)
    tz2 = torch.from_numpy(z).requires_grad_()
    (tops.hyft_softmax(tz2, CFGS[name][1]).to(tz2.dtype) * torch.from_numpy(w)).sum().backward()
    _same(tz2.grad, tz.grad)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", jreg.available())
def test_registry_entry_matches_jax(name):
    z = _scores(5, (8, 40), scale=3.0)
    want = np.asarray(jreg.get_softmax(name)(jnp.asarray(z)))
    got = treg.get_softmax(name)(torch.from_numpy(z))
    assert got.dtype == torch.float32
    if name == "exact":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * 2.0 ** -24)
    elif name == "lut8":
        np.testing.assert_allclose(got.numpy(), want, rtol=1 / 255, atol=0)
    else:
        _same(want, got)


def test_registry_names_and_hyft_configs_match_jax():
    assert treg.available() == jreg.available()
    for name in treg.available() + ["nope"]:
        cj, ct = jreg.hyft_config_for(name), treg.hyft_config_for(name)
        assert (cj is None) == (ct is None), name
        if cj is not None:
            assert dataclasses.asdict(cj) == dataclasses.asdict(ct), name
    with pytest.raises(KeyError, match="unknown softmax impl 'nope'"):
        treg.get_softmax("nope")


def test_register_softmax_adds_a_name():
    fn = treg.get_softmax("exact")
    treg.register_softmax("exact_again", fn)
    try:
        assert "exact_again" in treg.available()
        assert treg.get_softmax("exact_again") is fn
    finally:
        del treg._REGISTRY["exact_again"]
    assert "exact_again" not in treg.available()


# --------------------------------------------------------------------------
# hyft_jacobian and the ref.py oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CFGS))
def test_hyft_jacobian_matches_jax(name):
    cj, ct = CFGS[name]
    z = _scores(6, (3, 12), scale=2.0, masked=False)
    s = np.asarray(jhyft.hyft_softmax_fwd(jnp.asarray(z), cj).astype(jnp.float32))
    got = thyft.hyft_jacobian(torch.from_numpy(s), ct)
    assert got.shape == (3, 12, 12) and got.dtype == ct.dtype
    _same(jhyft.hyft_jacobian(jnp.asarray(s), cj), got)


def test_softmax_ref_oracles_match_jax():
    cj, ct = CFGS["hyft32"]
    z = _scores(7, (5, 33))
    dy = np.random.default_rng(7).standard_normal((5, 33)).astype(np.float32)
    s = np.asarray(jref.hyft_softmax_ref(jnp.asarray(z), cj))
    _same(s, tref.hyft_softmax_ref(torch.from_numpy(z), ct))
    _same(jref.hyft_softmax_bwd_ref(jnp.asarray(s), jnp.asarray(dy), cj),
          tref.hyft_softmax_bwd_ref(torch.from_numpy(s), torch.from_numpy(dy), ct))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_oracles_match_jax(causal):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 4, 32, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 32, 16)).astype(np.float32) for _ in range(2))
    cj, ct = CFGS["hyft32"]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    atol = 2 * 2.0 ** -ct.mant_bits * float(np.abs(v).max())
    for a, b in [
        (jref.attention_ref(jq, jk, jv, cj, causal=causal),
         tref.attention_ref(tq, tk, tv, ct, causal=causal)),
        (jref.attention_ref(jq, jk, jv, None, causal=causal),
         tref.attention_ref(tq, tk, tv, None, causal=causal)),
        (jref.attention_ref(jq, jk, jv, None, causal=causal,
                            softmax_fn=jreg.get_softmax("base2")),
         tref.attention_ref(tq, tk, tv, None, causal=causal,
                            softmax_fn=treg.get_softmax("base2"))),
        (jref.flash_hyft_attention_ref(jq, jk, jv, cj, causal=causal, block_q=16, block_k=16),
         tref.flash_hyft_attention_ref(tq, tk, tv, ct, causal=causal, block_q=16,
                                       block_k=16)),
    ]:
        assert b.shape == (1, 4, 32, 16)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=atol)


# --------------------------------------------------------------------------
# the wrappers' contract
# --------------------------------------------------------------------------


def test_wrappers_dispatch_on_device_and_check_inputs():
    """A CPU tensor runs the plain version and launches nothing; a meta
    tensor gets the output's shape alone (``SHAPE_CALLS``); other devices
    and bad inputs raise."""
    ct = thyft.HYFT16
    z = torch.from_numpy(_scores(9, (4, 8)))
    before = dict(ths.LAUNCHES)
    s = ths.hyft_softmax_fwd_kernel(z, ct)
    _same(thyft.hyft_softmax_fwd(z, ct), s)
    _same(thyft.hyft_softmax_bwd(s, z, ct), ths.hyft_softmax_bwd_kernel(s, z, ct))
    assert ths.LAUNCHES == before
    shaped = dict(ths.SHAPE_CALLS)
    out = ths.hyft_softmax_fwd_kernel(z.to("meta"), ct)
    assert (out.device.type, out.shape, out.dtype) == ("meta", z.shape, ct.dtype)
    out = ths.hyft_softmax_bwd_kernel(s.to("meta"), z.to("meta"), ct, out_dtype=torch.float32)
    assert (out.device.type, out.shape, out.dtype) == ("meta", z.shape, torch.float32)
    assert ths.LAUNCHES == before
    assert {k: ths.SHAPE_CALLS[k] - shaped[k] for k in shaped} == dict.fromkeys(shaped, 1)
    for pick in (ths._fwd_for, ths._bwd_for):
        with pytest.raises(ValueError, match="device"):
            pick(torch.device("xpu"))
    with pytest.raises(ValueError, match="dtype"):
        ths.hyft_softmax_fwd_kernel(z.to(torch.int32), ct)
    with pytest.raises(ValueError, match="dtype"):
        ths.hyft_softmax_bwd_kernel(s, z.double(), ct)
    with pytest.raises(ValueError, match="last axis"):
        ths.hyft_softmax_fwd_kernel(torch.zeros(3, 0), ct)
    with pytest.raises(ValueError, match="shape"):
        ths.hyft_softmax_bwd_kernel(s, z[:, :4], ct)
    with pytest.raises(ValueError, match="block_rows"):
        ths.hyft_softmax_fwd_kernel(z, ct, block_rows=0)


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_softmax_errors_flags_one_raw(name):
    """The check chip_smoke.py holds the kernels to: one output moved by one
    raw of its type is a mismatch in a row within the precondition, and a
    move of 2**-mant_bits of an output stays within the bound past it."""
    ct = CFGS[name][1]
    z = torch.from_numpy(_scores(10, (6, 50), masked=False))
    ref = ths.hyft_softmax_fwd_kernel(z, ct)
    units = ths.fwd_sum_units(z, ct)
    assert ths.softmax_errors(ref.clone(), ref, units, ct)["mismatches"] == 0
    bits = torch.int32 if ref.dtype == torch.float32 else torch.int16
    got = ref.clone()
    got.view(bits)[1, 7] += 1
    err = ths.softmax_errors(got, ref, units, ct)
    assert err["mismatches"] == 1 and err["rows_past_precondition"] == 0
    past = torch.full_like(units, ths.EXACT_UNITS + 1)
    moved = ref.float() * (1 + 2.0 ** -ct.mant_bits)
    assert ths.softmax_errors(moved.to(ref.dtype), ref, past, ct)["past_ratio"] <= 1
    far = ref.float() * (1 + 4 * 2.0 ** -ct.mant_bits)
    assert ths.softmax_errors(far.to(ref.dtype), ref, past, ct)["past_ratio"] > 1
