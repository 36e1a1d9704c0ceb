"""The port's split-K decode and chunk attention against the JAX kernels.

The plain PyTorch versions (what the wrappers run on a CPU tensor) against
``flash_hyft_decode`` and the contiguous branch of ``flash_hyft_verify``,
run in Pallas interpret mode as the JAX package's own tests run them.  The
same seeded numpy inputs go to both.

Tolerance: the split boundaries, the masking order and every Hyft step are
the same on both sides; only the fp32 dot products sum in another order.
That can move one score across an FP2FX rounding boundary (one raw), which
moves one probability by at most about 2**-frac relative, and can flip the
last mantissa bit of the log-subtract divide (2**-mant relative).  So each
output is held within ``2 * 2**-mant * max|v|``: 2**-9 for HYFT16 and
2**-15 for HYFT32.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hyft as jhyft
from repro.kernels.flash_attention import flash_hyft_decode, flash_hyft_verify
from repro.models.attention import fp2fx8_quantize
from repro_torch.core import hyft as thyft
from repro_torch.kernels import flash_attention as tfa

CONFIGS = {"hyft16": (jhyft.HYFT16, thyft.HYFT16),
           "hyft32": (jhyft.HYFT32, thyft.HYFT32)}
SHAPES = [(16, 1), (300, 2), (600, 3)]   # (Sk, g): padding, 2 and 3 splits
B, HKV, D = 2, 2, 32


def _inputs(Sk, g, Sq=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * g, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    return q, k, v


def _ragged_mask(Sk):
    """(B, Sk): row 0 sees everything, row 1 a third (ragged lengths)."""
    return (np.arange(Sk)[None] < np.array([Sk, Sk // 3 + 1])[:, None]).astype(np.float32)


def _lane_mask(Sk, Sq):
    """(B, Sq, Sk) causal frontier kv <= start_b + t, ragged starts."""
    start = np.array([Sk - Sq, Sk // 3])
    return (np.arange(Sk)[None, None]
            <= (start[:, None, None] + np.arange(Sq)[None, :, None])).astype(np.float32)


def _tol(cfg, v):
    return 2.0 * 2.0 ** -cfg.mant_bits * float(np.abs(v).max())


def _kv(k, v, quantized):
    """(jax operands, torch operands) for a float or fp2fx8 K/V."""
    if not quantized:
        return ((jnp.asarray(k), jnp.asarray(v), {}),
                (torch.from_numpy(k), torch.from_numpy(v), {}))
    kr, ks = (np.asarray(a) for a in fp2fx8_quantize(jnp.asarray(k)))
    vr, vs = (np.asarray(a) for a in fp2fx8_quantize(jnp.asarray(v)))
    return ((jnp.asarray(kr), jnp.asarray(vr),
             {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}),
            (torch.tensor(kr), torch.tensor(vr),
             {"k_scale": torch.tensor(ks), "v_scale": torch.tensor(vs)}))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("Sk,g", SHAPES)
def test_plain_decode_matches_jax(Sk, g, name, quantized):
    cj, ct = CONFIGS[name]
    q, k, v = _inputs(Sk, g)
    mask = _ragged_mask(Sk)
    (jk, jv, jsc), (tk, tv, tsc) = _kv(k, v, quantized)
    ref = np.asarray(flash_hyft_decode(jnp.asarray(q), jk, jv, cj,
                                       kv_len_mask=jnp.asarray(mask), **jsc))
    out = tfa.flash_hyft_decode(torch.from_numpy(q), tk, tv, ct,
                                kv_len_mask=torch.from_numpy(mask), **tsc)
    assert out.shape == (B, HKV * g, 1, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(ct, v))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("Sk,g", SHAPES)
def test_plain_verify_matches_jax(Sk, g, name, quantized):
    cj, ct = CONFIGS[name]
    Sq = 5
    q, k, v = _inputs(Sk, g, Sq=Sq, seed=1)
    pm = _lane_mask(Sk, Sq)
    (jk, jv, jsc), (tk, tv, tsc) = _kv(k, v, quantized)
    ref = np.asarray(flash_hyft_verify(jnp.asarray(q), jk, jv, jnp.asarray(pm),
                                       cj, **jsc))
    out = tfa.flash_hyft_verify(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(pm), ct, **tsc)
    assert out.shape == (B, HKV * g, Sq, D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(ct, v))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("Sk,g", SHAPES)
def test_verify_at_one_token_is_decode_bitwise(Sk, g, quantized):
    """At Sq == 1 the chunk path is the decode path: same splits, same tile,
    same combine; only the mask gained a lane axis."""
    q, k, v = _inputs(Sk, g, seed=2)
    mask = torch.from_numpy(_ragged_mask(Sk))
    _, (tk, tv, tsc) = _kv(k, v, quantized)
    qt = torch.from_numpy(q)
    dec = tfa.flash_hyft_decode(qt, tk, tv, thyft.HYFT16, kv_len_mask=mask, **tsc)
    ver = tfa.flash_hyft_verify(qt, tk, tv, mask[:, None], thyft.HYFT16, **tsc)
    assert torch.equal(dec, ver)


@pytest.mark.parametrize("step", [2, 3])
def test_strided_max_counts_from_split_start(step):
    """With step > 1 the max runs over every step-th key of each split,
    counted from the split's start (``_decode_tile``'s ``z_raw[:, ::step]``)."""
    cj, ct = (dataclasses.replace(c, step=step) for c in CONFIGS["hyft16"])
    q, k, v = _inputs(600, 2, seed=3)
    mask = _ragged_mask(600)
    ref = np.asarray(flash_hyft_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), cj,
                                       kv_len_mask=jnp.asarray(mask)))
    out = tfa.flash_hyft_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), ct,
                                kv_len_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(ct, v))


def test_wrapper_dispatches_on_device_only():
    """The plain version is taken for a CPU tensor and nothing else: a CUDA
    tensor launches the kernel, any other device raises."""
    assert tfa._tiles_for(torch.device("cpu")) is tfa.splitk_tiles_plain
    assert tfa._tiles_for(torch.device("cuda")) is tfa._splitk_tiles_cuda
    with pytest.raises(ValueError):
        tfa._tiles_for(torch.device("meta"))


def test_paged_verify_is_not_ported():
    q, k, v = _inputs(16, 1)
    with pytest.raises(NotImplementedError, match="queue 2"):
        tfa.flash_hyft_verify(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.ones(B, 1, 16),
                              thyft.HYFT16, block_tables=torch.zeros(B, 1))



@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tile_errors_flags_a_percent_error(name):
    """The bounds that hold the CUDA kernel to its plain version: scores
    summed in another order stay inside them, a 2% error in ``acc`` or a
    1% error in ``l_loc`` does not."""
    cfg = CONFIGS[name][1]
    q, k, v = (torch.from_numpy(a) for a in _inputs(600, 3))
    q3 = q.reshape(B * HKV, 3, D)
    k3, v3 = k.reshape(B * HKV, 600, D), v.reshape(B * HKV, 600, D)
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=256, hkv=HKV, sq=None)
    mask = torch.from_numpy(_ragged_mask(600))
    ref = tfa.splitk_tiles_plain(q3, k3, v3, None, None, mask, **kw)
    vmax = float(v.abs().max())
    assert tfa.tile_errors(ref, ref, cfg, vmax, 256)["out"] == 0
    # one ulp on every query element: the scores round another way
    got = tfa.splitk_tiles_plain(q3 * (1 + 2 ** -23), k3, v3, None, None, mask, **kw)
    err = tfa.tile_errors(got, ref, cfg, vmax, 256)
    assert err["m_loc"] <= 1 and err["l_loc"] <= 1 and err["out"] <= 1, err
    acc, m_loc, l_loc = ref
    assert tfa.tile_errors((acc * 1.02, m_loc, l_loc), ref, cfg, vmax, 256)["out"] > 1
    err = tfa.tile_errors((acc, m_loc, l_loc * 1.01), ref, cfg, vmax, 256)
    assert err["l_loc"] > 1 and err["out"] > 1
