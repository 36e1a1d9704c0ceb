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
B, HKV, D = 2, 2, 32
# (Sk, g, d): padding, 2 and 3 splits at D; then the head widths of the
# configs beside 64 and 128: the smoke models' 16, zamba2-7b's 112 (a group
# of 1) and nemotron-4-340b's 192 (a group of 12)
SHAPES = [pytest.param(16, 1, D, id="16-1"), pytest.param(300, 2, D, id="300-2"),
          pytest.param(600, 3, D, id="600-3"), pytest.param(300, 2, 16, id="300-2-d16"),
          pytest.param(300, 1, 112, id="300-1-d112"),
          pytest.param(64, 12, 192, id="64-12-d192")]


def _inputs(Sk, g, Sq=1, seed=0, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * g, Sq, d)).astype(np.float32)
    k = rng.standard_normal((B, HKV, Sk, d)).astype(np.float32)
    v = rng.standard_normal((B, HKV, Sk, d)).astype(np.float32)
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
@pytest.mark.parametrize("Sk,g,d", SHAPES)
def test_plain_decode_matches_jax(Sk, g, d, name, quantized):
    cj, ct = CONFIGS[name]
    q, k, v = _inputs(Sk, g, d=d)
    mask = _ragged_mask(Sk)
    (jk, jv, jsc), (tk, tv, tsc) = _kv(k, v, quantized)
    ref = np.asarray(flash_hyft_decode(jnp.asarray(q), jk, jv, cj,
                                       kv_len_mask=jnp.asarray(mask), **jsc))
    out = tfa.flash_hyft_decode(torch.from_numpy(q), tk, tv, ct,
                                kv_len_mask=torch.from_numpy(mask), **tsc)
    assert out.shape == (B, HKV * g, 1, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(ct, v))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("Sk,g,d", SHAPES)
def test_plain_verify_matches_jax(Sk, g, d, name, quantized):
    cj, ct = CONFIGS[name]
    Sq = 5
    q, k, v = _inputs(Sk, g, Sq=Sq, seed=1, d=d)
    pm = _lane_mask(Sk, Sq)
    (jk, jv, jsc), (tk, tv, tsc) = _kv(k, v, quantized)
    ref = np.asarray(flash_hyft_verify(jnp.asarray(q), jk, jv, jnp.asarray(pm),
                                       cj, **jsc))
    out = tfa.flash_hyft_verify(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(pm), ct, **tsc)
    assert out.shape == (B, HKV * g, Sq, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(ct, v))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("Sk,g,d", SHAPES)
def test_verify_at_one_token_is_decode_bitwise(Sk, g, d, quantized):
    """At Sq == 1 the chunk path is the decode path: same splits, same tile,
    same combine; only the mask gained a lane axis."""
    q, k, v = _inputs(Sk, g, seed=2, d=d)
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
    """The plain version (both levels) is taken for a CPU tensor and nothing
    else: a CUDA tensor launches the one-launch kernel, any other device
    raises."""
    assert tfa._splitk_attention_for(torch.device("cpu")) is tfa.splitk_attention_plain
    assert tfa._splitk_attention_for(torch.device("cuda")) is tfa._splitk_attention_cuda
    with pytest.raises(ValueError):
        tfa._splitk_attention_for(torch.device("meta"))


def test_paged_verify_is_not_ported():
    """Paged verify was the unported branch; it now takes the pool and
    block tables (``test_torch_paged.py`` holds it to JAX): at Sq == 1 it
    is the paged decode, where it used to raise NotImplementedError."""
    q, k, v = _inputs(16, 1)
    kp = torch.cat([torch.zeros(1, HKV, 16, D), torch.from_numpy(k)])  # page b + 1
    bt = torch.tensor([[1], [2]], dtype=torch.int32)
    qt = torch.from_numpy(q)
    ver = tfa.flash_hyft_verify(qt, kp, kp, torch.ones(B, 1, 16), thyft.HYFT16,
                                block_tables=bt)
    assert torch.equal(ver, tfa.flash_hyft_decode_paged(qt, kp, kp, bt, thyft.HYFT16))



@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tile_errors_flags_a_percent_error(name):
    """The bound that holds a CUDA kernel's output to its plain version
    (``out_errors``; the kernels merge their splits on chip and show no
    per-split stats): scores summed in another order stay inside it, a 2%
    error in ``acc`` or a 1% error in ``l_loc`` does not."""
    cfg = CONFIGS[name][1]
    q, k, v = (torch.from_numpy(a) for a in _inputs(600, 3))
    q3 = q.reshape(B * HKV, 3, D)
    k3, v3 = k.reshape(B * HKV, 600, D), v.reshape(B * HKV, 600, D)
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=256, hkv=HKV, sq=None)
    mask = torch.from_numpy(_ragged_mask(600))
    ref = tfa.splitk_tiles_plain(q3, k3, v3, None, None, mask, **kw)
    vmax = float(v.abs().max())
    assert tfa.out_errors(tfa._splitk_combine(*ref, cfg), ref, cfg, vmax)["out"] == 0
    # one ulp on every query element: the scores round another way
    got = tfa.splitk_attention_plain(q3 * (1 + 2 ** -23), k3, v3, None, None, mask, **kw)
    assert tfa.out_errors(got, ref, cfg, vmax)["out"] <= 1
    acc, m_loc, l_loc = ref
    assert tfa.out_errors(tfa._splitk_combine(acc * 1.02, m_loc, l_loc, cfg),
                          ref, cfg, vmax)["out"] > 1
    assert tfa.out_errors(tfa._splitk_combine(acc, m_loc, l_loc * 1.01, cfg),
                          ref, cfg, vmax)["out"] > 1


def test_splitk_attention_plain_is_tiles_then_combine():
    """The contiguous plain version is level 1 then the torch combine, bit
    for bit: what the one-launch kernel is held to."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(300, 2, seed=4))
    q3 = q.reshape(B * HKV, 2, D)
    k3, v3 = k.reshape(B * HKV, 300, D), v.reshape(B * HKV, 300, D)
    kw = dict(cfg=thyft.HYFT16, sm_scale=D ** -0.5, bk=128, hkv=HKV, sq=None)
    mask = torch.from_numpy(_ragged_mask(300))
    out = tfa.splitk_attention_plain(q3, k3, v3, None, None, mask, **kw)
    ref = tfa._splitk_combine(*tfa.splitk_tiles_plain(q3, k3, v3, None, None, mask, **kw),
                              thyft.HYFT16)
    assert out.shape == (B * HKV, 2, D) and torch.equal(out, ref)


@pytest.mark.parametrize("kind", ["decode", "verify"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("ps", [64, 128, 256])
def test_contiguous_is_sequential_pages_bitwise(ps, quantized, kind):
    """``flash_hyft_decode`` / ``flash_hyft_verify`` at ``block_k = p`` equal
    the paged wrappers over a sequential table of pages of ``p``, bit for
    bit: a page is a split, the arithmetic is shared."""
    nb, g, Sq = 3, 2, (1 if kind == "decode" else 5)
    Sk = nb * ps
    q, k, v = _inputs(Sk, g, Sq=Sq, seed=5)
    _, (tk, tv, tsc) = _kv(k, v, quantized)

    def pages(x):   # (B, Hkv, Sk[, ...]) -> (B * nb, Hkv, ps[, ...]), in order
        x = x.reshape(B, HKV, nb, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B * nb, HKV, ps, *x.shape[4:]).contiguous()
    seq = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    psc = {n: pages(t) for n, t in tsc.items()}
    qt = torch.from_numpy(q)
    if kind == "decode":
        mask = torch.from_numpy(_ragged_mask(Sk))
        dense = tfa.flash_hyft_decode(qt, tk, tv, thyft.HYFT16, block_k=ps,
                                      kv_len_mask=mask, **tsc)
        paged = tfa.flash_hyft_decode_paged(qt, pages(tk), pages(tv), seq, thyft.HYFT16,
                                            kv_len_mask=mask, **psc)
    else:
        pm = torch.from_numpy(_lane_mask(Sk, Sq))
        dense = tfa.flash_hyft_verify(qt, tk, tv, pm, thyft.HYFT16, block_k=ps, **tsc)
        paged = tfa.flash_hyft_verify(qt, pages(tk), pages(tv), pm, thyft.HYFT16,
                                      block_tables=seq, **psc)
    assert dense.shape == (B, HKV * g, Sq, D)
    assert torch.equal(dense, paged)
