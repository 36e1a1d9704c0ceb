"""The port's flash attention, chunked mode and Hyft softmax VJP against JAX.

The plain PyTorch versions (what the wrappers run on a CPU tensor) against
``flash_hyft_attention`` run in Pallas interpret mode, as the JAX package's
own tests run it, and against the JAX package's chunked mode and
``hyft_softmax``.  The same seeded numpy inputs go to both.

Tolerances: the KV blocks, the masking order and every Hyft step are the
same on both sides; only the fp32 dot products sum in another order.  That
can move one score across an FP2FX rounding boundary (one raw), which moves
one probability by about 2**-frac relative and can flip the last mantissa
bit of the log-subtract divide: each output within ``2 * 2**-mant *
max|v|``.  Gradients are held to ``atol=2e-4, rtol=1e-4``, the tolerance of
``tests/test_flash_backward.py`` between the JAX package's kernel and
chunked modes.  The Hyft softmax VJP has no dot product and is bit-exact.
torch runs under ``set_flush_denormal``: XLA on the CPU flushes subnormals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hyft as jhyft
from repro.kernels.flash_attention import flash_hyft_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.core import hyft as thyft
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

CONFIGS = {"hyft16": (jhyft.HYFT16, thyft.HYFT16),
           "hyft32": (jhyft.HYFT32, thyft.HYFT32),
           "hyft16-step2": (dataclasses.replace(jhyft.HYFT16, step=2),
                            dataclasses.replace(thyft.HYFT16, step=2))}
B, HQ, HKV, D = 2, 4, 2, 16
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)

# (id, cfg, causal, Sq, Sk, block, ragged mask, q_offset): block sizes below
# the lengths give several KV blocks; 40 and 56 are not multiples of 32, so
# the wrapper pads q and K/V
FWD_CASES = [
    ("causal-h16", "hyft16", True, 40, 40, 16, False, 0),
    ("causal-h32", "hyft32", True, 40, 40, 16, False, 0),
    ("noncausal-h16", "hyft16", False, 40, 40, 16, False, 0),
    ("noncausal-h32", "hyft32", False, 40, 40, 16, False, 0),
    ("step2", "hyft16-step2", True, 40, 40, 16, False, 0),
    ("mask-h16", "hyft16", False, 8, 64, 32, True, 0),
    ("mask-h32", "hyft32", False, 8, 64, 32, True, 0),
    ("padded", "hyft32", False, 40, 56, 32, True, 0),
    ("q-offset", "hyft16", True, 24, 40, 16, False, 16),
]


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _inputs(Sq, Sk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    w = rng.standard_normal((B, HQ, Sq, D)).astype(np.float32)
    return q, k, v, w


def _ragged_mask(Sk):
    """(B, Sk): row 0 sees everything, row 1 a third (ragged lengths)."""
    return (np.arange(Sk)[None] < np.array([Sk, Sk // 3 + 1])[:, None]).astype(np.float32)


def _tol(cfg, v):
    return 2.0 * 2.0 ** -cfg.mant_bits * float(np.abs(v).max())


def _case(case):
    _, name, causal, Sq, Sk, block, ragged, q_offset = case
    cj, ct = CONFIGS[name]
    q, k, v, w = _inputs(Sq, Sk)
    mask = _ragged_mask(Sk) if ragged else None
    kw = dict(causal=causal, block_q=block, block_k=block, q_offset=q_offset)
    return cj, ct, (q, k, v, w), mask, kw


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_flash_forward_matches_jax(case):
    """(o, m, l) of the plain forward against the JAX kernel's stats: o
    within 2 * 2**-mant * max|v|, l within the bound ``flash_errors``
    states; the differentiable output is the stats' o.  m is exact in all
    but a few rows, where a block's largest score rounds to the
    neighbouring raw (HYFT32's 2**-16 grid is fine enough for the fp32
    dot order to reach it): off by one raw there."""
    cj, ct, (q, k, v, _), mask, kw = _case(case)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cj,
                    interpret=True, return_stats=True,
                    kv_len_mask=None if mask is None else jnp.asarray(mask), **kw)
    o_j, m_j, l_j = (np.array(a) for a in ref)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, m, l = tfa.flash_hyft_attention(tq, tk, tv, ct, return_stats=True,
                                       kv_len_mask=tmask, **kw)
    assert o.dtype == torch.float32 and m.dtype == torch.int32
    assert o.shape == o_j.shape and m.shape == m_j.shape == l.shape
    moved = np.abs(m.numpy().astype(np.int64) - m_j)
    assert moved.max() <= 1 and (moved > 0).mean() <= 0.02
    np.testing.assert_allclose(o.numpy(), o_j, rtol=0, atol=_tol(ct, v))
    bk = min(kw["block_k"], k.shape[2])
    nk = -(-k.shape[2] // bk)
    err = tfa.flash_errors((o, m, l), tuple(map(torch.from_numpy, (o_j, m_j, l_j))),
                           ct, float(np.abs(v).max()), bk, nk)
    assert err["l"] <= 1 and err["o"] <= 1, err
    out = ops.hyft_attention(tq, tk, tv, ct, kv_len_mask=tmask, **kw)
    assert torch.equal(out, o)


GRAD_CASES = [c for c in FWD_CASES if c[0] != "step2"]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_flash_backward_matches_jax_grad(case):
    """dq, dk, dv through torch.autograd (the plain backward) against
    jax.grad through the JAX kernel's custom_vjp."""
    cj, ct, (q, k, v, w), mask, kw = _case(case)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, cj, interpret=True,
                                 kv_len_mask=jmask, **kw) * w)
    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_hyft_attention(tq, tk, tv, ct, **kw,
                                 kv_len_mask=None if mask is None else torch.from_numpy(mask))
    (o * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    if mask is not None:
        # masked keys get (at most) negligible dk/dv: FP2FX saturates a
        # masked score at -32 under HYFT16, which leaves a probability of at
        # most about e**-32 (1.1e-14); HYFT32 flushes it to zero
        dead = torch.from_numpy(mask == 0)[:, None, :, None]
        for g in (tk.grad, tv.grad):
            assert float(torch.where(dead, g, 0).abs().max()) < 1e-12


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_bf16_inputs_are_read_as_fp32(name):
    """bf16 q/k/v go in as they are and are read as fp32: the same result
    as their fp32 copies, and the gradients come back in bf16."""
    _, ct = CONFIGS[name]
    q, k, v, w = (torch.from_numpy(a).bfloat16() for a in _inputs(40, 40, seed=3))
    o32 = tfa.flash_hyft_attention(q.float(), k.float(), v.float(), ct,
                                   block_q=16, block_k=16)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    o = tfa.flash_hyft_attention(qb, kb, vb, ct, block_q=16, block_k=16)
    assert torch.equal(o, o32)
    (o * w.float()).sum().backward()
    assert qb.grad.dtype == kb.grad.dtype == torch.bfloat16


CHUNK_CASES = [("causal", True, 0, None), ("q-offset", True, 16, None),
               ("masked", False, 0, "2d"), ("per-row-mask", False, 0, "3d")]


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=[c[0] for c in CHUNK_CASES])
def test_chunked_mode_matches_jax(case, name):
    """Chunked mode, forward and backward, against the JAX package's
    ``chunked_hyft_attention`` (its custom VJP)."""
    _, causal, q_offset, mask_kind = case
    cj, ct = CONFIGS[name]
    Sq, Sk, chunk = (24, 48, 16) if q_offset == 0 else (32, 48, 16)
    q, k, v, w = _inputs(Sq, Sk, seed=4)
    mask = None
    if mask_kind == "2d":
        mask = _ragged_mask(Sk)
    elif mask_kind == "3d":   # per-token frontier kv <= start_b + t
        start = np.array([Sk - Sq, Sk // 3])
        mask = (np.arange(Sk)[None, None]
                <= start[:, None, None] + np.arange(Sq)[None, :, None]).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        o = jattn.chunked_hyft_attention(q_, k_, v_, cj, causal, chunk, q_offset, jmask)
        return jnp.sum(o * w), o
    (_, o_j), g_j = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.chunked_hyft_attention(tq, tk, tv, ct, causal, chunk, q_offset,
                                     None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), rtol=0,
                               atol=_tol(ct, v))
    (o * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("grad", ["hyft", "exact"])
@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_hyft_softmax_vjp_bitexact(name, grad):
    """hyft_softmax forward and VJP through the registry's cast to the input
    dtype: bit for bit under the Hyft backward, whose dot product sums
    fixed-point values; the exact VJP's <dy, s> is an fp32 sum in each
    library's own order, so it matches to a few ulps of the largest
    gradient."""
    cj, ct = (dataclasses.replace(c, grad=grad) for c in CONFIGS[name])
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((6, 37)) * 3).astype(np.float32)
    dy = rng.standard_normal((6, 37)).astype(np.float32)
    @jax.jit
    def fwd_bwd(x, g):
        s_, vjp = jax.vjp(lambda x_: jhyft.hyft_softmax(x_, cj).astype(x_.dtype), x)
        return s_, vjp(g)[0]
    s_j, dz_j = fwd_bwd(jnp.asarray(z), jnp.asarray(dy))
    tz = torch.from_numpy(z).requires_grad_()
    s = thyft.hyft_softmax(tz, ct).to(tz.dtype)
    s.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_j))
    if grad == "hyft":
        np.testing.assert_array_equal(tz.grad.numpy(), np.asarray(dz_j))
    else:
        np.testing.assert_allclose(tz.grad.numpy(), np.asarray(dz_j), rtol=0,
                                   atol=4 * 2.0 ** -24 * float(np.abs(dz_j).max()))


def test_unfused_attention_passes_dq_and_dk():
    """The unfused mode's Hyft softmax is differentiable: dq, dk and dv
    match jax.grad of the JAX unfused path.  (Before the softmax had its
    autograd Function, FP2FX's integer cast cut the graph: q and k got no
    gradient, and only v did.)"""
    q, k, v, w = _inputs(24, 24, seed=6)

    def f(q_, k_, v_):
        return jnp.sum(jattn.unfused_attention(q_, k_, v_, "hyft32", causal=True) * w)
    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.unfused_attention(tq, tk, tv, "hyft32", causal=True)
    (o * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert got is not None and float(got.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_flash_dispatches_on_device_only():
    """The plain versions for a CPU tensor and nothing else: a CUDA tensor
    launches the kernels, any other device raises."""
    assert tfa._flash_impls(torch.device("cpu")) == (
        tfa._flash_fwd_plain, tfa._flash_bwd_dq_plain, tfa._flash_bwd_dkv_plain)
    assert tfa._flash_impls(torch.device("cuda")) == (
        tfa._flash_fwd_cuda, tfa._flash_bwd_dq_cuda, tfa._flash_bwd_dkv_cuda)
    with pytest.raises(ValueError):
        tfa._flash_impls(torch.device("meta"))


def _plain_kw(cfg):
    return dict(cfg=cfg, sm_scale=D ** -0.5, causal=True, bk=16, group=HQ // HKV,
                q_offset=0)


def _plain_stats(cfg, q3, k3, v3):
    return tfa._flash_fwd_plain(q3, k3, v3, None, **_plain_kw(cfg))


def _plain_grads(cfg, q3, k3, v3, do3, o3, m2, l2):
    args = (q3, k3, v3, None, do3, tfa._flash_delta(do3, o3), m2, l2)
    return (tfa._flash_bwd_dq_plain(*args, **_plain_kw(cfg)),
            *tfa._flash_bwd_dkv_plain(*args, **_plain_kw(cfg)))


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_flash_errors_flag_a_percent_error(name):
    """The bounds that hold the CUDA kernels to their plain versions: a
    one-ulp change of every query element (scores rounded another way)
    stays inside them; a 1% error in o, l, dq, dk or dv does not."""
    _, ct = CONFIGS[name]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(48, 48, seed=7))
    q3, k3, v3 = (t.reshape(-1, 48, D) for t in (q, k, v))
    ref = _plain_stats(ct, q3, k3, v3)
    vmax = float(v.abs().max())
    assert tfa.flash_errors(ref, ref, ct, vmax, 16, 3)["o"] == 0
    got = _plain_stats(ct, q3 * (1 + 2 ** -23), k3, v3)
    err = tfa.flash_errors(got, ref, ct, vmax, 16, 3)
    assert err["m"] <= 1 and err["l"] <= 1 and err["o"] <= 1, err
    o, m, l = ref
    assert tfa.flash_errors((o * 1.01, m, l), ref, ct, vmax, 16, 3)["o"] > 1
    assert tfa.flash_errors((o, m, l * 1.01), ref, ct, vmax, 16, 3)["l"] > 1

    do = torch.from_numpy(np.random.default_rng(8).standard_normal(q3.shape)
                          .astype(np.float32))
    gref = _plain_grads(ct, q3, k3, v3, do, o, m, l)
    ggot = _plain_grads(ct, q3 * (1 + 2 ** -23), k3, v3, do, o, m, l)
    err = tfa.grad_errors(ggot, gref, ct)
    assert max(err["dq"], err["dk"], err["dv"]) <= 1, err
    for i, name_ in enumerate(("dq", "dk", "dv")):
        bad = list(gref)
        bad[i] = bad[i] * 1.01
        assert tfa.grad_errors(bad, gref, ct)[name_] > 1


SKIP_ROWS, SKIP_KEYS, SKIP_BK = 64, 512, 128   # the forward kernel's row tile


def _skip_inputs(dtype, Sk=SKIP_KEYS, seed=9):
    q, k, v, _ = _inputs(Sk, Sk, seed=seed)
    q3, k3, v3 = (torch.from_numpy(a).reshape(-1, Sk, D).to(dtype) for a in (q, k, v))
    return q3, k3, v3


def _tile_forward(q3, k3, v3, maskf, cfg, t):
    """The plain forward of 64-row tile ``t`` over the KV blocks up to its
    causal frontier only, as the kernel walks it when it skips."""
    nkeys = min(k3.shape[1], ((t + 1) * SKIP_ROWS - 1) // SKIP_BK * SKIP_BK + SKIP_BK)
    rows = slice(t * SKIP_ROWS, (t + 1) * SKIP_ROWS)
    return tfa._flash_fwd_plain(
        q3[:, rows], k3[:, :nkeys], v3[:, :nkeys],
        None if maskf is None else maskf[:, :nkeys].contiguous(), cfg=cfg,
        sm_scale=D ** -0.5, causal=True, bk=SKIP_BK, group=HQ // HKV,
        q_offset=t * SKIP_ROWS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_flash_forward_causal_skip_is_exact(name, dtype):
    """Dropping the KV blocks past a 64-row tile's causal frontier changes no
    bit of its o, m and l on these inputs, whose rows' maxima lie well above
    FX's lowest raw: a masked key's adder-tree count is then 0, its rescale
    exactly 1 and its PV term below the last bit of acc.  Not on every
    input under HYFT16, whose masked probability is never 0: there the term
    can move the last bit of a small acc (bf16 inputs on the card showed
    it), so the forward kernel drops only those blocks' scores and keeps
    their PV chain, and drops a block outright only where the probability
    is 0 (HYFT32)."""
    _, ct = CONFIGS[name]
    q3, k3, v3 = _skip_inputs(dtype)
    full = tfa._flash_fwd_plain(q3, k3, v3, None, cfg=ct, sm_scale=D ** -0.5,
                                causal=True, bk=SKIP_BK, group=HQ // HKV, q_offset=0)
    for t in range(SKIP_KEYS // SKIP_ROWS):
        part = _tile_forward(q3, k3, v3, None, ct, t)
        rows = slice(t * SKIP_ROWS, (t + 1) * SKIP_ROWS)
        for got, want in zip(part, full):
            assert torch.equal(got, want[:, rows]), (name, t)


DQ_SUB = 32   # the dq kernel's key sub-tile (its row tile is SKIP_ROWS)


def _dq_stats(q3, k3, v3, maskf, cfg):
    """The full walk's forward stats and a seeded do: the backward operands
    that the dq kernel and its skip share."""
    kw = dict(cfg=cfg, sm_scale=D ** -0.5, causal=True, bk=SKIP_BK, group=HQ // HKV,
              q_offset=0)
    o, m, l = tfa._flash_fwd_plain(q3, k3, v3, maskf, **kw)
    do3 = torch.from_numpy(np.random.default_rng(10).standard_normal(q3.shape)
                           .astype(np.float32))
    return do3, tfa._flash_delta(do3, o), m, l


def _dq_to(q3, k3, v3, maskf, stats, cfg, nkeys):
    """The plain dq of every row over keys [0, nkeys) in sub-tiles of 32."""
    do3, delta, m, l = stats
    return tfa._flash_bwd_dq_plain(
        q3, k3[:, :nkeys], v3[:, :nkeys], None if maskf is None else
        maskf[:, :nkeys].contiguous(), do3, delta, m, l, cfg=cfg, sm_scale=D ** -0.5,
        causal=True, bk=DQ_SUB, group=HQ // HKV, q_offset=0)


def _dq_skipped(q3, k3, v3, maskf, stats, cfg):
    """dq as the kernel computes it when it drops the key sub-tiles past each
    64-row tile's causal frontier: each tile's rows (at their query
    positions) over keys up to its frontier's sub-tile only.  The plain dq is
    row by row, so a tile's rows alone give the bits they give among all
    rows (``_tile_forward`` slices the forward alike)."""
    do3, delta, m, l = stats
    Sk = k3.shape[1]
    out = torch.empty(q3.shape)
    for t in range(q3.shape[1] // SKIP_ROWS):
        nkeys = min(Sk, ((t + 1) * SKIP_ROWS - 1) // DQ_SUB * DQ_SUB + DQ_SUB)
        rows = slice(t * SKIP_ROWS, (t + 1) * SKIP_ROWS)
        out[:, rows] = tfa._flash_bwd_dq_plain(
            q3[:, rows], k3[:, :nkeys], v3[:, :nkeys],
            None if maskf is None else maskf[:, :nkeys].contiguous(), do3[:, rows],
            delta[:, rows], m[:, rows], l[:, rows], cfg=cfg, sm_scale=D ** -0.5,
            causal=True, bk=DQ_SUB, group=HQ // HKV, q_offset=t * SKIP_ROWS)
    return out


def test_flash_dq_skip_needs_the_guard():
    """Why dq drops the masked sub-tiles only under its guard: batch entry 1
    masks keys 0-99, so its first 100 rows see no valid key, keep FX's
    lowest raw as their max and weigh every masked key 1.  Their masked term
    counts, the guard fails, and dropping the sub-tiles past the frontier
    would move their dq: the kernel runs those sub-tiles instead, on each
    row's masked probability."""
    _, ct = CONFIGS["hyft16"]
    Sk = 256
    q3, k3, v3 = _skip_inputs(torch.float32, Sk=Sk)
    maskf = torch.ones(B, Sk)
    maskf[1, :100] = 0
    stats = _dq_stats(q3, k3, v3, maskf, ct)
    dead = slice(HQ, 2 * HQ)                 # the heads of batch entry 1
    m = stats[2]
    assert bool((m[dead, :SKIP_ROWS] == -(2 ** (ct.total_bits - 1))).all())
    assert bool((tfa.masked_counts(m[dead, :SKIP_ROWS], ct) > 0).all())
    full = _dq_to(q3, k3, v3, maskf, stats, ct, Sk)
    got = _dq_skipped(q3, k3, v3, maskf, stats, ct)
    assert not torch.equal(got[dead, :SKIP_ROWS], full[dead, :SKIP_ROWS])
    assert tfa.grad_errors((got,), (full,), ct)["dq"] > 1
    live = slice(0, HQ)                      # entry 0's rows pass the guard
    assert bool((tfa.masked_counts(m[live], ct) == 0).all())
    assert tfa.grad_errors((got[live],), (full[live],), ct)["dq"] <= 1


def test_flash_skip_needs_a_live_row_max():
    """Why the kernels skip only under a guard: a row that sees no valid key
    keeps FX's lowest raw as its max, so every masked key weighs 1 in its
    sum.  Batch entry 1 masks keys 0-99, so its first 64 rows see nothing:
    the full forward sums 256 keys for them, a walk that stops at the
    tile's frontier block 128, and their output moves."""
    _, ct = CONFIGS["hyft16"]
    Sk = 256
    q3, k3, v3 = _skip_inputs(torch.float32, Sk=Sk)
    maskf = torch.ones(B, Sk)
    maskf[1, :100] = 0
    full = tfa._flash_fwd_plain(q3, k3, v3, maskf, cfg=ct, sm_scale=D ** -0.5,
                                causal=True, bk=SKIP_BK, group=HQ // HKV, q_offset=0)
    o, m, l = _tile_forward(q3, k3, v3, maskf, ct, 0)
    dead = slice(HQ, 2 * HQ)                 # the heads of batch entry 1
    lo = -(2 ** (ct.total_bits - 1))
    assert bool((full[1][dead, :SKIP_ROWS] == lo).all())
    assert bool((full[2][dead, :SKIP_ROWS] == 256.0).all())
    assert bool((l[dead] == 128.0).all())
    assert not torch.equal(o[dead], full[0][dead, :SKIP_ROWS])
    live = slice(0, HQ)                      # entry 0 sees key 0 in every row
    assert torch.equal(o[live], full[0][live, :SKIP_ROWS])


def _hold_at_width(name, d, groups, seed, derived=False):
    """The plain forward's (o, m, l) and its VJP against the JAX kernel in
    interpret mode at head width ``d``, non-causal, one case per (hq, hkv)
    of ``groups``, at this file's tolerances; ``derived`` holds the share of
    moved maxima and the gradients to the bounds that scale with the
    operands instead (``flash_errors`` alone, and ``grad_errors``)."""
    cj, ct = CONFIGS[name]
    rng = np.random.default_rng(seed)
    S = 40
    kw = dict(causal=False, block_q=16, block_k=16)
    for hq, hkv in groups:
        q = rng.standard_normal((B, hq, S, d)).astype(np.float32)
        k = rng.standard_normal((B, hkv, S, d)).astype(np.float32)
        v = rng.standard_normal((B, hkv, S, d)).astype(np.float32)
        w = rng.standard_normal((B, hq, S, d)).astype(np.float32)
        o_j, m_j, l_j = (np.array(a) for a in jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cj, interpret=True,
            return_stats=True, **kw))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o, m, l = tfa.flash_hyft_attention(tq.detach(), tk.detach(), tv.detach(), ct,
                                           return_stats=True, **kw)
        moved = np.abs(m.numpy().astype(np.int64) - m_j)
        assert moved.max() <= 1 and (derived or (moved > 0).mean() <= 0.02)
        np.testing.assert_allclose(o.numpy(), o_j, rtol=0, atol=_tol(ct, v))
        err = tfa.flash_errors((o, m, l), tuple(map(torch.from_numpy, (o_j, m_j, l_j))),
                               ct, float(np.abs(v).max()), 16, S // 16 + 1)
        assert err["l"] <= 1 and err["o"] <= 1, err

        def f(q_, k_, v_):
            return jnp.sum(jax_flash(q_, k_, v_, cj, interpret=True, **kw) * w)
        ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out = tfa.flash_hyft_attention(tq, tk, tv, ct, **kw)
        (out * torch.from_numpy(w)).sum().backward()
        if derived:
            gerr = tfa.grad_errors((tq.grad, tk.grad, tv.grad),
                                   tuple(torch.from_numpy(np.asarray(r)) for r in ref), ct)
            assert max(gerr["dq"], gerr["dk"], gerr["dv"]) <= 1, gerr
            continue
        for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
def test_flash_matches_jax_at_width_64(name):
    """At head width 64 (bert-base's), non-causal, a GQA group of 1 and of
    2: the plain forward's (o, m, l) and its VJP against the JAX kernel in
    interpret mode, at this file's tolerances."""
    _hold_at_width(name, 64, [(HQ, HQ), (HQ, HKV)], 64)


@pytest.mark.parametrize("name", ["hyft16", "hyft32"])
@pytest.mark.parametrize("d, groups", [(112, [(HQ, HQ)]), (192, [(12, 1)])],
                         ids=["d112-group1", "d192-group12"])
def test_flash_matches_jax_at_widths_112_and_192(name, d, groups):
    """The configs' other widths beside this file's 16: zamba2-7b's 112 (a
    GQA group of 1) and nemotron-4-340b's 192 (a group of 12), as at 64 but
    with the bounds derived from the operands: the fixed 2% share of moved
    maxima and the absolute gradient tolerance of the narrow cases do not
    scale with D (fp32 dot products of 112 or 192 terms in torch's order
    and the kernel's move 3-4% of the maxima by one raw)."""
    _hold_at_width(name, d, groups, d, derived=True)
