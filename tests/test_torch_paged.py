"""The port's paged KV layout against the JAX package, on the CPU.

Paged decode and paged chunk attention: the plain PyTorch versions (what
the wrappers run for a CPU tensor) against ``flash_hyft_decode_paged`` and
the paged branch of ``flash_hyft_verify``, run in Pallas interpret mode as
the JAX package's own tests run them, on the same seeded numpy inputs: a
shuffled block table with null-page entries past each sequence and ragged
lengths.  Tolerance (ROADMAP, rules of the port): each output within
``2 * 2**-mant * max|v|``, since XLA and torch sum the fp32 dot products in
another order (a score can cross one FP2FX rounding boundary; an fp32
accumulator can differ in its last bit).  Under HYFT16 at least 99% of the
outputs must also be bitwise equal: in these cases at most 0.8% differ, by
at most 0.016 of the bound.

Then the paged cache writes (identical pools and fp2fx8 scales outside the
null page), the gather, and the layout invariances: page placement, verify
at Sq = 1 against decode, and a sequential table against the contiguous
split-K decode at ``block_k == page_size``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import hyft as jhyft
from repro.kernels.flash_attention import (flash_hyft_decode_paged,
                                           flash_hyft_verify)
from repro.models import attention as jattn
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hyft as thyft
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn

CONFIGS = {"hyft16": (jhyft.HYFT16, thyft.HYFT16),
           "hyft32": (jhyft.HYFT32, thyft.HYFT32)}
B, HKV, G, D, NB = 2, 2, 2, 16, 4
# (ps, d): pages of 4 and 16 at D; then pages of 16 at the configs' other
# head widths beside 64 and 128, zamba2-7b's 112 and nemotron-4-340b's 192
PAGES = [pytest.param(4, D, id="4"), pytest.param(16, D, id="16"),
         pytest.param(16, 112, id="16-d112"), pytest.param(16, 192, id="16-d192")]


def _pool(ps, seed, quantized, d=D):
    """Random pools of B * NB + 3 pages (page 0 the null page, holding
    values no unmasked read may see), a shuffled block table whose blocks
    past each sequence's length are the null page, and the lengths."""
    rng = np.random.default_rng(seed)
    P = B * NB + 3
    k = rng.standard_normal((P, HKV, ps, d)).astype(np.float32)
    v = rng.standard_normal((P, HKV, ps, d)).astype(np.float32)
    lengths = np.array([3 * ps - 1, ps + 2])
    used = -(-lengths // ps)
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, NB), np.int32)
    bt[0, :used[0]] = perm[:used[0]]
    bt[1, :used[1]] = perm[used[0]:used[0] + used[1]]
    sc = {}
    if quantized:
        kr, ks = (np.asarray(a) for a in jattn.fp2fx8_quantize(jnp.asarray(k)))
        vr, vs = (np.asarray(a) for a in jattn.fp2fx8_quantize(jnp.asarray(v)))
        k, v, sc = kr, vr, {"k_scale": ks, "v_scale": vs}
    return k, v, sc, bt, lengths


def _operands(k, v, sc, bt):
    jax_side = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                {n: jnp.asarray(a) for n, a in sc.items()})
    torch_side = (torch.tensor(k), torch.tensor(v), torch.tensor(bt),
                  {n: torch.tensor(a) for n, a in sc.items()})
    return jax_side, torch_side


def _vmax(v, sc):
    return float(np.abs(v).max()) * (float(sc["v_scale"].max()) if sc else 1.0)


def _hold(out, ref, name, ct, vmax):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 * 2.0 ** -ct.mant_bits * vmax)
    if name == "hyft16":
        assert float((out != ref).mean()) <= 0.01


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("ps, d", PAGES)
def test_plain_paged_decode_matches_jax(ps, d, quantized, name):
    cj, ct = CONFIGS[name]
    k, v, sc, bt, lengths = _pool(ps, 0, quantized, d)
    q = np.random.default_rng(1).standard_normal((B, HKV * G, 1, d)).astype(np.float32)
    mask = (np.arange(NB * ps)[None] < lengths[:, None]).astype(np.float32)
    (jk, jv, jbt, jsc), (tk, tv, tbt, tsc) = _operands(k, v, sc, bt)
    ref = np.asarray(flash_hyft_decode_paged(
        jnp.asarray(q), jk, jv, jbt, cj, interpret=True,
        kv_len_mask=jnp.asarray(mask), **jsc))
    out = tfa.flash_hyft_decode_paged(torch.from_numpy(q), tk, tv, tbt, ct,
                                      kv_len_mask=torch.from_numpy(mask), **tsc)
    assert out.shape == (B, HKV * G, 1, d) and out.dtype == torch.float32
    _hold(out.numpy(), ref, name, ct, _vmax(v, sc))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("Sq", [1, 5, 17])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
@pytest.mark.parametrize("ps, d", PAGES)
def test_plain_paged_verify_matches_jax(ps, d, quantized, Sq, name):
    """The chunk ends at each sequence's length: lane t sees keys
    ``<= length - Sq + t`` (17 lanes reach back before a short sequence's
    start, where a lane sees nothing but the masked keys)."""
    cj, ct = CONFIGS[name]
    k, v, sc, bt, lengths = _pool(ps, 2, quantized, d)
    q = np.random.default_rng(3).standard_normal((B, HKV * G, Sq, d)).astype(np.float32)
    start = lengths - Sq
    pm = (np.arange(NB * ps)[None, None]
          <= (start[:, None, None] + np.arange(Sq)[None, :, None])).astype(np.float32)
    (jk, jv, jbt, jsc), (tk, tv, tbt, tsc) = _operands(k, v, sc, bt)
    ref = np.asarray(flash_hyft_verify(jnp.asarray(q), jk, jv, jnp.asarray(pm), cj,
                                       interpret=True, block_tables=jbt, **jsc))
    out = tfa.flash_hyft_verify(torch.from_numpy(q), tk, tv, torch.from_numpy(pm),
                                ct, block_tables=tbt, **tsc)
    assert out.shape == (B, HKV * G, Sq, d)
    _hold(out.numpy(), ref, name, ct, _vmax(v, sc))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
def test_paged_verify_at_one_token_is_paged_decode(quantized):
    k, v, sc, bt, lengths = _pool(16, 4, quantized)
    _, (tk, tv, tbt, tsc) = _operands(k, v, sc, bt)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, HKV * G, 1, D)).astype(np.float32))
    mask = torch.from_numpy((np.arange(NB * 16)[None] < lengths[:, None])
                            .astype(np.float32))
    dec = tfa.flash_hyft_decode_paged(q, tk, tv, tbt, thyft.HYFT16,
                                      kv_len_mask=mask, **tsc)
    ver = tfa.flash_hyft_verify(q, tk, tv, mask[:, None], thyft.HYFT16,
                                block_tables=tbt, **tsc)
    assert torch.equal(dec, ver)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
def test_paged_decode_invariant_to_page_placement(quantized):
    """Moving every page elsewhere in the pool, with the block table
    following, changes no bit: pages are read only through the table."""
    k, v, sc, bt, lengths = _pool(8, 6, quantized)
    _, (tk, tv, tbt, tsc) = _operands(k, v, sc, bt)
    q = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, HKV * G, 1, D)).astype(np.float32))
    mask = torch.from_numpy((np.arange(NB * 8)[None] < lengths[:, None])
                            .astype(np.float32))
    base = tfa.flash_hyft_decode_paged(q, tk, tv, tbt, thyft.HYFT16,
                                       kv_len_mask=mask, **tsc)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(tk.shape[0]))
    inv = torch.argsort(perm)
    shuf = tfa.flash_hyft_decode_paged(
        q, tk[perm], tv[perm], inv[tbt.long()].to(torch.int32), thyft.HYFT16,
        kv_len_mask=mask, **{n: t[perm] for n, t in tsc.items()})
    assert torch.equal(base, shuf)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
def test_paged_decode_bitwise_vs_contiguous(quantized):
    """A sequential block table over a contiguous pool is the contiguous
    split-K decode at ``block_k == page_size`` (JAX's
    ``test_paged_kernel_bitwise_vs_contiguous``)."""
    rng = np.random.default_rng(9)
    ps, Sk = 16, 16 * NB
    q = torch.from_numpy(rng.standard_normal((B, HKV * G, 1, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, HKV, Sk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, HKV, Sk, D)).astype(np.float32))
    mask = (torch.arange(Sk)[None] < torch.tensor([37, 64])[:, None]).float()
    sc = {}
    if quantized:
        (k, ks), (v, vs) = tattn.fp2fx8_quantize(k), tattn.fp2fx8_quantize(v)
        sc = {"k_scale": ks, "v_scale": vs}

    def pages(x):  # (B, Hkv, Sk[, D]) -> (B * NB, Hkv, ps[, D]), in order
        x = x.reshape(B, HKV, NB, ps, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B * NB, HKV, ps, *x.shape[4:]).contiguous()
    dense = tfa.flash_hyft_decode(q, k, v, thyft.HYFT16, block_k=ps,
                                  kv_len_mask=mask, **sc)
    bt = torch.arange(B * NB, dtype=torch.int32).reshape(B, NB)
    paged = tfa.flash_hyft_decode_paged(
        q, pages(k), pages(v), bt, thyft.HYFT16, kv_len_mask=mask,
        **{n: pages(t) for n, t in sc.items()})
    assert torch.equal(dense, paged)


# --------------------------------------------------------------------------
# the paged cache writes and the gather
# --------------------------------------------------------------------------


def _cfgs(Hkv=HKV, Dh=8):
    return (smoke_config(get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv, d_head=Dh),
            jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv,
                                                                  d_head=Dh))


def _same_outside_null(jc, tc):
    for name, arr in jc.items():
        a, b = np.asarray(arr)[1:], tc[name].numpy()[1:]
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), name


def _table(rng, n_pages, rows, nb):
    """Distinct pages per row (no two rows share a written page)."""
    pages = rng.permutation(np.arange(1, n_pages + 1))[:rows * nb]
    return pages.reshape(rows, nb).astype(np.int32)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_cache_update_paged_matches_jax(cache_dtype):
    """One token per row through the block table; a gated row lands on the
    null page."""
    rng = np.random.default_rng(10)
    Bw, ps, nb, n_pages, Dh = 3, 4, 3, 12, 8
    tcfg, jcfg = _cfgs(Dh=Dh)
    bt = _table(rng, n_pages, Bw, nb)
    jc = jattn.paged_cache_init(jcfg, n_pages, ps, cache_dtype)
    tc = tattn.paged_cache_init(tcfg, n_pages, ps, cache_dtype)
    for pos, gate in (([0, 5, 11], [True, True, False]), ([1, 6, 3], [True, False, True])):
        k = rng.standard_normal((Bw, HKV, 1, Dh)).astype(np.float32)
        v = rng.standard_normal((Bw, HKV, 1, Dh)).astype(np.float32)
        pos, gate = np.array(pos, np.int32), np.array(gate)
        jc = jattn.cache_update_paged(jc, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), jnp.asarray(bt),
                                      jnp.asarray(gate))
        tc = tattn.cache_update_paged(tc, torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(pos), torch.from_numpy(bt),
                                      torch.from_numpy(gate))
    _same_outside_null(jc, tc)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_cache_update_block_paged_matches_jax(cache_dtype):
    """A chunk per row in one write, against JAX's token-by-token writes:
    padded lanes, a gated row and lanes past the table's extent land on the
    null page; everything else, the fp2fx8 scales included, bit for bit."""
    rng = np.random.default_rng(11)
    Bw, S, ps, nb, n_pages, Dh = 3, 6, 4, 3, 12, 8
    tcfg, jcfg = _cfgs(Dh=Dh)
    bt = _table(rng, n_pages, Bw, nb)
    k = rng.standard_normal((Bw, HKV, S, Dh)).astype(np.float32)
    v = rng.standard_normal((Bw, HKV, S, Dh)).astype(np.float32)
    pos = np.array([0, 3, 9], np.int32)      # row 2 runs past 12 = nb * ps
    nv = np.array([6, 4, 6], np.int32)
    for gate in (np.array([True, True, True]), np.array([True, False, True])):
        jc = jattn.cache_update_block_paged(
            jattn.paged_cache_init(jcfg, n_pages, ps, cache_dtype),
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(bt),
            jnp.asarray(nv), jnp.asarray(gate))
        tc = tattn.cache_update_block_paged(
            tattn.paged_cache_init(tcfg, n_pages, ps, cache_dtype),
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
            torch.from_numpy(bt), torch.from_numpy(nv), torch.from_numpy(gate))
        _same_outside_null(jc, tc)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_paged_gather_kv_matches_jax(cache_dtype):
    rng = np.random.default_rng(12)
    ps, n_pages, Dh = 4, 10, 8
    tcfg, jcfg = _cfgs(Dh=Dh)
    jc = jattn.paged_cache_init(jcfg, n_pages, ps, cache_dtype)
    bt = np.array([[3, 1, 0], [7, 2, 9]], np.int32)
    k = rng.standard_normal((2, HKV, 1, Dh)).astype(np.float32)
    for p in range(12):                       # fill pages through the writes
        kk = k * (p + 1)
        jc = jattn.cache_update_paged(jc, jnp.asarray(kk), jnp.asarray(-kk),
                                      jnp.full((2,), p, jnp.int32), jnp.asarray(bt))
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    jk, jv = jattn.paged_gather_kv(jc, jnp.asarray(bt))
    tk, tv = tattn.paged_gather_kv(tc, torch.from_numpy(bt))
    assert tk.shape == (2, HKV, 3 * ps, Dh)
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
def test_paged_model_step_matches_dense_and_placement(attn_mode):
    """prefill_chunk then decode_step of the smoke model (fp32) over the
    paged cache: bitwise the dense cache in the unfused mode (which gathers
    the same K/V), and in either mode bitwise itself with the pages placed
    elsewhere in the pool (the kernel mode's splits are pages, so it is not
    the dense cache's 128-key split)."""
    from repro_torch.models import build_model
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(
        softmax_impl="hyft16", compute_dtype="float32", vocab=64,
        attn_mode=attn_mode)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, 64, (2, 7))
                            .astype(np.int32))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    ps, nb = 4, 4
    lengths = torch.tensor([7, 5], dtype=torch.int32)
    caches = [model.init_cache(params, 2, nb * ps, "float32", device="cpu")]
    for table in ([[5, 2, 7, 0], [1, 8, 3, 0]], [[3, 8, 1, 0], [6, 4, 2, 0]]):
        c = model.init_paged_cache(params, 2 * nb, ps, "float32", device="cpu")
        caches.append(dict(c, block_tables=torch.tensor(table, dtype=torch.int32)))
    outs = []
    for cache in caches:
        lp, cache = model.prefill_chunk(params, cache, toks,
                                        torch.zeros(2, dtype=torch.int32),
                                        lengths=lengths)
        ld, _ = model.decode_step(params, cache, toks[:, :1], lengths)
        outs.append(torch.cat([lp.flatten(), ld.flatten()]))
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[1], outs[2])
    if attn_mode == "unfused":
        assert torch.equal(outs[0], outs[1])


def test_paged_wrapper_dispatches_on_device_only():
    """The plain version for a CPU tensor and nothing else: a CUDA tensor
    launches the one-launch paged kernel, a meta one gets the output's
    shape alone, any other device raises."""
    assert tfa._paged_attention_for(torch.device("cpu")) is tfa.paged_attention_plain
    assert tfa._paged_attention_for(torch.device("cuda")) is tfa._paged_attention_cuda
    assert tfa._paged_attention_for(torch.device("meta")) is tfa._paged_attention_shapes
    with pytest.raises(ValueError):
        tfa._paged_attention_for(torch.device("xpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("Sq", [None, 5], ids=["decode", "verify5"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "fp2fx8"])
def test_paged_attention_plain_is_tiles_then_combine(quantized, Sq, name):
    """The plain version of the one-launch kernels is bitwise the per-page
    stats merged by the torch combine, and JAX's paged decode / paged
    verify within the stated tolerance, ``2 * 2**-mant * max|v|`` per
    output.  The share of outputs that differ from JAX at all is not held
    here: one FP2FX raw that rounds the other way moves a whole row of 16
    outputs, so on these few rows the share depends on the data (3.1% of
    the fp2fx8 decode outputs under HYFT16 at this seed)."""
    cj, ct = CONFIGS[name]
    ps = 16
    k, v, sc, bt, lengths = _pool(ps, 10, quantized)
    n = 1 if Sq is None else Sq
    q = np.random.default_rng(11).standard_normal((B, HKV * G, n, D)).astype(np.float32)
    if Sq is None:
        mask = (np.arange(NB * ps)[None] < lengths[:, None]).astype(np.float32)
    else:
        mask = (np.arange(NB * ps)[None, None]
                <= (lengths - Sq)[:, None, None] + np.arange(Sq)[None, :, None]
                ).astype(np.float32)
    (jk, jv, jbt, jsc), (tk, tv, tbt, tsc) = _operands(k, v, sc, bt)
    q3 = torch.from_numpy(q).reshape(B * HKV, G * n, D)
    args = (q3, tk, tv, tsc.get("k_scale"), tsc.get("v_scale"), tbt,
            torch.from_numpy(mask))
    kw = dict(cfg=ct, sm_scale=D ** -0.5, hkv=HKV, sq=Sq)
    out = tfa.paged_attention_plain(*args, **kw)
    assert out.shape == (B * HKV, G * n, D)
    assert torch.equal(out, tfa._splitk_combine(*tfa.paged_tiles_plain(*args, **kw), ct))
    if Sq is None:
        ref = flash_hyft_decode_paged(jnp.asarray(q), jk, jv, jbt, cj, interpret=True,
                                      kv_len_mask=jnp.asarray(mask), **jsc)
    else:
        ref = flash_hyft_verify(jnp.asarray(q), jk, jv, jnp.asarray(mask), cj,
                                interpret=True, block_tables=jbt, **jsc)
    np.testing.assert_allclose(out.reshape(q.shape).numpy(), np.asarray(ref), rtol=0,
                               atol=2.0 * 2.0 ** -ct.mant_bits * _vmax(v, sc))
