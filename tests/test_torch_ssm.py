"""The port's SSM family (mamba2-370m) and ``prefill`` against the JAX
package's, on the CPU.

``models/ssm.py`` layer by layer (init, the chunked SSD forward with and
without its final state, the decode step), then mamba2-370m's smoke config
(2 layers, d_model 64, state 16, heads of 16, chunks of 8, vocab 64, fp32
compute) through the weights bridge: lm_loss and its gradients under each
remat policy, ``decode_step`` with a ragged position vector and a write
mask, ``prefill`` (sequential, parallel and ragged), ``prefill_chunk``,
``generate``, and the slot pool, which resets a recurrent slot on
admission; and ``prefill`` of the attention families (qwen2-1.5b smoke,
unfused and kernel mode, whole and ragged prompts).  The Mamba2 smoke
model's ``out_proj`` is scaled by 8 so that its greedy tokens do not echo
the input (tied embeddings at unit scale dominate a weak block).

What can go wrong where torch differs from JAX, each named in a test:
  * the conv's dtype: the training conv sums its taps in the input's dtype
    (bf16 when serving), the decode conv in fp32 over a window of the
    promoted dtype (``test_ssm_train_matches_jax``,
    ``test_ssm_decode_matches_jax`` in bf16: every output and cache leaf's
    dtype equals JAX's);
  * ``softplus``: torch's has a threshold, JAX's is ``logaddexp(x, 0)``;
  * the fp32 leaves under bf16 parameters (``A_log``, ``D``, ``dt_bias``)
    in the init and in the weights bridge;
  * a sequence the chunk size does not divide fails in both packages.

Tolerances: fp32 outputs, logits, states and caches within 1e-4 of their
largest (``tests/test_torch_generate.py``'s); the loss within 1e-5
relative and each gradient leaf within 1e-3 of its largest |g|
(``tests/test_torch_train.py``'s); bf16 outputs within 2**-6 of their
largest, two bf16 ulps at the largest (XLA may keep a fused chain of bf16
operations in fp32, torch rounds each); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.layers import unbox
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, transformer
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_leaves

MAMBA, QWEN = "mamba2-370m", "qwen2-1.5b"
RTOL, LOSS_RTOL, GRAD_TOL, BF16_RTOL = 1e-4, 1e-5, 1e-3, 2.0 ** -6
S = 16                                    # two chunks of the smoke config's 8


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


class _CopyingJnp:
    """``jax.numpy`` with an ``asarray`` that always copies its input (the
    JAX scheduler's host mirrors, ROADMAP queue 3)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x):
        return jnp.array(x, copy=True)


def _configs(arch, **kw):
    kw = dict(dict(vocab=64, compute_dtype="float32"), **kw)
    return (jax_smoke_config(jax_get_config(arch)).with_(**kw),
            smoke_config(get_config(arch)).with_(**kw))


def _weights(jcfg, seed=0, out_scale=8.0):
    """JAX's init and its bridge to the port; a Mamba2 block's ``out_proj``
    scaled by ``out_scale`` in both."""
    jparams = jax.jit(lambda k: unbox(jax_build_model(jcfg).init(k)))(jax.random.PRNGKey(seed))
    if "ssm" in jparams["blocks"]:
        ssm = jparams["blocks"]["ssm"]
        jparams["blocks"]["ssm"] = dict(ssm, out_proj=ssm["out_proj"] * out_scale)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _close(want, got, rtol=RTOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _same_dtype(want, got):
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close_cache(jc, tc, rtol=RTOL):
    """Every leaf of a JAX cache against the port's: dtype, and values."""
    want = jax.tree.leaves(jc)
    got = tree_leaves(tc)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        _same_dtype(w, g)
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif np.abs(np.asarray(w, np.float32)).max() > 0:
            _close(w, g, rtol)
        else:
            assert not g.any()


# --------------------------------------------------------------------------
# models/ssm.py, layer by layer
# --------------------------------------------------------------------------


def test_ssm_init_matches_jax():
    """The same keys, shapes and dtypes as JAX's ``ssm_init`` at bf16
    params (``A_log``, ``D``, ``dt_bias`` fp32), its constants' values, and
    each random leaf's spread within 10% of JAX's scale; stacked per layer
    by the transformer's init."""
    cfg = get_config(MAMBA).with_(d_model=64, n_layers=3, vocab=64, ssm_state=16,
                                  ssm_head_dim=16, ssm_chunk=8, param_dtype="bfloat16")
    want = unbox(jssm.ssm_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16))
    got = tssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    scale = {"in_proj": 64 ** -0.5, "conv_w": cfg.ssm_conv ** -0.5, "out_proj": 128 ** -0.5}
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape, name
        _same_dtype(w, t)
        if name in scale:
            assert abs(float(t.float().std()) / scale[name] - 1) < 0.1, name
        else:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(w, np.float32),
                                       rtol=1e-6, err_msg=name)
    stacked = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")["blocks"]
    assert sorted(stacked) == ["norm", "ssm"]
    for name, w in want.items():
        assert tuple(stacked["ssm"][name].shape) == (3,) + w.shape
        _same_dtype(w, stacked["ssm"][name])


def _layer0(jcfg):
    jparams, _ = _weights(jcfg, out_scale=1.0)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_train_matches_jax(dtype, return_state):
    """The chunked SSD forward of one block on the same input, in fp32 and
    in bf16 (the serving dtype, where the conv sums its taps in bf16):
    the output, and with ``return_state`` the final state (fp32) and the
    conv tail (the input's dtype), each of JAX's dtype."""
    jcfg, tcfg = _configs(MAMBA)
    jp, tp = _layer0(jcfg)
    x = np.random.default_rng(1).standard_normal((2, S, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax.jit(jssm.ssm_train, static_argnums=(2, 3))(jp, jx, jcfg, return_state)
    with torch.no_grad():
        got = tssm.ssm_train(tp, tx, tcfg, return_state=return_state)
    if not return_state:
        want, got = (want, {}), (got, {})
    rtol = RTOL if dtype == "float32" else BF16_RTOL
    _same_dtype(want[0], got[0])
    _close(want[0], got[0], rtol)
    for name in want[1]:
        _same_dtype(want[1][name], got[1][name])
        _close(want[1][name], got[1][name], rtol)


@pytest.mark.parametrize("x_dtype,cache_dtype", [("float32", "float32"),
                                                 ("bfloat16", "float32"),
                                                 ("bfloat16", "bfloat16")])
def test_ssm_decode_matches_jax(x_dtype, cache_dtype):
    """One decode step of one block from a seeded state and conv tail: the
    output and the new state and conv tail, each of JAX's dtype (a bf16
    token over an fp32 tail, fp2fx8's storage, promotes the window to
    fp32)."""
    jcfg, tcfg = _configs(MAMBA)
    jp, tp = _layer0(jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    c = tssm.ssm_cache_init(tcfg, 2, getattr(torch, cache_dtype), "cpu")
    st = rng.standard_normal(tuple(c["ssm"].shape)).astype(np.float32)
    conv = rng.standard_normal(tuple(c["conv"].shape)).astype(np.float32)
    jc = {"ssm": jnp.asarray(st), "conv": jnp.asarray(conv).astype(cache_dtype)}
    tc = {"ssm": torch.from_numpy(st),
          "conv": torch.from_numpy(conv).to(getattr(torch, cache_dtype))}
    want, wc = jax.jit(jssm.ssm_decode, static_argnums=3)(
        jp, jnp.asarray(x).astype(x_dtype), jc, jcfg)
    with torch.no_grad():
        got, gc = tssm.ssm_decode(tp, torch.from_numpy(x).to(getattr(torch, x_dtype)), tc,
                                  tcfg)
    rtol = RTOL if x_dtype == "float32" else BF16_RTOL
    _same_dtype(want, got)
    _close(want, got, rtol)
    for name in wc:
        _same_dtype(wc[name], gc[name])
        _close(wc[name], gc[name], rtol)


def test_ssm_train_refuses_a_length_the_chunk_does_not_divide():
    """S = 12 over chunks of 8: JAX's reshape into chunks fails, and so does
    the port's; neither pads."""
    jcfg, tcfg = _configs(MAMBA)
    jp, tp = _layer0(jcfg)
    x = np.zeros((1, 12, 64), np.float32)
    with pytest.raises(TypeError):
        jssm.ssm_train(jp, jnp.asarray(x), jcfg)
    with pytest.raises(RuntimeError, match="invalid for input"):
        tssm.ssm_train(tp, torch.from_numpy(x), tcfg)


def test_cache_storage_dtype_matches_jax():
    for name in ("float32", "bfloat16", "fp2fx8"):
        assert (str(tattn.cache_storage_dtype(name)).removeprefix("torch.")
                == str(jattn.cache_storage_dtype(name)))


def test_bridge_keeps_the_fp32_leaves():
    """``params_from_numpy(..., dtype=bf16)`` of JAX's bf16 init widened to
    fp32 recasts the float leaves but ``A_log``, ``D`` and ``dt_bias``,
    which stay fp32 as JAX's ``Param``s do under bf16 params; the layout
    equals the port's own init's."""
    jcfg, _ = _configs(MAMBA, param_dtype="bfloat16")
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    wide = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    got = params_from_numpy(wide, "cpu", dtype=torch.bfloat16)
    own = build_model(smoke_config(get_config(MAMBA)).with_(
        vocab=64, param_dtype="bfloat16")).init(0, device="cpu")
    for name in ("A_log", "D", "dt_bias"):
        assert got["blocks"]["ssm"][name].dtype == torch.float32
    assert got["blocks"]["ssm"]["in_proj"].dtype == torch.bfloat16
    for a, b, w in zip(tree_leaves(got), tree_leaves(own), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype and a.shape == b.shape
        _same_dtype(w, a)


# --------------------------------------------------------------------------
# mamba2-370m smoke: loss, decode, prefill, chunk prefill, generate, pool
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _configs(MAMBA)
    jparams, tparams = _weights(jcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def mamba_grads(mamba):
    """One batch and JAX's loss and gradients on it (remat "none")."""
    jcfg, _, jparams, _ = mamba
    toks = _tokens(3, (2, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jm = jax_build_model(jcfg)
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), remat="none"),
        has_aux=True))(jparams)
    return batch, float(want), jax.tree.map(np.asarray, wgrads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_jax(mamba, mamba_grads, remat):
    """lm_loss and every gradient leaf against JAX's (remat "none"), under
    each remat policy; the three policies give the same bits."""
    _, tcfg, _, tparams = mamba
    batch, want, wgrads = mamba_grads
    model = build_model(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {p: grads_of(lambda q, b: model.loss(q, b, remat=p), tparams, tbatch)
            for p in ("none", remat)}
    loss, _, grads = runs[remat]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(wgrads)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))
    assert float(grads["blocks"]["ssm"]["A_log"].abs().max()) > 0
    assert torch.equal(runs["none"][0], loss)
    for a, b in zip(tree_leaves(runs["none"][2]), tree_leaves(grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_decode_step_matches_jax(mamba, cache_dtype):
    """From the state after a sequential prefill of 8 tokens, a decode step
    at the ragged positions (8, 5) with row 1's writes masked: the logits,
    and every cache leaf (row 1's unchanged), against JAX's.  Under fp2fx8
    the Mamba2 state and conv tail are fp32."""
    jcfg, tcfg, jparams, tparams = mamba
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    toks = _tokens(4, (2, 8))
    jc = jm.init_cache(jparams, 2, 16, cache_dtype)
    tc = tm.init_cache(tparams, 2, 16, cache_dtype, device="cpu")
    _close_cache(jc, tc)
    _, jc, _ = jm.prefill(jparams, jc, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, tc, _ = tm.prefill(tparams, tc, {"tokens": torch.from_numpy(toks)})
    before = [t.clone() for t in tree_leaves(tc)]
    nxt, pos, wm = np.array([[3], [5]], np.int32), np.array([8, 5], np.int32), [True, False]
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos),
                            write_mask=jnp.asarray(wm))
    with torch.no_grad():
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt), torch.from_numpy(pos),
                                write_mask=torch.tensor(wm))
    _close(jl, tl)
    _close_cache(jc, tc)
    for a, b in zip(before, tree_leaves(tc)):
        assert torch.equal(a[:, 1], b[:, 1])
        assert not torch.equal(a[:, 0], b[:, 0])


def _prefill_both(jcfg, tcfg, jparams, tparams, toks, lengths=None, cache_dtype="float32"):
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    B = toks.shape[0]
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if lengths is not None:
        jb["lengths"], tb["lengths"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    jl, jc, jn = jm.prefill(jparams, jm.init_cache(jparams, B, 24, cache_dtype), jb)
    with torch.no_grad():
        tl, tc, tn = tm.prefill(tparams, tm.init_cache(tparams, B, 24, cache_dtype,
                                                       device="cpu"), tb)
    assert tn == int(jn) == toks.shape[1]
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("kind", ["sequential", "parallel", "ragged"])
def test_prefill_matches_jax(mamba, kind):
    """``model.prefill`` of 2 x 16 tokens: the token-by-token state build,
    the parallel prefill (the chunked SSD's final state), and ragged
    prompts (lengths 16 and 11, the sequential build gating row 1's steps
    past 11): the logits (each row's last real position) and every cache
    leaf against JAX's."""
    jcfg, tcfg, jparams, tparams = mamba
    par = kind == "parallel"
    jcfg, tcfg = jcfg.with_(parallel_prefill=par), tcfg.with_(parallel_prefill=par)
    lengths = np.array([16, 11], np.int32) if kind == "ragged" else None
    (jl, jc), (tl, tc) = _prefill_both(jcfg, tcfg, jparams, tparams, _tokens(5, (2, S)),
                                       lengths)
    assert tuple(tl.shape) == (2, 1, 64)
    _close(jl, tl)
    _close_cache(jc, tc)


def test_parallel_prefill_matches_sequential(mamba):
    """The port's two prefills of one prompt: the logits and the state
    within RTOL of each other (``tests/test_models.py`` holds JAX's alike)."""
    _, tcfg, _, tparams = mamba
    toks = torch.from_numpy(_tokens(6, (2, S)))
    out = {}
    for par in (False, True):
        m = build_model(tcfg.with_(parallel_prefill=par))
        with torch.no_grad():
            lg, c, _ = m.prefill(tparams, m.init_cache(tparams, 2, 24, "float32",
                                                       device="cpu"), {"tokens": toks})
        out[par] = (lg, c)
    _close(out[False][0].numpy(), out[True][0])
    for a, b in zip(tree_leaves(out[False][1]), tree_leaves(out[True][1])):
        _close(a.numpy(), b)


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("ragged", [False, True])
def test_dense_prefill_matches_jax(attn_mode, ragged):
    """``prefill`` of the attention families (qwen2-1.5b smoke, hyft16):
    one causal pass whose K/V land at position 0, against JAX's, with
    ``kv_len_mask`` over ragged prompts (lengths 16 and 9): the logits at
    each row's last real position and the cache's valid positions."""
    jcfg, tcfg = _configs(QWEN, softmax_impl="hyft16", attn_mode=attn_mode)
    jparams, tparams = _weights(jcfg)
    lengths = np.array([16, 9], np.int32) if ragged else None
    (jl, jc), (tl, tc) = _prefill_both(jcfg, tcfg, jparams, tparams, _tokens(7, (2, S)),
                                       lengths)
    _close(jl, tl)
    for name in ("k", "v"):
        want, got = np.asarray(jc["blocks"][name]), tc["blocks"][name]
        for b, n in enumerate(lengths if ragged else (S, S)):
            _close(want[:, b, :, :n], got[:, b, :, :n])
        assert not got[:, :, :, S:].any()


def test_prefill_chunk_matches_jax(mamba):
    """``prefill_chunk`` of the recurrent family (one gated decode step per
    lane): 2 x 8 lanes at starts (0, 0), lengths (8, 5), against JAX's, the
    logits of each row's real lanes and every cache leaf; and two chunks of
    4 give the bits of one chunk of 8."""
    jcfg, tcfg, jparams, tparams = mamba
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    toks, lengths = _tokens(8, (2, 8)), np.array([8, 5], np.int32)
    jl, jc = jm.prefill_chunk(jparams, jm.init_cache(jparams, 2, 16, "float32"),
                              jnp.asarray(toks), jnp.zeros((2,), jnp.int32),
                              lengths=jnp.asarray(lengths))
    start = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        tl, tc = tm.prefill_chunk(tparams, tm.init_cache(tparams, 2, 16, "float32",
                                                         device="cpu"),
                                  torch.from_numpy(toks), start,
                                  lengths=torch.from_numpy(lengths))
        split = tm.init_cache(tparams, 2, 16, "float32", device="cpu")
        l1, split = tm.prefill_chunk(tparams, split, torch.from_numpy(toks[:, :4]), start)
        l2, split = tm.prefill_chunk(tparams, split, torch.from_numpy(toks[:, 4:]),
                                     start + 4, lengths=torch.tensor([4, 1]))
    assert tuple(tl.shape) == (2, 8, 64)
    for b, n in enumerate(lengths):
        _close(np.asarray(jl)[b, :n], tl[b, :n])
    _close_cache(jc, tc)
    assert torch.equal(torch.cat([l1, l2], 1)[0], tl[0])
    assert torch.equal(torch.cat([l1, l2], 1)[1, :5], tl[1, :5])
    for a, b in zip(tree_leaves(split), tree_leaves(tc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("parallel", [False, True])
def test_generate_matches_jax(mamba, parallel):
    """``generate`` prefills through ``model.prefill`` (the sequential or the
    parallel state build) as JAX's engine does for the recurrent families:
    the greedy tokens of 2 x 16 prompts, 6 new each, equal JAX's."""
    jcfg, tcfg, jparams, tparams = mamba
    jcfg, tcfg = jcfg.with_(parallel_prefill=parallel), tcfg.with_(parallel_prefill=parallel)
    toks = _tokens(9, (2, S))
    kw = dict(max_len=24, cache_dtype="float32")
    want = jengine.generate(jax_build_model(jcfg), jparams, {"tokens": jnp.asarray(toks)},
                            JaxServeConfig(**kw), max_new=6)
    got = tengine.generate(build_model(tcfg), tparams, {"tokens": torch.from_numpy(toks)},
                           ServeConfig(**kw), max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3


def _pool_requests(seed, n=5):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, tokens=rng.integers(0, 64, int(rng.integers(3, 12))).astype(np.int32),
                 max_new=int(rng.integers(3, 8))) for i in range(n)]


def _pool_matches_solo_and_jax(jcfg, tcfg, jparams, tparams, prefill_chunk, monkeypatch,
                               seed=0):
    """The slot pool over 5 ragged requests (bursts of 4, a dense fp32
    cache): with 3 slots, so that freed slots are reused, every request's
    greedy tokens equal those of a solo ``generate`` of its prompt alone;
    with a slot each, they equal the JAX engine's (its ``jnp.asarray``
    made to copy).  The JAX engine is not held with slots reused: under a
    loaded CPU its zamba2 pool gives a reused slot's request other tokens
    from run to run (one read 30 for 32 at its third token, against its
    own solo run; ROADMAP queue 3)."""
    reqs = _pool_requests(seed)
    kw = dict(max_len=32, cache_dtype="float32", scheduler="continuous", decode_burst=4,
              prefill_chunk=prefill_chunk, audit=True)
    tmodel = build_model(tcfg)

    def pool(n_slots):
        eng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(n_slots=n_slots, **kw),
                                    device="cpu")
        done = eng.run([tsched.Request(**r) for r in reqs])
        assert sorted(done) == list(range(len(reqs))) and all(c.ok for c in done.values())
        assert eng.stats["admitted"] == len(reqs)
        return done, eng.stats["prefills"]
    tdone, prefills = pool(3)
    assert prefills >= 2                 # freed slots were refilled
    for r in reqs:
        solo = tengine.generate(tmodel, tparams, {"tokens": torch.from_numpy(r["tokens"][None])},
                                ServeConfig(max_len=32, cache_dtype="float32"),
                                max_new=r["max_new"], device="cpu")
        assert solo[0].tolist() == tdone[r["rid"]].tokens, r["rid"]
    monkeypatch.setattr(jsched, "jnp", _CopyingJnp())
    jdone = jsched.SlotPoolEngine(jax_build_model(jcfg), jparams,
                                  JaxServeConfig(n_slots=len(reqs), **kw)).run(
        [jsched.Request(**r) for r in reqs])
    wide, _ = pool(len(reqs))
    for r in reqs:
        assert wide[r["rid"]].tokens == jdone[r["rid"]].tokens == tdone[r["rid"]].tokens, r["rid"]
    return tdone


@pytest.mark.parametrize("prefill_chunk", [4, 0])
def test_slot_pool_matches_solo_and_jax(mamba, prefill_chunk, monkeypatch):
    """``_pool_matches_solo_and_jax`` on mamba2: chunks of 4 lanes, and the
    whole prompt in one call.  A reused slot starts from fresh state: its
    tokens equal the solo run's."""
    tdone = _pool_matches_solo_and_jax(*mamba, prefill_chunk, monkeypatch)
    assert len({t for c in tdone.values() for t in c.tokens}) > 3


@pytest.mark.parametrize("what", ["paged", "spec"])
def test_recurrent_family_refuses_paged_and_spec(mamba, what):
    """``kv_layout="paged"`` and ``scheduler="spec"`` with a model that has
    no paged cache raise JAX's ``ValueError``, word for word; and the
    model's ``init_paged_cache`` is None, as in JAX."""
    jcfg, tcfg, jparams, tparams = mamba
    kw = (dict(kv_layout="paged") if what == "paged"
          else dict(scheduler="spec", kv_layout="dense"))
    with pytest.raises(ValueError) as want:
        jsched.SlotPoolEngine(jax_build_model(jcfg), jparams, JaxServeConfig(**kw))
    model = build_model(tcfg)
    with pytest.raises(ValueError) as got:
        tsched.SlotPoolEngine(model, tparams, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    assert model.init_paged_cache is None and jax_build_model(jcfg).init_paged_cache is None
    with pytest.raises(ValueError) as want:
        jtransformer.init_paged_cache(jparams, jcfg, 4, 4, "float32")
    with pytest.raises(ValueError) as got:
        transformer.init_paged_cache(tparams, tcfg, 4, 4, "float32", device="cpu")
    assert str(got.value) == str(want.value)


def test_slot_reset_and_scrub_touch_only_their_rows(mamba):
    """The pool's recurrent state: a slot admitted after another request
    starts from ``init_cache``'s rows, and the quarantine scrub rewrites
    every leaf of its slot (NaN planted in slot 1's state and conv tail),
    its neighbours' bits unchanged."""
    _, tcfg, _, tparams = mamba
    eng = tsched.SlotPoolEngine(build_model(tcfg), tparams,
                                ServeConfig(max_len=16, cache_dtype="float32", n_slots=3),
                                device="cpu")
    for leaf in tree_leaves(eng.cache):
        leaf.copy_(torch.randn(leaf.shape))
        leaf[:, 1] = float("nan")
    before = [t.clone() for t in tree_leaves(eng.cache)]
    eng._scrub_dense_slot(1)
    for a, b in zip(before, tree_leaves(eng.cache)):
        assert not b[:, 1].any()
        assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])
    eng.admit([tsched.Request(rid=0, tokens=np.arange(3, dtype=np.int32), max_new=2)], 0.0)
    for a, b in zip(before, tree_leaves(eng.cache)):
        assert not b[:, :2].any() and torch.equal(a[:, 2], b[:, 2])


def test_launchers_run_mamba2_on_cpu(tmp_path, capsys):
    """``--arch mamba2-370m`` through both launchers with the JAX launchers'
    flags: a lockstep generate, a continuous run, 2 training steps."""
    from repro_torch.launch import serve, train
    serve.main(["--arch", MAMBA, "--smoke", "--device", "cpu", "--batch", "2",
                "--prefill", "8", "--max-new", "3"])
    serve.main(["--arch", MAMBA, "--smoke", "--device", "cpu", "--scheduler", "continuous",
                "--batch", "3", "--prefill", "8", "--max-new", "3", "--n-slots", "2",
                "--prefill-chunk", "4"])
    train.main(["--arch", MAMBA, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "stats:" in out and "[1]" in out and "final loss:" in out
