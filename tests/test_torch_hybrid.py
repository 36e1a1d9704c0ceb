"""The port's hybrid family (zamba2-7b) against the JAX package's, on the CPU.

zamba2-7b's smoke config (4 Mamba2 layers of d_model 64, the shared
attention block after layers 1 and 3 with 4 / 4 heads of 16, d_ff 128,
vocab 64, fp32 compute) through the weights bridge, the Mamba2 blocks'
``out_proj`` scaled by 8 as in ``tests/test_torch_ssm.py``, whose helpers
this module shares.  Kernel mode runs the JAX package's Pallas kernels in
interpret mode and the port's plain versions of its CUDA kernels (3-6 on
this family's path).  Held against JAX: lm_loss and its gradients under
each remat policy, in the unfused and kernel modes, at HYFT16 and HYFT32;
``decode_step`` over fp32 and fp2fx8 caches with a ragged position vector
and a write mask; ``prefill`` (sequential, parallel, ragged),
``prefill_chunk``, ``generate``, and the slot pool in chunked and
whole-prompt admission.  Also: one K per invocation in the shared cache,
the pool's refusals and its scrub, a checkpoint of the smoke model
crossing between the packages bit for bit, and the launchers.

Tolerances: ``tests/test_torch_ssm.py``'s (1e-4 of the largest for
logits, caches and hidden states; 1e-5 relative for the loss, 1e-3 of
the largest |g| per gradient leaf); fp2fx8 raws equal; tokens equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtransformer
from repro.models.layers import unbox
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import ServeConfig
from repro_torch.models import build_model, transformer
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_leaves
from test_torch_ssm import (GRAD_TOL, LOSS_RTOL, S, _close, _close_cache, _configs,
                            _pool_matches_solo_and_jax, _prefill_both, _tokens, _weights)

ZAMBA = "zamba2-7b"


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def zamba():
    """zamba2 smoke, hyft16, kernel mode; JAX weights bridged."""
    jcfg, tcfg = _configs(ZAMBA, softmax_impl="hyft16", attn_mode="kernel")
    jparams, tparams = _weights(jcfg)
    return jcfg, tcfg, jparams, tparams


def _with(z, **kw):
    jcfg, tcfg, jparams, tparams = z
    return jcfg.with_(**kw), tcfg.with_(**kw), jparams, tparams


def test_init_matches_jax():
    """The port's init has JAX's tree: the Mamba2 blocks stacked on the layer
    axis, and ``shared_attn`` an attention block's tree without it; every
    leaf's shape and dtype equal at bf16 params."""
    jcfg, cfg = _configs(ZAMBA, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = build_model(cfg).init(0, device="cpu")
    assert sorted(got) == sorted(want) == ["blocks", "embed", "final_norm", "shared_attn",
                                           "unembed"]
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), jax.tree_util.keystr(path)
    assert got["shared_attn"]["attn"]["wq"].shape == (64, 4, 16)
    assert transformer.hybrid_inv_idx(cfg) == [-1, 0, 0, 1]
    assert transformer.hybrid_attn_flags(cfg) == [bool(f) for f in
                                                  jtransformer._hybrid_attn_flags(jcfg)]


_JAX_GRADS: dict = {}


def _jax_grads(jcfg, jparams, batch):
    """JAX's loss, gradients and hidden states (remat "none"), one jitted
    call per (softmax, mode)."""
    key = (jcfg.softmax_impl, jcfg.attn_mode)
    if key not in _JAX_GRADS:
        jm = jax_build_model(jcfg)
        jb = jax.tree.map(jnp.asarray, batch)

        def run(p):
            (loss, _), grads = jax.value_and_grad(
                lambda q: jm.loss(q, jb, remat="none"), has_aux=True)(p)
            return loss, grads, jtransformer.forward(p, jb["tokens"], jcfg, remat="none")[0]
        loss, grads, hidden = jax.jit(run)(jparams)
        _JAX_GRADS[key] = float(loss), jax.tree.map(np.asarray, grads), np.asarray(hidden)
    return _JAX_GRADS[key]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("softmax", ["hyft16", "hyft32"])
def test_lm_loss_and_grads_match_jax(zamba, softmax, attn_mode, remat):
    """lm_loss and every gradient leaf (the shared block's summed over its
    two invocations) against JAX's (remat "none"), under each remat policy
    (the shared block its own remat region); the three give the same bits.
    The forward's hidden states too."""
    jcfg, tcfg, jparams, tparams = _with(zamba, softmax_impl=softmax, attn_mode=attn_mode)
    toks = _tokens(3, (2, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, wgrads, hidden = _jax_grads(jcfg, jparams, batch)
    model = build_model(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {p: grads_of(lambda q, b: model.loss(q, b, remat=p), tparams, tbatch)
            for p in ("none", remat)}
    loss, _, grads = runs[remat]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(wgrads)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads["shared_attn"]))
    assert torch.equal(runs["none"][0], loss)
    for a, b in zip(tree_leaves(runs["none"][2]), tree_leaves(grads)):
        assert torch.equal(a, b)
    if remat == "none":
        with torch.no_grad():
            ht, _ = transformer.forward(tparams, tbatch["tokens"], tcfg, remat="none")
        _close(hidden, ht)


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_decode_step_matches_jax(zamba, cache_dtype, attn_mode):
    """From a sequential prefill of 8 tokens, a decode step at the ragged
    positions (8, 5) with row 1's writes masked: the logits and every cache
    leaf (the stacked shared cache, each invocation's slice written in
    place) against JAX's, row 1 unchanged; kernel mode through kernel 6's
    plain version, reading the fp2fx8 raws."""
    jcfg, tcfg, jparams, tparams = _with(zamba, attn_mode=attn_mode)
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


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("kind", ["sequential", "parallel", "ragged"])
def test_prefill_matches_jax(zamba, kind, attn_mode):
    """``model.prefill`` of 2 x 16 tokens, as in ``tests/test_torch_ssm.py``:
    the parallel prefill runs the shared block over the whole prompt
    (kernel 3's plain version in kernel mode), the sequential one a decode
    step per token (kernel 6's); the logits and every cache leaf."""
    par = kind == "parallel"
    jcfg, tcfg, jparams, tparams = _with(zamba, parallel_prefill=par, attn_mode=attn_mode)
    lengths = np.array([16, 11], np.int32) if kind == "ragged" else None
    (jl, jc), (tl, tc) = _prefill_both(jcfg, tcfg, jparams, tparams, _tokens(5, (2, S)),
                                       lengths)
    _close(jl, tl)
    _close_cache(jc, tc)


def test_prefill_chunk_matches_jax(zamba):
    """``prefill_chunk`` through gated decode steps: 2 x 8 lanes at starts
    (2, 0) after a first chunk of 2 tokens in row 0, lengths (8, 5), row 1's
    first call masked: the logits of the real lanes and every cache leaf."""
    jcfg, tcfg, jparams, tparams = zamba
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    first, toks, lengths = _tokens(10, (2, 2)), _tokens(8, (2, 8)), np.array([8, 5], np.int32)
    gate, start = np.array([True, False]), np.array([2, 0], np.int32)
    jc = jm.init_cache(jparams, 2, 16, "float32")
    _, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(first), jnp.zeros((2,), jnp.int32),
                             write_mask=jnp.asarray(gate))
    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks), jnp.asarray(start),
                              lengths=jnp.asarray(lengths))
    with torch.no_grad():
        tc = tm.init_cache(tparams, 2, 16, "float32", device="cpu")
        _, tc = tm.prefill_chunk(tparams, tc, torch.from_numpy(first),
                                 torch.zeros(2, dtype=torch.int32),
                                 write_mask=torch.from_numpy(gate))
        tl, tc = tm.prefill_chunk(tparams, tc, torch.from_numpy(toks), torch.from_numpy(start),
                                  lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):
        _close(np.asarray(jl)[b, :n], tl[b, :n])
    _close_cache(jc, tc)


@pytest.mark.parametrize("parallel,cache_dtype", [(False, "float32"), (True, "fp2fx8")])
def test_generate_matches_jax(zamba, parallel, cache_dtype):
    """``generate`` through ``model.prefill`` and the decode steps: greedy
    tokens of 2 x 16 prompts, 6 new each, equal JAX's."""
    jcfg, tcfg, jparams, tparams = _with(zamba, parallel_prefill=parallel)
    toks = _tokens(9, (2, S))
    kw = dict(max_len=24, cache_dtype=cache_dtype, attn_mode="kernel")
    want = jengine.generate(jax_build_model(jcfg), jparams, {"tokens": jnp.asarray(toks)},
                            JaxServeConfig(**kw), max_new=6)
    got = tengine.generate(build_model(tcfg), tparams, {"tokens": torch.from_numpy(toks)},
                           ServeConfig(**kw), max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3


@pytest.mark.parametrize("prefill_chunk", [4, 0])
def test_slot_pool_matches_solo_and_jax(zamba, prefill_chunk, monkeypatch):
    """``tests/test_torch_ssm.py``'s pool check on zamba2 (kernel mode): with
    slots reused the pool's tokens equal each prompt's solo run, with a
    slot a request the JAX engine's too."""
    tdone = _pool_matches_solo_and_jax(*zamba, prefill_chunk, monkeypatch, seed=1)
    assert len({t for c in tdone.values() for t in c.tokens}) > 3


@pytest.mark.parametrize("what", ["paged", "spec"])
def test_hybrid_refuses_paged_and_spec(zamba, what):
    """JAX's ``ValueError``s, word for word."""
    jcfg, tcfg, jparams, tparams = zamba
    kw = (dict(kv_layout="paged") if what == "paged"
          else dict(scheduler="spec", kv_layout="dense"))
    with pytest.raises(ValueError) as want:
        jsched.SlotPoolEngine(jax_build_model(jcfg), jparams, JaxServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        tsched.SlotPoolEngine(build_model(tcfg), tparams, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_shared_cache_holds_one_k_per_invocation(zamba):
    """``tests/test_models.py``'s case on the port: the shared cache is
    stacked on an invocation axis of n_layers // attn_every, and one
    decode step writes a distinct K into each invocation's slice, equal to
    JAX's."""
    jcfg, tcfg, jparams, tparams = zamba
    n = transformer.hybrid_n_invocations(tcfg)
    assert n == tcfg.n_layers // tcfg.attn_every == 2
    model = build_model(tcfg)
    cache = model.init_cache(tparams, 2, 8, "float32", device="cpu")
    assert cache["shared_attn"]["k"].shape == (n, 2, 4, 8, 16)
    tok = np.ones((2, 1), np.int32)
    with torch.no_grad():
        _, cache = model.decode_step(tparams, cache, torch.from_numpy(tok), 0)
    _, jc = jax_build_model(jcfg).decode_step(
        jparams, jax_build_model(jcfg).init_cache(jparams, 2, 8, "float32"),
        jnp.asarray(tok), 0)
    k = cache["shared_attn"]["k"][:, :, :, 0]
    assert not torch.allclose(k[0], k[1])
    _close(np.asarray(jc["shared_attn"]["k"]), cache["shared_attn"]["k"])


def test_scrub_resets_state_and_shared_cache(zamba):
    """The quarantine scrub of a hybrid slot: a NaN planted in slot 1's SSM
    state, conv tail and shared K/V (fp2fx8 scales too) is gone after it,
    every leaf of the row equal to ``init_cache``'s, and slots 0 and 2
    keep their bits."""
    _, tcfg, _, tparams = zamba
    eng = tsched.SlotPoolEngine(build_model(tcfg), tparams,
                                ServeConfig(max_len=16, cache_dtype="fp2fx8", n_slots=3),
                                device="cpu")
    assert sorted(eng.cache) == ["blocks", "shared_attn"]
    for leaf in tree_leaves(eng.cache):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape))
            leaf[:, 1] = float("nan")
        else:
            leaf.copy_(torch.randint(-127, 128, leaf.shape))
    before = [t.clone() for t in tree_leaves(eng.cache)]
    eng._scrub_dense_slot(1)
    for a, b in zip(before, tree_leaves(eng.cache)):
        assert not b[:, 1].any()
        assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """The zamba2 smoke model's bf16 params (fp32 ``A_log``, ``D``,
    ``dt_bias``; the shared block's tree): the port's checkpoint restores
    into JAX bit for bit, and JAX's into the port."""
    jcfg, cfg = _configs(ZAMBA, param_dtype="bfloat16")
    params = build_model(cfg).init(0, device="cpu")
    ck.save(str(tmp_path / "port"), 3, params)
    want = jax.jit(lambda k: unbox(jax_build_model(jcfg).init(k)))(jax.random.PRNGKey(0))
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), want)
    got, step = jck.restore(str(tmp_path / "port"), 3, like)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), tree_leaves(params)):
        have = np.asarray(a).view(np.int16) if a.dtype == jnp.bfloat16 else np.asarray(a)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(have, _bits(b).numpy())
    jck.save(str(tmp_path / "jax"), 5, want)
    back, step = ck.restore(str(tmp_path / "jax"), 5, params)
    assert step == 5
    for a, w in zip(tree_leaves(back), jax.tree.leaves(want)):
        w = np.asarray(w)
        expect = w.view(np.int16) if w.dtype == ml_dtypes.bfloat16 else w
        assert str(a.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_bits(a).numpy(), expect)


def test_launchers_run_zamba2_on_cpu(tmp_path, capsys):
    """``--arch zamba2-7b`` through both launchers in kernel mode: a lockstep
    generate, a continuous run over fp2fx8, 2 training steps."""
    from repro_torch.launch import serve, train
    serve.main(["--arch", ZAMBA, "--smoke", "--device", "cpu", "--batch", "2",
                "--prefill", "8", "--max-new", "3", "--attn-mode", "kernel"])
    serve.main(["--arch", ZAMBA, "--smoke", "--device", "cpu", "--scheduler", "continuous",
                "--batch", "3", "--prefill", "8", "--max-new", "3", "--n-slots", "2",
                "--prefill-chunk", "4", "--attn-mode", "kernel", "--cache-dtype", "fp2fx8"])
    train.main(["--arch", ZAMBA, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq", "16", "--attn-mode", "kernel",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "stats:" in out and "[1]" in out and "final loss:" in out
