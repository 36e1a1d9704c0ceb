"""The port's encoder-decoder family (whisper-medium) against the JAX
package's, on the CPU.

whisper-medium's smoke config (2 encoder and 2 decoder layers of d_model
64, 4 / 4 heads of 16, d_ff 128, LayerNorm, GELU, 8 frames of 16, vocab 64,
fp32 compute) through the weights bridge, the decoder MLPs' ``w_down``
scaled by 8 in both packages so that greedy tokens do not echo the prompt
(tied embeddings at unit scale dominate a weak block).  Frames are numpy
draws from a seed.  Kernel mode runs the JAX package's Pallas kernels in
interpret mode and the port's plain versions of its CUDA kernels (3-6 on
this family's path).  Held against JAX: the init tree, ``encode``, the loss
and its gradients under each remat policy in the unfused and kernel modes
at HYFT16 and HYFT32, ``decode_step`` over fp32 and fp2fx8 caches with a
ragged position vector and a write mask, ``prefill`` (sequential, parallel,
ragged, and over a bf16 cache, where the two prefills read the memory in
different dtypes), ``prefill_chunk``, ``generate``, and the slot pool in
chunked and whole-prompt admission.  At ``frontend_len=200`` the keys of
the encoder and of the cross-attention pad to 256, as the real 1,500 pad
to 1,536.  Also: the decode step's cross-attention runs the flash forward
at Sq = 1 (not split-K) and computes the cross K/V from the memory anew;
the pool's scrub, frames on requeue, the mixed-group, paged and spec
refusals, and the serving launcher.

Tolerances: ``tests/test_torch_ssm.py``'s (1e-4 of the largest for
logits, caches and hidden states; 1e-5 relative for the loss, 1e-3 of
the largest |g| per gradient leaf); fp2fx8 raws equal; tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.models.layers import unbox
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model, encdec
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_leaves
from test_torch_ssm import (BF16_RTOL, GRAD_TOL, LOSS_RTOL, _close, _close_cache, _configs,
                            _CopyingJnp, _tokens)

WHISPER = "whisper-medium"
S = 16                                    # prompt tokens
W_DOWN_SCALE = 8.0


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _weights(jcfg, seed=0):
    """JAX's init, the decoder MLPs' ``w_down`` scaled, and its bridge."""
    jparams = jax.jit(lambda k: unbox(jax_build_model(jcfg).init(k)))(jax.random.PRNGKey(seed))
    mlp = jparams["dec_blocks"]["mlp"]
    jparams["dec_blocks"]["mlp"] = dict(mlp, w_down=mlp["w_down"] * W_DOWN_SCALE)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _frames(seed, batch, cfg):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def whisper():
    """whisper smoke, hyft16, kernel mode; JAX weights bridged."""
    jcfg, tcfg = _configs(WHISPER, softmax_impl="hyft16", attn_mode="kernel")
    jparams, tparams = _weights(jcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def whisper200():
    """The same at ``frontend_len=200``: keys pad to 256 in kernel mode."""
    jcfg, tcfg = _configs(WHISPER, softmax_impl="hyft16", attn_mode="kernel",
                          frontend_len=200)
    jparams, tparams = _weights(jcfg)
    return jcfg, tcfg, jparams, tparams


def _with(w, **kw):
    jcfg, tcfg, jparams, tparams = w
    return jcfg.with_(**kw), tcfg.with_(**kw), jparams, tparams


def _batch(jcfg, B=2, seed=3, S_=S):
    return {"tokens": _tokens(seed, (B, S_)), "frames": _frames(seed, B, jcfg)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# config, init, encode
# --------------------------------------------------------------------------


def test_config_matches_jax():
    """The config's fields equal the JAX config's, and so do the smoke
    configs' (2 + 2 layers, 8 frames of 16)."""
    cfg, jcfg = get_config(WHISPER), jax_get_config(WHISPER)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sm = smoke_config(cfg)
    assert dataclasses.asdict(sm) == dataclasses.asdict(jax_smoke_config(jcfg))
    assert (sm.enc_layers, sm.frontend_len, sm.frontend_dim) == (2, 8, 16)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_matches_jax(param_dtype):
    """JAX's tree: ``frontend_proj``, ``enc_blocks`` and ``dec_blocks``
    stacked on their layer axes (the decoder's with ``cross`` and
    ``pre_cross``), ``enc_norm``, ``embed``, ``final_norm``, no unembed;
    every leaf's shape and dtype equal; the random leaves' spread within
    10% of JAX's scale."""
    jcfg, cfg = _configs(WHISPER, param_dtype=param_dtype)
    want = jax.eval_shape(lambda: unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = build_model(cfg).init(0, device="cpu")
    assert sorted(got) == sorted(want) == ["dec_blocks", "embed", "enc_blocks", "enc_norm",
                                           "final_norm", "frontend_proj"]
    assert sorted(got["dec_blocks"]) == ["attn", "cross", "mlp", "norms"]
    assert sorted(got["dec_blocks"]["norms"]) == ["pre_attn", "pre_cross", "pre_mlp"]
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), jax.tree_util.keystr(path)
    for leaf, scale in ((got["frontend_proj"]["w"], 16 ** -0.5),
                        (got["dec_blocks"]["cross"]["wq"], 64 ** -0.5),
                        (got["enc_blocks"]["mlp"]["w_down"], 128 ** -0.5)):
        assert abs(float(leaf.float().std()) / scale - 1) < 0.1


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("frontend_len", [8, 200])
def test_encode_matches_jax(whisper, whisper200, attn_mode, frontend_len):
    """``encode`` of 2 x frames against JAX's, both modes; at 200 frames the
    kernel mode's keys pad to 256 under a mask in both packages."""
    jcfg, tcfg, jparams, tparams = _with(whisper if frontend_len == 8 else whisper200,
                                         attn_mode=attn_mode)
    fr = _frames(1, 2, jcfg)
    want = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg, remat="none"))(jparams,
                                                                            jnp.asarray(fr))
    with torch.no_grad():
        got = build_model(tcfg).encode(tparams, torch.from_numpy(fr))
    assert tuple(got.shape) == (2, frontend_len, 64)
    _close(want, got)


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

_JAX_GRADS: dict = {}


def _jax_grads(jcfg, jparams, batch):
    """JAX's loss and gradients (remat "none"), one jitted call per (softmax,
    mode)."""
    key = (jcfg.softmax_impl, jcfg.attn_mode)
    if key not in _JAX_GRADS:
        jm = jax_build_model(jcfg)
        jb = _jb(batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: jm.loss(q, jb, remat="none"), has_aux=True))(jparams)
        _JAX_GRADS[key] = float(loss), jax.tree.map(np.asarray, grads)
    return _JAX_GRADS[key]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("softmax", ["hyft16", "hyft32"])
def test_loss_and_grads_match_jax(whisper, softmax, attn_mode, remat):
    """The loss and every gradient leaf (the encoder's through the
    cross-attention) against JAX's (remat "none"), under each remat policy;
    the three policies give the same bits."""
    jcfg, tcfg, jparams, tparams = _with(whisper, softmax_impl=softmax, attn_mode=attn_mode)
    toks = _tokens(3, (2, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "frames": _frames(3, 2, jcfg)}
    want, wgrads = _jax_grads(jcfg, jparams, batch)
    model = build_model(tcfg)
    tbatch = _tb(batch)
    runs = {p: grads_of(lambda q, b: model.loss(q, b, remat=p), tparams, tbatch)
            for p in ("none", remat)}
    loss, metrics, grads = runs[remat]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    assert float(metrics["aux"]) == 0.0
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(wgrads)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads["enc_blocks"]))
    assert torch.equal(runs["none"][0], loss)
    for a, b in zip(tree_leaves(runs["none"][2]), tree_leaves(grads)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# serving: decode step, prefill, chunk prefill, generate
# --------------------------------------------------------------------------


def _prefill_both(jcfg, tcfg, jparams, tparams, batch, cache_dtype="float32", max_len=24):
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    B = batch["tokens"].shape[0]
    jl, jc, jn = jm.prefill(jparams, jm.init_cache(jparams, B, max_len, cache_dtype), _jb(batch))
    with torch.no_grad():
        tl, tc, tn = tm.prefill(tparams, tm.init_cache(tparams, B, max_len, cache_dtype,
                                                       device="cpu"), _tb(batch))
    assert tn == int(jn) == batch["tokens"].shape[1]
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("frontend_len", [8, 200])
def test_decode_step_matches_jax(whisper, whisper200, cache_dtype, frontend_len):
    """From JAX's cache after a sequential prefill of 8 tokens, bridged, a
    decode step at the ragged positions (8, 5) with row 1's write masked:
    the logits and every cache leaf (row 1's self KV unchanged, the memory
    untouched) against JAX's; at 200 frames the cross-attention's keys pad
    to 256.  The step starts from JAX's cache so that the comparison holds
    the step alone: after two layers of Hyft attention the packages' K/V
    are about 1e-5 apart, and an fp2fx8 raw at a rounding edge may then
    move by one (1 of 4,096 at 8 frames; ``test_prefill_matches_jax``
    holds the prefill itself).  That cache is filled in the unfused mode
    (the kernels' interpret mode would run 8 decode steps for it)."""
    jcfg, tcfg, jparams, tparams = whisper if frontend_len == 8 else whisper200
    jm = jax_build_model(jcfg.with_(attn_mode="unfused"))
    _, jc, _ = jm.prefill(jparams, jm.init_cache(jparams, 2, 16, cache_dtype),
                          _jb(_batch(jcfg, S_=8)))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    before = [t.clone() for t in tree_leaves(tc["self"])]
    mem = tc["memory"].clone()
    nxt, pos, wm = np.array([[3], [5]], np.int32), np.array([8, 5], np.int32), [True, False]
    jl, jc = jax_build_model(jcfg).decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos),
                                               write_mask=jnp.asarray(wm))
    assert jcfg.attn_mode == tcfg.attn_mode == "kernel"
    with torch.no_grad():
        tl, tc = build_model(tcfg).decode_step(tparams, tc, torch.from_numpy(nxt),
                                               torch.from_numpy(pos),
                                               write_mask=torch.tensor(wm))
    _close(jl, tl)
    _close_cache(jc, tc)
    for a, b in zip(before, tree_leaves(tc["self"])):
        assert torch.equal(a[:, 1], b[:, 1]) and not torch.equal(a[:, 0], b[:, 0])
    assert torch.equal(mem, tc["memory"])


def test_cross_attention_is_the_flash_forward_at_sq_1(whisper200, monkeypatch):
    """A kernel-mode decode step runs, per decoder layer, split-K decode once
    (the self-attention) and the flash forward once at Sq = 1 over the
    memory's 200 keys padded to 256 in blocks of 128 (the cross-attention,
    as JAX's ``attention_fwd(causal=False)``; split-K would take one split
    of 256 keys, other arithmetic).  Its cross K/V come from the memory
    every step: a changed memory moves the next step's logits."""
    jcfg, tcfg, jparams, tparams = whisper200
    model = build_model(tcfg)
    cache = model.init_cache(tparams, 2, 16, "float32", device="cpu")
    cache["memory"].copy_(torch.from_numpy(np.array(
        jencdec.encode(jparams, jnp.asarray(_frames(4, 2, jcfg)), jcfg, remat="none"))))
    calls = {"flash": [], "splitk": 0}
    flash, splitk = fa._flash_fwd_plain, fa.splitk_attention_plain

    def counted_flash(q3, k3, *args, **kw):
        calls["flash"].append((q3.shape[1], k3.shape[1], kw["bk"]))
        return flash(q3, k3, *args, **kw)

    def counted_splitk(*args, **kw):
        calls["splitk"] += 1
        return splitk(*args, **kw)
    monkeypatch.setattr(fa, "_flash_fwd_plain", counted_flash)
    monkeypatch.setattr(fa, "splitk_attention_plain", counted_splitk)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    with torch.no_grad():
        first, _ = model.decode_step(tparams, cache, tok, 0)
        assert calls == {"flash": [(1, 256, 128)] * tcfg.n_layers, "splitk": tcfg.n_layers}
        assert sorted(cache) == ["memory", "self"]
        cache["self"]["k"].zero_()
        cache["self"]["v"].zero_()
        again, _ = model.decode_step(tparams, cache, tok, 0)
        cache["memory"].mul_(0.5)
        moved, _ = model.decode_step(tparams, cache, tok, 0)
    assert torch.equal(first, again) and not torch.equal(first, moved)


@pytest.mark.parametrize("kind", ["sequential", "parallel", "ragged", "ragged-parallel"])
def test_prefill_matches_jax(whisper, kind):
    """``model.prefill`` of 2 x 16 tokens: the token-by-token prefill after
    the memory is installed, the parallel prefill, and ragged prompts
    (lengths 16 and 11) through each: the logits (each row's last real
    position) and every cache leaf against JAX's, the self KV at the valid
    positions.  At HYFT32: under HYFT16 the two packages' fp32 sums, a few
    ulps apart, put a score of the first layer's self-attention on either
    side of a raw, and the cross-attention and the scaled MLP carry that to
    3e-4 of the largest K in the second layer (measured; the loss, the
    decode step and the tokens hold HYFT16)."""
    par = kind.endswith("parallel")
    jcfg, tcfg, jparams, tparams = _with(whisper, parallel_prefill=par, softmax_impl="hyft32")
    batch = _batch(jcfg, seed=5)
    lengths = None
    if kind.startswith("ragged"):
        lengths = np.array([16, 11], np.int32)
        batch["lengths"] = lengths
    (jl, jc), (tl, tc) = _prefill_both(jcfg, tcfg, jparams, tparams, batch)
    assert tuple(tl.shape) == (2, 1, 64)
    _close(jl, tl)
    _close(jc["memory"], tc["memory"])
    for name in ("k", "v"):
        want, got = np.asarray(jc["self"][name]), tc["self"][name]
        for b, n in enumerate(lengths if lengths is not None else (S, S)):
            _close(want[:, b, :, :n], got[:, b, :, :n])


def test_prefills_read_the_memory_in_their_dtypes(whisper):
    """Over a bf16 cache at fp32 compute, as in JAX: the parallel prefill
    attends to the encoder's fp32 output (its logits equal, bit for bit,
    those over an fp32 cache) and stores it rounded; the sequential prefill
    stores the rounded memory first and its decode steps read that (its
    logits move with the cache dtype).  Both against JAX's at the repo's
    bf16 tolerance (``tests/test_torch_ssm.py``'s 2**-6 of the largest: a
    memory a few ulps apart in fp32 rounds to bf16 one ulp apart here and
    there)."""
    jcfg, tcfg, jparams, tparams = _with(whisper, softmax_impl="hyft32")
    batch = _batch(jcfg, seed=6)
    with torch.no_grad():
        mem = build_model(tcfg).encode(tparams, torch.from_numpy(batch["frames"]))
    logits = {}
    for par in (False, True):
        jc_, tc_ = jcfg.with_(parallel_prefill=par), tcfg.with_(parallel_prefill=par)
        (jl, jc), (tl, tc) = _prefill_both(jc_, tc_, jparams, tparams, batch, "bfloat16")
        _close(jl, tl, BF16_RTOL)
        _close(jc["memory"], tc["memory"], BF16_RTOL)
        logits[par, "bfloat16"] = tl
        model = build_model(tc_)
        with torch.no_grad():
            logits[par, "float32"], tc32, _ = model.prefill(
                tparams, model.init_cache(tparams, 2, 24, "float32", device="cpu"), _tb(batch))
        for c, dt in ((tc, torch.bfloat16), (tc32, torch.float32)):
            assert torch.equal(c["memory"], mem.to(dt))
    assert torch.equal(logits[True, "float32"], logits[True, "bfloat16"])
    assert not torch.equal(logits[False, "float32"], logits[False, "bfloat16"])


def test_prefill_chunk_matches_jax(whisper):
    """``prefill_chunk`` (one gated decode step a lane, over the installed
    memory): 2 x 8 lanes at starts (0, 0), lengths (8, 5), against JAX's,
    the logits of each row's real lanes and every cache leaf; two chunks of
    4 give the bits of one chunk of 8."""
    jcfg, tcfg, jparams, tparams = whisper
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    toks, lengths = _tokens(8, (2, 8)), np.array([8, 5], np.int32)
    mem = jencdec.encode(jparams, jnp.asarray(_frames(8, 2, jcfg)), jcfg, remat="none")
    jc = dict(jm.init_cache(jparams, 2, 16, "float32"), memory=mem)
    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks), jnp.zeros((2,), jnp.int32),
                              lengths=jnp.asarray(lengths))

    def fresh():
        c = tm.init_cache(tparams, 2, 16, "float32", device="cpu")
        c["memory"].copy_(torch.from_numpy(np.array(mem)))
        return c
    start = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        tl, tc = tm.prefill_chunk(tparams, fresh(), torch.from_numpy(toks), start,
                                  lengths=torch.from_numpy(lengths))
        l1, split = tm.prefill_chunk(tparams, fresh(), torch.from_numpy(toks[:, :4]), start)
        l2, split = tm.prefill_chunk(tparams, split, torch.from_numpy(toks[:, 4:]), start + 4,
                                     lengths=torch.tensor([4, 1]))
    assert tuple(tl.shape) == (2, 8, 64)
    for b, n in enumerate(lengths):
        _close(np.asarray(jl)[b, :n], tl[b, :n])
    _close_cache(jc, tc)
    assert torch.equal(torch.cat([l1, l2], 1)[0], tl[0])
    assert torch.equal(torch.cat([l1, l2], 1)[1, :5], tl[1, :5])
    for a, b in zip(tree_leaves(split), tree_leaves(tc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("parallel,cache_dtype", [(False, "float32"), (True, "fp2fx8"),
                                                  (False, "fp2fx8")])
def test_generate_matches_jax(whisper, parallel, cache_dtype):
    """``generate`` prefills through ``model.prefill`` with the frames (the
    sequential or the parallel prefill): the greedy tokens of 2 x 16
    prompts, 6 new each, equal JAX's."""
    jcfg, tcfg, jparams, tparams = _with(whisper, parallel_prefill=parallel)
    batch = _batch(jcfg, seed=9)
    kw = dict(max_len=24, cache_dtype=cache_dtype)
    want = jengine.generate(jax_build_model(jcfg), jparams, _jb(batch), JaxServeConfig(**kw),
                            max_new=6)
    got = tengine.generate(build_model(tcfg), tparams, _tb(batch), ServeConfig(**kw),
                           max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3


# --------------------------------------------------------------------------
# the slot pool
# --------------------------------------------------------------------------


def _requests(cfg, seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, tokens=rng.integers(0, 64, int(rng.integers(3, 12))).astype(np.int32),
                 max_new=int(rng.integers(3, 8)),
                 frames=rng.standard_normal((cfg.frontend_len, cfg.frontend_dim)
                                            ).astype(np.float32))
            for i in range(n)]


def _solo(model, params, r, cache_dtype="float32"):
    batch = {"tokens": torch.from_numpy(r["tokens"][None]),
             "frames": torch.from_numpy(r["frames"][None])}
    return tengine.generate(model, params, batch, ServeConfig(max_len=32, cache_dtype=cache_dtype),
                            max_new=r["max_new"], device="cpu")[0].tolist()


@pytest.mark.parametrize("prefill_chunk", [4, 0])
def test_slot_pool_matches_solo_and_jax(whisper, prefill_chunk, monkeypatch):
    """The slot pool over 5 ragged requests with frames (bursts of 4, a dense
    fp32 cache): with 3 slots, so that freed slots are reused (each
    admission encodes its rows and installs their memory), every request's
    greedy tokens equal a solo ``generate``'s; with a slot each they equal
    the JAX engine's (its ``jnp.asarray`` made to copy; not held with slots
    reused, ROADMAP queue 3)."""
    jcfg, tcfg, jparams, tparams = whisper
    reqs = _requests(tcfg)
    kw = dict(max_len=32, cache_dtype="float32", scheduler="continuous", decode_burst=4,
              prefill_chunk=prefill_chunk, audit=True)
    tmodel = build_model(tcfg)

    def pool(n_slots):
        eng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(n_slots=n_slots, **kw),
                                    device="cpu")
        done = eng.run([tsched.Request(**r) for r in reqs])
        assert sorted(done) == list(range(len(reqs))) and all(c.ok for c in done.values())
        return done, eng.stats
    tdone, st = pool(3)
    assert st["admitted"] == len(reqs) and st["prefills"] >= 2
    for r in reqs:
        assert _solo(tmodel, tparams, r) == tdone[r["rid"]].tokens, r["rid"]
    monkeypatch.setattr(jsched, "jnp", _CopyingJnp())
    jdone = jsched.SlotPoolEngine(jax_build_model(jcfg), jparams,
                                  JaxServeConfig(n_slots=len(reqs), **kw)).run(
        [jsched.Request(**r) for r in reqs])
    wide, _ = pool(len(reqs))
    for r in reqs:
        assert wide[r["rid"]].tokens == jdone[r["rid"]].tokens == tdone[r["rid"]].tokens, r["rid"]
    assert len({t for c in tdone.values() for t in c.tokens}) > 3


def test_scrub_resets_every_leaf_on_its_slot_axis(whisper):
    """The quarantine scrub rewrites slot 1's rows of every leaf along the
    leaf's own slot axis: axis 1 of the layer-stacked self KV, axis 0 of
    the memory (NaN planted in both); the neighbours' bits stay.  The next
    admission into the slot encodes its frames into that row."""
    jcfg, tcfg, jparams, tparams = whisper
    eng = tsched.SlotPoolEngine(build_model(tcfg), tparams,
                                ServeConfig(max_len=16, cache_dtype="fp2fx8", n_slots=3),
                                device="cpu")
    assert eng._cache_batch_axes() == [0, 1, 1, 1, 1]
    mem = eng.cache["memory"]
    for leaf in tree_leaves(eng.cache["self"]):
        leaf.copy_(torch.randint(-5, 5, leaf.shape) if leaf.dtype == torch.int8
                   else torch.randn(leaf.shape))
        if leaf.is_floating_point():
            leaf[:, 1] = float("nan")
    mem.copy_(torch.randn(mem.shape))
    mem[1] = float("nan")
    before = [t.clone() for t in tree_leaves(eng.cache)]
    eng._scrub_dense_slot(1)
    for a, b, ax in zip(before, tree_leaves(eng.cache), eng._cache_batch_axes()):
        a, b = a.movedim(ax, 0), b.movedim(ax, 0)
        assert not b[1].any()
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    r = _requests(tcfg, seed=1, n=1)[0]
    eng.admit([tsched.Request(**r)], 0.0)        # into slot 0, the first free
    want = jencdec.encode(jparams, jnp.asarray(r["frames"][None]), jcfg, remat="none")
    _close(np.asarray(want)[0], mem[0])
    assert not mem[1].any() and torch.equal(mem[2], before[0][2])


def test_quarantine_requeues_with_the_frames(whisper, monkeypatch):
    """A request whose first burst goes non-finite is requeued with its
    frames: re-admitted, it is encoded again, and its tokens equal a solo
    run's; the requeued ``Request`` carries the same frames."""
    jcfg, tcfg, jparams, tparams = whisper
    model = build_model(tcfg)
    r = _requests(tcfg, seed=2, n=1)[0]
    eng = tsched.SlotPoolEngine(model, tparams, ServeConfig(
        max_len=32, cache_dtype="float32", scheduler="continuous", decode_burst=4,
        n_slots=2), device="cpu")
    seen, requeue = [], eng._requeue
    burst, poisoned = eng._burst, []

    def poison_once(params, cache, *args):
        out = burst(params, cache, *args)
        if not poisoned:
            poisoned.append(True)
            out[1][:] = False                    # every step's logits non-finite
        return out

    def spy(s, now):
        ok = requeue(s, now)
        seen.append(eng._queue[0])
        return ok
    eng._burst = poison_once
    monkeypatch.setattr(eng, "_requeue", spy)
    done = eng.run([tsched.Request(**r)])
    assert eng.stats["quarantines"] == 1 and eng.stats["admitted"] == 1
    assert len(seen) == 1 and seen[0].frames is r["frames"] and seen[0].resume
    assert done[0].ok and done[0].tokens == _solo(model, tparams, r)


def test_mixed_group_and_paged_and_spec_refusals(whisper):
    """An admitted group where some requests carry frames and some do not
    raises JAX's ``ValueError``, word for word; ``kv_layout="paged"`` and
    ``scheduler="spec"`` raise JAX's refusals; ``init_paged_cache`` is
    None in both packages."""
    jcfg, tcfg, jparams, tparams = whisper
    reqs = _requests(tcfg, n=2)
    reqs[1]["frames"] = None
    msgs = []
    for eng, req in ((jsched.SlotPoolEngine(jax_build_model(jcfg), jparams,
                                            JaxServeConfig(n_slots=2, max_len=32)),
                      jsched.Request),
                     (tsched.SlotPoolEngine(build_model(tcfg), tparams,
                                            ServeConfig(n_slots=2, max_len=32),
                                            device="cpu"), tsched.Request)):
        with pytest.raises(ValueError) as err:
            eng.admit([req(**r) for r in reqs], 0.0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "mixed group" in msgs[1]
    for kw in (dict(kv_layout="paged"), dict(scheduler="spec", kv_layout="dense")):
        with pytest.raises(ValueError) as want:
            jsched.SlotPoolEngine(jax_build_model(jcfg), jparams, JaxServeConfig(**kw))
        with pytest.raises(ValueError) as got:
            tsched.SlotPoolEngine(build_model(tcfg), tparams, ServeConfig(**kw), device="cpu")
        assert str(got.value) == str(want.value)
    assert build_model(tcfg).init_paged_cache is None
    assert jax_build_model(jcfg).init_paged_cache is None
    assert build_model(get_config("qwen2-1.5b")).encode is None


def test_cache_bridge_and_launcher(whisper, capsys):
    """The cache bridge carries JAX's encdec cache (``self`` and
    ``memory``) key for key; ``--arch whisper-medium`` through the serving
    launcher at ``--device cpu``: a lockstep generate with the frames, and
    a continuous run."""
    jcfg, tcfg, jparams, tparams = whisper
    jc = jax_build_model(jcfg).init_cache(jparams, 2, 16, "fp2fx8")
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert sorted(tc) == ["memory", "self"] and tc["self"]["k"].dtype == torch.int8
    _close_cache(jc, tc)
    from repro_torch.launch import serve
    serve.main(["--arch", WHISPER, "--smoke", "--device", "cpu", "--batch", "2",
                "--prefill", "8", "--max-new", "3", "--attn-mode", "kernel"])
    serve.main(["--arch", WHISPER, "--smoke", "--device", "cpu", "--scheduler", "continuous",
                "--batch", "3", "--prefill", "8", "--max-new", "3", "--n-slots", "2",
                "--prefill-chunk", "4", "--cache-dtype", "fp2fx8"])
    out = capsys.readouterr().out
    assert "stats:" in out and "[1]" in out and "[2] prompt=" in out
