"""The port's VLM family (internvl2-1b) against the JAX package's, on the
CPU.

internvl2-1b's smoke config (2 layers of d_model 64, 4 / 2 heads of 16 with
QKV bias, a gated MLP of 128, RMSNorm, tied embeddings, 8 patches of 16,
vocab 64, fp32 compute) through the weights bridge, the blocks' matrices
scaled by 3 in both packages so that greedy tokens do not echo the prompt
(``tests/test_torch_scheduler.py``'s weights).  Patch embeddings are numpy
draws from a seed.  Kernel mode runs the JAX package's Pallas kernels in
interpret mode and the port's plain versions of its CUDA kernels (3-9 on
this family's path).  Held against JAX: the configs, the init tree
(``frontend_proj``), ``forward`` with the patches before the text,
``lm_loss`` on the text positions and its gradients under each remat
policy in both modes, ``generate`` (text-only, as the JAX engine serves
the VLM) over fp32 and fp2fx8 caches, the continuous slot pool over the
paged layout with the prefix cache, and the full config's GQA group of 7
(14 / 2 heads of 64, which no other config has) through prefill,
``prefill_chunk`` and ``decode_step``.

Tolerances: ``tests/test_torch_ssm.py``'s (1e-4 of the largest for
logits and hidden states; 1e-5 relative for the loss, 1e-3 of the largest
|g| per gradient leaf); tokens equal.
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
from repro.models import transformer as jtransformer
from repro.models.layers import unbox
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, transformer
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_leaves
from test_torch_ssm import GRAD_TOL, LOSS_RTOL, _close, _configs, _CopyingJnp, _tokens

VLM = "internvl2-1b"
S, P = 12, 8                              # text tokens, patches (the smoke frontend_len)


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _weights(jcfg, seed=0, scale=3.0):
    """JAX's init, the blocks' matrices scaled by ``scale``, and its bridge."""
    jparams = jax.jit(lambda k: unbox(jax_build_model(jcfg).init(k)))(jax.random.PRNGKey(seed))
    jparams["blocks"] = jax.tree.map(lambda x: x * scale if x.ndim >= 3 else x,
                                     jparams["blocks"])
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def vlm():
    """internvl2 smoke, hyft16, kernel mode; JAX weights bridged."""
    jcfg, tcfg = _configs(VLM, softmax_impl="hyft16", attn_mode="kernel")
    jparams, tparams = _weights(jcfg)
    return jcfg, tcfg, jparams, tparams


def _with(w, **kw):
    jcfg, tcfg, jparams, tparams = w
    return jcfg.with_(**kw), tcfg.with_(**kw), jparams, tparams


def _embeds(seed, batch, cfg):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


def test_config_matches_jax():
    """The config's fields equal the JAX config's, and so do the smoke
    configs' (4 / 2 heads, 8 patches of 16)."""
    cfg, jcfg = get_config(VLM), jax_get_config(VLM)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sm = smoke_config(cfg)
    assert dataclasses.asdict(sm) == dataclasses.asdict(jax_smoke_config(jcfg))
    assert (cfg.n_heads // cfg.n_kv_heads, sm.frontend_len) == (7, 8)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_matches_jax(param_dtype):
    """JAX's tree: the dense stack's (blocks with QKV biases, embed,
    final_norm, no unembed) and ``frontend_proj``; every leaf's shape and
    dtype equal; the projection's spread within 10% of JAX's scale."""
    jcfg, cfg = _configs(VLM, param_dtype=param_dtype)
    want = jax.eval_shape(lambda: unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = build_model(cfg).init(0, device="cpu")
    assert sorted(got) == sorted(want) == ["blocks", "embed", "final_norm", "frontend_proj"]
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), jax.tree_util.keystr(path)
    assert abs(float(got["frontend_proj"]["w"].float().std()) / 16 ** -0.5 - 1) < 0.1
    assert build_model(cfg).encode is None


@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
@pytest.mark.parametrize("with_embeds", [True, False])
def test_forward_matches_jax(vlm, attn_mode, with_embeds):
    """``forward`` with the projected patches before the text (hidden
    states (B, P + S, dm)) and without them, against JAX's."""
    jcfg, tcfg, jparams, tparams = _with(vlm, attn_mode=attn_mode)
    toks = _tokens(1, (2, S))
    emb = _embeds(1, 2, jcfg) if with_embeds else None
    want, _ = jtransformer.forward(jparams, jnp.asarray(toks), jcfg, remat="none",
                                   embeds_prefix=None if emb is None else jnp.asarray(emb))
    with torch.no_grad():
        got, _ = transformer.forward(tparams, torch.from_numpy(toks), tcfg, remat="none",
                                     embeds_prefix=None if emb is None else torch.from_numpy(emb))
    assert tuple(got.shape) == (2, S + (P if with_embeds else 0), 64)
    _close(want, got)


_JAX_GRADS: dict = {}


def _jax_grads(jcfg, jparams, batch):
    key = (jcfg.softmax_impl, jcfg.attn_mode)
    if key not in _JAX_GRADS:
        jm = jax_build_model(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: jm.loss(q, jb, remat="none"), has_aux=True))(jparams)
        _JAX_GRADS[key] = float(loss), jax.tree.map(np.asarray, grads)
    return _JAX_GRADS[key]


@pytest.fixture(scope="module")
def vlm_init():
    """The same on JAX's init as it is (``tests/test_torch_train.py``'s
    weights): the serving tests' x3 is there for token diversity, and under
    it a HYFT16 score raw at a rounding edge moves one gradient element to
    1.06e-3 of its leaf's largest (measured)."""
    jcfg, tcfg = _configs(VLM, softmax_impl="hyft16", attn_mode="kernel")
    jparams, tparams = _weights(jcfg, scale=1.0)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("attn_mode", ["unfused", "kernel"])
def test_lm_loss_and_grads_match_jax(vlm_init, attn_mode, remat):
    """``lm_loss`` with ``batch["embeds"]``, scored on the text positions
    only, and every gradient leaf (``frontend_proj``'s through the
    attention) against JAX's (remat "none"), under each remat policy; the
    three policies give the same bits."""
    jcfg, tcfg, jparams, tparams = _with(vlm_init, attn_mode=attn_mode)
    toks = _tokens(3, (2, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "embeds": _embeds(3, 2, jcfg)}
    want, wgrads = _jax_grads(jcfg, jparams, batch)
    model = build_model(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {p: grads_of(lambda q, b: model.loss(q, b, remat=p), tparams, tbatch)
            for p in ("none", remat)}
    loss, _, grads = runs[remat]
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(wgrads)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))
    assert float(grads["frontend_proj"]["w"].abs().max()) > 0
    assert torch.equal(runs["none"][0], loss)
    for a, b in zip(tree_leaves(runs["none"][2]), tree_leaves(grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_generate_matches_jax(vlm, cache_dtype):
    """``generate`` serves the VLM text-only, through the one-pass
    ``prefill_chunk`` and the decode step, as the JAX engine does: the
    greedy tokens of 2 x 12 prompts, 6 new each, equal JAX's."""
    jcfg, tcfg, jparams, tparams = vlm
    toks = _tokens(9, (2, S))
    kw = dict(max_len=24, cache_dtype=cache_dtype)
    want = jengine.generate(jax_build_model(jcfg), jparams, {"tokens": jnp.asarray(toks)},
                            JaxServeConfig(**kw), max_new=6)
    got = tengine.generate(build_model(tcfg), tparams, {"tokens": torch.from_numpy(toks)},
                           ServeConfig(**kw), max_new=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 3


def test_paged_pool_matches_solo_and_jax(vlm, monkeypatch):
    """The continuous slot pool over the paged layout (pages of 4, the
    prefix cache, fp2fx8, chunks of 4) with 5 requests sharing a prefix:
    with 3 slots every request's greedy tokens equal a solo ``generate``'s
    and the pool audit stays clean; with a slot each they equal the JAX
    paged engine's (its ``jnp.asarray`` made to copy)."""
    jcfg, tcfg, jparams, tparams = vlm
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 64, 8).astype(np.int32)
    reqs = [dict(rid=i, tokens=np.concatenate([prefix, rng.integers(
                     0, 64, int(rng.integers(1, 6))).astype(np.int32)]),
                 max_new=int(rng.integers(3, 8))) for i in range(5)]
    kw = dict(max_len=32, cache_dtype="fp2fx8", scheduler="continuous", decode_burst=4,
              kv_layout="paged", page_size=4, prefix_cache=True, prefill_chunk=4,
              audit=True)
    model = build_model(tcfg)

    def pool(n_slots):
        eng = tsched.SlotPoolEngine(model, tparams, ServeConfig(n_slots=n_slots, **kw),
                                    device="cpu")
        done = eng.run([tsched.Request(**r) for r in reqs])
        assert sorted(done) == list(range(len(reqs))) and all(c.ok for c in done.values())
        return done, eng.stats
    tdone, st = pool(3)
    assert st["prefix_hits"] >= 1
    for r in reqs:
        solo = tengine.generate(model, tparams, {"tokens": torch.from_numpy(r["tokens"][None])},
                                ServeConfig(max_len=32, cache_dtype="fp2fx8"),
                                max_new=r["max_new"], device="cpu")
        assert solo[0].tolist() == tdone[r["rid"]].tokens, r["rid"]
    monkeypatch.setattr(jsched, "jnp", _CopyingJnp())
    jdone = jsched.SlotPoolEngine(jax_build_model(jcfg), jparams,
                                  JaxServeConfig(n_slots=len(reqs), **kw)).run(
        [jsched.Request(**r) for r in reqs])
    wide, _ = pool(len(reqs))
    for r in reqs:
        assert wide[r["rid"]].tokens == jdone[r["rid"]].tokens == tdone[r["rid"]].tokens, r["rid"]


def test_group_of_seven_matches_jax():
    """The full config's heads, 14 / 2 of 64 (a GQA group of 7), on the
    smoke model's other widths, kernel mode: the prefill's logits, then a
    ``prefill_chunk`` of 2 x 4 lanes at starts (6, 3) and a ragged
    ``decode_step`` on it, against JAX's."""
    jcfg, tcfg = _configs(VLM, softmax_impl="hyft16", attn_mode="kernel", n_heads=14,
                          n_kv_heads=2, d_head=64)
    jparams, tparams = _weights(jcfg)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    toks = _tokens(5, (2, 10))
    jl, jc, _ = jm.prefill(jparams, jm.init_cache(jparams, 2, 16, "float32"),
                           {"tokens": jnp.asarray(toks[:, :6])})
    with torch.no_grad():
        tc = tm.init_cache(tparams, 2, 16, "float32", device="cpu")
        tl, tc, _ = tm.prefill(tparams, tc, {"tokens": torch.from_numpy(toks[:, :6])})
    _close(jl, tl)
    start, lengths = np.array([6, 3], np.int32), np.array([4, 2], np.int32)
    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks[:, 6:]), jnp.asarray(start),
                              lengths=jnp.asarray(lengths))
    with torch.no_grad():
        tl, tc = tm.prefill_chunk(tparams, tc, torch.from_numpy(toks[:, 6:]),
                                  torch.from_numpy(start), lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):
        _close(np.asarray(jl)[b, :n], tl[b, :n])
    pos, nxt = np.array([10, 5], np.int32), np.array([[1], [2]], np.int32)
    jl, _ = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos))
    with torch.no_grad():
        tl, _ = tm.decode_step(tparams, tc, torch.from_numpy(nxt), torch.from_numpy(pos))
    _close(jl, tl)


def test_launcher_serves_internvl2_on_cpu(capsys):
    """``--arch internvl2-1b`` through the serving launcher at ``--device
    cpu``: a lockstep generate and a continuous paged run."""
    from repro_torch.launch import serve
    serve.main(["--arch", VLM, "--smoke", "--device", "cpu", "--batch", "2",
                "--prefill", "8", "--max-new", "3", "--attn-mode", "kernel"])
    serve.main(["--arch", VLM, "--smoke", "--device", "cpu", "--scheduler", "continuous",
                "--kv-layout", "paged", "--prefix-cache", "--batch", "3", "--prefill", "8",
                "--max-new", "3", "--n-slots", "2", "--cache-dtype", "fp2fx8"])
    out = capsys.readouterr().out
    assert "stats:" in out and "[1]" in out and "[2] prompt=" in out
