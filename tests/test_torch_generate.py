"""The port's serving path against the JAX package, end to end on the CPU.

The qwen2-1.5b smoke model of ``tests/test_decode_path.py::_serve_setup``
(hyft16, vocab 64) with fp32 compute: the JAX weights go through the
weights bridge, and the same prompt goes through both frameworks.
"""
import ast
import os
import pathlib
import subprocess
import sys

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
from repro.models.layers import unbox
from repro.serve.engine import generate as jax_generate
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.serve.engine import _sample, generate

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHES = ["float32", "fp2fx8"]
MODES = [None, "kernel"]
# fp32 matmuls sum in another order in each framework; the logits agree to
# ~1e-6 of their scale.  Held to 1e-4 of it.
LOGIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    kw = dict(softmax_impl="hyft16", vocab=64, compute_dtype="float32")
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**kw)
    jmodel = jax_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 4), 0,
                                         jcfg.vocab, jnp.int32))
    tcfg = smoke_config(get_config("qwen2-1.5b")).with_(**kw)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, tparams, toks


def _models(setup, attn_mode):
    jcfg, jmodel, _, tcfg, _, _ = setup
    if attn_mode:
        jmodel = jax_build_model(jcfg.with_(attn_mode=attn_mode))
    return jmodel, build_model(tcfg.with_(attn_mode=attn_mode or "unfused"))


def _close(a, b, rtol=LOGIT_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=rtol * float(np.abs(a).max()))


def test_bridge_round_trips(setup):
    _, _, jparams, _, tparams, _ = setup
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        {k: v for k, v in tparams.items()}))
    for path, leaf in flat_j:
        t = tparams
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    jcache = {"blocks": {"k": np.arange(24, dtype=np.int8).reshape(2, 1, 3, 4),
                         "k_scale": np.ones((2, 1, 3), np.float32)}}
    back = cache_to_numpy(cache_from_numpy(jcache, "cpu"))
    for name, arr in jcache["blocks"].items():
        assert back["blocks"][name].dtype == arr.dtype
        np.testing.assert_array_equal(back["blocks"][name], arr)


@pytest.mark.parametrize("attn_mode", MODES, ids=["unfused", "kernel"])
@pytest.mark.parametrize("cache_dtype", CACHES)
def test_prefill_and_decode_match_jax(setup, cache_dtype, attn_mode):
    """prefill_chunk then one decode_step: logits within LOGIT_RTOL, the
    cache within the same bound (fp2fx8 raws within one step, since K/V
    come out of differently ordered sums)."""
    _, _, jparams, _, tparams, toks = setup
    jm, tm = _models(setup, attn_mode)
    B, S, L = toks.shape[0], toks.shape[1], 12
    jc = jm.init_cache(jparams, B, L, cache_dtype)
    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks),
                              jnp.zeros((B,), jnp.int32),
                              lengths=jnp.array([S, S - 1], jnp.int32))
    tc = tm.init_cache(tparams, B, L, cache_dtype, device="cpu")
    tl, tc = tm.prefill_chunk(tparams, tc, torch.from_numpy(toks),
                              torch.zeros(B, dtype=torch.int32),
                              lengths=torch.tensor([S, S - 1]))
    _close(jl, tl.numpy())
    nxt = np.array([[3], [5]], np.int32)
    jl2, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt), S)
    tl2, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt), S)
    _close(jl2, tl2.numpy())
    jb, tb = jax.tree.map(np.asarray, jc)["blocks"], cache_to_numpy(tc)["blocks"]
    assert sorted(jb) == sorted(tb)
    for name in jb:
        if jb[name].dtype == np.int8:
            diff = np.abs(jb[name].astype(int) - tb[name].astype(int))
            assert diff.max() <= 1 and diff.mean() < 0.01, name
        else:
            _close(jb[name], tb[name])


@pytest.mark.parametrize("L", [9, 4], ids=["wraps", "chunk-past-cache"])
@pytest.mark.parametrize("cache_dtype", CACHES)
def test_cache_write_bitexact(cache_dtype, L):
    """The ragged multi-token cache write on the same K/V: bit-exact raws
    and scales for fp2fx8, and the same gating (padded lanes, gated rows
    and positions past the cache write nothing), also for a chunk longer
    than the cache."""
    rng = np.random.default_rng(0)
    B, Hkv, S, D = 3, 2, 5, 8
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    pos = np.array([0, 2, 6], np.int32)
    nv = np.array([5, 3, 5], np.int32)
    gate = np.array([True, False, True])   # row 1 gated off
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv, d_head=D)
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv, d_head=D)
    jc = jattn.cache_init(jcfg, B, L, cache_dtype)
    jc = jattn.cache_update_block_ragged(jc, jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos), jnp.asarray(nv),
                                         jnp.asarray(gate))
    tc = tattn.cache_init(cfg, B, L, cache_dtype)
    tc = tattn.cache_update_block_ragged(tc, torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(nv),
                                         torch.from_numpy(gate))
    for name, arr in jc.items():
        a, b = np.asarray(arr), tc[name].numpy()
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), name


@pytest.mark.parametrize("cache_dtype", CACHES)
def test_cache_update_ragged_bitexact(cache_dtype):
    """The one-token per-row write of the ragged decode step: row b at its
    own position, a gated-off row keeps its old content, a position past
    the cache clamps to the last slot."""
    rng = np.random.default_rng(1)
    B, Hkv, D, L = 3, 2, 8, 6
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv, d_head=D)
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(n_kv_heads=Hkv, d_head=D)
    jc = jattn.cache_init(jcfg, B, L, cache_dtype)
    tc = tattn.cache_init(cfg, B, L, cache_dtype)
    for pos, gate in (([0, 3, 5], [True, True, False]), ([1, 3, 9], [True, False, True])):
        k = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
        v = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
        pos, gate = np.array(pos, np.int32), np.array(gate)
        jc = jattn.cache_update_ragged(jc, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), jnp.asarray(gate))
        tc = tattn.cache_update_ragged(tc, torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(pos), torch.from_numpy(gate))
    for name, arr in jc.items():
        a, b = np.asarray(arr), tc[name].numpy()
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), name


@pytest.mark.parametrize("attn_mode", MODES, ids=["unfused", "kernel"])
@pytest.mark.parametrize("cache_dtype", CACHES)
def test_greedy_generate_matches_jax(setup, cache_dtype, attn_mode):
    _, jmodel, jparams, tcfg, tparams, toks = setup
    ref = jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                       JaxServeConfig(max_len=16, cache_dtype=cache_dtype,
                                      attn_mode=attn_mode), max_new=5)
    outs = {}
    for loop in ("host", "scan"):
        scfg = ServeConfig(max_len=16, cache_dtype=cache_dtype,
                           attn_mode=attn_mode, decode_loop=loop)
        outs[loop] = generate(build_model(tcfg), tparams,
                              {"tokens": torch.from_numpy(toks)}, scfg,
                              max_new=5, device="cpu")
    assert outs["scan"].dtype == torch.int32 and outs["scan"].shape == (2, 5)
    np.testing.assert_array_equal(outs["scan"].numpy(), np.asarray(ref))
    assert torch.equal(outs["host"], outs["scan"])


def test_greedy_ties_go_to_first_index():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert _sample(logits, None, 0.0).tolist() == [1, 0]


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.5), (4, 0.6)])
def test_sampling_stays_in_support(top_k, top_p):
    """Top-k / top-p draws stay inside the support the filters define (the
    draws themselves are torch's, not JAX's)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32) * 2)
    temp = 0.7
    scaled = logits / temp
    srt = torch.sort(scaled, dim=-1, descending=True).values
    support = torch.ones_like(scaled, dtype=torch.bool)
    if top_k:
        support &= scaled >= srt[:, top_k - 1:top_k]
        srt = srt[:, :top_k]
    if top_p < 1.0:
        prob = torch.softmax(srt, -1)
        keep = (torch.cumsum(prob, -1) - prob) < top_p
        thresh = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
        support &= scaled >= thresh
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        tok = _sample(logits, gen, temp, top_k, top_p)
        assert bool(support[torch.arange(4), tok].all())
        seen.update(tok.tolist())
    assert len(seen) > 4          # it does sample, not argmax


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--smoke", "--device", "cpu", "--attn-mode", "kernel",
         "--cache-dtype", "fp2fx8", "--max-new", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("[") >= 4


def test_entry_points_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, _, tcfg, tparams, toks = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(build_model(tcfg), tparams, {"tokens": torch.from_numpy(toks)},
                 ServeConfig(max_len=16), max_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg).init()


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {name}"
