"""The port's mesh against the JAX package and its own one-process run, on
the CPU: spawned ranks over gloo (``tests/torch_mesh_worker.py``), one
spawn per world size serving several checks.

* The sharded training step (DTensor state and batch, ``default_rules``):
  dense qwen2-1.5b smoke on meshes (2, 1), (1, 2) and (2, 2) in kernel mode
  (the kernels' plain versions), and on (2, 2) also in the unfused and the
  chunked modes; MoE phi3.5 smoke on (1, 2) (experts over ``model``).  Two
  AdamW steps each, held against JAX's one-device step on the same
  converted weights within ``tests/test_torch_train.py``'s tolerances (the
  loss within 1e-5 relative; the parameters per element within 1e-3 of lr
  in all but 0.1%: AdamW's first updates are about lr * sign(g), which
  flips where a gradient is zero up to rounding), and against the port's
  one-process step (mesh (1, 1)): the loss and the gradient norm within
  1e-5 relative, the parameters as for JAX; an SGD run on (2, 2), whose
  update is linear in the gradient, within 1e-5 of the largest |p|.
* ``sp_decode_attention`` over 1, 2 and 4 ranks at JAX's test shape (B 2,
  4 / 2 heads, 64 keys of which 40 valid, D 16), HYFT32 and HYFT16,
  against JAX's ``sp_decode_attention`` run in one device's ``shard_map``,
  within ``2 * 2**-mant * max|v|`` (the PV sums reduce in another order);
  and at ``chip_smoke.py``'s shape (qwen2-1.5b's decode, 1,056 keys over 4
  ranks) against the split-K decode (kernel 6's plain version) within
  ``chip_smoke.SP_KERNEL6_BOUND``, which JAX's own gap must also respect.
* The GQA trap: q heads over ``model`` 4, kv heads whole; each rank reads
  the kv heads of its q heads, and their gradients sum over the ranks.
* ``compressed_psum_tree`` over 4 ranks (within 4 x the common scale of
  the exact sum), ``quantize_int8``'s bound and unbiasedness at JAX's
  bounds, ``elastic_remesh``, and a checkpoint written by one process,
  restored on a (2, 2) mesh and saved from it: bitwise, and the files'
  arrays and manifest byte-equal.
* The launcher under ``torch.distributed.run`` at (2, 2).
"""
import contextlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import warnings
import zipfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.optim as joptim
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.hyft import HYFT16 as J_HYFT16, HYFT32 as J_HYFT32
from repro.distributed.compat import shard_map
from repro.kernels.flash_attention import flash_hyft_decode as jax_flash_decode
from repro.models import build_model as jax_build_model
from repro.models.attention import sp_decode_attention as jax_sp_decode
from repro.models.layers import unbox
from repro.train.step import make_step_fn as jax_make_step_fn
from repro_torch import optim
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ShapeSpec, TrainConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention, build_model
from repro_torch.models import moe as tmoe
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from repro_torch.train.state import init_state
from repro_torch.train.step import make_step_fn
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_mesh_worker as worker  # noqa: E402

B, S = 4, 32
LOSS_RTOL, MESH_RTOL = 1e-5, 1e-5
LR, STEP0 = 1e-2, 3
TRAIN = dict(global_batch=B, seq_len=S, lr=LR, warmup_steps=2, total_steps=10,
             remat="full")
DENSE_KW = dict(softmax_impl="hyft32", vocab=64, compute_dtype="float32")
DENSE_CASES = {"dense-2x1-kernel": ((2, 1), "kernel", "adamw"),
               "dense-1x2-kernel": ((1, 2), "kernel", "adamw"),
               "dense-2x2-kernel": ((2, 2), "kernel", "adamw"),
               "dense-2x2-unfused-sgd": ((2, 2), "unfused", "sgd"),
               "dense-2x2-chunked": ((2, 2), "chunked", "adamw"),
               "dense-2x2-kernel-sgd": ((2, 2), "kernel", "sgd")}
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_KW = dict(softmax_impl="hyft16_kernel", vocab=64, compute_dtype="float32",
              attn_mode="kernel")
R = Replicate()
ONE_HOT = pytest.mark.filterwarnings("ignore:jax.nn.one_hot input should be integer-typed")


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(vocab, batch, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        toks = rng.integers(0, vocab, (batch, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "mask": np.ones((batch, S), np.float32)})
    return out


def _jax_run(jcfg, jparams, batches, mode, opt):
    """Two steps of JAX's one-device step: [(metrics, params)] after each."""
    tc = dict(TRAIN, optimizer=opt, attn_mode=mode, remat="none")
    ocfg = joptim.OptConfig(name=opt, lr=LR)
    step = jax.jit(jax_make_step_fn(jax_build_model(jcfg), JaxTrainConfig(**tc), ocfg))
    state = {"params": jparams, "opt": joptim.init(ocfg, jparams),
             "step": jnp.asarray(STEP0, jnp.int32), "rng": jax.random.PRNGKey(0)}
    out = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        out.append(({k: float(v) for k, v in m.items()},
                    [np.asarray(x) for x in jax.tree.leaves(state["params"])]))
    return out


def _port_run(cfg, params, batches, mode, opt):
    """Two steps of the port's one-process step (mesh (1, 1))."""
    ocfg = optim.OptConfig(name=opt, lr=LR)
    params = tree_map(torch.clone, params)
    state = {"params": params, "opt": optim.init(ocfg, params),
             "step": torch.tensor(STEP0, dtype=torch.int32)}
    step = make_step_fn(build_model(cfg), TrainConfig(**dict(TRAIN, optimizer=opt,
                                                             attn_mode=mode)), ocfg)
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append(({k: float(v) for k, v in m.items()},
                    [t.clone().numpy() for t in tree_leaves(state["params"])]))
    return out


def _case(arch, kw, mesh, mode, opt, weights):
    return dict(arch=arch, cfg=dict(kw, attn_chunk=16), mesh=mesh, step0=STEP0,
                opt=dict(name=opt, lr=LR), weights=weights,
                train=dict(TRAIN, optimizer=opt, attn_mode=mode))


def _jax_weights(arch, kw, router_scale=None):
    jcfg = jax_smoke_config(jax_get_config(arch)).with_(**kw)
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    if router_scale:
        jmoe = jparams["blocks"]["moe"]
        jparams["blocks"]["moe"] = dict(jmoe, router=jmoe["router"] * router_scale)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, params, smoke_config(get_config(arch)).with_(**kw)


@pytest.fixture(scope="module")
def weights():
    """JAX's weights and their bridge: qwen2-1.5b smoke (HYFT32, fp32
    compute) and phi3.5-moe smoke through kernels 1-2's plain versions (the
    router) and 3-5's, its router scaled x4 (``tests/test_torch_moe.py``:
    every token's top-k then survives a one-raw move of its logits, which
    ``moe`` asserts on the one-process run); two batches each, 4 x 32 and
    2 x 32 (two dispatch groups of 16 a row)."""
    return {"dense": (*_jax_weights("qwen2-1.5b", dict(DENSE_KW, attn_chunk=16)),
                      _batches(64, B, 0)),
            "moe": (*_jax_weights(MOE_ARCH, dict(MOE_KW, attn_chunk=16), 4.0),
                    _batches(64, 2, 1))}


@pytest.fixture(scope="module")
def dense(weights):
    """Both one-device references (JAX's, the port's) of every dense case."""
    jcfg, jparams, params, cfg, batches = weights["dense"]
    refs = {}
    for name, (_, mode, opt) in DENSE_CASES.items():
        if (mode, opt) not in refs:
            refs[(mode, opt)] = (_jax_run(jcfg, jparams, batches, mode, opt),
                                 _port_run(cfg, params, batches, mode, opt))
    return params, refs


@pytest.fixture(scope="module")
def moe(weights):
    jcfg, jparams, params, cfg, batches = weights["moe"]
    with pytest.MonkeyPatch.context() as mp:
        seen = _record_router(mp)
        port = _port_run(cfg, params, batches, "kernel", "sgd")
    _assert_router_margin(seen, cfg.moe_top_k)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "jax.nn.one_hot input should be integer-typed")
        ref = _jax_run(jcfg, jparams, batches, "kernel", "sgd")
    return params, (ref, port)


def _record_router(mp):
    seen, orig = [], tmoe.get_softmax

    def get(name):
        fn = orig(name)

        def record(z):
            seen.append(z.detach().clone())
            return fn(z)
        return record
    mp.setattr(tmoe, "get_softmax", get)
    return seen


def _assert_router_margin(seen, k):
    """Each token's top-k survives a move of one FP2FX raw of every router
    logit against it (HYFT16: 2**-10)."""
    from repro_torch.core.registry import get_softmax
    sm = get_softmax(MOE_KW["softmax_impl"])
    for z in seen:
        _, idx = tmoe.top_k(sm(z).float(), k)
        chosen = torch.nn.functional.one_hot(idx, z.shape[-1]).sum(-2).bool()
        _, moved = tmoe.top_k(sm(z + torch.where(chosen, -2.0 ** -10, 2.0 ** -10)).float(), k)
        assert torch.equal(idx.sort(-1).values, moved.sort(-1).values)


def _train_inputs(cases, weights):
    return {"cases": cases,
            "params": {k: w[2] for k, w in weights.items()},
            "batches": {k: [{n: torch.from_numpy(v) for n, v in b.items()} for b in w[4]]
                        for k, w in weights.items()}}


def _sp_inputs(seed=0):
    """JAX's test shape (tests/test_system.py): q (2, 4, 1, 16), k/v (2, 2,
    64, 16), the first 40 keys valid."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    valid = np.broadcast_to(np.arange(64)[None] < 40, (2, 64)).copy()
    return q, k, v, valid


def _gqa_inputs():
    gen = torch.Generator().manual_seed(3)
    cases = {}
    for hq, hkv in ((4, 2), (12, 6)):
        cases[(hq, hkv)] = {n: torch.randn(shape, generator=gen) for n, shape in (
            ("q", (2, hq, S, 16)), ("k", (2, hkv, S, 16)), ("v", (2, hkv, S, 16)),
            ("do", (2, hq, S, 16)))}
    return {"cfg": dict(DENSE_KW, attn_chunk=16), "cases": cases}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Both spawns, started at once before the references are computed:
    2 ranks for the (2, 1) and (1, 2) steps, 4 for the (2, 2) steps, the
    sequence-parallel decode, the GQA trap, the collectives, elastic
    re-meshing and the checkpoint, which one process writes first."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(vocab=64)
    state = init_state(build_model(cfg), optim.OptConfig(name="adamw"), 0, device="cpu")
    state["step"] += 5
    src = checkpointer.save(str(tmp / "one"), 5, state)
    two = {n: _case("qwen2-1.5b", DENSE_KW, mesh, mode, opt, "dense")
           for n, (mesh, mode, opt) in DENSE_CASES.items() if mesh != (2, 2)}
    two["moe-1x2-kernel"] = _case(MOE_ARCH, MOE_KW, (1, 2), "kernel", "sgd", "moe")
    four = {n: _case("qwen2-1.5b", DENSE_KW, mesh, mode, opt, "dense")
            for n, (mesh, mode, opt) in DENSE_CASES.items() if mesh == (2, 2)}
    q, k, v, valid = _sp_inputs()
    sp = {name: {"q": torch.from_numpy(q), "k": torch.from_numpy(k),
                 "v": torch.from_numpy(v), "valid": torch.from_numpy(valid)}
          for name in ("hyft32", "hyft16")}
    sp["chip"] = _chip_smoke().sp_inputs(torch, device="cpu")
    run2 = worker.Spawned(2, {"train": _train_inputs(two, weights), "ssm": _ssm_inputs()})
    run4 = worker.Spawned(4, {
        "train": _train_inputs(four, weights), "sp_decode": sp, "gqa": _gqa_inputs(),
        "collectives": {"trees": _psum_trees(), "ckpt": {
            "src": str(tmp / "one"), "step": 5, "dst": str(tmp / "mesh"), "opt": "adamw"}}})
    yield run2, run4, (state, tmp, src)
    run2.close()
    run4.close()


SSM_KW = dict(compute_dtype="float32", vocab=64)


def _ssm_inputs():
    """mamba2 smoke's weights (seed 0) and one 4 x 32 batch."""
    cfg = smoke_config(get_config("mamba2-370m")).with_(**SSM_KW)
    toks = torch.from_numpy(_batches(64, B, 2)[0]["tokens"])
    return {"cfg": SSM_KW, "params": build_model(cfg).init(0, device="cpu"),
            "batch": {"tokens": toks, "targets": toks.roll(-1, 1),
                      "mask": torch.ones(B, S)}}


def _psum_trees():
    rng = np.random.default_rng(5)
    return [{"a": torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32) * (r + 1)),
             "b": {"c": torch.from_numpy(rng.standard_normal((33,)).astype(np.float32))}}
            for r in range(4)]


@pytest.fixture(scope="module")
def two(ranks, dense, moe):
    return ranks[0].result()


@pytest.fixture(scope="module")
def four(ranks, dense):
    return ranks[1].result(), *ranks[2]


def _beyond(a, b):
    """The share of elements more than 1e-3 of lr apart (AdamW's first
    updates are about lr * sign(g))."""
    return float((np.abs(a - b) > 1e-3 * LR + 1e-7).mean())


def _hold_run(got, jax_ref, port_ref, opt, init):
    """Each step's loss and gradient norm, and its parameters.  AdamW's
    per element within 1e-3 of lr of the one-process run's in all but
    0.1%, and of JAX's in all but 0.1% more than the one-process run's
    share (under the unfused mode the Hyft VJP's 16-bit fixed-point dot
    turns the packages' one-raw score differences into gradient ones,
    ``tests/test_torch_train.py``'s 1e-3 of the largest |g|, which the
    second AdamW update spreads over a quarter of the elements; in kernel
    mode that share is below 0.1%).  SGD's within 1e-3 of the step's
    largest move of JAX's (``tests/test_torch_train.py``) and within 1e-5
    of the largest |p| of the one-process run's."""
    old = [t.numpy() for t in tree_leaves(init)]
    for step, (jm, jp), (pm, pp) in zip(got["steps"], jax_ref, port_ref):
        loss = step["metrics"]["loss"]
        assert abs(loss - jm["loss"]) <= LOSS_RTOL * abs(jm["loss"])
        assert abs(loss - pm["loss"]) <= MESH_RTOL * abs(pm["loss"])
        assert abs(step["metrics"]["grad_norm"] - pm["grad_norm"]) <= \
            MESH_RTOL * pm["grad_norm"]
        params = [t.numpy() for t in tree_leaves(step["params"])]
        for g, w, p, o in zip(params, jp, pp, old):
            assert g.shape == w.shape == p.shape
            if opt == "sgd":
                assert np.abs(g - w).max() <= 1e-3 * float(np.abs(w - o).max()) + 1e-7
                assert np.abs(g - p).max() <= MESH_RTOL * float(np.abs(p).max()) + 1e-7
            else:
                assert _beyond(g, p) <= 1e-3
                assert _beyond(g, w) <= _beyond(p, w) + 1e-3
        old = jp


@pytest.mark.parametrize("name", [n for n, c in DENSE_CASES.items() if c[0] != (2, 2)])
def test_sharded_step_matches_jax_two_ranks(two, dense, name):
    _, mode, opt = DENSE_CASES[name]
    jax_ref, port_ref = dense[1][(mode, opt)]
    _hold_run(two["train"][name], jax_ref, port_ref, opt, dense[0])


@pytest.mark.parametrize("name", [n for n, c in DENSE_CASES.items() if c[0] == (2, 2)])
def test_sharded_step_matches_jax_four_ranks(four, dense, name):
    _, mode, opt = DENSE_CASES[name]
    jax_ref, port_ref = dense[1][(mode, opt)]
    _hold_run(four[0]["train"][name], jax_ref, port_ref, opt, dense[0])


@pytest.mark.parametrize("name", [n for n, c in DENSE_CASES.items() if c[0] != (2, 2)])
def test_dryrun_collectives_match_the_gloo_step(two, name, monkeypatch):
    """The dry-run's fake trace of a two-rank case (a fake group of 2, the
    case's config, mesh and train step, rank 0's view) issues the
    collectives of the real gloo step: by kind, count and operand bytes;
    and its FLOPs and bytes are those that ``count_cost`` reads of rank 0's
    second real step (whose state is placed, as the trace's is).  The trace
    keeps gloo's all-gather and chunk for an all-to-all here, as the real
    ranks do (the dry-run's own trace issues the card's all-to-all:
    ``tests/test_torch_dryrun.py``)."""
    from repro_torch.configs import MeshConfig
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "_alltoall_as_on_the_card", contextlib.nullcontext)
    mesh, mode, opt = DENSE_CASES[name]
    case = _case("qwen2-1.5b", DENSE_KW, mesh, mode, opt, "dense")
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(**case["cfg"])
    spec = ShapeSpec("mesh_case", "train", S, B)
    got = dryrun.trace_cell(cfg, spec, MeshConfig(shape=mesh),
                            dryrun.CellOpts(attn_mode=mode, optimizer=opt), device="cpu",
                            tcfg=TrainConfig(**case["train"]))
    want = two["train"][name]["collectives"]
    assert got["collectives"] == want and want
    assert got["roofline"]["coll_bytes_device"] == sum(c["bytes"] for c in want.values())
    real = two["train"][name]["cost"]
    assert real["flops"] > 0
    assert {k: got["cost"][k] for k in real} == real


def test_sharded_ssm_matches_one_process(two):
    """mamba2 smoke on (2, 1): the chunked SSD on each rank's batch rows,
    the weights whole, their gradients reduced over the data axis: the loss
    and every gradient of the one-process run, but for the order of the
    sums over the ranks."""
    from repro_torch.train.step import grads_of, make_loss_fn
    x = _ssm_inputs()
    cfg = smoke_config(get_config("mamba2-370m")).with_(**SSM_KW)
    model = build_model(cfg)
    loss, _, grads = grads_of(make_loss_fn(model, TrainConfig(remat="full")), x["params"],
                              x["batch"])
    got = two["ssm"]
    assert abs(got["loss"] - float(loss)) <= MESH_RTOL * abs(float(loss))
    for g, w in zip(tree_leaves(got["grads"]), tree_leaves(grads)):
        assert float((g - w).abs().max()) <= MESH_RTOL * float(w.abs().max()) + 1e-7


@ONE_HOT
def test_sharded_moe_step_matches_jax(two, moe):
    """phi3.5-moe smoke on (1, 2): the experts over ``model`` (expert
    parallelism), the router's softmax on whole rows."""
    jax_ref, port_ref = moe[1]
    _hold_run(two["train"]["moe-1x2-kernel"], jax_ref, port_ref, "sgd", moe[0])
    pl = two["train"]["moe-1x2-kernel"]["placements"]["blocks"]["moe"]
    assert pl["w_up"] == (R, Shard(1))                  # (L, E, dm, dff): E over model
    assert pl["router"] == (R, R)


def test_sharded_step_keeps_the_state_placements(two, four):
    """The parameters leave the steps in ``state_shardings``' placements:
    on (2, 2) heads and mlp over ``model``, everything whole over
    ``data`` (no FSDP)."""
    pl = four[0]["train"]["dense-2x2-kernel"]["placements"]
    assert pl["blocks"]["attn"]["wq"] == (R, Shard(2))     # (L, dm, heads, D)
    assert pl["blocks"]["attn"]["wk"] == (R, Shard(2))     # 2 kv heads over 2
    assert pl["blocks"]["mlp"]["w_down"] == (R, Shard(1))  # (L, mlp, dm)
    assert pl["embed"]["table"] == (R, Shard(0))           # vocab over model
    assert pl["final_norm"]["scale"] == (R, R)
    assert all(p[0] == R for p in tree_leaves(two["train"]["dense-2x1-kernel"]["placements"]))


_JAX_SP: dict = {}


def _jax_sp(q, k, v, valid, cfg):
    """JAX's sp_decode_attention in a one-device shard_map (as
    tests/test_system.py runs it), jitted; memoized by config and shape."""
    key = (cfg, q.shape, k.shape)
    if key not in _JAX_SP:
        mesh = Mesh(np.array(jax.devices()[:1]), ("model",))

        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(), P(None, None, "model"), P(None, None, "model"),
                           P(None, "model")),
                 out_specs=P())
        def sp(q, k, v, valid):
            return jax_sp_decode(q, k, v, valid, cfg, "model")
        _JAX_SP[key] = np.asarray(sp(q, k, v, valid))
    return _JAX_SP[key]


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("name", ["hyft32", "hyft16"])
def test_sp_decode_matches_jax(four, name, W):
    q, k, v, valid = _sp_inputs()
    cfg = {"hyft32": J_HYFT32, "hyft16": J_HYFT16}[name]
    want = _jax_sp(q, k, v, valid, cfg)
    got = four[0]["sp_decode"][(W, name)].numpy()
    assert got.shape == want.shape == (2, 4, 1, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * 2.0 ** -cfg.mant_bits * float(np.abs(v).max()))


def test_sp_decode_bound_against_kernel6_covers_jax(four):
    """At chip_smoke.py's shape the sequence-parallel decode and the split-K
    decode (5 splits of up to 256 keys, a Hyft rescale each) differ by the
    rescales: JAX's own gap plus the port's stated tolerance must lie
    within ``SP_KERNEL6_BOUND``, and the port's gap (4 ranks against kernel
    6's plain version) within it too."""
    chip = _chip_smoke()
    x = chip.sp_inputs(torch, device="cpu")
    q, k, v, lengths = (x[n].numpy() for n in ("q", "k", "v", "lengths"))
    valid = np.arange(k.shape[2])[None, :] < lengths[:, None]
    cfg = J_HYFT16
    sp = _jax_sp(q, k, v, valid, cfg)
    fl = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                                     kv_len_mask=jnp.asarray(valid.astype(np.float32))))
    tol = 2 * 2.0 ** -cfg.mant_bits * float(np.abs(v).max())
    jax_gap = float(np.abs(sp - fl).max())
    assert jax_gap + tol <= chip.SP_KERNEL6_BOUND
    assert four[0]["sp_decode"]["chip"]["gap"] <= chip.SP_KERNEL6_BOUND
    np.testing.assert_allclose(four[0]["sp_decode"]["chip"]["sp"].numpy(), sp, rtol=0, atol=tol)


@pytest.mark.parametrize("heads", [(4, 2), (12, 6)])
@pytest.mark.parametrize("mode", ["kernel", "unfused", "chunked"])
def test_sharded_attention_reads_the_kv_heads_of_its_q_heads(four, heads, mode):
    """q heads over ``model`` 4, kv heads whole: 1 q head a rank reading
    one kv head (4 / 2), and 3 q heads a rank reading two (12 / 6); the
    output and the q/k/v gradients equal the one-process call's, and the
    kv gradients come back whole."""
    x = _gqa_inputs()["cases"][heads]
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(**_gqa_inputs()["cfg"], attn_mode=mode)
    q, k, v = (x[n].clone().requires_grad_() for n in ("q", "k", "v"))
    o = attention.attention_fwd(q, k, v, cfg, causal=True)
    o.backward(x["do"])
    got = four[0]["gqa"][(heads, mode)]
    for name, want in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        torch.testing.assert_close(got[name], want.detach(), rtol=0,
                                   atol=1e-5 * float(want.detach().abs().max()))
    assert got["placements"] == ((R, Shard(1)), (R, R))


def test_compressed_psum_tree_over_four_ranks(four):
    """Each rank's tree quantized on the common (all-reduced max) scale:
    the int32 sum is exact, so each element lies within 4 x scale (one
    stochastic rounding a rank) of the exact sum, and the tree keeps its
    structure and dtypes."""
    res = four[0]["collectives"]
    trees = [tree_map(lambda t: t.numpy(), t) for t in _psum_trees()]
    for path in (("a",), ("b", "c")):
        parts = [t[path[0]] if len(path) == 1 else t["b"]["c"] for t in trees]
        scale = max(float(np.abs(p).max()) for p in parts) / 127.0
        exact = np.sum(parts, axis=0)
        got = res["summed"][path[0]] if len(path) == 1 else res["summed"]["b"]["c"]
        assert got.dtype == torch.float32 and got.shape == exact.shape
        assert float(np.abs(got.numpy() - exact).max()) <= 4 * scale + 1e-6


def test_quantize_int8_bounded_and_unbiased():
    """JAX's bounds (tests/test_substrate.py): the error within one scale;
    the mean of 300 draws of 0.3 within 2e-3."""
    gen = torch.Generator().manual_seed(1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32)) * 3
    q, s = quantize_int8(x, gen)
    assert q.dtype == torch.int8
    assert float((dequantize_int8(q, s) - x).abs().max()) <= float(s) + 1e-6
    x = torch.full((8,), 0.3)
    vals = [dequantize_int8(*quantize_int8(x, gen)).numpy() for _ in range(300)]
    assert abs(np.mean(vals) - 0.3) < 2e-3


def test_elastic_remesh_over_four_ranks(four):
    """The data axis absorbs the loss; a model group stays whole."""
    m = four[0]["collectives"]["meshes"]
    assert m[1][:2] == ((4, 1), [[0], [1], [2], [3]])
    assert m[2][:2] == ((2, 2), [[0, 1], [2, 3]])
    assert m[3][:2] == ((1, 3), [[0, 1, 2]])
    assert m["lost"][:2] == ((1, 2), [[0, 1]])
    assert all(list(m[k][2]) == [0, 0] for k in (1, 2, 3, "lost"))
    assert "not enough ranks" in m["too_few"]


def _npz_members(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_checkpoint_moves_between_meshes(four):
    """Written by one process, restored on (2, 2) by ``state_shardings``
    (bitwise, in those placements), saved from (2, 2) (the arrays and the
    manifest byte for byte the one-process save's), and that checkpoint
    restored by one process (bitwise)."""
    res, state, tmp, src = four
    got = res["collectives"]
    for a, b in zip(tree_leaves(got["restored"]), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["restored_placements"]["params"]["blocks"]["attn"]["wq"] == (R, Shard(2))
    assert got["restored_placements"]["opt"]["m"]["blocks"]["attn"]["wq"] == (R, Shard(2))
    assert got["restored_placements"]["step"] == (R, R)
    dst = os.path.join(tmp, "mesh", "step_00000005")
    assert _npz_members(dst) == _npz_members(src)
    with open(os.path.join(dst, "manifest.json"), "rb") as f, \
            open(os.path.join(src, "manifest.json"), "rb") as g:
        assert f.read() == g.read()
    like = tree_map(torch.zeros_like, state)
    back, step = checkpointer.restore(os.path.join(tmp, "mesh"), 5, like)
    assert step == 5
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)


def test_only_rank_0_copies_a_mesh_checkpoint_to_the_host(four):
    """Saving from (2, 2): every rank gathers each leaf (a collective), and
    rank 0, the writer, alone copies the gathered leaves to the host."""
    res, state, _, _ = four
    assert res["collectives"]["host_copies"] == [len(tree_leaves(state)), 0, 0, 0]


def test_launcher_runs_a_mesh_under_torch_distributed_run():
    """(2, 2) over 4 processes: exit 0 and one final loss (rank 0's)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--smoke", "--device", "cpu", "--data-mesh", "2",
         "--model-mesh", "2", "--steps", "2", "--global-batch", "4", "--seq", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    finals = [ln for ln in res.stdout.splitlines() if ln.startswith("final loss:")]
    assert len(finals) == 1 and np.isfinite(float(finals[0].split(":")[1]))
