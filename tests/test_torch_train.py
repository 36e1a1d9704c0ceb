"""The port's training path against the JAX package, on the CPU.

The qwen2-1.5b smoke model (2 layers, d_model 64, vocab 64) with fp32
compute: the JAX weights go through the weights bridge, and the same tokens
go through both frameworks.  Kernel mode runs the JAX package's Pallas
kernels in interpret mode and the port's plain versions of its CUDA kernels.

Tolerances: the loss within 1e-5 relative, and each gradient leaf within
1e-3 of its largest |g| (the attention's fp32 dot products sum in another
order, which can move a Hyft score by one raw); the optimizers, clipping
and schedules are elementwise and held within a few fp32 ulps.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.models.layers import unbox
from repro.optim.schedules import SCHEDULES as JAX_SCHEDULES
from repro.train.step import make_step_fn as jax_make_step_fn
from repro_torch import optim
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.train.loop import StragglerMonitor, run_train
from repro_torch.train.step import grads_of, make_step_fn
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 32
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _torch_np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def setup():
    """The JAX smoke model (hyft32, fp32 compute), its weights bridged to
    the port, one batch, and the JAX loss and gradients in kernel and
    unfused mode."""
    kw = dict(softmax_impl="hyft32", vocab=64, compute_dtype="float32")
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**kw)
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((B, S), np.float32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    ref = {}
    for mode in ("kernel", "unfused"):
        jm = jax_build_model(jcfg.with_(attn_mode=mode))
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jbatch, remat="none"), has_aux=True))(jparams)
        ref[mode] = (float(loss), _np(g))
    tcfg = smoke_config(get_config("qwen2-1.5b")).with_(**kw)
    tparams = params_from_numpy(_np(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, jparams, jbatch, tcfg, tparams, tbatch, ref


def _port_grads(tcfg, tparams, tbatch, mode, remat="full"):
    model = build_model(tcfg.with_(attn_mode=mode))
    loss, _, grads = grads_of(lambda p, b: model.loss(p, b, remat=remat),
                              tparams, tbatch)
    return float(loss), grads


def _leaves_close(got, want, tol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g = g.detach().numpy() if torch.is_tensor(g) else g
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()))


def _global_gap(loss_a, g_a, loss_b, g_b):
    """(|loss_a - loss_b| / |loss_b|, ||g_a - g_b|| / ||g_b|| over all
    leaves): the train parity metrics of ``chip_smoke.py``."""
    la, lb = jax.tree.leaves(g_a), jax.tree.leaves(g_b)
    d = sum(float(((np.asarray(a) - np.asarray(b)) ** 2).sum()) for a, b in zip(la, lb))
    n = sum(float((np.asarray(b) ** 2).sum()) for b in lb)
    return abs(loss_a - loss_b) / abs(loss_b), (d / n) ** 0.5


@pytest.mark.parametrize("mode", ["kernel", "unfused"])
def test_lm_loss_and_grads_match_jax(setup, mode):
    """lm_loss and its gradient through the bridge: kernel mode (the flash
    forward and backward) and the unfused mode (the differentiable Hyft
    softmax)."""
    *_, tcfg, tparams, tbatch, ref = setup
    loss, grads = _port_grads(tcfg, tparams, tbatch, mode)
    want_loss, want_grads = ref[mode]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _leaves_close(grads, want_grads, GRAD_TOL)


def test_train_parity_bound_covers_the_jax_gap(setup):
    """The gap between kernel and unfused mode (loss, and the gradient over
    all leaves) that the JAX package shows between its own two modes, and
    that the port shows on the same model: both inside the bound that
    ``chip_smoke.py`` holds the port to at full width on the card."""
    *_, tcfg, tparams, tbatch, ref = setup
    bound = _chip_smoke().TRAIN_PARITY_BOUND
    jax_gap = _global_gap(*ref["kernel"], *ref["unfused"])
    lk, gk = _port_grads(tcfg, tparams, tbatch, "kernel")
    lu, gu = _port_grads(tcfg, tparams, tbatch, "unfused")
    port_gap = _global_gap(lk, _torch_np(gk), lu, _torch_np(gu))
    for gap in (jax_gap, port_gap):
        assert 0 < gap[0] <= bound["loss"] and 0 < gap[1] <= bound["grad"], (gap, bound)


def test_remat_full_equals_none(setup):
    """Recomputing each block in the backward gives the same gradients."""
    *_, tcfg, tparams, tbatch, _ = setup
    l_full, g_full = _port_grads(tcfg, tparams, tbatch, "kernel", remat="full")
    l_none, g_none = _port_grads(tcfg, tparams, tbatch, "kernel", remat="none")
    assert l_full == l_none
    for a, b in zip(tree_leaves(g_full), tree_leaves(g_none)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="dots"):
        _port_grads(tcfg, tparams, tbatch, "kernel", remat="dots")


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_train_step_matches_jax(setup, name):
    """One make_step_fn step from the same state on the same batch: the
    metrics, and the new parameters.  SGD's update is linear in the
    gradient, so its parameters agree to the gradients' tolerance; AdamW's
    first update is about lr * sign(g), which can flip where a gradient is
    zero up to rounding, so it is held per element in all but 0.1%."""
    jcfg, jparams, jbatch, tcfg, tparams, tbatch, _ = setup
    tc = dict(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=2, total_steps=10,
              optimizer=name, attn_mode="kernel", remat="none")
    ocfg = dict(name=name, lr=1e-2)
    jstep = jax.jit(jax_make_step_fn(jax_build_model(jcfg), JaxTrainConfig(**tc),
                                     joptim.OptConfig(**ocfg)))
    jstate = {"params": jparams, "opt": joptim.init(joptim.OptConfig(**ocfg), jparams),
              "step": jnp.asarray(3, jnp.int32), "rng": jax.random.PRNGKey(0)}
    jnew, jm = jstep(jstate, jbatch)
    params = tree_map(torch.clone, tparams)
    state = {"params": params, "opt": optim.init(optim.OptConfig(**ocfg), params),
             "step": torch.tensor(3, dtype=torch.int32)}
    new, m = make_step_fn(build_model(tcfg), TrainConfig(**tc),
                          optim.OptConfig(**ocfg))(state, tbatch)
    assert float(jm["lr_scale"]) > 0         # a jitted cos may differ in one ulp
    assert float(m["lr_scale"]) == pytest.approx(float(jm["lr_scale"]), rel=1e-6)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= GRAD_TOL * float(jm["grad_norm"])
    assert int(new["step"]) == 4 and int(new["opt"]["step"]) == 1
    lr = 1e-2 * float(jm["lr_scale"])
    for got, want, old in zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"]),
                              jax.tree.leaves(jparams)):
        diff = np.abs(got.numpy() - np.asarray(want))
        moved = np.abs(np.asarray(want) - np.asarray(old)).max()
        if name == "sgd":
            assert diff.max() <= GRAD_TOL * moved + 1e-7
        else:
            assert (diff > 1e-3 * lr + 1e-7).mean() <= 1e-3


def test_microbatches_accumulate_to_the_full_batch(setup):
    """Two microbatches of one row give the full batch's loss, gradient
    norm and (SGD) update: the gradients are summed, then divided by 2."""
    *_, tcfg, tparams, tbatch, _ = setup
    outs = []
    for micro in (0, 1):
        params = tree_map(torch.clone, tparams)
        ocfg = optim.OptConfig(name="sgd", lr=1e-2)
        state = {"params": params, "opt": optim.init(ocfg, params),
                 "step": torch.tensor(3, dtype=torch.int32)}
        tc = TrainConfig(microbatch=micro, warmup_steps=2, total_steps=10,
                         attn_mode="kernel")
        outs.append(make_step_fn(build_model(tcfg), tc, ocfg)(state, tbatch))
    (full, mf), (acc, ma) = outs
    for key in ("loss", "grad_norm", "nll"):
        assert abs(float(ma[key]) - float(mf[key])) <= 1e-5 * abs(float(mf[key]))
    for a, b in zip(tree_leaves(acc["params"]), tree_leaves(full["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_update_matches_jax(name):
    """init, then two updates (at lr scales 1 and 0.5) from the same
    gradients: parameters and every optimizer buffer."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 3, 4)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(2)]
    jcfg, tcfg = joptim.OptConfig(name=name), optim.OptConfig(name=name)
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = joptim.init(jcfg, jp)
    tp = params_from_numpy(params, "cpu")
    tst = optim.init(tcfg, tp)
    for g, scale in zip(grads, (1.0, 0.5)):
        jp, jst = joptim.update(jcfg, jax.tree.map(jnp.asarray, g), jst, jp,
                                lr_scale=jnp.float32(scale))
        tp, tst = optim.update(tcfg, params_from_numpy(g, "cpu"), tst, tp,
                               lr_scale=torch.tensor(scale))
    assert int(tst["step"]) == int(jst["step"]) == 2
    for key in jst:
        if key == "step":
            continue
        for a, b in zip(tree_leaves(tst[key]), jax.tree.leaves(jst[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)
    assert tst["master"]["a"].data_ptr() != tp["a"].data_ptr()


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"x": rng.standard_normal((7, 5)).astype(np.float32) * 3,
            "y": {"z": rng.standard_normal((11,)).astype(np.float32)}}
    for max_norm in (1.0, 100.0):
        jt, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        tt, tn = optim.clip_by_global_norm(params_from_numpy(tree, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["warmup_cosine", "constant"])
def test_schedules_match_jax(name):
    for step in (0, 1, 7, 99, 100, 101, 550, 1000, 2000):
        want = float(JAX_SCHEDULES[name](jnp.asarray(step, jnp.int32), warmup=100,
                                         total=1000))
        got = float(SCHEDULES[name](torch.tensor(step, dtype=torch.int32), warmup=100,
                                    total=1000))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(SCHEDULES["warmup_cosine"](torch.tensor(0), warmup=100, total=1000)) == 0


def test_lm_batch_is_deterministic_with_shifted_targets():
    cfg = DataConfig(vocab=97, seq_len=24, global_batch=4, seed=3)
    a, b = lm_batch(cfg, 5), lm_batch(cfg, 5)
    for key in ("tokens", "targets", "mask"):
        assert torch.equal(a[key], b[key])
    assert a["tokens"].dtype == a["targets"].dtype == torch.int32
    assert a["tokens"].shape == (4, 24) and a["mask"].dtype == torch.float32
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97
    assert not torch.equal(lm_batch(cfg, 6)["tokens"], a["tokens"])
    half = DataConfig(vocab=97, seq_len=24, global_batch=4, seed=3, n_hosts=2, host_id=1)
    assert lm_batch(half, 5)["tokens"].shape == (2, 24)
    # the Markov structure: most next tokens follow (shift1[prev] + prev) % vocab
    shift1 = torch.randint(0, 97, (97,), generator=torch.Generator().manual_seed(3 + 7919))
    toks = lm_batch(DataConfig(vocab=97, seq_len=512, global_batch=2, seed=3), 0)["tokens"]
    prev, nxt = toks[:, :-1].long(), toks[:, 1:].long()
    assert float(((shift1[prev] + prev) % 97 == nxt).float().mean()) > 0.8


def test_train_loop_logs_and_flags_stragglers():
    monitor = StragglerMonitor(warm=2)
    assert [monitor.observe(dt) for dt in (1.0, 1.0, 1.1, 5.0, 1.0)] == [
        False, False, False, True, False]
    assert monitor.flagged == 1
    calls = []

    def step(state, batch):
        calls.append(batch)
        return state + 1, {"loss": torch.tensor(float(state))}
    state, hist = run_train(0, step, lambda s: s, TrainConfig(total_steps=5),
                            log_every=2, log_fn=lambda *_: None)
    assert state == 5 and calls == [0, 1, 2, 3, 4]
    assert [h["step"] for h in hist] == [0, 2, 4]
    with pytest.raises(NotImplementedError, match="remat='dots' and checkpointing"):
        run_train(0, step, lambda s: s, TrainConfig(total_steps=1), ckpt_dir="ckpt")


def test_launcher_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b",
         "--smoke", "--device", "cpu", "--steps", "3", "--attn-mode", "kernel",
         "--global-batch", "2", "--seq", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loss = float(res.stdout.strip().splitlines()[-1].split(":")[1])
    assert np.isfinite(loss)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])
    with pytest.raises(SystemExit):      # one device: no mesh flags above 1
        launch_train.parse_args(["--arch", "qwen2-1.5b", "--data-mesh", "2"])
