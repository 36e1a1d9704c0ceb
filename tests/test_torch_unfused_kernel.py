"""The unfused-attention path with the standalone softmax kernels, end to
end on the CPU, against the JAX package.

The qwen2-1.5b smoke model (2 layers, d_model 64, vocab 64) with fp32
compute, ``softmax_impl="hyft16_kernel"`` and ``attn_mode="unfused"``: every
attention softmax goes through ``ops.hyft_softmax`` (the plain versions of
the softmax kernels on the CPU; the JAX package's Pallas kernels in
interpret mode).  The JAX weights go through the weights bridge.

Tolerances are ``tests/test_torch_train.py``'s: the loss within 1e-5
relative, each gradient leaf within 1e-3 of its largest |g| (the
attention's fp32 dot products sum in another order, which can move a Hyft
score by one raw); greedy tokens equal.
"""
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
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.models.layers import unbox
from repro.serve.engine import generate as jax_generate
from repro.train.step import make_step_fn as jax_make_step_fn
from repro_torch import optim
from repro_torch.configs import ServeConfig, TrainConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hyft_softmax as ths
from repro_torch.models import build_model
from repro_torch.serve.engine import generate
from repro_torch.train.step import grads_of, make_step_fn
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 32
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3
KW = dict(softmax_impl="hyft16_kernel", attn_mode="unfused", vocab=64,
          compute_dtype="float32")


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX smoke model with the kernel softmax in the unfused mode, its
    weights bridged to the port, one batch, and the JAX loss and gradients
    for ``hyft16_kernel`` and ``hyft16``."""
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**KW)
    jparams = unbox(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((B, S), np.float32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    ref = {}
    for impl in ("hyft16_kernel", "hyft16"):
        jm = jax_build_model(jcfg.with_(softmax_impl=impl))
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jbatch, remat="none"), has_aux=True))(jparams)
        ref[impl] = (float(loss), _np(g))
    tcfg = smoke_config(get_config("qwen2-1.5b")).with_(**KW)
    tparams = params_from_numpy(_np(jparams), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, jparams, jbatch, tcfg, tparams, tbatch, ref


def _port_grads(tcfg, tparams, tbatch, impl):
    model = build_model(tcfg.with_(softmax_impl=impl))
    loss, _, grads = grads_of(lambda p, b: model.loss(p, b, remat="full"),
                              tparams, tbatch)
    return float(loss), grads


def test_lm_loss_and_grads_match_jax(setup):
    """lm_loss and its gradient through the kernel softmax's autograd op,
    under remat "full"; the CPU runs no kernel (launch counts stay)."""
    *_, tcfg, tparams, tbatch, ref = setup
    before = (dict(ths.LAUNCHES), dict(fa.LAUNCHES))
    loss, grads = _port_grads(tcfg, tparams, tbatch, "hyft16_kernel")
    assert (dict(ths.LAUNCHES), dict(fa.LAUNCHES)) == before
    want_loss, want_grads = ref["hyft16_kernel"]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want_grads)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()))


def test_kernel_entry_equals_the_hyft_entry(setup):
    """hyft16_kernel and hyft16 compute the same function with the same
    backward (cfg.grad is "hyft"): the port gives both the same loss and
    gradient bits, as the JAX package gives both the same loss."""
    *_, tcfg, tparams, tbatch, ref = setup
    assert ref["hyft16_kernel"][0] == ref["hyft16"][0]
    lk, gk = _port_grads(tcfg, tparams, tbatch, "hyft16_kernel")
    lh, gh = _port_grads(tcfg, tparams, tbatch, "hyft16")
    assert lk == lh
    for a, b in zip(tree_leaves(gk), tree_leaves(gh)):
        assert torch.equal(a, b)


def test_train_step_matches_jax(setup):
    """One SGD step of make_step_fn from the same state on the same batch:
    the metrics and the new parameters (SGD's update is linear in the
    gradient, so the parameters agree to the gradients' tolerance)."""
    jcfg, jparams, jbatch, tcfg, tparams, tbatch, _ = setup
    tc = dict(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=2, total_steps=10,
              optimizer="sgd", attn_mode="unfused", remat="full")
    ocfg = dict(name="sgd", lr=1e-2)
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
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= GRAD_TOL * float(jm["grad_norm"])
    assert int(new["step"]) == 4
    for got, want, old in zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"]),
                              jax.tree.leaves(jparams)):
        moved = np.abs(np.asarray(want) - np.asarray(old)).max()
        assert np.abs(got.numpy() - np.asarray(want)).max() <= GRAD_TOL * moved + 1e-7


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
def test_greedy_generate_matches_jax(setup, cache_dtype):
    """Greedy generate, prompt and decode both through the kernel softmax
    in the unfused mode, gives JAX's tokens."""
    jcfg, jparams, _, tcfg, tparams, _ = setup[:6]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    ref = jax_generate(jax_build_model(jcfg), jparams, {"tokens": jnp.asarray(toks)},
                       JaxServeConfig(max_len=16, cache_dtype=cache_dtype,
                                      attn_mode="unfused"), max_new=5)
    got = generate(build_model(tcfg), tparams, {"tokens": torch.from_numpy(toks)},
                   ServeConfig(max_len=16, cache_dtype=cache_dtype, attn_mode="unfused"),
                   max_new=5, device="cpu")
    assert got.shape == (2, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_the_unfused_kernel_path_on_cpu(launcher):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = {"serve": ["--max-new", "3", "--cache-dtype", "fp2fx8"],
            "train": ["--steps", "2", "--global-batch", "2", "--seq", "32"]}[launcher]
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", "qwen2-1.5b",
         "--smoke", "--device", "cpu", "--softmax", "hyft16_kernel",
         "--attn-mode", "unfused", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    if launcher == "train":
        assert np.isfinite(float(res.stdout.strip().splitlines()[-1].split(":")[1]))
    else:
        assert res.stdout.count("[") >= 3
