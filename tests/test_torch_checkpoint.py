"""The port's checkpointing and restart against the JAX package's, on the CPU.

The port's copies of ``tests/test_substrate.py``'s checkpoint and
fault-tolerance cases; checkpoints crossing between the two packages bit
for bit in both directions (the same ``arrays.npz`` + ``manifest.json``
layout, bf16 as uint16 bits, JAX's ``keystr`` leaf paths); and
``run_train`` killed at step 15 of 20 ending bitwise equal to the
uninterrupted run, as ``tests/test_system.py`` holds the JAX loop.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro_torch import optim
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.distributed.fault_tolerance import RestartManager, StragglerMonitor
from repro_torch.models import build_model
from repro_torch.train import loop
from repro_torch.train.loop import run_train
from repro_torch.train.state import init_state
from repro_torch.train.step import make_step_fn
from repro_torch.tree import tree_leaves


def _state():
    """A tree with every leaf type a train state holds: fp32, bf16 and
    int32 leaves, nested dicts, a 0-d step."""
    g = torch.Generator().manual_seed(0)
    return {"params": {"blocks": {"w": torch.randn(3, 4, 5, generator=g),
                                  "scale": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
                       "embed": {"table": torch.randn(7, 5, generator=g)}},
            "opt": {"m": {"w": torch.randn(3, 4, 5, generator=g)},
                    "step": torch.tensor(4, dtype=torch.int32)},
            "step": torch.tensor(5, dtype=torch.int32)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
                 "step": torch.tensor(5, dtype=torch.int32)}
        ck.save(str(tmp_path), 5, state)
        like = {"a": torch.zeros(2, 3, dtype=torch.int64),
                "b": {"c": torch.zeros(4, dtype=torch.bfloat16)},
                "step": torch.zeros((), dtype=torch.int32)}
        restored, step = ck.restore(str(tmp_path), 5, like)
        assert step == 5
        for x, y in zip(tree_leaves(state), tree_leaves(restored)):
            assert x.dtype == y.dtype and torch.equal(x, y)

    def test_keep_k_gc(self, tmp_path):
        for s in range(6):
            ck.save(str(tmp_path), s, {"x": torch.ones(2)}, keep=2)
        assert ck.all_steps(str(tmp_path)) == [4, 5]

    def test_no_partial_checkpoint_visible(self, tmp_path):
        os.makedirs(tmp_path / "step_00000009.tmp")  # simulated crash debris
        ck.save(str(tmp_path), 3, {"x": torch.ones(2)})
        assert ck.all_steps(str(tmp_path)) == [3]
        assert ck.latest_step(str(tmp_path)) == 3
        assert ck.latest_step(str(tmp_path / "absent")) is None

    def test_restore_takes_the_like_trees_dtype(self, tmp_path):
        ck.save(str(tmp_path), 1, {"x": torch.tensor([1.5, -2.0]),
                                   "y": torch.tensor([1.5], dtype=torch.bfloat16)})
        got, _ = ck.restore(str(tmp_path), 1, {"x": torch.zeros(2, dtype=torch.bfloat16),
                                               "y": torch.zeros(1)})
        assert got["x"].dtype == torch.bfloat16 and got["x"].tolist() == [1.5, -2.0]
        assert got["y"].dtype == torch.float32 and got["y"].tolist() == [1.5]


class TestFaultTolerance:
    def test_restart_manager_resumes(self, tmp_path):
        calls, restarts = [], []

        def body(start):
            calls.append(start)
            state = {"x": torch.full((2,), float(start))}
            for step in range(start, 10):
                state = {"x": state["x"] + 1}
                if step == 4 and len(calls) == 1:
                    ck.save(str(tmp_path), step + 1, state)
                    raise RuntimeError("injected node failure")
            return 10

        rm = RestartManager(str(tmp_path), max_restarts=2, on_restart=restarts.append)
        assert rm.run(body) == 10
        assert calls == [0, 5]  # resumed from the checkpointed step
        assert restarts == [1]

    def test_restart_bounded(self, tmp_path):
        calls = []

        def body(start):
            calls.append(start)
            raise RuntimeError("always fails")

        with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
            RestartManager(str(tmp_path), max_restarts=2).run(body)
        assert calls == [0, 0, 0]

    @pytest.mark.parametrize("exc", [KeyboardInterrupt, SystemExit])
    def test_interrupt_and_exit_pass_through(self, tmp_path, exc):
        calls = []

        def body(start):
            calls.append(start)
            raise exc()

        with pytest.raises(exc):
            RestartManager(str(tmp_path), max_restarts=2).run(body)
        assert calls == [0]

    def test_straggler_monitor(self):
        m = StragglerMonitor(threshold=3.0, warm=3)
        for _ in range(10):
            m.observe(0.1)
        assert m.flagged == 0
        assert m.observe(1.0) is True
        assert m.flagged == 1
        # outlier did not poison the EMA
        assert m.ema < 0.2
        assert loop.StragglerMonitor is StragglerMonitor   # the loop's re-export


def test_jax_checkpoint_restores_bitwise_into_the_port(tmp_path):
    """JAX's checkpointer writes, the port's restores: every leaf's bits
    and dtype (the JAX tree's extra ``rng`` leaf is not in the port's
    state and is left out)."""
    state = _state()
    jstate = jax.tree.map(lambda t: jnp.asarray(
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy()), state)
    jstate["rng"] = jax.random.PRNGKey(0)
    jck.save(str(tmp_path), 7, jstate)
    like = jax.tree.map(torch.zeros_like, state)
    got, step = ck.restore(str(tmp_path), 7, like)
    assert step == 7
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_bitwise_into_jax(tmp_path):
    """The port's checkpointer writes, JAX's restores: every leaf's bits
    and dtype, and both write the same manifest."""
    state = _state()
    ck.save(str(tmp_path / "port"), 7, state)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                         torch.int32: jnp.int32}[t.dtype]), state)
    got, step = jck.restore(str(tmp_path / "port"), 7, like)
    assert step == 7
    for a, b in zip(jax.tree.leaves(got), tree_leaves(state)):
        want = _bits(b).numpy()
        have = np.asarray(a).view(np.int16) if a.dtype == jnp.bfloat16 else np.asarray(a)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(have, want)
    jstate = jax.tree.map(jnp.asarray, got)
    jck.save(str(tmp_path / "jax"), 7, jstate)
    with open(tmp_path / "port" / "step_00000007" / "manifest.json") as f:
        port_manifest = f.read()
    with open(tmp_path / "jax" / "step_00000007" / "manifest.json") as f:
        assert f.read() == port_manifest


def _tiny_setup(steps=20):
    """``tests/test_system.py``'s tiny run on the port: olmo-1b smoke, 2
    layers, vocab 64, the exact softmax, AdamW without weight decay, a
    checkpoint every 10 steps."""
    cfg = smoke_config(get_config("olmo-1b")).with_(softmax_impl="exact", vocab=64,
                                                    n_layers=2)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=steps, lr=3e-3, warmup_steps=5,
                       checkpoint_every=10, z_loss=0.0)
    ocfg = optim.OptConfig(name="adamw", lr=3e-3, weight_decay=0.0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    state = init_state(model, ocfg, 0, device="cpu")
    return tcfg, state, make_step_fn(model, tcfg, ocfg), dcfg


def test_checkpoint_restart_mid_training(tmp_path):
    """Kill at step 15 of 20, restart from step 10's checkpoint: the final
    params and optimizer state equal the uninterrupted run's bit for bit."""
    def run(fail, ckpt_dir):
        tcfg, state, step, dcfg = _tiny_setup()
        fired = []

        def fail_at(s):
            if fail and s == 15 and not fired:
                fired.append(s)
                raise RuntimeError("injected failure")
        state, _ = run_train(state, step, lambda s: lm_batch(dcfg, s), tcfg,
                             ckpt_dir=str(ckpt_dir), fail_at=fail_at, log_every=100,
                             log_fn=lambda *_: None)
        assert fired == ([15] if fail else [])
        return state

    s1 = run(False, tmp_path / "a")
    s2 = run(True, tmp_path / "b")
    assert ck.all_steps(str(tmp_path / "b")) == [10, 20]
    assert int(s2["step"]) == 20
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b)
