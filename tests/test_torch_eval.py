"""The port's Tables 1-3 proxies (``repro_torch.evaluation``) against the
JAX package's (``benchmarks/table{1,2,3}_*.py``), on the CPU.

The same inputs, made with numpy from a seed (or the JAX weights through
the weights bridge), go to both.  Tolerances: the cost model is the same
pure Python, so Table 3 is exact; the classifier's logits within 1e-5 of
their largest (fp32 matmuls sum in another order); one training step's
loss within 1e-5 relative and each gradient leaf within 1e-3 of its
largest |g|, ``tests/test_torch_train.py``'s tolerances; the softmax error
metrics within 1e-5 relative (1e-7 absolute, for the exact softmax's
rounding-level KL).  torch runs under ``set_flush_denormal``: XLA on the CPU
flushes subnormals.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
from repro.core.costmodel import table3 as jax_table3
from repro_torch import optim
from repro_torch.convert import params_from_numpy
from repro_torch.core.costmodel import table3
from repro_torch.data.synthetic import classify_batch
from repro_torch.evaluation import table1_accuracy as t1
from repro_torch.evaluation import table2_training as t2
from repro_torch.evaluation import table3_hardware as t3
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # benchmarks/
from benchmarks import table1_accuracy as jt1  # noqa: E402
from benchmarks import table2_training as jt2  # noqa: E402
from benchmarks import table3_hardware as jt3  # noqa: E402

LOGIT_RTOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-3


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _batch(vocab, seed=0, batch=8, seq=24):
    """Seeded tokens and labels of the marker task, as numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, batch).astype(np.int32)
    tokens = rng.integers(5, vocab, (batch, seq)).astype(np.int32)
    marker = rng.random((batch, seq)) < 0.3
    return np.where(marker, labels[:, None] + 1, tokens).astype(np.int32), labels


def _setup(softmax):
    """The JAX proxy classifier and its weights bridged to the port."""
    jcfg = jt1._bert_proxy_cfg(softmax)
    jparams = jt1._classifier_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_np(jparams), "cpu")
    return jcfg, jparams, t1._bert_proxy_cfg(softmax), tparams


def test_table3_rows_equal_jax():
    assert table3(N=8) == jax_table3(N=8)
    got, want = [], []
    t3.run(got.append, device="cpu")
    jt3.run(want.append)
    assert got == want and len(got) == 6


def test_classify_batch_shapes_labels_and_marker_rate():
    b = classify_batch(0, 3, 64, 128, vocab=30522)
    tokens, labels = b["tokens"], b["labels"]
    assert tokens.shape == (64, 128) and labels.shape == (64,)
    assert tokens.dtype == torch.int32 and labels.dtype == torch.int32
    assert int(labels.min()) >= 0 and int(labels.max()) < 4
    marker = tokens == labels[:, None] + 1
    assert abs(float(marker.float().mean()) - 0.3) <= 0.05
    base = tokens[~marker]
    assert int(base.min()) >= 5 and int(base.max()) < 30522
    assert torch.equal(classify_batch(0, 3, 64, 128, vocab=30522)["tokens"], tokens)
    assert not torch.equal(classify_batch(0, 4, 64, 128, vocab=30522)["tokens"], tokens)


@pytest.mark.parametrize("softmax", ["exact", "hyft32"])
def test_logits_match_jax(softmax):
    jcfg, jparams, tcfg, tparams = _setup(softmax)
    tokens, _ = _batch(jcfg.vocab)
    want = np.asarray(jt1._logits(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = t1._logits(tparams, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("softmax, loss_scale", [("exact", 1.0), ("hyft32", 256.0)])
def test_train_step_matches_jax(softmax, loss_scale):
    """One step of ``_train_with``'s loop: the loss, every gradient leaf and
    the AdamW update against the JAX proxy's step on the same weights and
    batch."""
    jcfg, jparams, tcfg, tparams = _setup(softmax)
    tokens, labels = _batch(jcfg.vocab, seed=1)
    ocfg = joptim.OptConfig(name="adamw", lr=2e-3, weight_decay=0.0)

    def loss_fn(p):   # the body of benchmarks/table2_training.py's step
        lg = jt1._logits(p, jnp.asarray(tokens), jcfg)
        return loss_scale * jnp.mean(
            -jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), jnp.asarray(labels)])
    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    jgrads = jax.tree.map(lambda x: x / loss_scale, jgrads)
    jnew, _ = joptim.update(ocfg, jgrads, joptim.init(ocfg, jparams), jparams)

    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    loss, grads = t1._loss_and_grads(tparams, tt, tl, tcfg, loss_scale)
    want_loss = float(jloss) / loss_scale
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(_np(jgrads))):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))
    tocfg = optim.OptConfig(name="adamw", lr=2e-3, weight_decay=0.0)
    new, _, loss2 = t1._train_step(tparams, optim.init(tocfg, tparams), tt, tl, tcfg, tocfg,
                                   loss_scale)
    assert float(loss2) == float(loss)
    # AdamW's first step moves each weight by about lr * sign(g): a gradient
    # within its tolerance may still flip a sign where it is about 0
    for p, w in zip(tree_leaves(new), jax.tree.leaves(_np(jnew))):
        assert float(np.abs(p.numpy() - w).max()) <= 2 * 2e-3 + 1e-6


@pytest.mark.parametrize("impl", t1.IMPLS)
def test_softmax_error_metrics_match_jax(impl):
    z = np.array(jax.random.normal(jax.random.PRNGKey(0), (256, 128), jnp.float32) * 3.0)
    want = jt1.softmax_error_metrics(impl)
    got = t1.softmax_error_metrics(impl, z=torch.from_numpy(z))
    for k in ("mean_abs", "max_abs", "mean_kl"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) + 1e-7, (k, got[k], want[k])


def test_classifier_trains_past_the_target_on_the_cpu():
    """The port's ``_train_classifier`` (150 steps, exact softmax) reaches
    0.95 held-out accuracy, as the JAX proxy does (0.998)."""
    cfg, params = t1._train_classifier(device="cpu")
    assert t1._accuracy(params, cfg, "exact") >= 0.95


def test_proxies_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for run in (t1.run, t2.run, t3.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(print)
    assert t1.IMPLS == jt1.IMPLS + ["hyft16_kernel"]
    assert t2.IMPLS == jt2.IMPLS + ["hyft16_kernel"]
