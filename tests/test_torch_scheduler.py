"""The port's slot-pool scheduler against the JAX package's, on the CPU.

The same requests go through ``repro.serve.scheduler.SlotPoolEngine`` and
``repro_torch.serve.scheduler.SlotPoolEngine`` on the qwen2-1.5b smoke
model (hyft16, vocab 64, fp32 compute, ``attn_mode="kernel"``: Pallas in
interpret mode on the JAX side, the plain versions of the CUDA kernels on
the port's), the weights carried across by ``repro_torch.convert``.  The
block weights are scaled by 3 so that greedy decoding does not settle on
one repeated token.  Greedy tokens and each request's outcome must be
equal, and so must the scheduler's counters where a case is about them.

Every arrival is at 0, so admission order never depends on timing; the
deadline case drives the port's engine through its injected clock, and
mid-run cancellation drives both engines step by step.  The JAX engine
hands its numpy slot mirrors to asynchronously dispatched calls through
``jnp.asarray`` and then updates them in place, relying on ``asarray`` to
copy; on the CPU it shares the memory of a 64-byte-aligned array, so its
tokens change from run to run (ROADMAP queue 3).  This module hands the
JAX scheduler a ``jax.numpy`` whose ``asarray`` copies, as the engine
assumes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.models.layers import unbox
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.serve import kvpool
from repro_torch.serve import scheduler as tsched

KW = dict(softmax_impl="hyft16", vocab=64, compute_dtype="float32")


class _CopyingJnp:
    """``jax.numpy`` with an ``asarray`` that always copies its input."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x):
        return jnp.array(x, copy=True)


@pytest.fixture(scope="module", autouse=True)
def _jax_scheduler_copies_host_mirrors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsched, "jnp", _CopyingJnp())
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**KW)
    jmodel = jax_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    jparams["blocks"] = jax.tree.map(lambda x: x * 3 if x.ndim >= 3 else x,
                                     jparams["blocks"])
    tcfg = smoke_config(get_config("qwen2-1.5b")).with_(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _requests(n, seed, plen=(3, 9), max_new=(3, 9), **kw):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, tokens=rng.integers(0, 64, int(rng.integers(*plen)))
                 .astype(np.int32), max_new=int(rng.integers(*max_new)), **kw)
            for rid in range(n)]


def _engines(setup, reqs, clock=None, **kw):
    """(jax engine, port engine), built on the same serve config."""
    jmodel, jparams, tmodel, tparams = setup
    kw = dict(dict(max_len=32, cache_dtype="float32", scheduler="continuous",
                   n_slots=3, decode_burst=4, attn_mode="kernel", audit=True),
              **kw)
    jeng = jsched.SlotPoolEngine(jmodel, jparams, JaxServeConfig(**kw))
    extra = {} if clock is None else {"clock": clock}
    teng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**kw), device="cpu",
                                 **extra)
    return jeng, teng


def _outcome(c):
    return (c.tokens, c.ok, c.cancelled,
            None if c.failure is None else c.failure.reason)


def _serve_both(setup, reqs, **kw):
    jeng, teng = _engines(setup, reqs, **kw)
    jdone = jeng.run([jsched.Request(**r) for r in reqs])
    tdone = teng.run([tsched.Request(**r) for r in reqs])
    assert sorted(jdone) == sorted(tdone) == sorted(r["rid"] for r in reqs)
    for rid in jdone:
        assert _outcome(tdone[rid]) == _outcome(jdone[rid]), rid
    return jeng, teng, tdone


def _stats_equal(jeng, teng, keys):
    for k in keys:
        assert teng.stats[k] == jeng.stats[k], k


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_matches_jax(setup, layout, cache_dtype):
    """5 ragged requests through 3 slots: queueing and admission into freed
    slots mid-decode, dense stripes or pages of 4."""
    reqs = _requests(5, 0)
    jeng, teng, done = _serve_both(setup, reqs, kv_layout=layout, page_size=4,
                                   cache_dtype=cache_dtype)
    assert all(done[r["rid"]].ok and len(done[r["rid"]].tokens) == r["max_new"]
               for r in reqs)
    assert len({t for c in done.values() for t in c.tokens}) > 5   # not one token
    _stats_equal(jeng, teng, ["admitted", "bursts", "prefills", "burst_steps",
                              "tokens_emitted", "pages_peak"])
    if layout == "paged":
        assert teng.pool.pages_in_use == 0


def test_prefix_cache_hits_match_jax(setup):
    """Prompts sharing a 12-token head through one slot: every follower hits
    the trie, only the suffix goes through the model."""
    rng = np.random.default_rng(1)
    head = rng.integers(0, 64, 12).astype(np.int32)
    reqs = [dict(rid=i, tokens=np.concatenate(
        [head, rng.integers(0, 64, 3).astype(np.int32)]), max_new=5)
        for i in range(4)]
    jeng, teng, _ = _serve_both(setup, reqs, kv_layout="paged", page_size=4,
                                prefix_cache=True, n_slots=1)
    assert teng.stats["prefix_hits"] == 3 and teng.stats["cached_tokens"] == 36
    _stats_equal(jeng, teng, ["prefix_hits", "cached_tokens", "prefill_tokens",
                              "prompt_tokens", "pages_peak"])


def test_page_exhaustion_preempts_like_jax(setup):
    """A pool of 9 pages for three 16-token sequences: the latest arrival is
    preempted, requeued with its tokens folded in, and still finishes."""
    reqs = _requests(3, 3, plen=(6, 7), max_new=(10, 11))
    jeng, teng, done = _serve_both(setup, reqs, kv_layout="paged", page_size=4,
                                   n_pages=9)
    assert teng.stats["preemptions"] >= 1
    assert all(len(c.tokens) == 10 for c in done.values())
    _stats_equal(jeng, teng, ["preemptions", "admitted", "pages_peak"])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prompt_longer_than_one_chunk(setup, layout):
    """prefill_chunk=4 with prompts of up to 13 tokens: prompts span several
    chunk calls interleaved with decode bursts."""
    reqs = _requests(5, 4, plen=(6, 14))
    jeng, teng, _ = _serve_both(setup, reqs, kv_layout=layout, page_size=4,
                                prefill_chunk=4)
    assert teng.stats["prefills"] > len(reqs)
    _stats_equal(jeng, teng, ["prefills", "prefill_tokens"])


def test_lockstep_matches_jax(setup):
    reqs = _requests(5, 5)
    jeng, teng, _ = _serve_both(setup, reqs, scheduler="lockstep",
                                kv_layout="paged", page_size=4, eos_id=7)
    _stats_equal(jeng, teng, ["admitted", "bursts", "prefills"])


def test_eos_frees_slot_like_jax(setup):
    """EOS is a token one request emits mid-decode: that request stops
    there and its slot takes the next request."""
    reqs = _requests(5, 6, max_new=(8, 12))
    _, teng, done = _serve_both(setup, reqs, kv_layout="paged", page_size=4)
    toks = done[0].tokens
    eos = next(t for t in toks[2:] if t not in toks[:2])
    jeng, teng, done = _serve_both(setup, reqs, kv_layout="paged", page_size=4,
                                   eos_id=eos)
    assert done[0].tokens[-1] == eos and len(done[0].tokens) < reqs[0]["max_new"]
    _stats_equal(jeng, teng, ["admitted", "bursts", "tokens_emitted"])


def test_malformed_requests_and_queue_full(setup):
    """An invalid request fails alone; with max_queue=1 the arrivals past
    the one queue seat fail with queue_full."""
    reqs = _requests(4, 7)
    reqs[1]["max_new"] = 0
    reqs[2]["tokens"] = np.arange(30, dtype=np.int32) % 64      # 30 + max_new > 32
    _serve_both(setup, reqs)
    jeng, teng, done = _serve_both(setup, _requests(4, 8), n_slots=1, max_queue=1)
    assert [c.failure.reason for c in done.values() if not c.ok] == ["queue_full"] * 3
    _stats_equal(jeng, teng, ["rejected", "failures"])


def test_cancel_mid_run_like_jax(setup):
    """Admit, prefill, one burst, cancel: a partial, cancelled completion
    whose tokens are the same in both, and a freed slot."""
    reqs = _requests(2, 9, max_new=(12, 13))
    jeng, teng = _engines(setup, reqs, kv_layout="paged", page_size=4)
    for eng, mod in ((jeng, jsched), (teng, tsched)):
        eng.admit([mod.Request(**r) for r in reqs], 0.0)
        eng._prefill_step(0.0)
        eng.burst(0.0)
        eng.cancel(0)
        eng.cancel(99)                        # unknown: ignored
        eng._apply_cancels(0.0)
    assert _outcome(teng.completions[0]) == _outcome(jeng.completions[0])
    c = teng.completions[0]
    assert c.cancelled and 0 < len(c.tokens) < 12
    assert teng.slot_rid.count(None) == jeng.slot_rid.count(None) == 2
    done = teng.shutdown()
    assert done[1].cancelled and teng.pool.pages_in_use == 0


class _Ticks:
    """A clock that moves one second at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_deadline_through_the_engine_clock(setup):
    """Deadlines on the injected clock: the request with the short deadline
    ends with reason ``deadline`` and a prefix of its undeadlined tokens
    (its slot and pages freed, the audit clean); the others are unchanged."""
    reqs = _requests(3, 10, max_new=(12, 13))
    ref = tsched.SlotPoolEngine(setup[2], setup[3], ServeConfig(
        max_len=32, cache_dtype="float32", scheduler="continuous", n_slots=3,
        decode_burst=2, attn_mode="kernel", kv_layout="paged", page_size=4),
        device="cpu", clock=_Ticks()).run([tsched.Request(**r) for r in reqs])
    reqs[0]["deadline"] = 12.0
    _, teng = _engines(setup, reqs, clock=_Ticks(), kv_layout="paged",
                       page_size=4, decode_burst=2)
    done = teng.run([tsched.Request(**r) for r in reqs])
    assert done[0].failure is not None and done[0].failure.reason == "deadline"
    assert 0 < len(done[0].tokens) < 12
    assert done[0].tokens == ref[0].tokens[:len(done[0].tokens)]
    assert done[1].tokens == ref[1].tokens and done[2].tokens == ref[2].tokens
    assert teng.stats["expired"] == 1 and teng.pool.pages_in_use == 0


def test_config_is_validated(setup):
    tmodel, tparams = setup[2], setup[3]
    bad = [dict(kv_layout="paged", page_size=4, n_pages=4),   # < one request
           dict(prefix_cache=True), dict(kv_layout="banana"),
           dict(scheduler="banana"), dict(max_queue=-1)]
    for kw in bad:
        with pytest.raises(ValueError):
            tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(max_len=32, **kw),
                                  device="cpu")
    # the speculative scheduler is ported: it builds, and refuses what JAX's
    # refuses (tests/test_torch_spec.py holds the rest)
    eng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(max_len=32, scheduler="spec"),
                                device="cpu")
    assert eng.spec and eng.drafter is not None
    for kw in (dict(temperature=0.5), dict(draft_k=0), dict(spec_mode="banana")):
        with pytest.raises(ValueError):
            tsched.SlotPoolEngine(tmodel, tparams,
                                  ServeConfig(max_len=32, scheduler="spec", **kw),
                                  device="cpu")


def test_audit_catches_a_leaked_slot_page(setup):
    _, teng = _engines(setup, [], kv_layout="paged", page_size=4)
    teng.slot_pages[0] = teng.pool.alloc(1)          # held by a free slot
    with pytest.raises(kvpool.AuditError, match="freed slot 0"):
        teng._audit_check()


def test_non_finite_logits_raise_naming_the_slot(setup):
    """Until the quarantine ladder is ported, a poisoned page fails loudly
    with the slot and the request instead of emitting garbage."""
    reqs = _requests(1, 11, max_new=(8, 9))
    _, teng = _engines(setup, reqs, kv_layout="paged", page_size=4)
    teng.admit([tsched.Request(**reqs[0])], 0.0)
    teng._prefill_step(0.0)
    teng.cache["blocks"]["v"][:, teng.slot_pages[0][0]] = float("nan")
    with pytest.raises(RuntimeError, match="slot 0 \\(request 0\\)"):
        teng.burst(0.0)


def test_serve_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.serve(setup[2], setup[3], [], ServeConfig(max_len=32))


def test_continuous_paged_launcher_runs_on_cpu():
    """The CLI's continuous paged path at smoke size on the CPU; without
    ``--device cpu`` and without a card it raises."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-1.5b",
           "--smoke", "--scheduler", "continuous", "--kv-layout", "paged",
           "--prefix-cache", "--cache-dtype", "fp2fx8", "--attn-mode", "kernel",
           "--batch", "5", "--max-new", "6", "--prefill-chunk", "8"]
    res = subprocess.run(cmd + ["--device", "cpu"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert sum(line.startswith("[") for line in res.stdout.splitlines()) == 5
    assert "FAILED" not in res.stdout and "stats:" in res.stdout
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
