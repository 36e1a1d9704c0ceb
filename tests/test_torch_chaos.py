"""The port's quarantine ladder and chaos harness against the JAX package's.

The same requests and the same ``FaultPlan`` go through
``repro.serve.scheduler.SlotPoolEngine`` with ``repro.serve.chaos`` and
through ``repro_torch.serve.scheduler.SlotPoolEngine`` with
``repro_torch.serve.chaos``, on the qwen2-1.5b smoke model (hyft16, vocab
64, fp32 compute, kernel mode: Pallas in interpret mode on the JAX side,
the plain versions of the CUDA kernels on the port's), the weights carried
across by ``repro_torch.convert`` and scaled by 3 as in
``tests/test_torch_scheduler.py``.  Every arrival is at 0 with no
deadline, so the scheduling sequence and with it the harness's draws do
not depend on the clock: the fault log, the quarantine and retry counts
and every request's outcome and tokens must be equal.  The JAX engine gets
a ``jax.numpy`` whose ``asarray`` copies (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.models.layers import unbox
from repro.serve import chaos as jchaos
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig, get_config, smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.serve import chaos as tchaos
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


def _requests(n, seed, plen=(3, 9), max_new=(3, 9), motif=False):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        if motif:   # a repeated motif, so the n-gram drafter drafts
            toks = np.concatenate([np.tile(rng.integers(0, 64, 3), 3),
                                   rng.integers(0, 64, 2)])
        else:
            toks = rng.integers(0, 64, int(rng.integers(*plen)))
        out.append(dict(rid=rid, tokens=toks.astype(np.int32),
                        max_new=int(rng.integers(*max_new))))
    return out


def _serve(setup, reqs, plan=None, jax_too=True, **kw):
    """Serve ``reqs`` through the port (and the JAX engine) under ``plan``:
    returns (port engine, port monkey, port completions, jax engine, jax
    monkey, jax completions)."""
    jmodel, jparams, tmodel, tparams = setup
    kw = dict(dict(max_len=32, cache_dtype="float32", scheduler="continuous",
                   n_slots=2, decode_burst=4, attn_mode="kernel"), **kw)
    tmonkey = tchaos.ChaosMonkey(tchaos.FaultPlan(**plan)) if plan else None
    teng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**kw), device="cpu",
                                 chaos=tmonkey)
    tdone = teng.run([tsched.Request(**r) for r in reqs])
    if not jax_too:
        return teng, tmonkey, tdone, None, None, None
    jmonkey = jchaos.ChaosMonkey(jchaos.FaultPlan(**plan)) if plan else None
    jeng = jsched.SlotPoolEngine(jmodel, jparams, JaxServeConfig(**kw), chaos=jmonkey)
    jdone = jeng.run([jsched.Request(**r) for r in reqs])
    return teng, tmonkey, tdone, jeng, jmonkey, jdone


def _outcome(c):
    return (c.tokens, c.ok, c.cancelled, None if c.failure is None else c.failure.reason)


def _same_as_jax(teng, tmonkey, tdone, jeng, jmonkey, jdone, keys=()):
    assert tmonkey.log == jmonkey.log
    assert tmonkey.faulted_rids == jmonkey.faulted_rids
    assert sorted(tdone) == sorted(jdone)
    for rid in jdone:
        assert _outcome(tdone[rid]) == _outcome(jdone[rid]), rid
    for k in ("quarantines", "fp32_retries", "failures") + tuple(keys):
        assert teng.stats[k] == jeng.stats[k], k


@pytest.mark.parametrize("cache_dtype", ["float32", "fp2fx8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_quarantine_recovers_like_jax(setup, layout, cache_dtype):
    """One NaN poison (fp32 rows or fp2fx8 scale rows; a dense stripe or
    the slot's exclusive frontier page): the same slot is quarantined,
    requeued and recomputed in both, and every request's tokens equal the
    fault-free run's, the poisoned one's included."""
    reqs = _requests(2, 6, plen=(4, 7), max_new=(8, 11))
    kw = dict(kv_layout=layout, cache_dtype=cache_dtype)
    if layout == "paged":
        kw.update(page_size=4, prefix_cache=True, audit=True)
    base = _serve(setup, reqs, jax_too=False, **kw)[2]
    run = _serve(setup, reqs, dict(seed=0, nan_kv_rate=1.0, max_faults=1), **kw)
    _same_as_jax(*run)
    teng, monkey, done = run[:3]
    assert teng.stats["quarantines"] == 1 and len(monkey.faulted_rids) == 1
    assert [e["kind"] for e in monkey.log] == ["nan_kv"]
    for r in reqs:
        assert done[r["rid"]].ok and done[r["rid"]].tokens == base[r["rid"]].tokens
    if layout == "paged":
        assert teng.pool.pages_in_use == teng.trie.n_pages() and teng.stats["audits"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_unfused_quarantine_recovers_like_jax(setup, layout):
    """The unfused mode (the JAX config's default ``attn_mode``, and the
    card's ladder runs in ``chip_smoke.py``): PV is a plain product, so a
    NaN V reaches the logits; up to three poisons over three requests give
    the same log, quarantines and tokens as JAX, one quarantine a poison,
    every request its fault-free tokens."""
    reqs = _requests(3, 11, plen=(4, 9), max_new=(8, 11))
    kw = dict(kv_layout=layout, attn_mode="unfused", n_slots=3)
    if layout == "paged":
        kw.update(page_size=4, prefix_cache=True, audit=True)
    base = _serve(setup, reqs, jax_too=False, **kw)[2]
    run = _serve(setup, reqs, dict(seed=0, nan_kv_rate=1.0, max_faults=3), **kw)
    _same_as_jax(*run)
    teng, monkey, done = run[:3]
    n_nan = sum(e["kind"] == "nan_kv" for e in monkey.log)
    assert teng.stats["quarantines"] == n_nan >= 2
    for r in reqs:
        assert done[r["rid"]].ok and done[r["rid"]].tokens == base[r["rid"]].tokens


def test_repeat_fault_walks_to_fp32_retry_like_jax(setup):
    """The same request poisoned twice: the first fault requeues it, the
    second sends it to the one unfused fp32 retry, which completes its
    budget with JAX's tokens."""
    reqs = _requests(1, 7, max_new=(6, 7))
    run = _serve(setup, reqs, dict(seed=0, nan_kv_rate=1.0, max_faults=2), n_slots=1)
    _same_as_jax(*run)
    teng, _, done = run[:3]
    assert teng.stats["quarantines"] == 2 and teng.stats["fp32_retries"] == 1
    assert done[0].ok and len(done[0].tokens) == reqs[0]["max_new"]


def test_third_fault_fails_with_numeric_fault(setup):
    """Past the fp32 retry the ladder ends: an engine that may not retry
    (the retry engine itself) fails the request with ``numeric_fault`` on
    its second fault, keeping the tokens emitted before it."""
    _, _, tmodel, tparams = setup
    reqs = _requests(1, 7, max_new=(6, 7))
    monkey = tchaos.ChaosMonkey(tchaos.FaultPlan(seed=0, nan_kv_rate=1.0, max_faults=2))
    eng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(
        max_len=32, cache_dtype="float32", scheduler="continuous", n_slots=1,
        decode_burst=4, attn_mode="kernel"), device="cpu", chaos=monkey)
    eng._allow_fp32_retry = False
    c = eng.run([tsched.Request(**reqs[0])])[0]
    assert c.failure is not None and c.failure.reason == "numeric_fault"
    assert eng.stats["quarantines"] == 2 and eng.stats["fp32_retries"] == 0
    assert not eng.active.any() and eng.slot_rid == [None]


def test_retries_exhausted_after_a_quarantine_like_jax(setup):
    """``max_retries=0``: the requeue of the first quarantine fails the
    request with ``retries_exhausted``, in both."""
    reqs = _requests(1, 3, max_new=(8, 9))
    run = _serve(setup, reqs, dict(seed=0, nan_kv_rate=1.0, max_faults=1), n_slots=1,
                 max_retries=0)
    _same_as_jax(*run)
    assert run[2][0].failure.reason == "retries_exhausted"


def test_drafter_desync_never_changes_outputs(setup):
    """Junk drafts at rate 1: exact verification rejects them, so the spec
    outputs equal the fault-free spec run's, and JAX's, with the same log."""
    reqs = _requests(3, 9, max_new=(8, 9), motif=True)
    kw = dict(scheduler="spec", draft_k=4)
    base = _serve(setup, reqs, jax_too=False, **kw)[2]
    run = _serve(setup, reqs, dict(seed=0, drafter_junk_rate=1.0), **kw)
    _same_as_jax(*run, keys=("draft_tokens", "accepted_tokens"))
    assert any(e["kind"] == "drafter_junk" for e in run[1].log)
    for r in reqs:
        assert run[2][r["rid"]].tokens == base[r["rid"]].tokens


_SWEEP_KW = dict(kv_layout="paged", page_size=4, prefix_cache=True, n_slots=3, audit=True)


def _sweep_plan(seed):
    return dict(seed=seed, preempt_rate=0.3, evict_storm_rate=0.3, squeeze_rate=0.3,
                squeeze_hold=2, nan_kv_rate=0.3, cancel_rate=0.1, max_faults=12)


@pytest.mark.parametrize("mode", ["paged", "spec"])
def test_mixed_sweep_matches_jax(setup, mode):
    """A mixed seeded plan over a whole run: the JAX package's sweep plans
    at three times the rates (a short run): preemptions, eviction storms,
    NaN poison and a cancellation (paged), junk drafts, preemptions and
    cancellations (spec, paged too).  The same log, counters and outcomes
    as JAX; every request ends definitely; the audits stay clean (the run
    raises otherwise); only the trie holds pages at the end; every ok
    request the poison never touched has its fault-free tokens."""
    reqs = _requests(6, 10, plen=(4, 10), max_new=(6, 12))
    kw = dict(_SWEEP_KW)
    if mode == "paged":
        plan = _sweep_plan(1)
    else:
        kw.update(scheduler="spec", draft_k=4)
        plan = dict(seed=1, drafter_junk_rate=0.3, preempt_rate=0.1, cancel_rate=0.03,
                    max_faults=8)
    base = _serve(setup, reqs, jax_too=False, **kw)[2]
    run = _serve(setup, reqs, plan, **kw)
    _same_as_jax(*run, keys=("preemptions", "cancelled", "audits", "admitted"))
    teng, monkey, done = run[:3]
    assert monkey.n_faults > 0 and set(done) == {r["rid"] for r in reqs}
    kinds = {e["kind"] for e in monkey.log}
    assert kinds >= ({"nan_kv", "evict_storm", "preempt"} if mode == "paged"
                     else {"drafter_junk", "preempt", "cancel"}), kinds
    for rid, c in done.items():
        if c.ok and rid not in monkey.faulted_rids:
            assert c.tokens == base[rid].tokens, rid
    assert teng.pool.pages_in_use == teng.trie.n_pages()


def test_harness_draws_like_jax_without_an_engine():
    """Both harnesses consult their generator once per injection decision:
    the same plan gives the same decisions and draws in the same order
    through the plumbing alone, and a bad payload kind is refused."""
    plan = dict(seed=5, preempt_rate=0.3, max_faults=4)
    t, j = tchaos.ChaosMonkey(tchaos.FaultPlan(**plan)), jchaos.ChaosMonkey(
        jchaos.FaultPlan(**plan))
    for _ in range(20):
        a, b = t._maybe(0.3), j._maybe(0.3)
        assert a == b
        if a:
            t._log("pre_burst", "preempt")
            j._log("pre_burst", "preempt")
    assert t.log == j.log and t.summary() == j.summary() and t.n_faults == 4
    with pytest.raises(ValueError, match="nan_kind"):
        tchaos.ChaosMonkey(tchaos.FaultPlan(nan_kind="zero"))


def test_poisoned_v_serves_what_jax_serves():
    """A reference fault the port keeps (ROADMAP queue 3).  The Hyft
    ``hyft_finalize`` divides the fields of the PV sum, so a NaN sum reads
    as about 2**128, the next norm flattens the slot's state, and with the
    smoke model's own weights and 24-token prompts the poisoned request
    serves wrong tokens from finite logits: no quarantine, in the port as
    in JAX, with the same tokens."""
    jcfg = jax_smoke_config(jax_get_config("qwen2-1.5b")).with_(**KW)
    jmodel = jax_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tmodel = build_model(smoke_config(get_config("qwen2-1.5b")).with_(**KW))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    reqs = _requests(2, 0, plen=(24, 25), max_new=(6, 7))
    kw = dict(kv_layout="paged", page_size=16, max_len=40)
    run = _serve((jmodel, jparams, tmodel, tparams), reqs,
                 dict(seed=0, nan_kv_rate=1.0, max_faults=1), **kw)
    base = _serve((jmodel, jparams, tmodel, tparams), reqs, jax_too=False, **kw)[2]
    _same_as_jax(*run)
    teng, monkey, done = run[:3]
    assert len(monkey.faulted_rids) == 1 and teng.stats["quarantines"] == 0
    rid = next(iter(monkey.faulted_rids))
    assert done[rid].ok and done[rid].tokens != base[rid].tokens     # served garbage


def test_a_poisoned_slot_spreads_through_the_null_page_like_jax(setup):
    """A reference fault the port keeps (ROADMAP queue 3).  The sweep at
    seed 2 squeezes the pool, then poisons a slot that reaches its budget
    mid-burst; from there its NaN state writes K/V for a masked row, which
    goes to the null page.  Every sequence's unused block-table entries
    point there and attention weighs a masked key by a probability that is
    not 0, so all three slots turn non-finite in that burst and are
    quarantined, in the port as in JAX, and every request still ends with
    its fault-free tokens."""
    reqs = _requests(6, 10, plen=(4, 10), max_new=(6, 12))
    base = _serve(setup, reqs, jax_too=False, **_SWEEP_KW)[2]
    run = _serve(setup, reqs, _sweep_plan(2), **_SWEEP_KW)
    _same_as_jax(*run, keys=("preemptions", "cancelled", "audits", "admitted"))
    teng, monkey, done = run[:3]
    first = next(i for i, e in enumerate(monkey.log) if e["kind"] == "nan_kv")
    assert {e["kind"] for e in monkey.log[:first]} >= {"squeeze", "preempt"}
    n_nan = sum(e["kind"] == "nan_kv" for e in monkey.log)
    assert n_nan == 1 and teng.stats["quarantines"] == 3
    for r in reqs:
        assert done[r["rid"]].tokens == base[r["rid"]].tokens
    assert teng.pool.pages_in_use == teng.trie.n_pages()
