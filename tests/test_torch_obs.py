"""The port's observability layer against the JAX package's, on the CPU.

Under test, each held to the JAX module on the same input:
  * metrics — the histogram sketch's percentiles, the registry's snapshot
    rows and JSONL export, the report;
  * tracer — event shapes on one clock, non-finite arguments stringified;
  * numerics — ``logit_stats`` / ``reduce_logit_stats``, ``format_stats``
    over one converted fp2fx8 cache (dense and paged), ``int8_size`` and
    the ``NumericsMonitor`` summary;
  * the scheduler — the ``stats`` view's keys, telemetry that changes no
    token, the telemetry and quarantine annotation of a poisoned run, a
    traced serve whose metrics reconcile with its completions.
The serving cases use ``tests/test_torch_chaos.py``'s smoke model and
copying ``jax.numpy`` (ROADMAP queue 3).
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import attention as jattn
from repro.obs import Obs as JObs
from repro.obs import metrics as jmetrics
from repro.obs import numerics as jnum
from repro.obs import trace as jtrace
from repro.serve import chaos as jchaos
from repro.serve import scheduler as jsched
from repro_torch.configs import ServeConfig
from repro_torch.obs import Obs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import numerics as tnum
from repro_torch.obs import trace as ttrace
from repro_torch.serve import chaos as tchaos
from repro_torch.serve import scheduler as tsched
from test_torch_chaos import _CopyingJnp, _requests, setup  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _jax_scheduler_copies_host_mirrors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsched, "jnp", _CopyingJnp())
        yield


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def _feed(mod, stream):
    reg = mod.Registry()
    h = reg.histogram("serve.tbt_s", scheduler="continuous")
    for v in stream:
        h.observe(float(v))
    reg.counter("serve.bursts", scheduler="continuous").inc(7)
    reg.counter("serve.bursts", scheduler="spec").inc()
    g = reg.gauge("serve.pages_peak", scheduler="continuous")
    for v in (3, 9, 4):
        g.track_max(v)
    reg.histogram("serve.ttft_s", scheduler="continuous")      # empty
    return reg, h


def test_histogram_percentiles_equal_jax():
    """A lognormal stream with zeros (the underflow bucket): every
    percentile and the summary equal the JAX sketch's, and the sketch stays
    within its ~2.5% relative error of the exact percentile."""
    rng = np.random.default_rng(0)
    stream = np.concatenate([rng.lognormal(-4, 1.5, 2000), np.zeros(50), [1e-12]])
    _, th = _feed(tmetrics, stream)
    _, jh = _feed(jmetrics, stream)
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q), q
    assert th.summary() == jh.summary()
    exact = np.percentile(stream, 90, method="lower")
    assert abs(th.percentile(90) - exact) <= 0.026 * exact
    assert tmetrics.Histogram().percentile(50) is None


def test_registry_snapshot_jsonl_and_report_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    stream = rng.exponential(0.05, 300)
    treg, _ = _feed(tmetrics, stream)
    jreg, _ = _feed(jmetrics, stream)
    assert treg.snapshot()["metrics"] == jreg.snapshot()["metrics"]
    assert treg.report() == jreg.report()
    path = tmp_path / "m.jsonl"
    treg.write_jsonl(str(path))
    treg.counter("serve.bursts", scheduler="continuous").inc()
    treg.write_jsonl(str(path))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 2 and all(set(ln) == {"ts", "metrics"} for ln in lines)
    bursts = [next(m["value"] for m in ln["metrics"] if m["name"] == "serve.bursts"
                   and m["labels"] == {"scheduler": "continuous"}) for ln in lines]
    assert bursts == [7, 8]
    with pytest.raises(TypeError):
        treg.gauge("serve.bursts", scheduler="continuous")
    assert treg.find("serve.nothing") is None


# --------------------------------------------------------------------------
# tracer
# --------------------------------------------------------------------------


def _trace(mod):
    clock = iter(np.arange(0.0, 10.0, 0.5))
    tr = mod.Tracer(enabled=True, clock=lambda: next(clock))
    with tr.span("admit", n=3, rids=[0, 1, 2]):
        tr.instant("quarantine", slot=1, fault=1, rid=4, z_max=float("nan"))
    tr.counter("queue", depth=2)
    tr.compile_span("hyft_kernels", 0.25, "nvcc")
    with mod.NULL_TRACER.span("x", a=1):
        mod.NULL_TRACER.instant("y")
    return tr


def test_tracer_events_equal_jax(tmp_path):
    """The same calls on the same clock give the JAX tracer's events, and
    the written file (NaN arguments stringified) parses to the JAX file."""
    tt, jt = _trace(ttrace), _trace(jtrace)
    assert [e["ph"] for e in tt.events] == ["i", "X", "C", "X"]
    assert str(tt.events) == str(jt.events)      # NaN != NaN: compare the text
    assert tt.span_kinds() == jt.span_kinds() == {"admit", "quarantine", "queue",
                                                  "compile"}
    assert not ttrace.NULL_TRACER.events
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    tt.write(str(tp))
    jt.write(str(jp))
    assert json.loads(tp.read_text()) == json.loads(jp.read_text())
    assert json.loads(tp.read_text())["traceEvents"][0]["args"]["z_max"] == "nan"


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------


def test_logit_stats_equal_jax():
    """Random logits with an inactive row and a NaN row: the per-step
    stats and their reduction equal JAX's, NaN propagating; all rows
    inactive gives the neutral values."""
    rng = np.random.default_rng(2)
    steps = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    steps[2, 3, 7] = np.nan
    active = np.array([True, False, True, True, True])
    tz = torch.stack([tnum.logit_stats(torch.tensor(x), torch.tensor(active))
                      for x in steps])
    jz = jnp.stack([jnum.logit_stats(jnp.asarray(x), jnp.asarray(active)) for x in steps])
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    tr, jr = tnum.reduce_logit_stats(tz[:2]), jnum.reduce_logit_stats(jz[:2])
    assert {k: float(v) for k, v in tr.items()} == {k: float(v) for k, v in jr.items()}
    assert math.isnan(float(tnum.reduce_logit_stats(tz)["z_max"]))
    none = tnum.logit_stats(torch.tensor(steps[0]), torch.zeros(5, dtype=torch.bool))
    assert none.tolist() == [-math.inf, math.inf, math.inf]


def _fp2fx8_cache(layout, seed=3):
    """One fp2fx8 cache in both frameworks: JAX's quantize of seeded K/V
    into the first positions (or pages) of a zero cache, with one
    saturated raw and one NaN scale, converted to torch."""
    rng = np.random.default_rng(seed)
    shape = (2, 3, 2, 8, 16) if layout == "dense" else (2, 6, 2, 4, 16)
    leaves = {}
    for name in ("k", "v"):
        x = (rng.standard_normal(shape) * rng.choice([0.01, 1.0, 30.0], shape[:-1])[..., None]
             ).astype(np.float32)
        raw, scale = jattn.fp2fx8_quantize(jnp.asarray(x))
        raw, scale = np.array(raw), np.array(scale)
        raw[:, :, :, -2:] = 0         # unwritten positions: raw 0, scale 0
        scale[:, :, :, -2:] = 0
        leaves[name], leaves[f"{name}_scale"] = raw, scale
    leaves["v_scale"][1, 1, 0, 0] = np.nan
    jcache = {"blocks": {k: jnp.asarray(v) for k, v in leaves.items()}}
    tcache = {"blocks": {k: torch.from_numpy(v) for k, v in leaves.items()}}
    if layout == "paged":
        jcache["block_tables"] = jnp.zeros((2, 3), jnp.int32)
        tcache["block_tables"] = torch.zeros(2, 3, dtype=torch.int32)
    return jcache, tcache


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_format_stats_and_monitor_equal_jax(layout):
    """``format_stats`` over one converted cache, ``int8_size``, and the
    monitor's summary after two bursts of stats (the second with a NaN
    z_max, which stays in ``last`` but out of the range) and a
    quarantine: all equal JAX's.  An unquantized cache gives {}."""
    jcache, tcache = _fp2fx8_cache(layout)
    ts, js = tnum.format_stats(tcache), jnum.format_stats(jcache)
    assert set(ts) == set(js)
    for k in ts:
        np.testing.assert_array_equal(ts[k].numpy().astype(np.float64),
                                      np.asarray(js[k]).astype(np.float64), err_msg=k)
    assert tnum.int8_size(tcache) == jnum.int8_size(jcache) > 0
    assert tnum.format_stats({"blocks": {"k": torch.zeros(2, 3)}}) == {}
    tm, jm = tnum.NumericsMonitor(), jnum.NumericsMonitor()
    tm.kv_int8_total = jm.kv_int8_total = jnum.int8_size(jcache)
    z = [np.array([12.5, -3.0, -20.0], np.float32), np.array([np.nan, -1.0, -9.0], np.float32)]
    for zs in z:
        tm.update(dict(tnum.reduce_logit_stats(torch.tensor(zs)[None]), **ts))
        jm.update(dict(jnum.reduce_logit_stats(jnp.asarray(zs)[None]), **js))
        tm.add_converts(96)
        jm.add_converts(96)
    assert math.isnan(tm.last["z_max"]) and tm.z_max == 12.5
    assert tm.record_quarantine(3, "burst").keys() == jm.record_quarantine(3, "burst").keys()
    tsum, jsum = tm.summary(), jm.summary()
    assert str(tsum) == str(jsum)                # NaN in the quarantine event
    assert tsum["kv_scale_hist"] and tsum["converts"] == 192


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------


def _engines(setup, obs=None, jobs=None, chaos=None, jchaos_=None, **kw):
    jmodel, jparams, tmodel, tparams = setup
    kw = dict(dict(max_len=32, cache_dtype="fp2fx8", scheduler="continuous", n_slots=2,
                   decode_burst=4, attn_mode="kernel", kv_layout="paged", page_size=4),
              **kw)
    teng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**kw), device="cpu",
                                 obs=obs, chaos=chaos)
    jeng = jsched.SlotPoolEngine(jmodel, jparams, JaxServeConfig(**kw), obs=jobs,
                                 chaos=jchaos_)
    return teng, jeng


def test_stats_view_keys_equal_jax(setup):
    """The ``stats`` view has the JAX engine's keys in its order, each a
    ``serve.<key>`` metric with the scheduler and family labels."""
    teng, jeng = _engines(setup)
    assert list(teng.stats) == list(jeng.stats)
    for key in teng.stats:
        m = teng.obs.metrics.find(f"serve.{key}", scheduler="continuous", family="dense")
        assert m is not None, key
    names = {n for n, _, _ in teng.obs.metrics.items()}
    assert names == {n for n, _, _ in jeng.obs.metrics.items()
                     if not n.startswith("perf.")}


@pytest.mark.parametrize("scheduler", ["continuous", "spec"])
def test_telemetry_changes_no_token_and_matches_jax(setup, scheduler):
    """Telemetry on or off: the same tokens.  With it on, the port's
    monitor folds as many bursts as JAX's with the same convert volume and
    int8 total, and stats within what separates the two frameworks'
    attention (a few outputs one FP2FX raw apart, ROADMAP queue 3, grown
    through the layers): z ranges and scale extremes within 2**-9 of
    themselves, the scale histogram over the same written rows, where a
    row whose scale sits at a power of two may land in the next bin (at
    most 2% of the rows move; ``format_stats`` itself is held exactly
    above)."""
    reqs = _requests(3, 12, max_new=(5, 8), motif=scheduler == "spec")
    kw = dict(scheduler=scheduler, kv_layout="dense")
    off, _ = _engines(setup, **kw)
    base = off.run([tsched.Request(**r) for r in reqs])
    teng, jeng = _engines(setup, telemetry=True, **kw)
    done = teng.run([tsched.Request(**r) for r in reqs])
    jeng.run([jsched.Request(**r) for r in reqs])
    assert {r: c.tokens for r, c in done.items()} == {r: c.tokens for r, c in base.items()}
    ts, js = teng.obs.numerics.summary(), jeng.obs.numerics.summary()
    for k in ("bursts", "converts", "kv_int8_total"):
        assert ts[k] == js[k], k
    for k in ("z_max", "z_min", "zsub_min", "kv_scale_min", "kv_scale_max"):
        assert ts[k] == pytest.approx(js[k], rel=2.0 ** -9), k
    th, jh = ts["kv_scale_hist"], js["kv_scale_hist"]
    rows = sum(jh.values())
    assert sum(th.values()) == rows > 0
    moved = sum(abs(th.get(e, 0) - jh.get(e, 0)) for e in set(th) | set(jh)) / 2
    assert moved <= 0.02 * rows
    assert abs(ts["kv_saturated"] - js["kv_saturated"]) <= 0.02 * js["kv_saturated"]
    assert ts["bursts"] == teng.stats["bursts"] > 0


def test_poisoned_run_annotates_its_quarantine_like_jax(setup):
    """Telemetry on, one NaN poison in an fp32 dense cache: the quarantine
    event carries the burst's NaN z_max in both, and the trace holds the
    ``chaos.nan_kv`` and ``quarantine`` instants beside the bursts."""
    reqs = _requests(2, 6, plen=(4, 7), max_new=(8, 11))
    plan = dict(seed=0, nan_kv_rate=1.0, max_faults=1)
    obs, jobs = Obs.enabled(), JObs.enabled()
    teng, jeng = _engines(setup, obs=obs, jobs=jobs, chaos=tchaos.ChaosMonkey(
        tchaos.FaultPlan(**plan)), jchaos_=jchaos.ChaosMonkey(jchaos.FaultPlan(**plan)),
        cache_dtype="float32", kv_layout="dense", telemetry=True)
    teng.run([tsched.Request(**r) for r in reqs])
    jeng.run([jsched.Request(**r) for r in reqs])
    tev = teng.obs.numerics.quarantine_events
    jev = jeng.obs.numerics.quarantine_events
    assert len(tev) == len(jev) == 1
    assert (tev[0]["rid"], tev[0]["where"]) == (jev[0]["rid"], jev[0]["where"])
    assert math.isnan(tev[0]["z_max"]) and math.isnan(jev[0]["z_max"])
    kinds = obs.tracer.span_kinds()
    assert {"decode_burst", "prefill_chunk", "admit", "quarantine", "chaos.nan_kv"} <= kinds
    assert kinds <= jobs.tracer.span_kinds()


def test_traced_serve_reconciles_with_its_completions(setup, tmp_path):
    """A traced paged serve with a metrics path: the trace file parses and
    holds every burst as a span, the JSONL holds at least the final
    snapshot, and the registry's totals equal the completions' (tokens,
    TTFT count, TBT gaps)."""
    path = tmp_path / "m.jsonl"
    obs = Obs.enabled(metrics_path=str(path))
    teng, _ = _engines(setup, obs=obs, prefix_cache=True, audit=True)
    reqs = _requests(4, 13, max_new=(4, 9))
    done = teng.run([tsched.Request(**r) for r in reqs])
    tp = tmp_path / "t.json"
    obs.tracer.write(str(tp))
    events = json.loads(tp.read_text())["traceEvents"]
    bursts = [e for e in events if e["name"] == "decode_burst"]
    assert len(bursts) == teng.stats["bursts"] and all(e["ph"] == "X" for e in bursts)
    lines = path.read_text().splitlines()
    assert lines and all(json.loads(ln)["metrics"] for ln in lines)
    labels = dict(scheduler="continuous", family="dense")
    reg = obs.metrics
    assert reg.find("serve.tokens_emitted", **labels).value == sum(
        len(c.tokens) for c in done.values())
    assert reg.find("serve.ttft_s", **labels).count == sum(
        c.ttft is not None for c in done.values())
    assert reg.find("serve.tbt_s", **labels).count == sum(
        max(0, len(c.token_times) - 1) for c in done.values())
    assert reg.find("serve.burst_wall_s", **labels).count == teng.stats["bursts"]
