"""The port's cost book, kernel microbench and roofline module against the
JAX package's, on the CPU.

Under test, each held to its JAX counterpart:
  * ``roofline/analysis.py`` — ``count_params``, ``model_flops`` and
    ``scan_trip_factor`` for every arch; ``analyze`` with no fp32 share
    against JAX's with its TPU constants swapped for the H100's;
  * ``obs/profile.py`` — ``exec_cost`` of a matmul and of every Hyft
    wrapper at the JAX registry's shapes (each kernel's own count from
    ``kernels/cost.py``, none of its plain version's products), the
    ``join_cost`` / ``summary`` / ``microbench`` row keys, and the
    ``CostBook``'s metrics and counter tracks;
  * the wiring — the slot pool's prewarm and dispatches, ``generate``'s
    two decode loops and the launcher's ``--trace``: the JAX engine's
    executable names and observe counts, and the same tokens with a book
    as without;
  * ``kernels/cost.py`` at the main path's shapes against the bounds that
    ``PERF.md`` §6 records from the card.
The serving cases use ``tests/test_torch_chaos.py``'s smoke model and
copying ``jax.numpy`` (ROADMAP queue 3).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import pallas_check
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.launch import serve as jax_launch
from repro.obs import Obs as JObs
from repro.obs import profile as jprofile
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro.serve import scheduler as jsched
from repro.serve.engine import generate as jax_generate
from repro_torch.configs import ARCHS, ServeConfig, get_config
from repro_torch.core.hyft import HYFT16
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tlaunch
from repro_torch.obs import Obs
from repro_torch.obs import profile as tprofile
from repro_torch.roofline import analysis, hw
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import generate
from test_torch_chaos import _CopyingJnp, _requests, setup  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _jax_scheduler_copies_host_mirrors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsched, "jnp", _CopyingJnp())
        yield


# --------------------------------------------------------------------------
# roofline/
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_counts_equal_jax(arch):
    """``count_params`` (all and active), ``model_flops`` and
    ``scan_trip_factor`` are JAX's, exactly, for every arch."""
    assert set(ARCHS) == set(JAX_ARCHS)
    t, j = get_config(arch), jax_get_config(arch)
    for active in (False, True):
        assert analysis.count_params(t, active) == janalysis.count_params(j, active)
    for kind in ("train", "prefill", "decode"):
        assert analysis.model_flops(t, 4096, kind) == janalysis.model_flops(j, 4096, kind)
        assert (analysis.scan_trip_factor(t, kind, 128, 8, 2)
                == janalysis.scan_trip_factor(j, kind, 128, 8, 2))


@pytest.mark.parametrize("cost", [
    {"flops": 1e12, "bytes accessed": 1e6},
    {"flops": 1e6, "bytes accessed": 1e12},
    {"flops": 0.0, "bytes accessed": 0.0}], ids=["compute", "memory", "empty"])
def test_analyze_equals_jax_at_the_h100_constants(cost, monkeypatch):
    """With no fp32 share the bound is the JAX module's under the H100's
    peaks (monkeypatched into ``repro.roofline.hw`` here only), within
    1e-12; an fp32 share runs at the fp32 peak."""
    monkeypatch.setattr(jhw, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jhw, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(jhw, "ICI_BW", hw.NVLINK_BW)
    got = analysis.analyze(dict(cost, flops_fp32=0.0)).to_dict()
    want = janalysis.analyze(cost, hlo_text="", chips=1).to_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k
        else:
            assert got[k] == v, k
    fp32 = analysis.analyze(dict(cost, flops_fp32=cost["flops"]))
    assert fp32.compute_s == pytest.approx(cost["flops"] / hw.PEAK_FLOPS_FP32, rel=1e-12)


def test_h100_constants_are_the_published_peaks():
    assert (hw.HBM_BW, hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_FP32) == (3.35e12, 989e12, 67e12)
    assert (hw.LANE_INSTR_PER_S, hw.INT_INSTR_PER_S, hw.NVLINK_BW) == (33.5e12, 16.75e12,
                                                                      450e9)


# --------------------------------------------------------------------------
# exec_cost, join_cost, the cost book
# --------------------------------------------------------------------------


def test_exec_cost_of_a_matmul_equals_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in ((64, 128), (128, 32)))
    want = jprofile.exec_cost(jax.jit(jnp.matmul), a, b)
    got = tprofile.exec_cost(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"]) == (524288, 57344)
    assert got["flops_fp32"] == got["flops"] and got["transcendentals"] == 0


def test_exec_cost_returns_none_when_the_call_raises():
    def bad(x):
        raise RuntimeError("no")
    assert tprofile.exec_cost(bad, torch.zeros(2)) is None


ENTRIES = [e.name for e in pallas_check.default_registry()]


@pytest.mark.parametrize("name", ENTRIES)
def test_exec_cost_of_each_wrapper_is_its_kernel_count(name):
    """At the JAX registry's shapes, a wrapper's counted call is exactly its
    kernels' counts from ``kernels/cost.py``: the plain versions it runs on
    the CPU add none of their products or reads, nor the count its own
    reads of the mask, and nothing transcendental."""
    entry = {e.name: e for e in tprofile.default_registry("cpu")}[name]
    fn, args, want = entry.make()
    got = tprofile.exec_cost(fn, *args)
    assert got["flops"] == want["flops"] > 0
    assert got["bytes"] == want["bytes"]
    assert got["flops_fp32"] == want["flops_fp32"] == want["flops"]
    assert got["transcendentals"] == 0


def test_exec_cost_does_not_depend_on_the_allocator():
    """A count keyed by storage address must not inherit the touches of an
    intermediate whose freed block the allocator hands to a later output:
    flash_bwd's bytes stay its kernels' count whatever the heap held before
    (blocks of seeded random sizes allocated and freed between calls; before
    the fix about 1 call in 30 counted 8-16 KB more)."""
    entry = {e.name: e for e in tprofile.default_registry("cpu")}["flash_bwd"]
    fn, args, want = entry.make()
    rng = np.random.default_rng(0)
    kept = []
    for _ in range(60):
        junk = [torch.empty(int(n)) for n in rng.integers(1, 1 << 16, rng.integers(0, 30))]
        kept += junk[: int(rng.integers(0, len(junk) + 1))]
        del junk
        assert tprofile.exec_cost(fn, *args)["bytes"] == want["bytes"]


def test_bytes_are_what_the_call_moves_not_whole_storages(setup):
    """An indexed read of a large table counts its rows; a gated decode step
    over a paged pool counts the pages its mask admits and the rows it
    writes, so its count is the same over 9 pages as over 33."""
    table, idx = torch.ones(1000, 64), torch.tensor([3, 7, 7, 900])
    got = tprofile.exec_cost(lambda t, i: t[i], table, idx)
    assert got["bytes"] == 4 * 64 * 4 * 2 + 4 * 8         # rows read, out, idx
    _, _, tmodel, tparams = setup
    from repro_torch.models.model_zoo import resolve_attn_mode
    model = resolve_attn_mode(tmodel, "kernel")

    def count(n_pages):
        cache = model.init_paged_cache(tparams, n_pages, 4, "fp2fx8", device="cpu")
        cache["block_tables"] = torch.arange(8, dtype=torch.int32).reshape(2, 4) + 1
        return tprofile.exec_cost(
            lambda p, c, t: model.decode_step(p, c, t, 5,
                                              write_mask=torch.zeros(2, dtype=torch.bool)),
            tparams, cache, torch.tensor([[1], [2]], dtype=torch.int32))
    small, large = count(9), count(33)
    assert small == large
    weights = sum(t.nbytes for t in tprofile._tensors(tparams))
    assert weights < small["bytes"]                       # every weight read once


def _fake_kernels(monkeypatch):
    """Wrappers whose kernels compute nothing through aten's products (as
    the card's ctypes launches): the outputs are zeros of the kernels'
    shapes."""
    def attend(q3, *a, **kw):
        return torch.zeros(q3.shape)

    def fwd(q3, k3, v3, maskf, **kw):
        BH, Sq, _ = q3.shape
        return torch.zeros(q3.shape), torch.zeros(BH, Sq, dtype=torch.int32), \
            torch.ones(BH, Sq)
    monkeypatch.setattr(fa, "_splitk_attention_for", lambda dev: attend)
    monkeypatch.setattr(fa, "_paged_attention_for", lambda dev: attend)
    monkeypatch.setattr(fa, "_flash_impls", lambda dev: (
        fwd, lambda q3, *a, **kw: torch.zeros(q3.shape),
        lambda q3, k3, *a, **kw: (torch.zeros(k3.shape), torch.zeros(k3.shape))))


def test_a_count_is_the_same_through_the_plain_versions_or_the_kernels(setup, monkeypatch):
    """An executable (a prefill chunk and a decode step of the smoke model,
    kernel mode, paged fp2fx8) counts the same whether the wrappers run the
    plain versions or kernels that do no aten product; the plain versions'
    own products are there to leak (a direct call counts them)."""
    _, _, tmodel, tparams = setup
    from repro_torch.models.model_zoo import resolve_attn_mode
    from repro_torch.serve import engine
    model = resolve_attn_mode(tmodel, "kernel")
    scfg = ServeConfig(max_len=32, cache_dtype="fp2fx8", attn_mode="kernel")
    cache = model.init_paged_cache(tparams, 9, 4, "fp2fx8", device="cpu")
    cache["block_tables"] = torch.arange(8, dtype=torch.int32).reshape(2, 4) + 1
    n = 2
    args = (tparams, cache, torch.arange(16, dtype=torch.int32).reshape(n, 8) % 64,
            torch.zeros(n, dtype=torch.int32), torch.full((n,), 8, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool))
    pc = engine.build_prefill_chunk(model, scfg, 8)
    plain = tprofile.exec_cost(pc, *args)
    q3 = torch.randn(4, 2, 16)
    k = torch.randn(4, 8, 16)
    leak = tprofile.exec_cost(lambda: fa.splitk_attention_plain(
        q3, k, k, None, None, torch.ones(2, 8), cfg=HYFT16, sm_scale=0.25, bk=8, hkv=2,
        sq=None))
    assert leak["flops"] > 0
    _fake_kernels(monkeypatch)
    kernels = tprofile.exec_cost(pc, *args)
    assert plain == kernels
    assert plain["flops_fp32"] == plain["flops"] > 0      # fp32 compute


def _jcost():
    return {"flops": 2e9, "bytes": 3e6, "transcendentals": 5.0}


def test_join_cost_has_the_jax_keys():
    got = tprofile.join_cost(dict(_jcost(), flops_fp32=0.0), 1e-3)
    want = jprofile.join_cost(_jcost(), 1e-3)
    assert set(got) == set(want)
    assert got["achieved_gflops"] == want["achieved_gflops"]
    assert got["bound_dominant"] == "compute"


def _book_sequence(book, record, name="mm"):
    record(book, name)
    for wall in (2e-3, 4e-3):
        book.observe(name, wall)
    return book


def _jrecord(book, name):
    a = jnp.ones((64, 128), jnp.float32)
    b = jnp.ones((128, 32), jnp.float32)
    book.record(name, jax.jit(jnp.matmul), a, b, trip_factor=3)


def _trecord(book, name):
    book.record(name, torch.matmul, torch.ones(64, 128), torch.ones(128, 32), trip_factor=3)


def test_cost_book_emits_the_jax_metrics_tracks_and_rows():
    """record / observe: the same ``perf.*`` names and labels, the same
    ``roofline.<name>`` counter events, summary rows with JAX's keys (and
    ``flops_fp32``), ``trip_factor`` scaling the count, and JAX's calls
    and mean wall."""
    jobs, tobs = JObs.enabled(), Obs.enabled()
    jbook = _book_sequence(jobs.profile, _jrecord)
    tbook = _book_sequence(tobs.profile, _trecord)
    assert ({(n, tuple(sorted(lab.items()))) for n, lab, _ in tobs.metrics.items()}
            == {(n, tuple(sorted(lab.items()))) for n, lab, _ in jobs.metrics.items()})
    assert ([(e["name"], e["ph"], sorted(e["args"])) for e in tobs.tracer.events]
            == [(e["name"], e["ph"], sorted(e["args"])) for e in jobs.tracer.events])
    trow, jrow = tbook.summary()["mm"], jbook.summary()["mm"]
    assert set(trow) - set(jrow) == {"flops_fp32"} and set(jrow) <= set(trow)
    assert trow["flops"] == jrow["flops"] == 3 * 524288 and trow["trip_factor"] == 3
    assert (trow["calls"], trow["wall_mean_us"]) == (jrow["calls"], jrow["wall_mean_us"])
    assert "mm" in tbook and "other" not in tbook
    assert tbook.observe("other", 1e-3) is None


def test_disabled_cost_book_is_a_noop():
    obs = Obs()
    assert not obs.profile.enabled
    assert obs.profile.record("mm", torch.matmul, torch.ones(2, 2), torch.ones(2, 2)) is None
    assert obs.profile.observe("mm", 1e-3) is None and not obs.profile.summary()
    assert not list(obs.metrics.items())


# --------------------------------------------------------------------------
# microbench
# --------------------------------------------------------------------------


def test_microbench_entries_and_rows_are_jax_s():
    """The port's ten entries carry the JAX registry's names in its order;
    a row has the keys of JAX's row for the same entry (and
    ``flops_fp32``), its bound that of its count, and the report line
    JAX's format."""
    entries = tprofile.default_registry("cpu")
    assert [e.name for e in entries] == ENTRIES
    lines = []
    (trow,) = tprofile.microbench(entries[:1], iters=1, report=lines.append, device="cpu")
    (jrow,) = jprofile.microbench(pallas_check.default_registry()[:1], iters=1)
    assert set(trow) - set(jrow) == {"flops_fp32"} and set(jrow) <= set(trow)
    assert (trow["kernel"], trow["format"], trow["shapes"], trow["dtypes"]) == (
        jrow["kernel"], jrow["format"], jrow["shapes"], jrow["dtypes"])
    _, _, c = entries[0].make()
    assert trow["bound_us"] == kcost.bound(c)[0].step_time_s * 1e6
    assert lines[0].startswith("bench_kernels,softmax_fwd,us_per_call=")


# --------------------------------------------------------------------------
# the wiring: slot pool, generate, launcher
# --------------------------------------------------------------------------


def _engines(setup, tobs, jobs, **kw):
    jmodel, jparams, tmodel, tparams = setup
    kw = dict(dict(max_len=32, cache_dtype="fp2fx8", scheduler="continuous", n_slots=2,
                   decode_burst=4, attn_mode="kernel", kv_layout="paged", page_size=4,
                   prefill_chunk=4), **kw)
    teng = tsched.SlotPoolEngine(tmodel, tparams, ServeConfig(**kw), device="cpu", obs=tobs)
    jeng = jsched.SlotPoolEngine(jmodel, jparams, JaxServeConfig(**kw), obs=jobs)
    return teng, jeng


def _calls(book):
    return {name: row.get("calls", 0) for name, row in book.summary().items()}


@pytest.mark.parametrize("kw", [dict(), dict(scheduler="spec", kv_layout="dense")],
                         ids=["continuous-paged", "spec-dense"])
def test_slot_pool_records_and_observes_the_jax_executables(setup, kw):
    """With ``Obs.enabled()`` and a prewarm, the port's engine records the
    JAX engine's executables by name and observes each as many times; every
    fraction is above 0; its tokens equal its tokens without a book, and
    JAX's."""
    reqs = _requests(3, 12, max_new=(5, 8), motif=kw.get("scheduler") == "spec")
    plain, _ = _engines(setup, None, None, **kw)
    base = plain.run([tsched.Request(**r) for r in reqs])
    teng, jeng = _engines(setup, Obs.enabled(), JObs.enabled(), **kw)
    longest = max(len(r["tokens"]) for r in reqs)
    teng.prewarm(longest)
    jeng.prewarm(longest)
    tdone = teng.run([tsched.Request(**r) for r in reqs])
    jdone = jeng.run([jsched.Request(**r) for r in reqs])
    assert _calls(teng.obs.profile) == _calls(jeng.obs.profile)
    assert all(v > 0 for v in _calls(teng.obs.profile).values())
    for row in teng.obs.profile.summary().values():
        assert row["roofline_fraction"] > 0 and row["flops"] > 0
    for rid in base:
        assert tdone[rid].tokens == base[rid].tokens == list(jdone[rid].tokens)
    names = {n for n, _, _ in teng.obs.metrics.items() if n.startswith("perf.")}
    assert names == {n for n, _, _ in jeng.obs.metrics.items() if n.startswith("perf.")}


@pytest.mark.parametrize("loop", ["scan", "host"])
def test_generate_records_the_jax_names(setup, loop):
    """``generate(profile=)`` counts and observes the JAX engine's
    executables under its names, once each, for both decode loops, and
    its tokens are those without a book."""
    jmodel, jparams, tmodel, tparams = setup
    kw = dict(max_len=16, attn_mode="unfused", decode_loop=loop)
    toks = np.arange(8, dtype=np.int32).reshape(2, 4) * 7 % 64
    jbook, tbook = jprofile.CostBook(enabled=True), tprofile.CostBook(enabled=True)
    jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks)}, JaxServeConfig(**kw),
                 max_new=4, profile=jbook)
    out = generate(tmodel, tparams, {"tokens": torch.from_numpy(toks)}, ServeConfig(**kw),
                   max_new=4, device="cpu", profile=tbook)
    base = generate(tmodel, tparams, {"tokens": torch.from_numpy(toks)}, ServeConfig(**kw),
                    max_new=4, device="cpu")
    assert _calls(tbook) == _calls(jbook) == {
        "prefill_chunk[w=4]": 1, ("decode_loop[steps=3]" if loop == "scan"
                                  else "serve_step"): 1}
    assert torch.equal(out, base)
    steps = tbook.summary()["decode_loop[steps=3]" if loop == "scan" else "serve_step"]
    assert steps["trip_factor"] == (3 if loop == "scan" else 1)


def _roofline_names(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sorted({e["name"] for e in events if e["name"].startswith("roofline.")})


@pytest.mark.parametrize("argv", [
    ["--max-new", "4"],
    ["--scheduler", "continuous", "--kv-layout", "paged", "--cache-dtype", "fp2fx8",
     "--n-slots", "2", "--max-new", "5"]], ids=["lockstep", "continuous"])
def test_launcher_trace_carries_the_jax_roofline_tracks(argv, tmp_path, monkeypatch,
                                                        capsys):
    """``--trace`` writes ``roofline.<name>`` counter events under the JAX
    launcher's names for the same arguments."""
    common = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--prefill", "8",
              "--attn-mode", "unfused", *argv]
    tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
    tlaunch.main([*common, "--device", "cpu", "--trace", str(tpath)])
    monkeypatch.setattr(sys, "argv", ["serve", *common, "--trace", str(jpath)])
    jax_launch.main()
    capsys.readouterr()
    names = _roofline_names(tpath)
    assert names and names == _roofline_names(jpath)


# --------------------------------------------------------------------------
# kernels/cost.py at the main path's shapes against PERF.md §6
# --------------------------------------------------------------------------

B, HQ, HKV, D, PROMPT, MAX_LEN = 4, 12, 2, 128, 1024, 1057
SLOTS, SERVE_LEN, PAGE, CHUNK = 8, 2048, 16, 256
META = dict(device="meta")


def _attend(rows, cache_dtype, mask, paged=False, bt=None, hkv=HKV):
    dtype = torch.int8 if cache_dtype == "fp2fx8" else torch.float32
    k = torch.empty((1, hkv, PAGE, D) if paged else (1, 1, D), dtype=dtype, **META)
    q3 = torch.empty((mask.shape[0] * hkv, rows, k.shape[-1]), **META)
    return kcost.attend_cost(q3, k, mask, hkv=hkv, block_tables=bt)


def _causal(lanes, total, start=0, batch=B):
    m = torch.arange(total)[None, None] <= (start + torch.arange(lanes))[None, :, None]
    return m.float().expand(batch, lanes, total)


def _flash(kernel, batch, hq, hkv, s, d, dtype, causal):
    return kcost.flash_cost(kernel, (batch, hq, s, d), (batch, hkv, s, d),
                            dtype.itemsize, causal=causal)


def _softmax(kernel, shape, in_bytes, out_bytes):
    return kcost.softmax_cost(kernel, shape, in_bytes, out_bytes)


def _zamba2_decode(cache_dtype):
    lens = torch.tensor([1056, 1045, 1035, 1025])
    mask = (torch.arange(MAX_LEN)[None] < lens[:, None]).float()
    dtype = torch.int8 if cache_dtype == "fp2fx8" else torch.float32
    q3 = torch.empty((B * 32, 1, 112), **META)
    return kcost.attend_cost(q3, torch.empty((1, 1, 112), dtype=dtype, **META), mask,
                             hkv=32)


BT = torch.zeros(SLOTS, SERVE_LEN // PAGE, dtype=torch.int32)
F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
PERF_ROWS = {
    "6 fp32": (lambda: _attend(6, "float32", torch.ones(B, MAX_LEN)), "0.00260"),
    "6 fp2fx8": (lambda: _attend(6, "fp2fx8", torch.ones(B, MAX_LEN)), "0.00069"),
    "8": (lambda: _attend(6 * PROMPT, "float32", _causal(PROMPT, MAX_LEN)), "0.1925"),
    "7 fp32": (lambda: _attend(6, "float32", torch.ones(SLOTS, SERVE_LEN), True, BT),
               "0.0101"),
    "7 fp2fx8": (lambda: _attend(6, "fp2fx8", torch.ones(SLOTS, SERVE_LEN), True, BT),
                 "0.00263"),
    "9": (lambda: _attend(6 * CHUNK, "fp2fx8", _causal(CHUNK, SERVE_LEN, 768, SLOTS), True,
                          BT), "0.168"),
    "3": (lambda: _flash("hyft_flash_fwd", B, HQ, HKV, 1024, D, F32, True), "0.192"),
    "4": (lambda: _flash("hyft_flash_bwd_dq", B, HQ, HKV, 1024, D, F32, True), "0.289"),
    "5": (lambda: _flash("hyft_flash_bwd_dkv", B, HQ, HKV, 1024, D, F32, True), "0.385"),
    "3 bert": (lambda: _flash("hyft_flash_fwd", 32, 12, 12, 128, 64, BF16, False),
               "0.0240"),
    "4 bert": (lambda: _flash("hyft_flash_bwd_dq", 32, 12, 12, 128, 64, BF16, False),
               "0.0361"),
    "5 bert": (lambda: _flash("hyft_flash_bwd_dkv", 32, 12, 12, 128, 64, BF16, False),
               "0.0481"),
    "3 zamba2 prefill": (lambda: _flash("hyft_flash_fwd", B, 32, 32, 1024, 112, BF16, True),
                         "0.449"),
    "3 zamba2 train": (lambda: _flash("hyft_flash_fwd", 2, 32, 32, 1024, 112, BF16, True),
                       "0.225"),
    "4 zamba2": (lambda: _flash("hyft_flash_bwd_dq", 2, 32, 32, 1024, 112, BF16, True),
                 "0.337"),
    "5 zamba2": (lambda: _flash("hyft_flash_bwd_dkv", 2, 32, 32, 1024, 112, BF16, True),
                 "0.449"),
    "6 zamba2 fp32": (lambda: _zamba2_decode("float32"), "0.0357"),
    "6 zamba2 fp2fx8": (lambda: _zamba2_decode("fp2fx8"), "0.0093"),
    "1 train": (lambda: _softmax("hyft_softmax_fwd", (49152, 1024), 4, 2), "0.0901"),
    "1 prompt": (lambda: _softmax("hyft_softmax_fwd", (49152, 1057), 4, 2), "0.0931"),
    "1 decode": (lambda: _softmax("hyft_softmax_fwd", (48, 1057), 4, 2), "0.000091"),
    "1 router prefill": (lambda: _softmax("hyft_softmax_fwd", (4096, 16), 4, 2),
                         "0.000117"),
    "1 router decode": (lambda: _softmax("hyft_softmax_fwd", (4, 16), 4, 2), "0.00000011"),
    "1 router train": (lambda: _softmax("hyft_softmax_fwd", (2048, 16), 4, 2), "0.000059"),
    "2 fp32 dz": (lambda: _softmax("hyft_softmax_bwd", (49152, 1024), 4, 4), "0.1202"),
    "2 fp16 dz": (lambda: _softmax("hyft_softmax_bwd", (49152, 1024), 4, 2), "0.0901"),
    "2 router": (lambda: _softmax("hyft_softmax_bwd", (2048, 16), 4, 4), "0.000078"),
}


@pytest.mark.parametrize("row", sorted(PERF_ROWS))
def test_kernel_counts_give_the_recorded_bounds(row):
    """Each kernel's count at the main path's shapes (``chip_smoke.py``'s
    kernels phases) bounds it at the ms that ``PERF.md`` §6 records, to
    the digits recorded there."""
    make, recorded = PERF_ROWS[row]
    seconds = kcost.bound(make())[0].step_time_s
    digits = len(recorded.split(".")[1])
    assert abs(seconds * 1e3 - float(recorded)) <= 0.5 * 10.0 ** -digits, seconds * 1e3
