"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's and against the port's own real steps, on the CPU.

* The shape cells (``configs/shapes.py``): ``SHAPES``, ``cell_supported``
  and ``input_specs`` equal to ``repro.configs.shapes`` for every arch x
  shape, by shape and dtype.
* The per-device train state at the 16 x 16 mesh for every assigned arch:
  the parameters' and the optimizer state's bytes on rank 0 equal those
  implied by the JAX package's ``state_shardings`` on its ``AbstractMesh``
  and ``jax.eval_shape``'s shapes.
* Kernels 1-9: the wrappers' shape-only route (fake tensors) gives the
  plain versions' output shapes and dtypes, counts one call in
  ``SHAPE_CALLS``, launches nothing and is counted by the cost scope like
  the real call.
* Smoke cells of every family x {train, prefill, decode}: the fake trace's
  FLOPs, bytes and kernel calls equal ``count_cost`` of the same step on
  real CPU tensors (the kernels' plain versions).
* A "cpu" trace issues the card's all-to-all where a real CPU mesh would
  all-gather and chunk.
* The fake process group is the dry-run's own, and the CLI: its parser
  against the JAX dry-run's (by syntax tree), a production cell OK, a
  sub-quadratic-only cell SKIP, an error cell exit 1.

The fake traces of the mesh (2, 1) and (1, 2) training steps are held to
the real gloo runs of those cases in ``tests/test_torch_mesh.py``, whose
ranks they need.
"""
import ast
import contextlib
import math
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.optim as joptim
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jshd
from repro.distributed.compat import abstract_mesh
from repro.models import build_model as jax_build_model
from repro.train.state import init_state as jax_init_state
from repro.train.state import state_shardings as jax_state_shardings
from repro_torch.configs import (ASSIGNED, SHAPES, ShapeSpec, TrainConfig, cell_supported,
                                 get_config, input_specs, smoke_config)
from repro_torch.configs.shapes import concrete_batch
from repro_torch.core.hyft import HYFT16
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hyft_softmax as hs
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.obs.profile import count_cost

ROOT = pathlib.Path(__file__).resolve().parents[1]
_JAX_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


# --------------------------------------------------------------------------
# the shape cells
# --------------------------------------------------------------------------


def test_shape_cells_match_jax():
    assert list(SHAPES) == list(jshapes.SHAPES)
    for name, spec in SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq, spec.batch) == (j.name, j.kind, j.seq, j.batch)
    from repro.configs import ASSIGNED as JAX_ASSIGNED
    assert ASSIGNED == JAX_ASSIGNED


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_input_specs_match_jax(arch):
    """Every shape cell of ``arch``: supported or not for the same reason,
    and the same inputs by name, shape and dtype."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, spec in SHAPES.items():
        assert cell_supported(cfg, spec) == jshapes.cell_supported(jcfg, jshapes.SHAPES[name])
        got = input_specs(cfg, spec)
        want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
        assert list(got) == list(want)
        for k, s in want.items():
            assert got[k] == (tuple(s.shape), _JAX_DTYPES[s.dtype.type]), (name, k)


def test_concrete_batch_follows_the_specs():
    cfg = smoke_config(get_config("internvl2-1b"))
    spec = ShapeSpec("smoke", "train", 32, 2)
    batch = concrete_batch(cfg, spec, torch.Generator().manual_seed(0))
    for k, (shape, dtype) in input_specs(cfg, spec).items():
        assert (tuple(batch[k].shape), batch[k].dtype) == (shape, dtype)
    assert bool((batch["mask"] == 1).all()) and int(batch["tokens"].max()) < cfg.vocab
    again = concrete_batch(cfg, spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


# --------------------------------------------------------------------------
# the per-device state at 16 x 16
# --------------------------------------------------------------------------


def _jax_device_bytes(arch):
    """Rank 0's bytes of the JAX train state's params and optimizer state
    (its step included, its rng not), from its specs and shapes."""
    jcfg = jax_get_config(arch)
    jmesh = abstract_mesh((16, 16), ("data", "model"))
    sizes = dict(zip(("data", "model"), (16, 16)))
    opt = "adafactor" if arch in ("nemotron-4-340b", "grok-1-314b") else "adamw"
    ocfg = joptim.OptConfig(name=opt)
    model = jax_build_model(jcfg)
    rules = jshd.default_rules(jmesh, jcfg, fsdp=arch in dryrun.BIG)
    specs = jax_state_shardings(jmesh, model, ocfg, rules)
    shapes = jax.eval_shape(lambda: jax_init_state(model, ocfg, jax.random.PRNGKey(0)))

    def nbytes(sds, sh):
        n = sds.dtype.itemsize
        for i, d in enumerate(sds.shape):
            e = sh.spec[i] if i < len(sh.spec) else None
            axes = e if isinstance(e, tuple) else (e,) if e else ()
            n *= d // math.prod(sizes[a] for a in axes)
        return n
    tot = lambda k: sum(jax.tree.leaves(jax.tree.map(nbytes, shapes[k], specs[k])))  # noqa: E731
    return {"params": tot("params"), "opt_state": tot("opt") + tot("step")}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_state_bytes_match_jax_specs(arch):
    assert dryrun.state_bytes(arch, "single", device="cpu") == _jax_device_bytes(arch)
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the kernels' shape-only route
# --------------------------------------------------------------------------


def _kernel_calls(kernel, gen):
    """(a call of kernel ``kernel``'s public wrapper, its inputs) at small
    shapes: B 2, 4 / 2 heads of 16, the masks all ones."""
    B, Hq, Hkv, D, S = 2, 4, 2, 16, 24
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    if kernel == "hyft_softmax_fwd":
        return (lambda z: hs.hyft_softmax_fwd_kernel(z, HYFT16)), (r(6, 40),)
    if kernel == "hyft_softmax_bwd":
        return (lambda s, dy: hs.hyft_softmax_bwd_kernel(s, dy, HYFT16, out_dtype=torch.float32),
                (torch.softmax(r(6, 40), -1), r(6, 40)))
    if kernel.startswith("hyft_flash"):
        def fwd_bwd(q, k, v):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            o = fa.flash_hyft_attention(q, k, v, HYFT16, block_q=16, block_k=16)
            return (o, *torch.autograd.grad(o.sum(), (q, k, v)))
        return fwd_bwd, (r(B, Hq, S, D), r(B, Hkv, S, D), r(B, Hkv, S, D))
    ones = torch.ones(B, S)
    if kernel == "hyft_splitk_decode":
        return (lambda q, k, v, m: fa.flash_hyft_decode(q, k, v, HYFT16, kv_len_mask=m),
                (r(B, Hq, 1, D), r(B, Hkv, S, D), r(B, Hkv, S, D), ones))
    if kernel == "hyft_splitk_verify":
        return (lambda q, k, v, m: fa.flash_hyft_verify(q, k, v, m, HYFT16),
                (r(B, Hq, 3, D), r(B, Hkv, S, D), r(B, Hkv, S, D), torch.ones(B, 3, S)))
    bt = torch.arange(B * 3, dtype=torch.int32).reshape(B, 3) + 1
    pool = (r(7, Hkv, 8, D), r(7, Hkv, 8, D))
    if kernel == "hyft_paged_decode":
        return (lambda q, k, v, b, m: fa.flash_hyft_decode_paged(q, k, v, b, HYFT16,
                                                                 kv_len_mask=m),
                (r(B, Hq, 1, D), *pool, bt, ones))
    return (lambda q, k, v, b, m: fa.flash_hyft_verify(q, k, v, m, HYFT16, block_tables=b),
            (r(B, Hq, 3, D), *pool, bt, torch.ones(B, 3, S)))


KERNELS = [*hs.LAUNCHES, *fa.LAUNCHES]


@pytest.mark.parametrize("kernel", KERNELS)
def test_shape_only_route_gives_the_plain_shapes(kernel):
    """On fake tensors each wrapper of kernels 1-9 makes its outputs with
    the plain version's shapes and dtypes, counts its shape-only calls
    (the flash call: forward, dq and dk/dv once each), launches nothing,
    and its cost scope counts it as the real call does."""
    fn, args = _kernel_calls(kernel, torch.Generator().manual_seed(0))
    want_out, want_cost = count_cost(fn, *args)
    launches = {**fa.LAUNCHES, **hs.LAUNCHES}
    dryrun._zero(fa.SHAPE_CALLS)
    dryrun._zero(hs.SHAPE_CALLS)
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in args]
        got_out, got_cost = count_cost(fn, *fakes)
    want_out = want_out if isinstance(want_out, tuple) else (want_out,)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    assert [(t.shape, t.dtype) for t in got_out] == [(t.shape, t.dtype) for t in want_out]
    assert all(kcost.shape_only(t) for t in got_out)
    assert {**fa.LAUNCHES, **hs.LAUNCHES} == launches
    calls = {k: v for k, v in {**fa.SHAPE_CALLS, **hs.SHAPE_CALLS}.items() if v}
    want_calls = ({k: 1 for k in fa.LAUNCHES if k.startswith("hyft_flash")}
                  if kernel.startswith("hyft_flash") else {kernel: 1})
    assert calls == want_calls
    assert got_cost["flops"] == want_cost["flops"] and got_cost["flops"] > 0
    assert got_cost["flops_fp32"] == want_cost["flops_fp32"]


def test_counts_without_values_count_every_key():
    """A mask without values admits every key it covers: the decode count
    of a full fake mask equals the real full mask's, and says so."""
    q3, k = torch.randn(4, 6, 16), torch.randn(4, 40, 16)
    real = kcost.attend_cost(q3, k, torch.ones(2, 40), hkv=2)
    fake = kcost.attend_cost(q3, k, torch.ones(2, 40, device="meta"), hkv=2)
    assert fake.pop("mask") == "from shapes" and fake == real
    real = kcost.flash_cost("hyft_flash_fwd", (2, 4, 24, 16), (2, 2, 24, 16), 4, causal=True,
                            kv_len_mask=torch.ones(2, 24))
    fake = kcost.flash_cost("hyft_flash_fwd", (2, 4, 24, 16), (2, 2, 24, 16), 4, causal=True,
                            kv_len_mask=torch.ones(2, 24, device="meta"))
    assert fake.pop("mask") == "from shapes" and fake == real


# --------------------------------------------------------------------------
# smoke cells: the fake trace against the real step
# --------------------------------------------------------------------------

FAMILIES = {"dense": "qwen2-1.5b", "moe": "phi3.5-moe-42b-a6.6b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-7b", "encdec": "whisper-medium", "vlm": "internvl2-1b"}
SMOKE = {"train": ShapeSpec("smoke_train", "train", 32, 2),
         "prefill": ShapeSpec("smoke_prefill", "prefill", 32, 2),
         "decode": ShapeSpec("smoke_decode", "decode", 32, 2)}


def _smoke_cfg(arch):
    """Kernel mode, fp32 compute; the recurrent families and encdec prefill
    in one pass (their sequential prefill attends a partly written cache,
    whose mask a fake trace counts whole: an upper bound, not the count)."""
    kw = dict(attn_mode="kernel", compute_dtype="float32", parallel_prefill=True)
    if arch == FAMILIES["moe"]:
        kw["softmax_impl"] = "hyft16_kernel"      # the router through kernels 1-2
    return smoke_config(get_config(arch)).with_(**kw)


_PLAIN = {"splitk_attention_plain": ("hyft_splitk_decode", "hyft_splitk_verify"),
          "paged_attention_plain": ("hyft_paged_decode", "hyft_paged_verify"),
          "_flash_fwd_plain": "hyft_flash_fwd", "_flash_bwd_dq_plain": "hyft_flash_bwd_dq",
          "_flash_bwd_dkv_plain": "hyft_flash_bwd_dkv"}


@contextlib.contextmanager
def _counted_plain_calls(monkeypatch):
    """The kernels' calls on real CPU tensors: each plain version the
    wrappers pick, counted by the kernel it stands for."""
    calls = {}

    def wrap(fn, name):
        def call(*a, **kw):
            n = name if isinstance(name, str) else name[kw.get("sq") is not None]
            calls[n] = calls.get(n, 0) + 1
            return fn(*a, **kw)
        return call
    for attr, name in _PLAIN.items():
        monkeypatch.setattr(fa, attr, wrap(getattr(fa, attr), name))
    monkeypatch.setattr(hs, "hyft_softmax_fwd", wrap(hs.hyft_softmax_fwd, "hyft_softmax_fwd"))
    monkeypatch.setattr(hs, "hyft_softmax_bwd", wrap(hs.hyft_softmax_bwd, "hyft_softmax_bwd"))
    yield calls


def _real_step(cfg, spec):
    """(the cell's step, its real CPU arguments): as the dry-run builds it."""
    from repro_torch import optim
    from repro_torch.train.step import make_step_fn
    from repro_torch.train.state import init_state

    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = concrete_batch(cfg, spec, gen)
    if spec.kind == "train":
        ocfg = optim.OptConfig(name="adamw")
        state = init_state(model, ocfg, 0, device="cpu")
        return make_step_fn(model, TrainConfig(global_batch=spec.batch, seq_len=spec.seq),
                            ocfg), (state, batch)
    params = model.init(0, device="cpu")
    cache = model.init_cache(params, spec.batch, spec.seq, "bfloat16", device="cpu")
    if spec.kind == "prefill":
        return model.prefill, (params, cache, batch)
    return (lambda p, c, t: model.decode_step(p, c, t, spec.seq - 1)), (params, cache,
                                                                        batch["tokens"])


@pytest.mark.filterwarnings("ignore:jax.nn.one_hot input should be integer-typed")
@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_smoke_trace_counts_the_real_step(family, kind, monkeypatch):
    cfg, spec = _smoke_cfg(FAMILIES[family]), SMOKE[kind]
    got = dryrun.trace_cell(cfg, spec, None, device="cpu")
    fn, args = _real_step(cfg, spec)
    with _counted_plain_calls(monkeypatch) as calls, \
            torch.set_grad_enabled(kind == "train"):
        _, want = count_cost(fn, *args)
    assert got["status"] == "ok" and got["kind"] == kind
    assert got["cost"]["flops"] == want["flops"] and want["flops"] > 0
    assert got["cost"]["flops_fp32"] == want["flops_fp32"]
    assert got["cost"]["bytes"] == want["bytes"]
    assert got["kernel_calls"] == calls
    assert got["collectives"] == {} and got["roofline"]["collective_s"] == 0.0
    assert 0 < got["memory"]["peak_device_bytes"] and got["memory"]["fits"]


# --------------------------------------------------------------------------
# the fake group and the CLI
# --------------------------------------------------------------------------


def test_the_fake_group_is_the_dry_runs_own():
    """The group exists only inside a traced mesh cell, and a dry-run
    refuses to start while another group is initialized."""
    cfg = _smoke_cfg("qwen2-1.5b")
    from repro_torch.configs import MeshConfig
    mesh = MeshConfig(shape=(2, 1))
    r = dryrun.trace_cell(cfg, SMOKE["decode"], mesh, device="cpu")
    assert r["status"] == "ok" and r["chips"] == 2 and not dist.is_initialized()
    with dryrun.fake_group(2):
        with pytest.raises(RuntimeError, match="process group is initialized"):
            dryrun.trace_cell(cfg, SMOKE["decode"], mesh, device="cpu")
    assert not dist.is_initialized()


def test_cpu_trace_issues_the_cards_alltoall(monkeypatch):
    """olmo-1b x decode_32k at 16 x 16 moves shards between dims.  A real
    CPU mesh would all-gather and chunk; the dry-run's "cpu" trace issues
    the card's ``shard_dim_alltoall`` instead, with the same operand bytes,
    so the "cpu" and "cuda" labels count the same collectives."""
    opts = dryrun.CellOpts(attn_mode="kernel")
    card = dryrun.trace_cell("olmo-1b", "decode_32k", "single", opts, device="cpu")
    monkeypatch.setattr(dryrun, "_alltoall_as_on_the_card", contextlib.nullcontext)
    gloo = dryrun.trace_cell("olmo-1b", "decode_32k", "single", opts, device="cpu")
    a2a = card["collectives"]["shard_dim_alltoall"]
    ag = card["collectives"]["all_gather_into_tensor"]
    assert a2a["count"] > 0 and "shard_dim_alltoall" not in gloo["collectives"]
    assert gloo["collectives"]["all_gather_into_tensor"] == {
        "count": ag["count"] + a2a["count"], "bytes": ag["bytes"] + a2a["bytes"]}
    assert gloo["collectives"]["all_reduce"] == card["collectives"]["all_reduce"]
    assert card["cost"] == gloo["cost"] and card["kernel_calls"] == gloo["kernel_calls"]


def test_cuda_label_needs_cuda_torch():
    if torch.backends.cuda.is_built():
        pytest.skip("this torch has CUDA: the 'cuda' label traces (chip_smoke.py holds it)")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.trace_cell("qwen2-1.5b", "decode_32k", "single")


def _flags(tree) -> dict:
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            flags[node.args[0].value] = kw
    return flags


def test_parser_matches_the_jax_dry_run():
    """Every flag of the JAX dry-run, with its type, choices, default and
    action; the port adds only ``--device``."""
    want = _flags(ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text()))
    got = _flags(ast.parse((ROOT / "src/repro_torch/launch/dryrun.py").read_text()))
    assert set(got) == set(want) | {"--device"}
    for flag, kw in want.items():
        assert got[flag] == kw, flag
    args = dryrun.build_parser().parse_args(["--arch", "qwen2-1.5b", "--device", "cpu"])
    assert (args.mesh, args.device, args.tag) == ("both", "cpu", "baseline")


def test_cli_prints_ok_skip_and_fails_on_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    argv = ["--arch", "qwen2-1.5b", "--mesh", "single", "--device", "cpu"]
    assert dryrun.main(argv + ["--shape", "decode_32k,long_500k"]) == 0
    out = capsys.readouterr().out
    assert "decode_32k   OK" in out and "peak=" in out and "dom=" in out and "coll=" in out
    assert "long_500k    SKIP" in out and "done: ok=1 skip=1 err=0" in out
    cached = tmp_path / "single__qwen2-1.5b__decode_32k__baseline.json"
    assert cached.exists()

    def broken(*a, **kw):
        raise ValueError("a sharding fault")
    monkeypatch.setattr(dryrun, "trace_cell", broken)
    assert dryrun.main(argv + ["--shape", "decode_32k"]) == 0       # the cached cell
    assert dryrun.main(argv + ["--shape", "decode_32k", "--force"]) == 1
    assert "ERROR ValueError: a sharding fault" in capsys.readouterr().out
    assert not dist.is_initialized()
