"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's real step on
fake tensors, in one process, and read its memory, cost and collectives.

The PyTorch counterpart of ``repro.launch.dryrun``.  The JAX module lowers
and compiles each cell under the production mesh and reads XLA's analyses;
the port has no compiler, so it runs the cell's real step function once on
``FakeTensor``s (shapes and dtypes, no data: nothing is allocated on the
card, and the kernel wrappers take their shape-only route, so nothing is
launched) over a fake process group at the production meshes
(``launch/mesh.py``: 16 x 16, and 2 x 16 x 16 with "pod"), one rank's view
of the step:

  * the peak of live bytes a device and its split (``dryrun_meter``), and
    whether it fits the card's 80 GB (``roofline/hw.py::HBM_BYTES``);
  * FLOPs, fp32 FLOPs and bytes a device (``obs/profile.py``'s counter, the
    kernels' counts from ``kernels/cost.py``);
  * the collectives by kind, their calls and per-device operand bytes;
  * the three-term roofline with the collective term, MODEL_FLOPS and the
    useful-FLOPs ratio; the kernel calls a step, by kernel (their
    shape-only calls, ``SHAPE_CALLS``).

There is no ``trip_factor``: eager tracing runs every layer.  These are
counts and predictions from shapes, not measurements: no time is measured.
A count that reads a mask (the kernels' admitted keys) takes every key the
mask covers: exact for the cells' full-length batches and a decode step
against a cache full to ``seq``, an upper bound for a sequential prefill
(each step's keys past its position are counted too).
Results are cached as JSON under results/dryrun_torch/, keyed by (mesh,
arch, shape, tag); re-runs skip finished cells unless --force.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k \\
      --mesh single --attn-mode kernel --device cpu

``--device`` is the fake tensors' device: "cuda" (the default; the card's
route and dtypes, which needs a torch built with CUDA but touches no card)
or "cpu" (this route on any machine); both give the same report, number
for number: a CPU mesh issues the card's all-to-all too (its fake kernel).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs import (ASSIGNED, SHAPES, MeshConfig, ModelConfig, ShapeSpec,
                                 TrainConfig, cell_supported, get_config, input_specs)
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hyft_softmax as hs
from repro_torch.launch.dryrun_meter import CollectiveMeter, MemoryMeter
from repro_torch.models import build_model
from repro_torch.models.layers import param_axes
from repro_torch.obs.profile import count_cost
from repro_torch.roofline import analysis, hw
from repro_torch.train import state as train_state
from repro_torch.train.step import build_train_step
from repro_torch.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# big archs get adafactor + fsdp + microbatching by default, as in the JAX
# package: their optimizer state does not fit a card otherwise (the H100's
# 80 GB, ``hw.HBM_BYTES``)
BIG = {"nemotron-4-340b": 16, "grok-1-314b": 32, "zamba2-7b": 64,
       "mistral-nemo-12b": 64, "phi3.5-moe-42b-a6.6b": 64}

MESHES = {"single": MeshConfig(),
          "multi": MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))}
TRIP_NOTE = "none: eager tracing runs every layer, so every count holds all of them"


@dataclasses.dataclass
class CellOpts:
    tag: str = "baseline"
    attn_mode: str | None = None     # None = arch default
    softmax: str | None = None
    remat: str = "full"
    optimizer: str | None = None
    microbatch: int | None = None
    fsdp: bool | None = None
    seq_shard: bool = False
    parallel_prefill: bool = False
    pad_vocab: int = 0          # pad vocab up to a multiple (shardability)


def cell_path(mesh_kind, arch, shape, tag):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{mesh_kind}__{arch}__{shape}__{tag}.json")


def build_cfg(arch, opts: CellOpts) -> ModelConfig:
    """The arch's config (or ``arch`` itself, a ModelConfig) with the
    options' overrides."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    kw = {}
    if opts.attn_mode:
        kw["attn_mode"] = opts.attn_mode
    if opts.softmax:
        kw["softmax_impl"] = opts.softmax
    if opts.parallel_prefill:
        kw["parallel_prefill"] = True
    if opts.pad_vocab:
        kw["vocab"] = -(-cfg.vocab // opts.pad_vocab) * opts.pad_vocab
    return cfg.with_(**kw) if kw else cfg


# the longest sequential prefill the dry-run traces: eager tracing runs
# its decode step once a token (the JAX dry-run compiles the scan once)
MAX_SEQUENTIAL_STEPS = 4096


def traceable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Can one eager trace cover the cell?  A recurrent or encdec prefill
    without ``parallel_prefill`` is one decode step a token: past
    ``MAX_SEQUENTIAL_STEPS`` it is skipped, with the option that traces
    its one-pass prefill."""
    sequential = (shape.kind == "prefill" and cfg.family in ("ssm", "hybrid", "encdec")
                  and not cfg.parallel_prefill)
    if sequential and shape.seq > MAX_SEQUENTIAL_STEPS:
        return False, (f"sequential prefill: {shape.seq} eager decode steps; "
                       "--parallel-prefill traces the one-pass prefill")
    return True, ""


def check_device(device) -> torch.device:
    """The fake tensors' device: "cuda" needs a torch built with CUDA (no
    card: nothing is allocated or launched), "cpu" runs anywhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("this torch has no CUDA: trace the dry-run with "
                           "device='cpu' (--device cpu), which gives the same counts")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the dry-run traces on 'cuda' or 'cpu', not {dev}")
    return dev


@contextlib.contextmanager
def fake_group(world: int):
    """The dry-run's own fake process group of ``world`` ranks (this
    process is rank 0): its collectives move nothing.  Refuses to start
    while another group is initialized, and is destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized: the dry-run makes and "
                           "destroys its own fake one, so it runs outside any other")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(t, dev, sharding=None):
    """A fake tensor of ``t``'s shape and dtype on ``dev`` (inside the fake
    mode); with ``sharding``, the DTensor whose local block is rank 0's."""
    if sharding is None:
        return torch.empty(t.shape, dtype=t.dtype, device=dev)
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    pl = sharding.placements()
    with unset_fake_temporarily():     # the shape math reads its offsets' values
        local, _ = compute_local_shape_and_global_offset(t.shape, sharding.mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device=dev), sharding.mesh,
                              pl, run_check=False, shape=t.shape, stride=t.stride())


def _fake_tree(meta, dev, shardings=None):
    if shardings is None:
        return tree_map(lambda t: _fake_like(t, dev), meta)
    return tree_map(lambda t, s: _fake_like(t, dev, s), meta, shardings)


def _zero(counts: dict) -> None:
    for k in counts:
        counts[k] = 0


def _kernel_calls() -> dict:
    return {k: v for k, v in {**fa.SHAPE_CALLS, **hs.SHAPE_CALLS}.items() if v}


def trace_cell(arch, shape, mesh_shape=None, opts: CellOpts | None = None,
               device="cuda", tcfg: TrainConfig | None = None) -> dict:
    """Trace one cell's step on fake tensors and read its meters.

    ``arch`` is an arch name or a ModelConfig, ``shape`` a name of
    ``SHAPES`` or any ShapeSpec; ``mesh_shape`` a MeshConfig, a mesh kind
    ("single", "multi") or None (one card, no mesh).  ``tcfg`` replaces the
    train step's TrainConfig (JAX's choices by default: the global batch
    and sequence of the shape, microbatching for ``BIG``).  Raises on any
    fault of the step (a bug of the port, as in the JAX module)."""
    opts = opts or CellOpts()
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mcfg = MESHES[mesh_shape] if isinstance(mesh_shape, str) else mesh_shape
    dev = check_device(device)
    cfg = build_cfg(arch, opts)
    name = arch if isinstance(arch, str) else cfg.name
    chips = math.prod(mcfg.shape) if mcfg is not None else 1
    t0 = time.perf_counter()
    with fake_group(chips) if mcfg is not None else contextlib.nullcontext():
        mesh = _device_mesh(mcfg, dev) if mcfg is not None else None
        res = _trace(name, cfg, shape, mesh, opts, dev, tcfg)
    res.update(host_s=time.perf_counter() - t0, chips=chips, device=dev.type,
               mesh=None if mcfg is None else dict(zip(mcfg.axes, mcfg.shape)))
    return res


def _device_mesh(mcfg: MeshConfig, dev: torch.device):
    """The mesh over the fake group (made outside the fake mode: inside, the
    mesh's rank bookkeeping would be fake)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(math.prod(mcfg.shape)).reshape(mcfg.shape),
                      mesh_dim_names=tuple(mcfg.axes))


def _rules(name, cfg, mesh, opts):
    """(fsdp, the sharding rules or None without a mesh)."""
    fsdp = opts.fsdp if opts.fsdp is not None else name in BIG
    if mesh is None:
        return fsdp, None
    rules = shd.default_rules(mesh, cfg, fsdp=fsdp)
    if opts.seq_shard:
        rules["seq"] = "model"
    return fsdp, rules


def _fake_state(state_meta, state_sh, dev):
    """(the fake train state, what the memory meter holds of it); inside
    the fake mode."""
    state = _fake_tree(state_meta, dev, state_sh)
    return state, {"params": state["params"], "opt_state": (state["opt"], state["step"])}


def _trace(name, cfg, shape, mesh, opts, dev, tcfg):
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg)
    fsdp, rules = _rules(name, cfg, mesh, opts)
    specs = input_specs(cfg, shape)
    meta = dict(arch=name, shape=shape.name, kind=shape.kind, tag=opts.tag, fsdp=fsdp,
                opts=dataclasses.asdict(opts))
    batch_meta = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in specs.items()}
    held = {}
    if shape.kind == "train":
        tcfg, ocfg = _train_configs(name, shape, opts, tcfg)
        state_meta, state_sh = _train_state(model, ocfg, mesh, rules)
        batch_sh = shd.batch_shardings(mesh, batch_meta, rules) if mesh is not None else None
        step = build_train_step(model, tcfg, ocfg, mesh, state_sh, batch_sh)
        meta.update(optimizer=ocfg.name, microbatch=tcfg.microbatch,
                    tokens=shape.batch * shape.seq)
        with FakeTensorMode():
            state, held = _fake_state(state_meta, state_sh, dev)
            batch = held["inputs"] = _fake_tree(batch_meta, dev)
            out = _run(lambda s, b: step(s, b), (state, batch), held, mesh, cfg)
    else:
        params_meta = model.init(device="meta")
        psh = cache_sh = None
        cache_meta = model.init_cache(params_meta, shape.batch, shape.seq, "bfloat16",
                                      device="meta")
        if mesh is not None:
            psh = shd.param_shardings(mesh, params_meta, param_axes(params_meta), rules)
            cache_sh = shd.cache_shardings(mesh, cache_meta, rules)
        batch_sh = (shd.batch_shardings(mesh, batch_meta, rules) if mesh is not None
                    else None)
        meta.update(tokens=shape.batch * (shape.seq if shape.kind == "prefill" else 1))
        with FakeTensorMode():
            params = _fake_tree(params_meta, dev, psh)
            cache = _fake_tree(cache_meta, dev, cache_sh)
            batch = _fake_tree(batch_meta, dev, batch_sh)
            held = {"params": params, "cache": cache, "inputs": batch}
            if shape.kind == "prefill":
                fn = model.prefill
                args = (params, cache, batch)
            else:                       # one new token against a full cache
                pos = shape.seq - 1
                fn = (lambda p, c, t: model.decode_step(p, c, t, pos))
                args = (params, cache, batch["tokens"])
            out = _run(fn, args, held, mesh, cfg, grad=False)
    cost, mem, coll, calls = out
    roof = analysis.analyze({"flops": cost["flops"], "flops_fp32": cost["flops_fp32"],
                             "bytes accessed": cost["bytes"]},
                            mesh.size() if mesh is not None else 1,
                            collectives=coll.bytes_by_kind())
    mf = analysis.model_flops(cfg, meta["tokens"],
                              "train" if shape.kind == "train" else "infer")
    peak = mem.peak
    return dict(
        meta, status="ok", trip_factor=None, trip_note=TRIP_NOTE,
        memory=dict(peak_device_bytes=peak, peak_by_category=mem.peak_by_cat,
                    hbm_bytes=hw.HBM_BYTES, fits=peak <= hw.HBM_BYTES),
        cost=cost, collectives=coll.counts, roofline=roof.to_dict(), model_flops=mf,
        useful_flops_ratio=(mf / roof.hlo_flops_global if roof.hlo_flops_global else 0.0),
        kernel_calls=calls)


def _train_configs(name, shape, opts, tcfg=None):
    """(TrainConfig, OptConfig) of a train cell, as the JAX dry-run picks
    them: microbatching for ``BIG``, Adafactor for the two largest."""
    mb = opts.microbatch if opts.microbatch is not None else BIG.get(name, 0)
    opt_name = opts.optimizer or ("adafactor" if name in ("nemotron-4-340b", "grok-1-314b")
                                  else "adamw")
    tcfg = tcfg or TrainConfig(global_batch=shape.batch, seq_len=shape.seq, microbatch=mb,
                               remat=opts.remat)
    return tcfg, optim.OptConfig(name=opt_name)


def _train_state(model, ocfg, mesh, rules):
    """(the train state on the meta device, its NamedSharding tree or None)."""
    state_meta, _ = train_state.abstract_state(model, ocfg)
    if mesh is None:
        return state_meta, None
    return state_meta, train_state.state_shardings(mesh, model, ocfg, rules)


def state_bytes(arch, mesh_kind="single", opts: CellOpts | None = None,
                device="cuda") -> dict:
    """A train cell's state bytes on one device (rank 0) at a production
    mesh, as its trace holds them: {"params", "opt_state"} (the optimizer's
    trees and the step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    opts = opts or CellOpts()
    mcfg, dev, cfg = MESHES[mesh_kind], check_device(device), build_cfg(arch, opts)
    _, ocfg = _train_configs(arch, SHAPES["train_4k"], opts)
    with fake_group(math.prod(mcfg.shape)):
        mesh = _device_mesh(mcfg, dev)
        state_meta, state_sh = _train_state(build_model(cfg), ocfg, mesh,
                                            _rules(arch, cfg, mesh, opts)[1])
        with FakeTensorMode():
            _, held = _fake_state(state_meta, state_sh, dev)
            mem = MemoryMeter()
            for cat, tree in held.items():
                mem.hold(tree, cat)
            return {cat: mem.by_cat[cat] for cat in held}


@contextlib.contextmanager
def _index_math_on_real_tensors():
    """DTensor's strided-shard bookkeeping (``_StridedShard``'s local size
    and offsets) builds small index tensors and reads them back; under the
    trace's fake mode they would be fake and unreadable.  While inside, it
    runs on real CPU tensors (they index no data of the step).  Raises on a
    torch without it, where a strided shard's sizes could not be traced."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    name = "local_shard_size_and_offset"
    orig = _StridedShard.__dict__.get(name)
    if orig is None:
        raise RuntimeError(f"torch {torch.__version__}: _StridedShard has no {name}")
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)
    setattr(_StridedShard, name, staticmethod(real) if isinstance(orig, staticmethod) else real)
    try:
        yield
    finally:
        setattr(_StridedShard, name, orig)


@contextlib.contextmanager
def _alltoall_as_on_the_card():
    """DTensor moves a shard to another dim by ``shard_dim_alltoall``, which
    on a CPU mesh (gloo has no all-to-all) becomes an all-gather and a
    chunk.  While inside, a CPU mesh issues the card's one all-to-all op
    (its fake kernel: nothing is sent), so a "cpu" trace counts the
    collectives, bytes and live storages of a "cuda" one."""
    from torch.distributed.tensor import _collective_utils, placement_types
    orig = _collective_utils.shard_dim_alltoall
    users = [m for m in (_collective_utils, placement_types)
             if getattr(m, "shard_dim_alltoall", None) is orig]

    def on_the_card(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)
    for m in users:
        m.shard_dim_alltoall = on_the_card
    try:
        yield
    finally:
        for m in users:
            m.shard_dim_alltoall = orig


def _run(fn, args, held, mesh, cfg, grad=True):
    """``fn(*args)`` once under the meters and the cost counter (on the
    mesh's ``mesh_compute`` context for serving calls; the sharded train
    step opens its own).  Returns (cost, memory meter, collective meter,
    kernel calls)."""
    mem, coll = MemoryMeter(), CollectiveMeter()
    for cat, tree in held.items():
        mem.hold(tree, cat)
    _zero(fa.SHAPE_CALLS)
    _zero(hs.SHAPE_CALLS)
    ctx = (shd.mesh_compute(mesh, cfg) if mesh is not None and not grad
           else contextlib.nullcontext())
    with ctx, _index_math_on_real_tensors(), _alltoall_as_on_the_card(), mem, coll, \
            (contextlib.nullcontext() if grad else torch.no_grad()):
        _, cost = count_cost(fn, *args)
    return cost, mem, coll, _kernel_calls()


def run_cell(arch, shape_name, mesh_kind, opts: CellOpts, force=False, device="cuda"):
    path = cell_path(mesh_kind, arch, shape_name, opts.tag)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(get_config(arch), shape)
    if ok:
        ok, reason = traceable(build_cfg(arch, opts), shape)
    if not ok:
        result = dict(arch=arch, shape=shape_name, mesh=mesh_kind, tag=opts.tag,
                      status="skipped", reason=reason)
    else:
        t0 = time.perf_counter()
        try:
            result = dict(trace_cell(arch, shape, mesh_kind, opts, device),
                          mesh_kind=mesh_kind)
        except Exception as e:  # noqa: BLE001  (a sharding or trace fault is a bug)
            result = dict(arch=arch, shape=shape_name, mesh=mesh_kind, tag=opts.tag,
                          status="error", error=f"{type(e).__name__}: {e}",
                          host_s=time.perf_counter() - t0,
                          tb=traceback.format_exc()[-2000:])
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--attn-mode", default=None)
    ap.add_argument("--softmax", default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--fsdp", type=int, default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--parallel-prefill", action="store_true")
    ap.add_argument("--pad-vocab", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's route; no card "
                         "is touched) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    opts = CellOpts(tag=args.tag, attn_mode=args.attn_mode,
                    softmax=args.softmax, remat=args.remat,
                    optimizer=args.optimizer, microbatch=args.microbatch,
                    fsdp=None if args.fsdp is None else bool(args.fsdp),
                    seq_shard=args.seq_shard,
                    parallel_prefill=args.parallel_prefill,
                    pad_vocab=args.pad_vocab)
    check_device(args.device)

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mesh_kind, opts, force=args.force,
                             device=args.device)
                st = r["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
                if st == "ok":
                    roof = r["roofline"]
                    print(f"[{mesh_kind}] {arch:22s} {shape:12s} OK "
                          f"trace={r['host_s']:6.1f}s "
                          f"peak={r['memory']['peak_device_bytes']/2**30:7.2f}GiB "
                          f"fits={r['memory']['fits']!s:5s} "
                          f"dom={roof['dominant']:10s} "
                          f"coll={roof['coll_bytes_device']/2**30:.3f}GiB "
                          f"frac={roof['roofline_fraction']:.3f}", flush=True)
                elif st == "skipped":
                    print(f"[{mesh_kind}] {arch:22s} {shape:12s} SKIP "
                          f"({r['reason'][:60]})", flush=True)
                else:
                    print(f"[{mesh_kind}] {arch:22s} {shape:12s} ERROR "
                          f"{r['error'][:140]}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
