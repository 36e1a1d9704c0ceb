"""Device-side performance accounting, and the ``--xla-profile`` window.

The PyTorch counterpart of ``repro.obs.profile``:

  ``exec_cost``  — FLOPs, bytes and transcendentals of one call.  The JAX
                   module reads XLA's HLO cost analysis; eager PyTorch has
                   none, so the call runs once under a counting
                   ``TorchDispatchMode``: products by
                   ``torch.utils.flop_counter``'s formulas, and each Hyft
                   kernel by its own count (``kernels/cost.py``), which the
                   kernel wrappers add through a cost scope.
  ``CostBook``   — the per-executable cost ledger the serving engine feeds:
                   costs recorded up front (the engine's prewarm, or before
                   ``generate``'s first dispatch), wall times observed per
                   dispatch.  The join emits achieved GFLOP/s, GB/s and the
                   roofline fraction (the H100's bound from
                   ``roofline/analysis.py`` and ``roofline/hw.py`` over the
                   measured wall) into the metrics registry
                   (``perf.*{executable=...}``) and as ``roofline.<name>``
                   counter events on the trace.
  ``microbench`` — the ten kernel entries of the JAX package's
                   ``analysis/pallas_check.default_registry()``, by its names
                   and shapes (or the entries a caller builds at other
                   shapes), timed and joined with their counts.

XLA counts a scan body once, so the JAX book scales its costs by the layer
scan's trip count.  Eager execution runs every layer, so the port's counts
hold every layer already; ``record``'s ``trip_factor`` is only the number
of calls that one counted call stands for (a burst of ``decode_burst``
steps is one step times the steps).

``bytes`` are what the call must move: each kernel's own count (the K/V
of the keys its mask admits, not the whole pool or cache), and of each
storage among the call's arguments (through dicts, lists and tuples: the
params and the cache) and its outputs, the bytes that the other ops read
or write of it, each byte once.  A view moves nothing; a dense view counts
its run of the storage, an indexed or strided access its elements.  So a
cache updated in place counts the rows written, and a weight read by every
row of a batch counts once.  Intermediates count nothing, the kernels'
small q and output aside (a storage born at the address of one freed
during the call starts its count afresh); so the bound understates the
least time, and a roofline fraction above 1 means a count is wrong.

``xla_profile`` is the ``--xla-profile`` capture window, on
``torch.profiler``.  Not ported: ``repro.obs.trace``'s ``compile_watch``
and ``CompileListener``, JAX-only (eager PyTorch compiles nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.roofline import analysis, hw

TRACE_FILE = "trace.json"

_aten = torch.ops.aten
# ops whose every output element is one transcendental evaluation (the Hyft
# exponent unit is shift-add and counts none)
_TRANSCENDENTAL = {_aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log2,
                   _aten.log1p, _aten.tanh, _aten.sigmoid, _aten.silu, _aten.gelu,
                   _aten.erf, _aten.rsqrt, _aten.sin, _aten.cos, _aten._softmax,
                   _aten._log_softmax}
_FP32 = (torch.float32, torch.float64)


# what a tensor's metadata queries dispatch as on a subclass (a fake
# tensor's device, sizes and strides): they touch no data, and a dense
# tensor answers them without dispatching
_METADATA = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
             "is_strides_like_format", "is_non_overlapping_and_dense", "dim", "size",
             "stride", "storage_offset", "numel"}


def _is_metadata(func) -> bool:
    return func.namespace == "prim" or func._overloadpacket.__name__ in _METADATA


# the indexing that reaches the params and the caches (the embedding rows,
# the K/V writes): ops that touch only the elements they index of their
# first argument, as many as the output (a read) or the values (a write)
_INDEXED = {_aten.index: None, _aten.index_put_: 2}


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of ``tree``; a DTensor's local block in its place."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DTensor):
            yield leaf._local_tensor
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _key(t: torch.Tensor):
    """A storage's identity while it lives: its ``StorageImpl``, which a
    real and a fake or meta storage (whose ``data_ptr`` is 0) both have."""
    return t.untyped_storage()._cdata


class _CountingMode(TorchDispatchMode):
    """Counts the products and transcendentals of the ops it sees into a
    ``kernels.cost.Counter``, and keeps the bytes each op reads or writes of
    each storage (``touched``), except while a kernel scope has paused it.
    A view moves nothing and counts nothing.  An op on DTensors is left to
    DTensor, whose per-rank ops on the local blocks it then counts: a
    sharded call's count is one rank's."""

    def __init__(self, counter: kcost.Counter):
        super().__init__()
        self.counter = counter
        # storage -> (byte runs [start, end), bytes of indexed or strided
        # accesses)
        self.touched: Dict[tuple, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # count the per-rank ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # a storage born in this op (an output at an address that no input
        # holds) starts its count afresh: the allocator may have given it
        # the block of an intermediate freed earlier in the call
        held = {_key(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if _key(t) not in held:
                self.touched.pop(_key(t), None)
        c = self.counter
        if c.paused or func.is_view or _is_metadata(func):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += n
            if any(isinstance(a, torch.Tensor) and a.dtype in _FP32 for a in args):
                c.flops_fp32 += n
        elif packet in _TRANSCENDENTAL and isinstance(out, torch.Tensor):
            c.transcendentals += out.numel()
        seen = {id(t): t for t in _tensors((args, kwargs, out))}
        if packet in _INDEXED:
            self_ = seen.pop(id(args[0]))
            pos = _INDEXED[packet]
            n = out.numel() if pos is None else args[pos].numel()
            self._add(self_, None, n * self_.element_size())
        for t in seen.values():
            self._add(t, *_extent(t))
        return out

    def _add(self, t, run, nbytes) -> None:
        if not t.untyped_storage().nbytes():
            return
        runs, strided = self.touched.setdefault(_key(t), ([], [0]))
        if run is None:
            strided[0] += nbytes
        else:
            runs.append(run)

    def bytes_of(self, key, size: int) -> int:
        """The bytes the counted ops read or wrote of the storage ``key`` of
        ``size`` bytes: its runs' union and the indexed or strided bytes,
        at most ``size``."""
        runs, strided = self.touched.get(key, ((), [0]))
        total, end = strided[0], 0
        for a, b in sorted(runs):
            total += max(0, b - max(a, end))
            end = max(end, b)
        return min(size, total)


def _extent(t: torch.Tensor):
    """(run, bytes) of a view in its storage: run is [start, end) in bytes
    when the view's elements fill one run of the storage (contiguous, or a
    permutation of it), else None and bytes is its distinct elements'."""
    size = t.element_size()
    distinct, span = 1, 1
    for n, s in zip(t.shape, t.stride()):
        if n == 0:
            return None, 0
        if s:
            distinct *= n
            span += (n - 1) * s
    if span != distinct:
        return None, distinct * size
    start = t.storage_offset() * size
    return (start, start + span * size), 0


def _storages(tree, seen: dict) -> None:
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st.nbytes():
            seen[_key(t)] = st.nbytes()


# the methods of DTensor's ``ShardingPropagator`` that run an op on fake
# tensors of the global shapes on a cache miss, newest torch first
_PROPAGATORS = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def unseen_sharding_propagation():
    """While inside, DTensor works out an op's sharding with the dispatch
    modes off.  On a cache miss it runs the op once on fake tensors of the
    global shapes to learn the output's (``ShardingPropagator``), which a
    counting or metering mode would take for the rank's own work, and its
    strategies may read values that a fake tensor does not have.  Raises
    on a torch whose propagator has none of ``_PROPAGATORS``: its counts of
    a sharded step would hold the global ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = next((n for n in _PROPAGATORS if n in ShardingPropagator.__dict__), None)
    if name is None:
        raise RuntimeError(f"torch {torch.__version__}: ShardingPropagator has none of "
                           f"{_PROPAGATORS}; a sharded step's count cannot leave out "
                           "DTensor's sharding propagation")
    orig = ShardingPropagator.__dict__[name]

    def quiet(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)
    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def count_cost(fn, *args) -> tuple:
    """``(fn(*args), its cost)``: the call runs once under the counting
    dispatch mode (see ``exec_cost``); a fault of the call raises.  While a
    process group exists (the only time DTensors can), DTensor's sharding
    propagation is kept out of the count (``unseen_sharding_propagation``)."""
    counter = kcost.Counter()
    mode = _CountingMode(counter)
    sharded = dist.is_available() and dist.is_initialized()
    with (unseen_sharding_propagation() if sharded else contextlib.nullcontext()), \
            kcost.counting(counter), mode:
        out = fn(*args)
    sizes: dict = {}
    _storages(args, sizes)
    _storages(out, sizes)
    nbytes = counter.bytes + sum(mode.bytes_of(k, n) for k, n in sizes.items())
    return out, {"flops": float(counter.flops), "flops_fp32": float(counter.flops_fp32),
                 "bytes": float(nbytes), "transcendentals": float(counter.transcendentals)}


def exec_cost(fn, *args) -> Optional[dict]:
    """FLOPs, bytes and transcendentals of ``fn(*args)``, from one call of it
    under a counting dispatch mode.  Returns None when the call raises
    (never raises, as the JAX module's); callers treat cost rows as
    best-effort.  ``flops_fp32`` is the share of ``flops`` that runs
    outside the tensor cores: products of fp32 operands and the Hyft
    kernels.  ``bytes`` are the kernels' own counts and, of each storage
    among the arguments (through dicts, lists and tuples) and the outputs,
    what the other ops read or wrote of it, each byte once.  The call runs
    for real: pass arguments whose call writes nothing the caller needs
    (gates off, slots inactive).  On DTensors the counts are one rank's."""
    try:
        return count_cost(fn, *args)[1]
    except Exception:  # noqa: BLE001  (best-effort, as the JAX module's)
        return None


def join_cost(cost: dict, wall_s: float) -> dict:
    """Join a cost row with a measured wall time: achieved GFLOP/s and GB/s,
    the H100's roofline bound (through ``analysis.analyze``, so the compute
    and memory terms and the dominant-term logic are its), and the fraction
    of that bound the measured time achieves.  ``peak_gflops`` is the
    tensor cores' bf16 peak, as the JAX module's is its TPU's."""
    roof = analysis.analyze(
        {"flops": cost["flops"], "flops_fp32": cost.get("flops_fp32", 0.0),
         "bytes accessed": cost["bytes"]}, chips=1)
    bound_s = roof.step_time_s
    return {
        "achieved_gflops": cost["flops"] / wall_s / 1e9,
        "achieved_gbps": cost["bytes"] / wall_s / 1e9,
        "peak_gflops": hw.PEAK_FLOPS_BF16 / 1e9,
        "peak_gbps": hw.HBM_BW / 1e9,
        "bound_us": bound_s * 1e6,
        "roofline_fraction": bound_s / wall_s if wall_s > 0 else 0.0,
        "bound_dominant": roof.dominant,
    }


def block_until_ready(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU): what
    ``jax.block_until_ready`` does before the JAX engine reads a wall."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CostBook:
    """Per-executable cost ledger + wall-time join.

    ``record`` runs up front (prewarm, or before the first dispatch) and is
    gated on ``enabled``, so engines built by tests and production paths
    never pay the extra counted call; ``observe`` runs on the hot path and
    is one dict probe when nothing was recorded, and its callers wait for
    the card (``block_until_ready``) only for a name on record.  ``bind``
    attaches the Obs bundle's registry and tracer, so joins land as
    ``perf.*`` gauges and ``roofline.*`` counter tracks.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.costs: Dict[str, dict] = {}
        self._agg: Dict[str, dict] = {}
        self._metrics = None
        self._tracer = None

    def bind(self, metrics, tracer) -> None:
        self._metrics = metrics
        self._tracer = tracer

    def __contains__(self, name: str) -> bool:
        return name in self.costs

    def record(self, name: str, fn, *args, trip_factor: float = 1.0
               ) -> Optional[dict]:
        """Count one call of ``fn(*args)`` (``exec_cost``) under ``name``,
        scaled by ``trip_factor``, the calls it stands for.  Idempotent per
        name (an executable's cost is static), a no-op unless enabled."""
        if not self.enabled:
            return None
        if name in self.costs:
            return self.costs[name]
        c = exec_cost(fn, *args)
        if c is None:
            return None
        c = {"flops": c["flops"] * trip_factor,
             "flops_fp32": c["flops_fp32"] * trip_factor,
             "bytes": c["bytes"] * trip_factor,
             "transcendentals": c["transcendentals"] * trip_factor,
             "trip_factor": trip_factor}
        self.costs[name] = c
        return c

    def observe(self, name: str, wall_s: float) -> Optional[dict]:
        """Join one measured dispatch of ``name`` against its recorded cost;
        emits gauges, a histogram and a counter event, and returns the join
        (None when no cost is on record: the disabled path's cost is this
        one dict probe)."""
        cost = self.costs.get(name)
        if cost is None or wall_s <= 0:
            return None
        j = join_cost(cost, wall_s)
        agg = self._agg.setdefault(name, {"calls": 0, "wall_s": 0.0})
        agg["calls"] += 1
        agg["wall_s"] += wall_s
        if self._metrics is not None:
            lab = dict(executable=name)
            self._metrics.gauge("perf.achieved_gflops", **lab).set(j["achieved_gflops"])
            self._metrics.gauge("perf.achieved_gbps", **lab).set(j["achieved_gbps"])
            self._metrics.gauge("perf.roofline_fraction", **lab).set(
                j["roofline_fraction"])
            self._metrics.histogram("perf.wall_s", **lab).observe(wall_s)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.counter(
                f"roofline.{name}", cat="perf", gflops=j["achieved_gflops"],
                gbps=j["achieved_gbps"], frac=j["roofline_fraction"])
        return j

    def summary(self) -> Dict[str, dict]:
        """Per-executable rows: the static cost, and the join at the mean
        observed wall time (an executable recorded but never dispatched
        carries its cost alone)."""
        rows: Dict[str, dict] = {}
        for name, cost in sorted(self.costs.items()):
            row = dict(cost)
            agg = self._agg.get(name)
            if agg and agg["calls"]:
                mean = agg["wall_s"] / agg["calls"]
                row.update(calls=agg["calls"], wall_mean_us=mean * 1e6,
                           **join_cost(cost, mean))
            rows[name] = row
        return rows


@contextlib.contextmanager
def xla_profile(outdir: Optional[str]) -> Iterator[None]:
    """The ``torch.profiler`` counterpart of the JAX package's
    ``xla_profile``: profile the CPU and, where there is one, the card
    while inside, then write the Chrome trace to ``outdir/trace.json``
    (load it in ui.perfetto.dev).  A no-op when ``outdir`` is falsy, so
    call sites pass the ``--xla-profile`` flag through unconditionally."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, TRACE_FILE))


# --------------------------------------------------------------------------
# the kernel microbench
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KernelEntry:
    """One kernel to time: ``make()`` returns ``(fn, args, cost)``, a call of
    a public wrapper, its tensor operands, and its count from
    ``kernels/cost.py`` at those operands."""
    name: str
    make: Callable[[], tuple]


def softmax_entry(name: str, kind: str, x, cfg, dy=None, out_dtype=None) -> KernelEntry:
    """Kernel 1 (``kind="fwd"``: ``hyft_softmax_fwd_kernel(x)``) or 2
    (``"bwd"``: ``hyft_softmax_bwd_kernel(x, dy)`` with dz in ``out_dtype``,
    ``cfg.dtype`` by default)."""
    from repro_torch.kernels import hyft_softmax as hs

    def make():
        if kind == "fwd":
            c = kcost.softmax_cost("hyft_softmax_fwd", x.shape, x.element_size(),
                                   cfg.dtype.itemsize)
            return (lambda z: hs.hyft_softmax_fwd_kernel(z, cfg)), (x,), c
        out = cfg.dtype if out_dtype is None else out_dtype
        c = kcost.softmax_cost("hyft_softmax_bwd", x.shape,
                               x.element_size() + dy.element_size(), out.itemsize)
        return (lambda s, d: hs.hyft_softmax_bwd_kernel(s, d, cfg, out_dtype=out)), \
            (x, dy), c
    return KernelEntry(name, make)


def flash_entry(name: str, q, k, v, cfg, *, backward: bool = False,
                block_q: int = 128, block_k: int = 128) -> KernelEntry:
    """Kernel 3 (``flash_hyft_attention``'s causal forward) or, with
    ``backward``, the gradient of its sum: kernels 3, 4 and 5 in one call,
    as the JAX registry's ``flash_bwd`` entry differentiates the whole."""
    from repro_torch.kernels import flash_attention as fa

    def attend(q, k, v):
        return fa.flash_hyft_attention(q, k, v, cfg, causal=True, block_q=block_q,
                                       block_k=block_k)

    def make():
        _, _, _, maskf, _ = fa.flash_operands(q, k, v, None, block_q, block_k)
        kernels = (("hyft_flash_fwd", "hyft_flash_bwd_dq", "hyft_flash_bwd_dkv")
                   if backward else ("hyft_flash_fwd",))
        c = kcost.add(*(kcost.flash_cost(n, q.shape, k.shape, q.element_size(),
                                         causal=True, masked=maskf is not None)
                        for n in kernels))
        if not backward:
            return attend, (q, k, v), c
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        return (lambda q, k, v: torch.autograd.grad(attend(q, k, v).sum(), (q, k, v))), \
            leaves, c
    return KernelEntry(name, make)


def attend_entry(name: str, q, k, v, mask, cfg, *, block_tables=None, k_scale=None,
                 v_scale=None, block_k: int = 256) -> KernelEntry:
    """Kernels 6-9 through their public wrappers: decode (``q`` with one
    lane, ``mask`` (B, Sk)) or a chunk (``mask`` (B, Sq, Sk)), over a
    contiguous cache or, with ``block_tables``, a paged pool."""
    from repro_torch.kernels import flash_attention as fa

    def make():
        hkv = k.shape[1]
        B, Hq, Sq, D = q.shape
        q3 = q.reshape(B * hkv, Hq // hkv * Sq, D)
        bt = None if block_tables is None else block_tables.to(torch.int32)
        c = kcost.attend_cost(q3, k, mask, hkv=hkv, block_tables=bt)
        kw = dict(k_scale=k_scale, v_scale=v_scale)
        if mask.ndim == 3:
            if bt is None:
                return (lambda q, k, v, m: fa.flash_hyft_verify(
                    q, k, v, m, cfg, block_k=block_k, **kw)), (q, k, v, mask), c
            return (lambda q, k, v, bt, m: fa.flash_hyft_verify(
                q, k, v, m, cfg, block_tables=bt, **kw)), (q, k, v, bt, mask), c
        if bt is None:
            return (lambda q, k, v, m: fa.flash_hyft_decode(
                q, k, v, cfg, block_k=block_k, kv_len_mask=m, **kw)), (q, k, v, mask), c
        return (lambda q, k, v, bt, m: fa.flash_hyft_decode_paged(
            q, k, v, bt, cfg, kv_len_mask=m, **kw)), (q, k, v, bt, mask), c
    return KernelEntry(name, make)


def default_registry(device=None) -> List[KernelEntry]:
    """The JAX package's ten registry entries (``pallas_check.
    default_registry``), by its names and shapes, on ``device`` (None = the
    card): B 2, 4 / 2 heads of 16, HYFT16, seeded normal data (int8 raws
    uniform in [-127, 127])."""
    from repro_torch.core.hyft import HYFT16
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = HYFT16
    B, Hq, Hkv, D = 2, 4, 2, 16
    F32, I8 = torch.float32, torch.int8

    def rnd(shape, dtype=F32):
        if dtype == I8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev).to(I8)
        return torch.randn(shape, generator=gen, device=dev)

    z = rnd((24, 64))
    entries = [softmax_entry("softmax_fwd", "fwd", z, cfg),
               softmax_entry("softmax_bwd", "bwd", torch.softmax(rnd((24, 64)), -1), cfg,
                             dy=rnd((24, 64)))]
    qkv = (rnd((B, Hq, 32, D)), rnd((B, Hkv, 32, D)), rnd((B, Hkv, 32, D)))
    entries += [flash_entry("flash_fwd", *qkv, cfg, block_q=16, block_k=16),
                flash_entry("flash_bwd", *qkv, cfg, backward=True, block_q=16, block_k=16)]
    Sk = 48                      # not a multiple of 128: the padded split
    ones = torch.ones(B, Sk, device=dev)
    q1 = rnd((B, Hq, 1, D))
    entries.append(attend_entry("splitk_decode[float32]", q1, rnd((B, Hkv, Sk, D)),
                                rnd((B, Hkv, Sk, D)), ones, cfg, block_k=128))
    entries.append(attend_entry("splitk_decode[fp2fx8]", q1, rnd((B, Hkv, Sk, D), I8),
                                rnd((B, Hkv, Sk, D), I8), ones, cfg, block_k=128,
                                k_scale=rnd((B, Hkv, Sk)), v_scale=rnd((B, Hkv, Sk))))
    n_pages, ps, nb = 6, 8, 3
    bt = (torch.arange(B * nb, device=dev).reshape(B, nb) % n_pages).to(torch.int32)
    paged_mask = torch.ones(B, nb * ps, device=dev)
    entries.append(attend_entry("paged_decode[float32]", q1, rnd((n_pages, Hkv, ps, D)),
                                rnd((n_pages, Hkv, ps, D)), paged_mask, cfg,
                                block_tables=bt))
    entries.append(attend_entry("paged_decode[fp2fx8]", q1, rnd((n_pages, Hkv, ps, D), I8),
                                rnd((n_pages, Hkv, ps, D), I8), paged_mask, cfg,
                                block_tables=bt, k_scale=rnd((n_pages, Hkv, ps)),
                                v_scale=rnd((n_pages, Hkv, ps))))
    Sq = 4
    q4 = rnd((B, Hq, Sq, D))
    entries.append(attend_entry("verify[dense]", q4, rnd((B, Hkv, Sk, D)),
                                rnd((B, Hkv, Sk, D)), torch.ones(B, Sq, Sk, device=dev),
                                cfg, block_k=128))
    entries.append(attend_entry("verify[paged,fp2fx8]", q4, rnd((n_pages, Hkv, ps, D), I8),
                                rnd((n_pages, Hkv, ps, D), I8),
                                torch.ones(B, Sq, nb * ps, device=dev), cfg,
                                block_tables=bt, k_scale=rnd((n_pages, Hkv, ps)),
                                v_scale=rnd((n_pages, Hkv, ps))))
    return entries


def _time_us(fn, args, iters: int, device) -> float:
    """Microseconds a call of ``fn(*args)`` after one warm-up call: CUDA
    events around ``iters`` calls on the card, the host clock on the CPU
    (where the wrappers run the plain versions)."""
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def microbench(entries=None, iters: int = 5, report=None, device=None) -> List[dict]:
    """Time every kernel entry and join it with its count: one row per
    (kernel, shape, format) with us/call, GFLOP/s, GB/s and the roofline
    fraction against the H100's bound, under the JAX module's row keys (and
    ``flops_fp32``).  ``entries`` defaults to ``default_registry(device)``'s
    ten on ``device`` (None = the card); given entries run where their
    operands lie."""
    rows: List[dict] = []
    for entry in entries if entries is not None else default_registry(device):
        fn, args, c = entry.make()
        us = _time_us(fn, args, iters, args[0].device)
        fmt = entry.name.partition("[")[2].rstrip("]") or "float32"
        row = {"kernel": entry.name, "format": fmt,
               "shapes": ["x".join(map(str, a.shape)) for a in args],
               "dtypes": [str(a.dtype).removeprefix("torch.") for a in args],
               "iters": iters, "us_per_call": us}
        row.update({k: c[k] for k in ("flops", "flops_fp32", "bytes", "transcendentals")})
        row.update(join_cost(c, us * 1e-6))
        rows.append(row)
        if report is not None:
            frac = row.get("roofline_fraction")
            report(f"bench_kernels,{entry.name},us_per_call={us:.1f},"
                   f"gflops={row.get('achieved_gflops', 0):.3f},"
                   f"gbps={row.get('achieved_gbps', 0):.3f},"
                   f"bound_us={row.get('bound_us', 0):.3f},"
                   f"frac={frac if frac is None else format(frac, '.2e')}")
    return rows
