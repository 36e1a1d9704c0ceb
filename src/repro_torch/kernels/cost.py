"""What each Hyft kernel must do: its bytes and operations, one function a
kernel, and the scope through which a counted call sees that work.

Each count is the least work of one launch at its operands, as the
roofline bound (``roofline/analysis.py``) reads it: every input read once
and every output written once, and the fp32 FLOPs over the (row, key)
pairs that the mask admits.  ``chip_smoke.py``'s kernels phases, the cost
book (``obs/profile.py::exec_cost``) and the kernel microbench
(``obs/profile.py::microbench``) all take their counts from here, so a
kernel's bound is the same work whatever times it.

A count is a dict: ``flops``, ``flops_fp32`` (the share of ``flops`` that
runs outside the tensor cores: all of it, the kernels use fp32 FMAs only),
``bytes`` and ``transcendentals`` (0: the Hyft exponent unit is
shift-add).  The softmax kernels (1-2) do no products; their ``flops`` are
the paper's datapath operations (``SOFTMAX_OPS``) in fp32 FLOPs of the
same instruction time (``ops_as_flops``), and they also carry ``ops`` and
``int_ops``.

The scope: ``exec_cost`` pushes a ``Counter`` (``counting``); each public
wrapper opens ``scope(count_fn, ...)`` around its kernel, which adds the
kernel's count (its bytes too) to the innermost counter and pauses it, so
that the plain version's own products and reads, which a CPU call runs in
the kernel's place, are not counted again.  On the card the kernels are ctypes launches that no
dispatch mode sees; the scope is how they get counted.  With no counter
pushed, ``scope`` returns a shared null context and computes nothing.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.roofline import analysis, hw

F32_BYTES = 4

# operations per element of the Hyft softmax as the paper's datapath
# defines it, one for each block an element passes through, whatever
# instructions carry it: forward FP2FX (a conversion), then the max, the
# exponent unit, the adder tree and the log-subtract divide (integer);
# backward the two fx_quantize (conversions to fixed point), then the two
# log-domain multiplies, the adder tree and the fixed-point subtract
# (integer)
SOFTMAX_OPS = {"hyft_softmax_fwd": {"int": 4, "other": 1},
               "hyft_softmax_bwd": {"int": 4, "other": 2}}


def shape_only(x) -> bool:
    """Whether ``x`` (a tensor or a device) holds shapes and dtypes but no
    data: a fake tensor (``FakeTensorMode``, the dry-run's trace) or one on
    the meta device.  No kernel runs on it (its ``data_ptr`` is null), and
    no count can read its values."""
    if isinstance(x, torch.device):
        return x.type == "meta"
    from torch._subclasses.fake_tensor import is_fake
    return x.device.type == "meta" or is_fake(x)


def _count(flops, nbytes, **extra) -> dict:
    return {"flops": float(flops), "flops_fp32": float(flops), "bytes": float(nbytes),
            "transcendentals": 0.0, **extra}


def attend_cost(q3, k, mask, *, hkv: int, block_tables=None) -> dict:
    """Kernels 6-9 (``_splitk_attention_cuda``, ``_paged_attention_cuda``)
    at their folded operands: q3 (BH, rows, D); K/V ``k`` (contiguous
    (BH, Sk, D) or paged (P, Hkv, ps, D)), float or int8 raws with fp32
    scales; ``mask`` (B, Sk) for decode or (B, Sq, Sk) per lane;
    ``block_tables`` (B, nb) int32 for the paged kernels.

    Bytes: q3 in and the fp32 output, each (BH, rows, D); K and V (and the
    scales) of the keys some row admits; the mask; the block table.  FLOPs:
    2 D each for QK^T and PV over the admitted (row, key) pairs.  Reads the
    mask from the device; a mask without values (``shape_only``) counts
    every key it covers as admitted, which is exact for a decode step
    against a full cache (the dry-run's cells), and the count says
    ``"mask": "from shapes"``."""
    BH, rows, D = q3.shape
    lanes = 1 if mask.ndim == 2 else mask.shape[1]
    group = rows // lanes                     # query heads a KV head
    extra = {}
    if shape_only(mask):
        B, Sk = mask.shape[0], mask.shape[-1]
        pairs, keys = B * lanes * Sk * hkv * group, B * Sk * hkv
        extra["mask"] = "from shapes"
    else:
        admit = mask > 0
        if admit.ndim == 2:                   # decode: one lane
            admit = admit[:, None]
        pairs = int(admit.sum()) * hkv * group
        keys = int(admit.any(1).sum()) * hkv  # live (head, key) rows
    per_key = 2 * D * k.element_size() + (2 * F32_BYTES if k.dtype == torch.int8 else 0)
    nbytes = (2 * BH * rows * D * F32_BYTES + keys * per_key + mask.numel() * F32_BYTES
              + (0 if block_tables is None else block_tables.numel() * F32_BYTES))
    return _count(4 * D * pairs, nbytes, **extra)


# the flash kernels' FLOPs a (row, key) pair, per D: QK^T and PV (forward);
# QK^T, dO V^T and dS K (dq); QK^T, dO V^T, P^T dO and dS^T Q (dk/dv)
_FLASH_PER_PAIR = {"hyft_flash_fwd": 4, "hyft_flash_bwd_dq": 6, "hyft_flash_bwd_dkv": 8}


def _flash_pairs(q_shape, k_shape, *, causal: bool, q_offset: int = 0,
                kv_len_mask=None) -> int:
    """The (row, key) pairs that the causal frontier and the mask admit, over
    every query head: row i sees key j when ``j <= i + q_offset`` (causal)
    and the mask admits j.  Reads the mask from the device; a mask without
    values (``shape_only``) admits every key it covers (the dry-run's
    full-length batches)."""
    B, Hq, Sq, _ = q_shape
    Sk = k_shape[2]
    if kv_len_mask is None or shape_only(kv_len_mask):
        if not causal:
            return B * Hq * Sq * Sk
        return B * Hq * sum(min(max(i + q_offset + 1, 0), Sk) for i in range(Sq))
    valid = (kv_len_mask > 0).to(torch.int64)           # (B, Sk)
    if not causal:
        return Hq * Sq * int(valid.sum())
    seen = torch.cumsum(valid, -1)                       # keys 0..j valid, per b
    last = torch.arange(Sq, device=valid.device) + q_offset
    per_row = torch.where(last >= 0, seen[:, last.clamp(0, Sk - 1)], 0)
    return Hq * int(per_row.sum())


def flash_cost(kernel: str, q_shape, k_shape, itemsize: int, *, causal: bool,
               q_offset: int = 0, kv_len_mask=None, masked: bool = False) -> dict:
    """Kernels 3-5 (``kernel``: ``hyft_flash_fwd``, ``hyft_flash_bwd_dq`` or
    ``hyft_flash_bwd_dkv``) at the unpadded operand shapes of
    ``flash_hyft_attention``: q (B, Hq, Sq, D), K/V (B, Hkv, Sk, D) of
    ``itemsize`` bytes; ``masked`` when the kernel reads a (B, Sk) fp32 mask
    (``kv_len_mask``, or keys padded to the block).

    Bytes: q, K and V (and the mask) in, then per kernel: the forward writes
    o (fp32) and the row stats m, l; dq reads do, delta, m, l and writes dq;
    dk/dv reads do, delta, m, l and writes dk and dv (fp32).  FLOPs: 2 D a
    product over the admitted pairs (``_flash_pairs``)."""
    B, Hq, Sq, D = q_shape
    _, Hkv, Sk, _ = k_shape
    BH, BHkv = B * Hq, B * Hkv
    pairs = _flash_pairs(q_shape, k_shape, causal=causal, q_offset=q_offset,
                        kv_len_mask=kv_len_mask)
    extra = ({"mask": "from shapes"} if kv_len_mask is not None and shape_only(kv_len_mask)
             else {})
    qkv = (BH * Sq + 2 * BHkv * Sk) * D * itemsize + (B * Sk * F32_BYTES if masked else 0)
    rows = BH * Sq * F32_BYTES                             # one fp32 / int32 a row
    out = {"hyft_flash_fwd": BH * Sq * D * F32_BYTES + 2 * rows,
           "hyft_flash_bwd_dq": 2 * BH * Sq * D * F32_BYTES + 3 * rows,
           "hyft_flash_bwd_dkv": BH * Sq * D * F32_BYTES + 3 * rows
           + 2 * BHkv * Sk * D * F32_BYTES}[kernel]
    return _count(_FLASH_PER_PAIR[kernel] * D * pairs, qkv + out, **extra)


def ops_as_flops(ops: float, int_ops: float) -> float:
    """``ops`` lane instructions, ``int_ops`` of them integer, as the fp32
    FLOPs that take the card the same instruction time: one instruction a lane a
    clock is half an FMA's two FLOPs, and integer ones run on half the
    lanes."""
    return max(ops * (hw.PEAK_FLOPS_FP32 / hw.LANE_INSTR_PER_S),
               int_ops * (hw.PEAK_FLOPS_FP32 / hw.INT_INSTR_PER_S))


def softmax_cost(kernel: str, shape, in_bytes: int, out_bytes: int) -> dict:
    """Kernels 1-2 (``hyft_softmax_fwd`` or ``hyft_softmax_bwd``) over rows
    of ``shape``'s last axis: ``in_bytes`` per element read (z; or s and dy
    together), ``out_bytes`` per element written (the output, or dz), and
    ``SOFTMAX_OPS[kernel]`` operations an element."""
    n = math.prod(shape)
    per = SOFTMAX_OPS[kernel]
    ops, int_ops = (per["int"] + per["other"]) * n, per["int"] * n
    return _count(ops_as_flops(ops, int_ops), n * (in_bytes + out_bytes), ops=ops,
                  int_ops=int_ops)


def add(*costs) -> dict:
    """The counts of several launches together (a call that runs them all)."""
    keys = ("flops", "flops_fp32", "bytes", "transcendentals")
    return {k: float(sum(c[k] for c in costs)) for k in keys}


def bound(cost: dict) -> tuple[analysis.Roofline, str]:
    """The roofline of ``cost`` (``analysis.analyze``: its ``step_time_s`` is
    the least time the card could take, of its bytes and its operations'
    terms), and the term that sets it, "bytes" or "operations"."""
    roof = analysis.analyze({"flops": cost["flops"], "flops_fp32": cost["flops_fp32"],
                             "bytes accessed": cost["bytes"]})
    return roof, "bytes" if roof.memory_s >= roof.compute_s else "operations"


# --------------------------------------------------------------------------
# the scope that a counted call's wrappers consult
# --------------------------------------------------------------------------


class Counter:
    """The work a counted call did: the products the dispatch mode saw and
    the kernels' counts that the scopes added (``bytes`` holds the kernels'
    alone; the dispatch mode keeps the other ops' bytes by storage).
    ``paused`` is the depth of open kernel scopes; the dispatch mode counts
    nothing while it is > 0."""

    def __init__(self):
        self.flops = 0.0
        self.flops_fp32 = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.paused = 0

    def add_kernel(self, cost: dict) -> None:
        self.flops += cost["flops"]
        self.flops_fp32 += cost["flops_fp32"]
        self.bytes += cost["bytes"]
        self.transcendentals += cost["transcendentals"]


# the counters of the counted calls in progress, innermost last (a list
# shared across threads: autograd runs a CUDA backward on a thread of its own)
_COUNTERS: list[Counter] = []
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def counting(counter: Counter):
    """Make ``counter`` the one that kernel scopes add to while inside."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


class _Scope:
    def __init__(self, counter: Counter):
        self.counter = counter

    def __enter__(self):
        self.counter.paused += 1

    def __exit__(self, *exc):
        self.counter.paused -= 1


def scope(count_fn, *args, **kw):
    """The context a public wrapper runs its kernel (or, on the CPU, the
    plain version) in: outside a counted call, a null context; inside one,
    adds ``count_fn(*args, **kw)``, one launch's count, and pauses the
    counter until it exits.  A wrapper reached inside another's scope (a
    plain version calling a wrapper) counts nothing of its own."""
    if not _COUNTERS or _COUNTERS[-1].paused:
        return _NULL
    paused = _Scope(_COUNTERS[-1])
    with paused:                 # the count's own reads of the mask count nothing
        paused.counter.add_kernel(count_fn(*args, **kw))
    return paused
