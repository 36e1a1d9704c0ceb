"""Split-K Hyft attention for decode (Sq = 1) and token chunks (Sq > 1).

The PyTorch counterpart of the split-K half of ``repro.kernels.flash_attention``:

* ``flash_hyft_decode`` replaces ``_decode_fwd_kernel`` (the TPU kernel at
  ``repro/kernels/flash_attention.py:541``, launched from ``:619``);
* ``flash_hyft_verify`` replaces the contiguous branch of
  ``flash_hyft_verify`` and its ``_verify_fwd_kernel`` (``:804``, ``:963``).

Both are one machine.  The KV axis is cut into splits of
``bk = min(block_k, ceil128(Sk))`` keys; per split, level 1 of the paper's
tree (``_decode_tile``: FP2FX, integer max, exponent unit, fixed-point sum,
PV) emits local ``(acc, m_loc, l_loc)`` stats, and level 2
(``_splitk_combine``: integer max across splits, ``hyft_alpha`` rescale,
fixed-sum merge, ``hyft_finalize`` divide) merges them.  The split size is
part of the arithmetic: every split adds one Hyft rescale.

Level 1 runs in the hand-written CUDA kernel ``csrc/hyft_splitk.cu`` for a
CUDA tensor and in its plain PyTorch version (``splitk_tiles_plain``) for a
CPU tensor; the wrapper picks by ``q.device.type`` and nothing else.  Level
2 is plain torch on the device for both, as the JAX package computes it
outside the ``pallas_call``.  To hold the kernel to its plain version, call
both by name on the same folded inputs and measure with ``tile_errors``.

Layouts are the JAX package's: q ``(B, Hq, Sq, D)``, K/V ``(B, Hkv, Sk, D)``
float or int8 FP2FX raws with fp32 ``(B, Hkv, Sk)`` scales.  The GQA group
(and, for a chunk, the token lane) folds into the rows of a split:
``rows = g * Sq``, row ``r`` carrying lane ``r % Sq``.  The TPU padded those
rows to 8 sublanes; rows are independent, so the port does not.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import numerics as nm
from repro_torch.core.hyft import HyftConfig

F32 = torch.float32
I32 = torch.int32
NEG_BIG = -3.0e38  # pre-quantization mask value; FP2FX saturates it to fx lo

# launches of each CUDA entry point; a plain count that callers reset and
# read to show which kernels a run went through
LAUNCHES = {"hyft_splitk_decode": 0, "hyft_splitk_verify": 0}

_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KEYS_PER_STAGE = 64   # the CUDA kernel stages K/V in sub-tiles of 64 keys
_HEAD_DIMS = (128,)  # head widths the CUDA kernel is instantiated for


def _pad0(x: torch.Tensor, widths) -> torch.Tensor:
    """Zero-pad at the end of each axis: ``widths`` is one pad length per
    axis, leading axes first (``jnp.pad`` with ``(0, w)`` pairs)."""
    pads = []
    for w in reversed(widths):
        pads += [0, w]
    return F.pad(x, pads)


def hyft_finalize(acc, l, cfg: HyftConfig):
    """Hyft stage 3: log-subtract division ``acc / l`` through the DIV unit.

    acc: (..., D) fp32 PV accumulator; l: (..., 1) fp32 fixed-point sum.
    """
    e_b, m_b = nm.lod_refloat(l, cfg.mant_bits)
    sg, e_n, m_n = nm.float_fields(acc, cfg.mant_bits)
    res = nm.log_div(e_n, m_n, e_b, m_b, cfg.mant_bits)
    res = torch.where(sg == 1, -res, res)
    return torch.where(acc == 0, torch.zeros_like(res), res)


def hyft_alpha(d_raw, cfg: HyftConfig):
    """Hyft-approximated ``exp(d)`` of a fixed-point max delta (d <= 0),
    assembled to fp32 — the DIV/MUL unit in rescale duty."""
    e_a, m_a = nm.exp_unit(d_raw, cfg.frac_bits, cfg.mant_bits)
    return ((1 << cfg.mant_bits) + m_a).to(F32) * nm.pow2_float(
        e_a - cfg.mant_bits)


def _decode_tile(q, k, v, maskrow, cfg: HyftConfig, sm_scale: float):
    """L1 of the decode tree: local Hyft stages 1-2 for KV splits.

    q (..., rows, D); k/v (..., bk, D) fp32 (already dequantized); maskrow
    broadcastable to (..., rows, bk).  Returns (acc (..., rows, D),
    m_loc (..., rows, 1) int32 raw, l_loc (..., rows, 1) fp32).
    """
    z = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    z = torch.where(maskrow > 0, z, NEG_BIG)
    z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
    zsub = z_raw[..., :: cfg.step] if cfg.step > 1 else z_raw
    m_loc = torch.amax(zsub, dim=-1, keepdim=True)
    e, m = nm.exp_unit(z_raw - m_loc, cfg.frac_bits, cfg.mant_bits)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    l_loc = torch.sum(addend, dim=-1, keepdim=True)
    p = ((1 << cfg.mant_bits) + m).to(F32) * nm.pow2_float(e - cfg.mant_bits)
    return torch.matmul(p, v), m_loc, l_loc


def _splitk_combine(acc, m_loc, l_loc, cfg: HyftConfig):
    """L2 of the decode tree: merge per-split stats across the split axis
    (axis 1).  acc (BH, ns, rows, D) f32; m_loc (BH, ns, rows) i32; l_loc
    (BH, ns, rows) f32.  Returns (BH, rows, D).

    The sums over splits run in split order, one split at a time, so the
    result does not depend on how a library reduction orders them.
    """
    m_glob = torch.amax(m_loc, dim=1, keepdim=True)
    alpha = hyft_alpha(m_loc - m_glob, cfg)                # (BH, ns, rows)
    l_terms = nm.fx_quantize(l_loc * alpha, cfg.acc_bits)
    acc_terms = acc * alpha[..., None]
    l_glob, acc_glob = l_terms[:, 0], acc_terms[:, 0]
    for j in range(1, acc.shape[1]):
        l_glob = l_glob + l_terms[:, j]
        acc_glob = acc_glob + acc_terms[:, j]
    return hyft_finalize(acc_glob, l_glob[..., None], cfg)


def _verify_mask_rows(mask, group: int):
    """(..., Sq, bk) per-lane mask -> (..., group * Sq, bk) tile rows: row
    ``r`` carries lane ``r % Sq``."""
    *lead, sq, bk = mask.shape
    return mask.unsqueeze(-3).expand(*lead, group, sq, bk).reshape(
        *lead, group * sq, bk)


# --------------------------------------------------------------------------
# level 1 over all splits: the plain version and the CUDA kernel
# --------------------------------------------------------------------------


def splitk_tiles_plain(q3, k3, v3, k_scale, v_scale, mask, *, cfg: HyftConfig,
                       sm_scale: float, bk: int, hkv: int, sq: int | None):
    """Per-split Hyft stats, in plain PyTorch, on any device.

    q3 (BH, rows, D) fp32; k3/v3 (BH, Sk, D) float, or int8 raws with
    ``k_scale``/``v_scale`` (BH, Sk) fp32; ``mask`` (B, Sk) shared by every
    row when ``sq`` is None (decode), else (B, sq, Sk) per token lane.  The
    KV axis is zero-padded to a multiple of ``bk`` and the padding masked.
    Returns acc (BH, ns, rows, D) f32, m_loc (BH, ns, rows) i32 and
    l_loc (BH, ns, rows) f32.
    """
    BH, rows, D = q3.shape
    Sk = k3.shape[1]
    ns = -(-Sk // bk)
    pad = ns * bk - Sk
    k = k3.to(F32)
    v = v3.to(F32)
    if k_scale is not None:              # dequant: raw * scale
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    k = _pad0(k, (0, pad, 0)).reshape(BH, ns, bk, D)
    v = _pad0(v, (0, pad, 0)).reshape(BH, ns, bk, D)
    b_of = torch.arange(BH, device=q3.device) // hkv
    maskp = _pad0(mask.to(F32), (0,) * (mask.ndim - 1) + (pad,))[b_of]
    if sq is None:                       # (BH, Skp) -> (BH, ns, 1, bk)
        mrow = maskp.reshape(BH, ns, 1, bk)
    else:                                # (BH, sq, Skp) -> (BH, ns, rows, bk)
        mrow = _verify_mask_rows(maskp, rows // sq)
        mrow = mrow.reshape(BH, rows, ns, bk).transpose(1, 2)
    acc, m_loc, l_loc = _decode_tile(q3[:, None], k, v, mrow, cfg, sm_scale)
    return acc, m_loc[..., 0], l_loc[..., 0]


def _splitk_tiles_cuda(q3, k3, v3, k_scale, v_scale, mask, *, cfg: HyftConfig,
                       sm_scale: float, bk: int, hkv: int, sq: int | None):
    """Per-split Hyft stats from the CUDA kernel; same contract as
    ``splitk_tiles_plain``.  The kernel reads the unpadded K/V and masks the
    ragged last split itself."""
    from repro_torch.kernels import build

    name = "hyft_splitk_decode" if sq is None else "hyft_splitk_verify"
    BH, rows, D = q3.shape
    Sk = k3.shape[1]
    B = BH // hkv
    quantized = k3.dtype == torch.int8
    _check(q3.dtype == F32 and q3.is_contiguous(), "q3 must be contiguous fp32")
    _check(k3.dtype in _KV_TYPES and v3.dtype == k3.dtype,
           f"K/V dtype {k3.dtype}/{v3.dtype} not one of {list(_KV_TYPES)}")
    _check(k3.shape == (BH, Sk, D) and v3.shape == (BH, Sk, D),
           f"K/V shape {tuple(k3.shape)} != {(BH, Sk, D)}")
    _check(k3.is_contiguous() and v3.is_contiguous(), "K/V must be contiguous")
    _check(quantized == (k_scale is not None) == (v_scale is not None),
           "int8 K/V need k_scale and v_scale, float K/V take none")
    if quantized:
        _check(k_scale.dtype == F32 and v_scale.dtype == F32
               and k_scale.shape == (BH, Sk) and v_scale.shape == (BH, Sk)
               and k_scale.is_contiguous() and v_scale.is_contiguous(),
               "scales must be contiguous fp32 (BH, Sk)")
    want = (B, Sk) if sq is None else (B, sq, Sk)
    _check(mask.dtype == F32 and tuple(mask.shape) == want
           and mask.is_contiguous(), f"mask must be contiguous fp32 {want}")
    _check(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    _check(bk % _KEYS_PER_STAGE == 0, f"bk={bk} not a multiple of {_KEYS_PER_STAGE}")
    tensors = (q3, k3, v3, mask) + ((k_scale, v_scale) if quantized else ())
    _check(all(t.device == q3.device and t.device.type == "cuda" for t in tensors),
           "all inputs must be on the same CUDA device")

    ns = -(-Sk // bk)
    acc = torch.empty((BH, ns, rows, D), dtype=F32, device=q3.device)
    m_loc = torch.empty((BH, ns, rows), dtype=I32, device=q3.device)
    l_loc = torch.empty((BH, ns, rows), dtype=F32, device=q3.device)
    lib = build.load()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    err = getattr(lib, name)(
        ptr(q3), ptr(k3), ptr(v3), ptr(k_scale), ptr(v_scale), ptr(mask),
        ptr(acc), ptr(m_loc), ptr(l_loc), _KV_TYPES[k3.dtype],
        BH, hkv, rows, Sk, bk, D, sq if sq is not None else 1,
        ctypes.c_float(sm_scale), cfg.frac_bits, cfg.total_bits,
        cfg.mant_bits, cfg.acc_bits, cfg.step,
        ctypes.c_void_p(torch.cuda.current_stream(q3.device).cuda_stream))
    if err:
        raise RuntimeError(f"{name} failed: cudaError {err} "
                           f"({lib.hyft_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return acc, m_loc, l_loc


def _check(ok: bool, msg: str):
    if not ok:
        raise ValueError(msg)


def _tiles_for(device: torch.device):
    """The wrapper's one choice: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if device.type == "cpu":
        return splitk_tiles_plain
    if device.type == "cuda":
        return _splitk_tiles_cuda
    raise ValueError(f"no split-K attention for device {device}")


def tile_errors(got, ref, cfg: HyftConfig, v_absmax: float, bk: int) -> dict:
    """Level-1 stats ``got`` against ``ref``, both ``(acc, m_loc, l_loc)``
    for the same inputs (the kernel's and the plain version's), as the
    worst |diff| over its bound: each of ``m_loc``, ``l_loc`` and ``out``
    must be <= 1.  A kernel that sums its fp32 dot products in another
    order may differ from the plain version only so:

    * a score can round to the neighbouring FP2FX raw, so ``m_loc`` may
      move by one raw;
    * that moves one key's Hyft exponent by about 2**-mant of itself, or
      every key's through ``m_loc``, and the addends round to
      2**-acc_bits: ``|dl| <= 2 * 2**-mant * l + bk * 2**-acc_bits``;
    * after the shared combine, the output moves by 2**-mant * max|v| *
      p / l for the key that moved, with l the row's merged fixed-point
      sum and p <= 1 (exactly 1 at the max; a strided max may leave a key
      above it, covered up to p = 2), plus 2**-mant of |out| from the
      log-subtract divide; twice each.
    """
    eps = 2.0 ** -cfg.mant_bits
    (_, m_g, l_g), (_, m_r, l_r) = got, ref
    out_g, out_r = _splitk_combine(*got, cfg), _splitk_combine(*ref, cfg)
    alpha = hyft_alpha(m_r - m_r.amax(1, keepdim=True), cfg)
    l_glob = (l_r * alpha).sum(1)[..., None]               # (BH, rows, 1)
    diff = (out_g - out_r).abs()
    return {"m_loc": float((m_g - m_r).abs().max()),
            "m_loc_mismatches": int((m_g != m_r).sum()),
            "l_loc": float(((l_g - l_r).abs()
                            / (2 * eps * l_r + bk * 2.0 ** -cfg.acc_bits)).max()),
            "out": float((diff / (2 * eps * (out_r.abs() + v_absmax / l_glob))).max()),
            "max_abs_err": float(diff.max())}


# --------------------------------------------------------------------------
# wrappers: the JAX entry points' folding, then level 1, then level 2
# --------------------------------------------------------------------------


def _block_k(Sk: int, block_k: int) -> int:
    return min(block_k, -(-Sk // 128) * 128)  # lane-aligned KV splits


def flash_hyft_decode(q, k, v, cfg: HyftConfig, sm_scale: float | None = None,
                      block_k: int = 256, kv_len_mask=None, k_scale=None,
                      v_scale=None):
    """Split-K fused decode attention with Hyft softmax (Sq = 1).

    Args:
      q: (B, Hq, 1, D);  k, v: (B, Hkv, Sk, D) float — or int8 FP2FX raws
        with ``k_scale``/``v_scale`` (B, Hkv, Sk) fp32 scales, dequantized
        in the K/V loads.
      kv_len_mask: optional (B, Sk) validity mask (nonzero = valid).
    Returns (B, Hq, 1, D) fp32.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Sq == 1 and Hq % Hkv == 0
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    maskf = (kv_len_mask.to(F32).contiguous() if kv_len_mask is not None
             else torch.ones((B, Sk), dtype=F32, device=q.device))
    q3 = q.reshape(B * Hkv, g, D).to(F32).contiguous()
    tiles = _tiles_for(q.device)
    acc, m_loc, l_loc = tiles(
        q3, k.reshape(B * Hkv, Sk, D), v.reshape(B * Hkv, Sk, D),
        None if k_scale is None else k_scale.reshape(B * Hkv, Sk),
        None if v_scale is None else v_scale.reshape(B * Hkv, Sk),
        maskf, cfg=cfg, sm_scale=scale, bk=_block_k(Sk, block_k), hkv=Hkv,
        sq=None)
    return _splitk_combine(acc, m_loc, l_loc, cfg).reshape(B, Hq, 1, D)


def flash_hyft_verify(q, k, v, kv_pos_mask, cfg: HyftConfig,
                      sm_scale: float | None = None, block_k: int = 256,
                      block_tables=None, k_scale=None, v_scale=None):
    """Split-K fused chunk attention with Hyft softmax (Sq = token chunk).

    The prompt-chunk path behind ``verify_attention``'s kernel mode.
    q: (B, Hq, Sq, D); k, v: contiguous (B, Hkv, Sk, D) stripes, float or
    int8 raws with scales; kv_pos_mask: (B, Sq, Sk) per-lane validity
    (the causal frontier ``kv_index <= pos + t``).  Returns (B, Hq, Sq, D)
    fp32.  At Sq == 1 this is bitwise ``flash_hyft_decode`` on the same
    splits: the tile and the combine are shared, only the mask gained a
    lane axis.
    """
    if block_tables is not None:
        raise NotImplementedError(
            "paged verify (_verify_paged_kernel) is not ported yet: "
            "ROADMAP queue 2, kernel 9")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    assert Hq % Hkv == 0
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q3 = q.reshape(B * Hkv, g * Sq, D).to(F32).contiguous()
    tiles = _tiles_for(q.device)
    acc, m_loc, l_loc = tiles(
        q3, k.reshape(B * Hkv, Sk, D), v.reshape(B * Hkv, Sk, D),
        None if k_scale is None else k_scale.reshape(B * Hkv, Sk),
        None if v_scale is None else v_scale.reshape(B * Hkv, Sk),
        kv_pos_mask.to(F32).contiguous(), cfg=cfg, sm_scale=scale,
        bk=_block_k(Sk, block_k), hkv=Hkv, sq=Sq)
    return _splitk_combine(acc, m_loc, l_loc, cfg).reshape(B, Hq, Sq, D)

