"""Fused Hyft attention: flash attention for training, split-K for serving.

The PyTorch counterpart of ``repro.kernels.flash_attention``:

* ``flash_hyft_attention`` (training, prefill) replaces the fused forward
  ``_flash_fwd_kernel`` (the TPU kernel at
  ``repro/kernels/flash_attention.py:96``) and, through its
  ``torch.autograd.Function``, the backward kernels
  ``_flash_bwd_dq_kernel`` (``:229``) and ``_flash_bwd_dkv_kernel``
  (``:260``);
* ``flash_hyft_decode`` replaces ``_decode_fwd_kernel`` (``:541``, launched
  from ``:619``);
* ``flash_hyft_verify`` replaces ``flash_hyft_verify``: its contiguous
  branch and ``_verify_fwd_kernel`` (``:804``, ``:963``), and its paged
  branch and ``_verify_paged_kernel`` (``:823``, ``:925``);
* ``flash_hyft_decode_paged`` replaces ``_paged_decode_kernel`` (``:660``,
  launched from ``:747``).

The flash half is described at its section below.  The split-K half's
entries are one machine.  The KV axis is cut into splits of
``bk = min(block_k, ceil128(Sk))`` keys; per split, level 1 of the paper's
tree (``_decode_tile``: FP2FX, integer max, exponent unit, fixed-point sum,
PV) emits local ``(acc, m_loc, l_loc)`` stats, and level 2
(``_splitk_combine``: integer max across splits, ``hyft_alpha`` rescale,
fixed-sum merge, ``hyft_finalize`` divide) merges them.  The split size is
part of the arithmetic: every split adds one Hyft rescale.

On the card both levels run in one launch of a hand-written CUDA kernel,
which merges the splits on chip and writes only the final output, bit for
bit what the per-split stats followed by the torch ``_splitk_combine``
give: ``csrc/hyft_splitk.cu`` over a contiguous cache
(``_splitk_attention_cuda``), ``csrc/hyft_paged.cu`` over a paged pool
(``_paged_attention_cuda``), both instantiating ``csrc/hyft_attend.cuh``.
On the CPU the plain versions are exactly those two levels:
``splitk_attention_plain`` (``splitk_tiles_plain``, then
``_splitk_combine``) and ``paged_attention_plain`` (``paged_tiles_plain``:
a gather, then ``splitk_tiles_plain`` at ``bk = page_size``; then
``_splitk_combine``).  The wrappers pick by ``q.device.type`` and nothing
else.  To hold a kernel to its plain version, call both by name on the same
folded inputs and measure with ``out_errors``.

The paged entries are the same machine with one page as one split: the
pool ``(n_pages + 1, Hkv, page_size, D)`` (page 0 the null page) is read
through a ``(B, nb)`` int32 block table, so that a sequential table over a
contiguous pool gives the contiguous entries' bits at ``bk = page_size``.

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
LAUNCHES = {"hyft_splitk_decode": 0, "hyft_splitk_verify": 0,
            "hyft_paged_decode": 0, "hyft_paged_verify": 0,
            "hyft_flash_fwd": 0, "hyft_flash_bwd_dq": 0, "hyft_flash_bwd_dkv": 0}

_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_IN_TYPES = {torch.float32: 0, torch.bfloat16: 1}   # the flash kernels' q/k/v
# head widths the CUDA kernels are instantiated for: every width of the
# configs (the smoke models' 16, bert's 64, zamba2's 112, 128, nemotron's 192)
_HEAD_DIMS = (16, 64, 112, 128, 192)
# split sizes the contiguous kernels, and page sizes the paged kernels, are
# built for
_SPLIT_SIZES = (64, 128, 256)
_PAGE_SIZES = (8, 16, 32, 64, 128, 256)


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
# a contiguous cache: level 1 over all splits, then level 2
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


def splitk_attention_plain(q3, k3, v3, k_scale, v_scale, mask, *, cfg: HyftConfig,
                           sm_scale: float, bk: int, hkv: int, sq: int | None):
    """Split-K Hyft attention, in plain PyTorch, on any device: the
    per-split stats of ``splitk_tiles_plain`` merged by ``_splitk_combine``.
    Same operands as ``splitk_tiles_plain``; returns (BH, rows, D) fp32."""
    return _splitk_combine(*splitk_tiles_plain(
        q3, k3, v3, k_scale, v_scale, mask, cfg=cfg, sm_scale=sm_scale, bk=bk,
        hkv=hkv, sq=sq), cfg)


def _splitk_attention_cuda(q3, k3, v3, k_scale, v_scale, mask, *, cfg: HyftConfig,
                           sm_scale: float, bk: int, hkv: int, sq: int | None):
    """Split-K Hyft attention from one launch of the CUDA kernel; same
    contract as ``splitk_attention_plain``.  The kernel reads the unpadded
    K/V, masks the ragged last split itself and merges the splits on chip:
    no per-split stats leave it."""
    name = "hyft_splitk_decode" if sq is None else "hyft_splitk_verify"
    BH, rows, D = q3.shape
    Sk = k3.shape[1]
    B = BH // hkv
    _check(B * hkv == BH, f"{BH} q3 rows not a multiple of {hkv} heads")
    _check(bk in _SPLIT_SIZES, f"bk={bk} not in {_SPLIT_SIZES}")
    _check_operands(q3, k3, v3, k_scale, v_scale, mask, (BH, Sk, D),
                    (B, Sk) if sq is None else (B, sq, Sk))
    _check(k3.data_ptr() % 16 == 0 and v3.data_ptr() % 16 == 0,
           "K/V must be 16-byte aligned")

    out = torch.empty((BH, rows, D), dtype=F32, device=q3.device)
    _launch(name, q3.device, _ptr(q3), _ptr(k3), _ptr(v3), _ptr(k_scale),
            _ptr(v_scale), _ptr(mask), _ptr(out), _KV_TYPES[k3.dtype], BH, hkv,
            rows, Sk, bk, D, sq if sq is not None else 1, ctypes.c_float(sm_scale),
            *_hyft_args(cfg))
    return out


def _check(ok: bool, msg: str):
    if not ok:
        raise ValueError(msg)


def _check_operands(q3, k, v, k_scale, v_scale, mask, kv_shape, mask_shape,
                    *extra):
    """The split-K kernels' common input contract: fp32 q3, K/V of one
    kernel type and shape ``kv_shape`` (int8 with fp32 scales of its
    leading shape), the fp32 mask, a built head width, everything
    contiguous on one CUDA device (``extra`` too)."""
    quantized = k.dtype == torch.int8
    _check(q3.dtype == F32 and q3.is_contiguous(), "q3 must be contiguous fp32")
    _check(k.dtype in _KV_TYPES and v.dtype == k.dtype,
           f"K/V dtype {k.dtype}/{v.dtype} not one of {list(_KV_TYPES)}")
    _check(k.shape == kv_shape and v.shape == kv_shape,
           f"K/V shape {tuple(k.shape)}/{tuple(v.shape)} != {kv_shape}")
    _check(k.is_contiguous() and v.is_contiguous(), "K/V must be contiguous")
    _check(quantized == (k_scale is not None) == (v_scale is not None),
           "int8 K/V need k_scale and v_scale, float K/V take none")
    if quantized:
        _check(k_scale.dtype == F32 and v_scale.dtype == F32
               and k_scale.shape == kv_shape[:-1] and v_scale.shape == kv_shape[:-1]
               and k_scale.is_contiguous() and v_scale.is_contiguous(),
               f"scales must be contiguous fp32 {kv_shape[:-1]}")
    _check(mask.dtype == F32 and tuple(mask.shape) == mask_shape
           and mask.is_contiguous(), f"mask must be contiguous fp32 {mask_shape}")
    _check(kv_shape[-1] in _HEAD_DIMS, f"head dim {kv_shape[-1]} not in {_HEAD_DIMS}")
    tensors = (q3, k, v, mask, *extra) + ((k_scale, v_scale) if quantized else ())
    _check(all(t.device == q3.device and t.device.type == "cuda" for t in tensors),
           "all inputs must be on the same CUDA device")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _hyft_args(cfg: HyftConfig) -> tuple:
    return (cfg.frac_bits, cfg.total_bits, cfg.mant_bits, cfg.acc_bits, cfg.step)


def _launch(name: str, device, *args, counts: dict | None = None):
    """Call the C entry ``name`` on the current stream of ``device``; raise
    if the launch fails, count it in ``counts`` (this module's
    ``LAUNCHES`` by default) if it does not."""
    from repro_torch.kernels import build

    lib = build.load()
    err = getattr(lib, name)(
        *args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError(f"{name} failed: cudaError {err} "
                           f"({lib.hyft_error_string(err).decode()})")
    (LAUNCHES if counts is None else counts)[name] += 1


def _splitk_attention_for(device: torch.device):
    """The contiguous wrappers' one choice: both levels in plain PyTorch for
    a CPU tensor, the one-launch kernel for a CUDA tensor."""
    if device.type == "cpu":
        return splitk_attention_plain
    if device.type == "cuda":
        return _splitk_attention_cuda
    raise ValueError(f"no split-K attention for device {device}")


def _paged_attention_for(device: torch.device):
    """The paged wrappers' one choice, likewise: both levels in plain
    PyTorch for a CPU tensor, the one-launch kernel for a CUDA tensor."""
    if device.type == "cpu":
        return paged_attention_plain
    if device.type == "cuda":
        return _paged_attention_cuda
    raise ValueError(f"no paged attention for device {device}")


# --------------------------------------------------------------------------
# a paged pool: one split per page, both levels
# --------------------------------------------------------------------------


def gather_pages(pool, block_tables, hkv: int):
    """(P, Hkv, ps[, D]) pool leaf -> each sequence's virtual stripe
    ``(B * Hkv, nb * ps[, D])``: block j of sequence b is page
    ``block_tables[b, j]``."""
    B, nb = block_tables.shape
    x = pool[block_tables.long()].transpose(1, 2)   # (B, Hkv, nb, ps[, D])
    return x.reshape(B * hkv, nb * pool.shape[2], *pool.shape[3:])


def paged_tiles_plain(q3, k_pages, v_pages, k_scale, v_scale, block_tables,
                      mask, *, cfg: HyftConfig, sm_scale: float, hkv: int,
                      sq: int | None):
    """Per-page Hyft stats, in plain PyTorch, on any device: every page is
    gathered through the block table, then ``splitk_tiles_plain`` runs
    ``_decode_tile`` with one page per split (``bk = page size``).

    q3 (BH, rows, D) fp32; k_pages/v_pages (P, Hkv, ps, D) float, or int8
    raws with ``k_scale``/``v_scale`` (P, Hkv, ps) fp32; block_tables
    (B, nb) int; ``mask`` (B, nb * ps) when ``sq`` is None (decode), else
    (B, sq, nb * ps).  Returns acc (BH, nb, rows, D) f32, m_loc
    (BH, nb, rows) i32 and l_loc (BH, nb, rows) f32.
    """
    ks, vs = ((None, None) if k_scale is None else
              (gather_pages(k_scale, block_tables, hkv),
               gather_pages(v_scale, block_tables, hkv)))
    return splitk_tiles_plain(
        q3, gather_pages(k_pages, block_tables, hkv),
        gather_pages(v_pages, block_tables, hkv), ks, vs, mask, cfg=cfg,
        sm_scale=sm_scale, bk=k_pages.shape[2], hkv=hkv, sq=sq)


def paged_attention_plain(q3, k_pages, v_pages, k_scale, v_scale, block_tables,
                          mask, *, cfg: HyftConfig, sm_scale: float, hkv: int,
                          sq: int | None):
    """Paged Hyft attention, in plain PyTorch, on any device: the per-page
    stats of ``paged_tiles_plain`` merged by ``_splitk_combine``.  Same
    operands as ``paged_tiles_plain``; returns (BH, rows, D) fp32."""
    return _splitk_combine(*paged_tiles_plain(
        q3, k_pages, v_pages, k_scale, v_scale, block_tables, mask, cfg=cfg,
        sm_scale=sm_scale, hkv=hkv, sq=sq), cfg)


def _paged_attention_cuda(q3, k_pages, v_pages, k_scale, v_scale, block_tables,
                          mask, *, cfg: HyftConfig, sm_scale: float, hkv: int,
                          sq: int | None):
    """Paged Hyft attention from one launch of the CUDA kernel; same
    contract as ``paged_attention_plain``.  The kernel reads each page
    through the block table on the device and merges the pages itself: no
    per-page stats leave it."""
    name = "hyft_paged_decode" if sq is None else "hyft_paged_verify"
    BH, rows, D = q3.shape
    P, ps = k_pages.shape[0], k_pages.shape[2]
    B, nb = block_tables.shape
    _check(B * hkv == BH, f"block table rows {B} x {hkv} heads != q3 rows {BH}")
    _check(block_tables.dtype == I32 and block_tables.is_contiguous(),
           "block_tables must be contiguous int32")
    _check(ps in _PAGE_SIZES, f"page size {ps} not in {_PAGE_SIZES}")
    _check_operands(q3, k_pages, v_pages, k_scale, v_scale, mask, (P, hkv, ps, D),
                    (B, nb * ps) if sq is None else (B, sq, nb * ps), block_tables)
    _check(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
           "K/V pools must be 16-byte aligned")

    out = torch.empty((BH, rows, D), dtype=F32, device=q3.device)
    _launch(name, q3.device, _ptr(q3), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scale), _ptr(v_scale), _ptr(block_tables), _ptr(mask),
            _ptr(out), _KV_TYPES[k_pages.dtype], BH, hkv, rows, nb, ps, D,
            sq if sq is not None else 1, ctypes.c_float(sm_scale),
            *_hyft_args(cfg))
    return out


def out_errors(out, ref, cfg: HyftConfig, v_absmax: float) -> dict:
    """A kernel's final output ``out`` (BH, rows, D) against the plain
    version's level-1 stats ``ref`` = ``(acc, m_loc, l_loc)`` for the same
    inputs, as the worst |diff| over its bound (``out``, which must be <= 1)
    and the worst |diff| (``max_abs_err``).  A kernel that sums its fp32 dot
    products in another order may differ from the plain version only so:

    * a score can round to the neighbouring FP2FX raw, so ``m_loc`` may
      move by one raw;
    * that moves one key's Hyft exponent by about 2**-mant of itself, or
      every key's through ``m_loc``;
    * after the combine, the output moves by 2**-mant * max|v| * p / l for
      the key that moved, with l the row's merged fixed-point sum and
      p <= 1 (exactly 1 at the max; a strided max may leave a key above
      it, covered up to p = 2), plus 2**-mant of |out| from the
      log-subtract divide; twice each.
    """
    eps = 2.0 ** -cfg.mant_bits
    _, m_r, l_r = ref
    out_r = _splitk_combine(*ref, cfg)
    alpha = hyft_alpha(m_r - m_r.amax(1, keepdim=True), cfg)
    l_glob = (l_r * alpha).sum(1)[..., None]               # (BH, rows, 1)
    diff = (out - out_r).abs()
    return {"out": float((diff / (2 * eps * (out_r.abs() + v_absmax / l_glob))).max()),
            "max_abs_err": float(diff.max())}


# --------------------------------------------------------------------------
# wrappers: the JAX entry points' folding, then both levels
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
    out = _splitk_attention_for(q.device)(
        q3, k.reshape(B * Hkv, Sk, D), v.reshape(B * Hkv, Sk, D),
        None if k_scale is None else k_scale.reshape(B * Hkv, Sk),
        None if v_scale is None else v_scale.reshape(B * Hkv, Sk),
        maskf, cfg=cfg, sm_scale=scale, bk=_block_k(Sk, block_k), hkv=Hkv,
        sq=None)
    return out.reshape(B, Hq, 1, D)


def flash_hyft_decode_paged(q, k_pages, v_pages, block_tables, cfg: HyftConfig,
                            sm_scale: float | None = None, kv_len_mask=None,
                            k_scale=None, v_scale=None):
    """Split-K fused decode attention over a paged KV pool (Sq = 1).

    Args:
      q: (B, Hq, 1, D);  k_pages, v_pages: (n_pages + 1, Hkv, page_size, D)
        float, or int8 FP2FX raws with ``k_scale``/``v_scale``
        (n_pages + 1, Hkv, page_size) fp32 scales.
      block_tables: (B, nb) int: virtual block j of sequence b lives in
        physical page ``block_tables[b, j]``.
      kv_len_mask: optional (B, nb * page_size) validity mask over the
        virtual KV axis (nonzero = valid).
    Returns (B, Hq, 1, D) fp32.  With ``block_tables[b, j] == j`` over a
    contiguous pool this is bitwise ``flash_hyft_decode`` at ``block_k ==
    page_size``.
    """
    B, Hq, Sq, D = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    assert Sq == 1 and Hq % Hkv == 0
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    maskf = (kv_len_mask.to(F32).contiguous() if kv_len_mask is not None
             else torch.ones((B, nb * ps), dtype=F32, device=q.device))
    q3 = q.reshape(B * Hkv, g, D).to(F32).contiguous()
    out = _paged_attention_for(q.device)(
        q3, k_pages, v_pages, k_scale, v_scale,
        block_tables.to(I32).contiguous(), maskf, cfg=cfg, sm_scale=scale,
        hkv=Hkv, sq=None)
    return out.reshape(B, Hq, 1, D)


def flash_hyft_verify(q, k, v, kv_pos_mask, cfg: HyftConfig,
                      sm_scale: float | None = None, block_k: int = 256,
                      block_tables=None, k_scale=None, v_scale=None):
    """Split-K fused chunk attention with Hyft softmax (Sq = token chunk).

    The prompt-chunk path behind ``verify_attention``'s kernel mode.
    q: (B, Hq, Sq, D); k, v: contiguous (B, Hkv, Sk, D) stripes or, with
    ``block_tables`` (B, nb), a paged pool (n_pages + 1, Hkv, page_size,
    D); either float or int8 raws with scales; kv_pos_mask: (B, Sq, Lk)
    per-lane validity over the (virtual) KV axis (the causal frontier
    ``kv_index <= pos + t``).  Returns (B, Hq, Sq, D) fp32.  At Sq == 1
    this is bitwise ``flash_hyft_decode`` (same splits) or
    ``flash_hyft_decode_paged`` (pages as splits): the arithmetic is
    shared, only the mask gained a lane axis.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    assert Hq % Hkv == 0
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q3 = q.reshape(B * Hkv, g * Sq, D).to(F32).contiguous()
    if block_tables is not None:          # paged pool: pages as splits
        out = _paged_attention_for(q.device)(
            q3, k, v, k_scale, v_scale, block_tables.to(I32).contiguous(),
            kv_pos_mask.to(F32).contiguous(), cfg=cfg, sm_scale=scale,
            hkv=Hkv, sq=Sq)
        return out.reshape(B, Hq, Sq, D)
    Sk = k.shape[2]
    out = _splitk_attention_for(q.device)(
        q3, k.reshape(B * Hkv, Sk, D), v.reshape(B * Hkv, Sk, D),
        None if k_scale is None else k_scale.reshape(B * Hkv, Sk),
        None if v_scale is None else v_scale.reshape(B * Hkv, Sk),
        kv_pos_mask.to(F32).contiguous(), cfg=cfg, sm_scale=scale,
        bk=_block_k(Sk, block_k), hkv=Hkv, sq=Sq)
    return out.reshape(B, Hq, Sq, D)



# --------------------------------------------------------------------------
# fused flash attention for training: plain versions, CUDA kernels, autograd
# --------------------------------------------------------------------------
#
# The forward walks the KV axis in blocks of ``bk = min(block_k, Sk)`` keys,
# in order, carrying per row the integer running max ``m``, the fixed-point
# sum ``l`` and the PV accumulator: each block adds one ``hyft_alpha``
# rescale and one ``fx_quantize`` of the carried sum, so the block size is
# part of the arithmetic.  The backward recomputes the Hyft probabilities
# from the final ``(m, l)`` (``_recompute_probs``): elementwise, so its
# blocking is free.  Operands arrive pre-padded and folded to 3D: q
# ``(BH, Sq, D)``, k/v ``(BHkv, Sk, D)`` with head ``bh`` reading KV head
# ``bh // group``, and an optional ``(B, Sk)`` fp32 mask shared by the heads
# of a batch entry.  The GQA group folds into the rows of a KV head:
# ``(BHkv, group * Sq)``, row ``g * Sq + i`` at query position ``i``.


def _fold_rows(t, bhkv: int):
    """(BH, Sq, ...) -> (BHkv, group * Sq, ...): the rows of one KV head."""
    return t.reshape(bhkv, -1, *t.shape[2:])


def _query_pos(sq: int, group: int, q_offset: int, device):
    """Query position of each folded row (``q_offset`` + its index)."""
    return q_offset + torch.arange(sq, device=device).repeat(group)


def _kv_mask_rows(maskf, bhkv: int):
    """(B, Sk) mask -> (BHkv, Sk), one row per KV head; None passes."""
    if maskf is None:
        return None
    return maskf.to(F32)[torch.arange(bhkv, device=maskf.device)
                         // (bhkv // maskf.shape[0])]


def _masked_scores(q, k, mask_row, *, sm_scale, causal, qpos, kpos):
    """Scaled scores with the causal and validity masks applied before FP2FX
    (``_flash_fwd_kernel`` :115-122)."""
    z = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        z = torch.where(qpos[:, None] >= kpos[None, :], z, NEG_BIG)
    if mask_row is not None:
        z = torch.where(mask_row > 0, z, NEG_BIG)
    return z


def _flash_fwd_plain(q3, k3, v3, maskf, *, cfg: HyftConfig, sm_scale: float,
                     causal: bool, bk: int, group: int, q_offset: int):
    """The forward in plain PyTorch: replays ``_flash_fwd_kernel`` over the
    KV blocks in order, every row at once (``repro/kernels/ref.py:52-101``).

    Returns (o (BH, Sq, D) f32, m (BH, Sq) i32 raw, l (BH, Sq) f32).
    """
    BH, Sq, D = q3.shape
    BHkv, Sk = k3.shape[0], k3.shape[1]
    dev = q3.device
    q = _fold_rows(q3.to(F32), BHkv)
    qpos = _query_pos(Sq, group, q_offset, dev)
    mrow = _kv_mask_rows(maskf, BHkv)
    m_run = torch.full((BHkv, group * Sq, 1), -(2 ** (cfg.total_bits - 1)),
                       dtype=I32, device=dev)
    l_run = torch.zeros((BHkv, group * Sq, 1), dtype=F32, device=dev)
    acc = torch.zeros((BHkv, group * Sq, D), dtype=F32, device=dev)
    for k0 in range(0, Sk, bk):
        kt, vt = k3[:, k0:k0 + bk].to(F32), v3[:, k0:k0 + bk].to(F32)
        z = _masked_scores(
            q, kt, None if mrow is None else mrow[:, None, k0:k0 + bk],
            sm_scale=sm_scale, causal=causal, qpos=qpos,
            kpos=torch.arange(k0, k0 + bk, device=dev))
        z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
        zsub = z_raw[..., :: cfg.step] if cfg.step > 1 else z_raw
        m_new = torch.maximum(m_run, torch.amax(zsub, dim=-1, keepdim=True))
        e, m = nm.exp_unit(z_raw - m_new, cfg.frac_bits, cfg.mant_bits)
        addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
        l_blk = torch.sum(addend, dim=-1, keepdim=True)
        alpha = hyft_alpha(m_run - m_new, cfg)
        l_run = nm.fx_quantize(l_run * alpha, cfg.acc_bits) + l_blk
        p = ((1 << cfg.mant_bits) + m).to(F32) * nm.pow2_float(e - cfg.mant_bits)
        acc = acc * alpha + torch.matmul(p, vt)
        m_run = m_new
    o = hyft_finalize(acc, l_run, cfg)
    return o.reshape(BH, Sq, D), m_run.reshape(BH, Sq), l_run.reshape(BH, Sq)


def _recompute_probs(q, k, mask_row, m_row, l_row, *, cfg: HyftConfig,
                     sm_scale: float, causal: bool, qpos, kpos):
    """Hyft probabilities of a (rows, keys) tile from the saved final row
    stats: ``log_div(exp_unit(z_raw - m), lod_refloat(l))``.  Elementwise,
    so independent of how the forward blocked the KV axis."""
    z = _masked_scores(q, k, mask_row, sm_scale=sm_scale, causal=causal,
                       qpos=qpos, kpos=kpos)
    z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
    e, m = nm.exp_unit(z_raw - m_row, cfg.frac_bits, cfg.mant_bits)
    e_b, m_b = nm.lod_refloat(l_row, cfg.mant_bits)
    return nm.log_div(e, m, e_b, m_b, cfg.mant_bits)


def _flash_delta(do3, o3):
    """delta = <do, o> per row, from the forward's fp32 output (``:305``);
    a torch op outside the kernels, as in JAX."""
    return torch.sum(do3.to(F32) * o3.to(F32), dim=-1)


def _bwd_operands(q3, k3, do3, delta, m2, l2, maskf, group, q_offset):
    """The backward's folded rows: q, do, m, l, delta per KV head, the
    query positions, and the mask rows."""
    BHkv, Sq = k3.shape[0], q3.shape[1]
    fold = lambda t: _fold_rows(t, BHkv)  # noqa: E731
    return (fold(q3.to(F32)), fold(do3.to(F32)), fold(m2)[..., None],
            fold(l2)[..., None], fold(delta)[..., None],
            _query_pos(Sq, group, q_offset, q3.device), _kv_mask_rows(maskf, BHkv))


def _flash_bwd_dq_plain(q3, k3, v3, maskf, do3, delta, m2, l2, *, cfg: HyftConfig,
                        sm_scale: float, causal: bool, bk: int, group: int,
                        q_offset: int):
    """dq in plain PyTorch (``_flash_bwd_dq_kernel`` :229-257): per KV block
    of ``bk`` keys the recomputed p, ``ds = p (dp - delta)``, ``dq += ds k *
    scale``.  Returns dq (BH, Sq, D) fp32."""
    BH, Sq, D = q3.shape
    q, do, m_row, l_row, dl, qpos, mrow = _bwd_operands(
        q3, k3, do3, delta, m2, l2, maskf, group, q_offset)
    dq = torch.zeros(q.shape, dtype=F32, device=q3.device)
    for k0 in range(0, k3.shape[1], bk):
        kt, vt = k3[:, k0:k0 + bk].to(F32), v3[:, k0:k0 + bk].to(F32)
        p = _recompute_probs(
            q, kt, None if mrow is None else mrow[:, None, k0:k0 + bk],
            m_row, l_row, cfg=cfg, sm_scale=sm_scale, causal=causal, qpos=qpos,
            kpos=torch.arange(k0, k0 + bk, device=q3.device))
        ds = p * (torch.matmul(do, vt.transpose(-1, -2)) - dl)
        dq = dq + torch.matmul(ds, kt) * sm_scale
    return dq.reshape(BH, Sq, D)


def _flash_bwd_dkv_plain(q3, k3, v3, maskf, do3, delta, m2, l2, *, cfg: HyftConfig,
                         sm_scale: float, causal: bool, bk: int, group: int,
                         q_offset: int):
    """dk and dv in plain PyTorch (``_flash_bwd_dkv_kernel`` :260-294): per
    KV block the recomputed p over every row of the GQA group, ``dv = p^T
    do``, ``dk = ds^T q * scale``.  Returns (dk, dv) (BHkv, Sk, D) fp32."""
    q, do, m_row, l_row, dl, qpos, mrow = _bwd_operands(
        q3, k3, do3, delta, m2, l2, maskf, group, q_offset)
    dk = torch.empty(k3.shape, dtype=F32, device=q3.device)
    dv = torch.empty(k3.shape, dtype=F32, device=q3.device)
    for k0 in range(0, k3.shape[1], bk):
        kt, vt = k3[:, k0:k0 + bk].to(F32), v3[:, k0:k0 + bk].to(F32)
        p = _recompute_probs(
            q, kt, None if mrow is None else mrow[:, None, k0:k0 + bk],
            m_row, l_row, cfg=cfg, sm_scale=sm_scale, causal=causal, qpos=qpos,
            kpos=torch.arange(k0, k0 + bk, device=q3.device))
        ds = p * (torch.matmul(do, vt.transpose(-1, -2)) - dl)
        dk[:, k0:k0 + bk] = torch.matmul(ds.transpose(-1, -2), q) * sm_scale
        dv[:, k0:k0 + bk] = torch.matmul(p.transpose(-1, -2), do)
    return dk, dv


def _flash_checks(q3, k3, v3, maskf, group: int):
    """What the CUDA flash kernels take; raises ValueError on anything else.
    Returns the heads per batch entry of the mask (``group`` without one)."""
    BH, Sq, D = q3.shape
    BHkv, Sk = k3.shape[0], k3.shape[1]
    _check(q3.dtype in _IN_TYPES and k3.dtype == q3.dtype and v3.dtype == q3.dtype,
           f"q/k/v dtypes {q3.dtype}/{k3.dtype}/{v3.dtype}: one of {list(_IN_TYPES)}")
    _check(BH == BHkv * group and k3.shape == (BHkv, Sk, D)
           and v3.shape == (BHkv, Sk, D), "q/k/v shapes do not fold")
    _check(all(t.is_contiguous() for t in (q3, k3, v3)), "q/k/v must be contiguous")
    _check(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    tensors = (q3, k3, v3)
    hq_per_b = group
    if maskf is not None:
        _check(maskf.dtype == F32 and maskf.ndim == 2 and maskf.shape[1] == Sk
               and BH % maskf.shape[0] == 0
               and (BH // maskf.shape[0]) % group == 0 and maskf.is_contiguous(),
               f"mask must be contiguous fp32 (B, {Sk}) with B dividing BH")
        hq_per_b = BH // maskf.shape[0]
        tensors += (maskf,)
    _check(all(t.device == q3.device and t.device.type == "cuda" for t in tensors),
           "all inputs must be on the same CUDA device")
    return hq_per_b


def _flash_fwd_cuda(q3, k3, v3, maskf, *, cfg: HyftConfig, sm_scale: float,
                    causal: bool, bk: int, group: int, q_offset: int,
                    skip_masked: bool = True):
    """The forward from the CUDA kernel ``hyft_flash_fwd``; same contract as
    ``_flash_fwd_plain``.  ``skip_masked=False`` computes the scores of the
    KV blocks past the causal frontier too; by default the kernel runs only
    their PV chain (every score there is masked), which gives the same bits
    (only the card checks turn it off)."""
    hq_per_b = _flash_checks(q3, k3, v3, maskf, group)
    BH, Sq, D = q3.shape
    Sk = k3.shape[1]
    _check(0 < bk <= 128 and Sk % bk == 0, f"Sk={Sk} not blocks of bk={bk} <= 128")
    _check(k3.data_ptr() % 16 == 0 and v3.data_ptr() % 16 == 0,
           "K/V must be 16-byte aligned")
    o = torch.empty((BH, Sq, D), dtype=F32, device=q3.device)
    m = torch.empty((BH, Sq), dtype=I32, device=q3.device)
    l = torch.empty((BH, Sq), dtype=F32, device=q3.device)
    _launch("hyft_flash_fwd", q3.device, _ptr(q3), _ptr(k3), _ptr(v3), _ptr(maskf),
            _ptr(o), _ptr(m), _ptr(l), _IN_TYPES[q3.dtype], BH, Sq, Sk, bk, D,
            group, hq_per_b, q_offset, int(causal), int(skip_masked),
            ctypes.c_float(sm_scale), *_hyft_args(cfg))
    return o, m, l


def _bwd_cuda_args(q3, k3, v3, maskf, do3, delta, m2, l2, *, cfg, sm_scale,
                   causal, group, q_offset, skip_masked):
    """The pointers and ints that both backward kernels take: the pointers,
    the ints up to ``skip``, and the scale with the Hyft parameters."""
    hq_per_b = _flash_checks(q3, k3, v3, maskf, group)
    BH, Sq, D = q3.shape
    _check(do3.dtype == F32 and do3.shape == q3.shape and do3.is_contiguous()
           and delta.dtype == F32 and delta.shape == (BH, Sq) and delta.is_contiguous()
           and m2.dtype == I32 and l2.dtype == F32 and m2.shape == (BH, Sq)
           and l2.shape == (BH, Sq) and m2.is_contiguous() and l2.is_contiguous(),
           "do must be contiguous fp32 like q; delta, m, l (BH, Sq) fp32 / int32")
    _check(all(t.data_ptr() % 16 == 0 for t in (q3, k3, v3, do3)),
           "q, k, v and do must be 16-byte aligned")
    inputs = tuple(map(_ptr, (q3, k3, v3, do3, delta, m2, l2, maskf)))
    ints = (_IN_TYPES[q3.dtype], BH, Sq, k3.shape[1], D, group, hq_per_b, q_offset,
            int(causal), int(skip_masked))
    return inputs, ints, (ctypes.c_float(sm_scale), *_hyft_args(cfg))


def _flash_bwd_dq_cuda(q3, k3, v3, maskf, do3, delta, m2, l2, *, cfg: HyftConfig,
                       sm_scale: float, causal: bool, bk: int, group: int,
                       q_offset: int, skip_masked: bool = True):
    """dq from the CUDA kernel ``hyft_flash_bwd_dq``; same contract as
    ``_flash_bwd_dq_plain`` (``bk`` is not part of the backward's
    arithmetic).  ``skip_masked=False`` walks the key sub-tiles past a row
    tile's causal frontier too; by default the kernel drops them while each
    row's masked term is below 2**-acc of its largest, which may move the
    last bits of dq, and otherwise runs them without their scores, which
    gives the same bits (only the card checks turn it off)."""
    inputs, ints, tail = _bwd_cuda_args(q3, k3, v3, maskf, do3, delta, m2, l2, cfg=cfg,
                                        sm_scale=sm_scale, causal=causal, group=group,
                                        q_offset=q_offset, skip_masked=skip_masked)
    dq = torch.empty(q3.shape, dtype=F32, device=q3.device)
    _launch("hyft_flash_bwd_dq", q3.device, *inputs, _ptr(dq), *ints, *tail)
    return dq


def _flash_bwd_dkv_cuda(q3, k3, v3, maskf, do3, delta, m2, l2, *, cfg: HyftConfig,
                        sm_scale: float, causal: bool, bk: int, group: int,
                        q_offset: int, skip_masked: bool = True):
    """dk and dv from the CUDA kernel ``hyft_flash_bwd_dkv``; same contract
    as ``_flash_bwd_dkv_plain``.  ``skip_masked=False`` walks the query rows
    wholly before a key tile too; by default the kernel skips them while
    each one's masked term is below 2**-acc of its largest, which may move
    the last bits of dk/dv (only the card checks turn it off)."""
    inputs, ints, tail = _bwd_cuda_args(q3, k3, v3, maskf, do3, delta, m2, l2, cfg=cfg,
                                        sm_scale=sm_scale, causal=causal, group=group,
                                        q_offset=q_offset, skip_masked=skip_masked)
    dk = torch.empty(k3.shape, dtype=F32, device=q3.device)
    dv = torch.empty(k3.shape, dtype=F32, device=q3.device)
    _launch("hyft_flash_bwd_dkv", q3.device, *inputs, _ptr(dk), _ptr(dv), *ints, *tail)
    return dk, dv


def _flash_impls(device: torch.device):
    """The wrapper's one choice: the plain versions for a CPU tensor, the
    kernels for a CUDA tensor.  Returns (forward, dq, dk/dv)."""
    if device.type == "cpu":
        return _flash_fwd_plain, _flash_bwd_dq_plain, _flash_bwd_dkv_plain
    if device.type == "cuda":
        return _flash_fwd_cuda, _flash_bwd_dq_cuda, _flash_bwd_dkv_cuda
    raise ValueError(f"no flash attention for device {device}")


def flash_errors(got, ref, cfg: HyftConfig, v_absmax: float, bk: int,
                 nk: int) -> dict:
    """The forward's ``(o, m, l)`` ``got`` against ``ref`` for the same
    inputs (the kernel's and the plain version's), as the worst |diff| over
    its bound: ``m`` must be exact or off by one raw, ``l`` and ``o`` <= 1.
    Only the fp32 dot products sum in another order, so:

    * a score can round to the neighbouring FP2FX raw: a block max, and so
      the running ``m``, may move by one raw;
    * that moves one key's Hyft exponent by about 2**-mant of itself, or
      every later key's (and the rescale's) through ``m``; the addends and
      the carried sum round to 2**-acc_bits once per key and per block:
      ``|dl| <= 2 * 2**-mant * l + nk * (bk + 1) * 2**-acc_bits``;
    * the output moves by 2**-mant * max|v| * p / l for the key that moved,
      p <= 1 (exactly 1 at the max; a strided max may leave a key above it,
      covered up to p = 2), plus 2**-mant of |o| from the log-subtract
      divide; twice each: ``2 * 2**-mant * (|o| + max|v| / l)``.
    """
    eps = 2.0 ** -cfg.mant_bits
    (o_g, m_g, l_g), (o_r, m_r, l_r) = got, ref
    diff = (o_g - o_r).abs()
    l_bound = 2 * eps * l_r + nk * (bk + 1) * 2.0 ** -cfg.acc_bits
    o_bound = 2 * eps * (o_r.abs() + v_absmax / l_r[..., None])
    return {"m": float((m_g - m_r).abs().max()),
            "m_mismatches": int((m_g != m_r).sum()),
            "l": float(((l_g - l_r).abs() / l_bound).max()),
            "o": float((diff / o_bound).max()),
            "max_abs_err": float(diff.max())}


def grad_errors(got, ref, cfg: HyftConfig) -> dict:
    """The backward's ``(dq, dk, dv)`` ``got`` against ``ref`` for the same
    inputs (the same q, k, v, mask, do and forward stats), each as
    ``max|diff| / (2 * 2**-mant * max|ref|)``, which must be <= 1.

    With the stats shared, only a recomputed score can differ: it may round
    to the neighbouring FP2FX raw (fp32 dot products in another order),
    which moves its p, and so its term ``p (dp - delta)`` of the sums, by at
    most about 2**-mant of itself (one exponent-unit step of 2**-frac <=
    2**-mant, and the mantissa's truncation); twice that for the log-divide
    and the remaining fp32 summation order.  A term is at most as large as
    the largest gradient element it feeds.
    """
    eps = 2.0 ** -cfg.mant_bits
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        out[name] = float((g - r).abs().max() / (2 * eps * r.abs().max()))
        out[f"{name}_max_abs_err"] = float((g - r).abs().max())
    return out


DQ_ROWS = 64   # the query rows of a dq kernel block (its causal-skip tile)


def masked_counts(m, cfg: HyftConfig):
    """Per row of max ``m`` (FX raws): the adder-tree count, in units of
    2**-acc, of one causally masked key's term.  The dq kernel's guard
    drops a row tile's masked key sub-tiles only where every row's is 0."""
    lo = -(2 ** (cfg.total_bits - 1))
    e, mm = nm.exp_unit(torch.full_like(m, lo) - m, cfg.frac_bits, cfg.mant_bits)
    return nm.expfloat_to_fx(e, mm, cfg.mant_bits, cfg.acc_bits) * 2.0 ** cfg.acc_bits


def dq_kept_rows(m, cfg: HyftConfig):
    """(BH, Sq) bool for the maxes ``m`` (BH, Sq): the rows of the dq
    kernel's DQ_ROWS-row tiles that keep their causally masked key
    sub-tiles (some row of the tile has a nonzero ``masked_counts``: a row
    that sees no valid key, or a max near FX's lowest raw), where the
    kernel's skip must be bit for bit."""
    BH, Sq = m.shape
    counts = F.pad(masked_counts(m, cfg) > 0, (0, (-Sq) % DQ_ROWS))
    tiles = counts.reshape(BH, -1, DQ_ROWS).any(-1)
    return tiles.repeat_interleave(DQ_ROWS, dim=1)[:, :Sq]


def _h3(x):
    B, H, S, D = x.shape
    return x.reshape(B * H, S, D).contiguous()


def flash_operands(q, k, v, kv_len_mask, block_q: int = 128, block_k: int = 128):
    """The blocks and the padding of ``flash_hyft_attention``: ``bq =
    min(block_q, Sq)``, ``bk = min(block_k, Sk)``; q and K/V are zero-padded
    to multiples of them, and padded keys are masked (a mask of ones is made
    when there is none).  Returns (q, k, v, maskf or None, bk)."""
    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    pad_q, pad_k = (-Sq) % bq, (-Sk) % bk
    maskf = None
    if kv_len_mask is not None:
        maskf = kv_len_mask.to(F32)
    elif pad_k:
        maskf = torch.ones((B, Sk), dtype=F32, device=q.device)
    if pad_q:
        q = _pad0(q, (0, 0, pad_q, 0))
    if pad_k:
        k = _pad0(k, (0, 0, pad_k, 0))
        v = _pad0(v, (0, 0, pad_k, 0))
        maskf = _pad0(maskf, (0, pad_k))
    return q, k, v, None if maskf is None else maskf.contiguous(), bk


class _FlashHyftAttention(torch.autograd.Function):
    """The fused forward, and a backward through the two backward kernels
    (``_flash_attn`` and its ``custom_vjp``, :374-412), on pre-padded 4D
    operands.  The forward saves ``(q, k, v, maskf, o, m, l)``; the backward
    takes do in fp32 and returns dq, dk, dv in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, maskf, cfg, sm_scale, causal, bk, q_offset):
        fwd, _, _ = _flash_impls(q.device)
        ctx.opts = dict(cfg=cfg, sm_scale=sm_scale, causal=causal, bk=bk,
                        group=q.shape[1] // k.shape[1], q_offset=q_offset)
        o3, m2, l2 = fwd(_h3(q), _h3(k), _h3(v), maskf, **ctx.opts)
        ctx.save_for_backward(q, k, v, maskf, o3, m2, l2)
        return o3.reshape(q.shape)

    @staticmethod
    def backward(ctx, do):
        q, k, v, maskf, o3, m2, l2 = ctx.saved_tensors
        _, bwd_dq, bwd_dkv = _flash_impls(q.device)
        q3, k3, v3, do3 = _h3(q), _h3(k), _h3(v), _h3(do.to(F32))
        args = (q3, k3, v3, maskf, do3, _flash_delta(do3, o3).contiguous(), m2, l2)
        dq = bwd_dq(*args, **ctx.opts)
        dk, dv = bwd_dkv(*args, **ctx.opts)
        return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
                dv.reshape(v.shape).to(v.dtype), None, None, None, None, None, None)


def flash_hyft_attention(q, k, v, cfg: HyftConfig, sm_scale: float | None = None,
                         causal: bool = True, block_q: int = 128,
                         block_k: int = 128, return_stats: bool = False,
                         kv_len_mask=None, q_offset: int = 0):
    """Fused attention with Hyft softmax — trainable and mask-aware.

    Args:
      q: (B, Hq, Sq, D);  k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA),
        fp32 or bf16 (read as fp32).
      kv_len_mask: optional (B, Sk) validity mask (nonzero = valid), applied
        before FP2FX like the unfused path.
      q_offset: int added to query positions for the causal mask.
    Returns (B, Hq, Sq, D) fp32 (callers cast).  Differentiable: the
    backward runs the two backward kernels, recomputing the probabilities
    from the saved (m, l) row stats.  With ``return_stats`` also returns the
    (m, l) row stats (forward only).  Lengths that are not multiples of the
    blocks are zero-padded, the padded keys masked.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    assert Hq % Hkv == 0
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q, k, v, maskf, bk = flash_operands(q, k, v, kv_len_mask, block_q, block_k)
    q_offset = int(q_offset)

    if return_stats:  # forward only
        fwd, _, _ = _flash_impls(q.device)
        with torch.no_grad():
            o, m2, l2 = fwd(_h3(q), _h3(k), _h3(v), maskf, cfg=cfg, sm_scale=scale,
                            causal=causal, bk=bk, group=Hq // Hkv, q_offset=q_offset)
        return (o.reshape(q.shape)[:, :, :Sq], m2.reshape(B, Hq, -1)[:, :, :Sq],
                l2.reshape(B, Hq, -1)[:, :, :Sq])

    out = _FlashHyftAttention.apply(q, k, v, maskf, cfg, scale, causal, bk, q_offset)
    return out[:, :, :Sq]
