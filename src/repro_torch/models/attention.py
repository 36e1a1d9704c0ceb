"""Attention: GQA projections, the three modes, the KV cache, and the decode
/ chunk attention entries of the serving path.

The PyTorch counterpart of ``repro.models.attention`` for the dense family
(the sequence-parallel decode comes later).  Modes (``cfg.attn_mode``):

  unfused  — QK^T -> registry softmax (hyft/exact) -> PV; the reference,
             differentiable through the Hyft softmax's own backward.
  chunked  — a loop over KV chunks with the online Hyft (max, sum, acc)
             carry: the plain twin of the fused kernel, differentiable by a
             recompute-from-stats backward (``chunked_hyft_attention``).
  kernel   — the CUDA kernels (plain PyTorch versions on the CPU): the fused
             flash forward and backward for whole sequences, split-K for
             decode and prompt chunks.

The cache is ``{"k", "v"[, "k_scale", "v_scale"]}`` per layer, the JAX
layout: (B, Hkv, L, D) dense, or a page pool (n_pages + 1, Hkv, page_size,
D) read through per-sequence block tables (the paged layout).  Unlike the
functional JAX cache, the port updates it in place: the returned dict
holds the same tensors, so a full cache is never copied to append one
token.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import numerics as nm
from repro_torch.core.registry import get_softmax, hyft_config_for
from repro_torch.configs.base import torch_dtype
from repro_torch.core.hyft import HyftConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import gather_pages, hyft_alpha, hyft_finalize
from repro_torch.models.layers import apply_rope

F32 = torch.float32
I32 = torch.int32
NEG_BIG = -3.0e38


def qkv_proj(p, x, kv_x, cfg, positions, kv_positions):
    """x: (B,S,dm) -> q (B,Hq,S,D); kv_x -> k,v (B,Hkv,Sk,D), rope'd."""
    def proj(w, inp):  # (B,S,dm) @ (dm,H,D) -> (B,S,H,D)
        dm, h, d = w.shape
        return torch.matmul(inp, w.to(x.dtype).reshape(dm, h * d)).reshape(
            *inp.shape[:-1], h, d)
    q, k, v = proj(p["wq"], x), proj(p["wk"], kv_x), proj(p["wv"], kv_x)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def out_proj(p, o):
    """o: (B,H,S,D) -> (B,S,dm)."""
    B, H, S, D = o.shape
    wo = p["wo"].to(o.dtype)
    return torch.matmul(o.transpose(1, 2).reshape(B, S, H * D),
                        wo.reshape(H * D, wo.shape[-1]))


# --------------------------------------------------------------------------
# unfused reference mode
# --------------------------------------------------------------------------


def unfused_attention(q, k, v, softmax_impl: str, *, causal: bool,
                      q_offset=0, kv_len_mask=None):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D); softmax over full score rows."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).to(F32)
    z = torch.matmul(qg, k.to(F32)[:, :, None].transpose(-1, -2)) * (D ** -0.5)
    if causal:
        qi = q_offset + torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        z = torch.where(qi >= ki, z, NEG_BIG)
    if kv_len_mask is not None:  # (B, Sk) — decode cache validity
        z = torch.where(kv_len_mask[:, None, None, None, :].bool(), z, NEG_BIG)
    p = get_softmax(softmax_impl)(z).to(F32)
    o = torch.matmul(p, v.to(F32)[:, :, None])
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


# --------------------------------------------------------------------------
# chunked online-Hyft mode (a loop over KV chunks) + its backward
# --------------------------------------------------------------------------


def _hyft_chunk_stats(z, cfg: HyftConfig, m_run):
    """One KV chunk: Hyft stages 1-2 against the running max.  Returns
    (m_new raw, alpha fp32, addend-sum fp32 on the acc grid, p fp32)."""
    z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
    zsub = z_raw[..., :: cfg.step] if cfg.step > 1 else z_raw
    m_new = torch.maximum(m_run, torch.amax(zsub, dim=-1, keepdim=True))
    e, m = nm.exp_unit(z_raw - m_new, cfg.frac_bits, cfg.mant_bits)
    addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
    l_blk = torch.sum(addend, dim=-1, keepdim=True)
    alpha = hyft_alpha(m_run - m_new, cfg)
    p = ((1 << cfg.mant_bits) + m).to(F32) * nm.pow2_float(e - cfg.mant_bits)
    return m_new, alpha, l_blk, p


def _mask_chunk(kv_len_mask, j: int, chunk: int):
    """Chunk ``j`` of a (B, Sk) or per-query-row (B, Sq, Sk) float mask,
    broadcast against scores (B, Hkv, g, Sq, chunk); None passes."""
    if kv_len_mask is None:
        return None
    mt = kv_len_mask[..., j * chunk:(j + 1) * chunk]
    if mt.ndim == 3:
        return mt[:, None, None, :, :]
    return mt[:, None, None, None, :]


def _chunk_scores(qg, kt, j, chunk, causal, q_offset, kv_len_mask):
    """Scores of chunk ``j`` with the causal and validity masks applied
    before FP2FX.  qg (B, Hkv, g, Sq, D) already scaled; kt (B, Hkv, chunk,
    D)."""
    Sq = qg.shape[3]
    z = torch.matmul(qg, kt[:, :, None].transpose(-1, -2))
    if causal:
        qi = q_offset + torch.arange(Sq, device=qg.device)[:, None]
        ki = torch.arange(chunk, device=qg.device)[None, :] + j * chunk
        z = torch.where(qi >= ki, z, NEG_BIG)
    mt = _mask_chunk(kv_len_mask, j, chunk)
    if mt is not None:
        z = torch.where(mt > 0, z, NEG_BIG)
    return z


def _chunked_fwd(q, k, v, cfg: HyftConfig, causal: bool, chunk: int,
                 q_offset, kv_len_mask=None):
    """Returns (o, m_final raw, l_final).  q (B, Hq, Sq, D), k/v GQA."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).to(F32) * (D ** -0.5)
    m_run = torch.full((B, Hkv, g, Sq, 1), -(2 ** (cfg.total_bits - 1)),
                       dtype=I32, device=q.device)
    l_run = torch.zeros((B, Hkv, g, Sq, 1), dtype=F32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=F32, device=q.device)
    for j in range(Sk // chunk):
        kt = k[:, :, j * chunk:(j + 1) * chunk].to(F32)
        vt = v[:, :, j * chunk:(j + 1) * chunk].to(F32)
        z = _chunk_scores(qg, kt, j, chunk, causal, q_offset, kv_len_mask)
        m_run, alpha, l_blk, p = _hyft_chunk_stats(z, cfg, m_run)
        l_run = nm.fx_quantize(l_run * alpha, cfg.acc_bits) + l_blk
        acc = acc * alpha + torch.matmul(p, vt[:, :, None])
    o = hyft_finalize(acc, l_run, cfg).reshape(B, Hq, Sq, D)
    return o, m_run, l_run


def _cha_bwd(cfg: HyftConfig, causal: bool, chunk: int, q_offset, res, do):
    """Flash-style backward: recompute the Hyft probabilities per chunk from
    the saved row stats (single pass, no online rescale), then the softmax
    attention gradients on the *Hyft* probabilities."""
    q, k, v, kv_len_mask, o, m_f, l_f = res
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, g, Sq, D).to(F32)
    dog = do.reshape(B, Hkv, g, Sq, D).to(F32)
    og = o.reshape(B, Hkv, g, Sq, D).to(F32)
    delta = torch.sum(dog * og, dim=-1, keepdim=True)       # (B, Hkv, g, Sq, 1)
    e_b, m_b = nm.lod_refloat(l_f, cfg.mant_bits)
    dq = torch.zeros((B, Hkv, g, Sq, D), dtype=F32, device=q.device)
    dk = torch.empty((B, Hkv, Sk, D), dtype=F32, device=q.device)
    dv = torch.empty((B, Hkv, Sk, D), dtype=F32, device=q.device)
    for j in range(Sk // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        kt, vt = k[:, :, sl].to(F32), v[:, :, sl].to(F32)
        z = _chunk_scores(qg * scale, kt, j, chunk, causal, q_offset, kv_len_mask)
        z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
        e, m = nm.exp_unit(z_raw - m_f, cfg.frac_bits, cfg.mant_bits)
        p = nm.log_div(e, m, e_b, m_b, cfg.mant_bits)        # (B, Hkv, g, Sq, chunk)
        dv[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
        dp = torch.matmul(dog, vt[:, :, None].transpose(-1, -2))
        ds = p * (dp - delta)
        dq = dq + torch.matmul(ds, kt[:, :, None]) * scale
        dk[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _ChunkedHyftAttention(torch.autograd.Function):
    """``chunked_hyft_attention``'s ``custom_vjp``: the forward saves
    ``(q, k, v, mask, o, m, l)`` with the fp32 output, the backward is
    ``_cha_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, causal, chunk, q_offset, kv_len_mask):
        o, m_f, l_f = _chunked_fwd(q, k, v, cfg, causal, chunk, q_offset,
                                   kv_len_mask)
        ctx.save_for_backward(q, k, v, kv_len_mask, o, m_f, l_f)
        ctx.opts = (cfg, causal, chunk, q_offset)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _cha_bwd(*ctx.opts, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None, None


def chunked_hyft_attention(q, k, v, cfg: HyftConfig, causal: bool = True,
                           chunk: int = 512, q_offset: int = 0,
                           kv_len_mask=None):
    """Online-Hyft attention, O(chunk) memory in the KV dimension.

    ``kv_len_mask``: optional (B, Sk) or per-query-row (B, Sq, Sk) float
    validity mask (nonzero = valid), per the mask contract in ``ops``.
    Differentiable; Sk must be a multiple of ``chunk``.
    """
    return _ChunkedHyftAttention.apply(q, k, v, cfg, causal, chunk, q_offset,
                                       kv_len_mask)


# --------------------------------------------------------------------------
# mode selection
# --------------------------------------------------------------------------


def attention_fwd(q, k, v, cfg, *, causal=True, q_offset=0, kv_len_mask=None):
    """Dispatch on ``cfg.attn_mode``, as in the JAX package.

    All three modes honor the mask contract (``kernels/ops.py``).  The
    unfused mode takes over for non-Hyft softmaxes, a ``q_offset`` that is
    not an int, and (chunked mode only) a KV length the chunk size does not
    divide.
    """
    hcfg = hyft_config_for(cfg.softmax_impl)
    mode = getattr(cfg, "attn_mode", "unfused")
    if hcfg is not None and isinstance(q_offset, int):
        maskf = ops.as_mask_f(kv_len_mask)
        if mode == "chunked":
            chunk = min(getattr(cfg, "attn_chunk", 512), k.shape[2])
            if k.shape[2] % chunk == 0:
                return chunked_hyft_attention(q, k, v, hcfg, causal, chunk,
                                              q_offset, maskf)
        if mode == "kernel":
            return ops.hyft_attention(q, k, v, hcfg, causal=causal,
                                      q_offset=q_offset,
                                      kv_len_mask=maskf).to(q.dtype)
    return unfused_attention(q, k, v, cfg.softmax_impl, causal=causal,
                             q_offset=q_offset, kv_len_mask=kv_len_mask)


# --------------------------------------------------------------------------
# KV cache (dense or FP2FX-quantized int8)
# --------------------------------------------------------------------------

FP2FX8 = "fp2fx8"
_FP2FX8_FRAC = 7  # int8 raw at 7 fractional bits; the scale folds in 2**-7


def is_fp2fx8(dtype) -> bool:
    return str(dtype) == FP2FX8


def cache_storage_dtype(dtype) -> torch.dtype:
    """The torch dtype of the non-attention cache buffers (the Mamba2 state's
    conv tail) when the attention cache may be the symbolic "fp2fx8"
    format: fp32 for fp2fx8, else ``dtype`` itself."""
    return F32 if is_fp2fx8(dtype) else torch_dtype(str(dtype))


def fp2fx8_quantize(x):
    """(..., D) float -> (int8 raw, fp32 scale over the last axis).

    A per-(head, position) amax scale maps the row into [-127/128, 127/128];
    FP2FX (round to nearest even, saturating) emits the int8 raw.
    Dequantization is ``raw * scale`` with the 2**-7 folded in.
    """
    x32 = x.to(F32)
    amax = torch.amax(torch.abs(x32), dim=-1)
    s = torch.clamp(amax, min=1e-30) * torch.tensor(128.0 / 127.0, dtype=F32)
    raw = nm.fp2fx(x32 / s[..., None], _FP2FX8_FRAC, 8)
    return raw.to(torch.int8), s * (2.0 ** -_FP2FX8_FRAC)


def fp2fx8_dequantize(raw, scale):
    return raw.to(F32) * scale[..., None]


def cache_is_quantized(cache) -> bool:
    return "k_scale" in cache


def cache_kv(cache):
    """(k, v) as float tensors — dequantizes the fp2fx8 layout (the unfused
    mode; the kernels read the raws directly)."""
    if cache_is_quantized(cache):
        return (fp2fx8_dequantize(cache["k"], cache["k_scale"]),
                fp2fx8_dequantize(cache["v"], cache["v_scale"]))
    return cache["k"], cache["v"]


def cache_init(cfg, batch, max_len, dtype, device=None) -> dict[str, Any]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    if is_fp2fx8(dtype):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=F32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=F32, device=device)}
    dt = torch_dtype(str(dtype))
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantized_entries(cache, k_new, v_new):
    """{name: new values} for every cache buffer, quantizing for fp2fx8."""
    if cache_is_quantized(cache):
        kr, ks = fp2fx8_quantize(k_new)
        vr, vs = fp2fx8_quantize(v_new)
        return {"k": kr, "v": vr, "k_scale": ks, "v_scale": vs}
    return {"k": k_new, "v": v_new}


def cache_update(cache, k_new, v_new, pos: int):
    """k_new/v_new: (B,Hkv,S_new,D) written at the scalar offset ``pos``
    (clamped so the write fits, as ``dynamic_update_slice`` clamps)."""
    S, L = k_new.shape[2], cache["k"].shape[2]
    pos = min(max(int(pos), 0), L - S)
    for name, new in _quantized_entries(cache, k_new, v_new).items():
        cache[name][:, :, pos:pos + S] = new.to(cache[name].dtype)
    return cache


def cache_update_ragged(cache, k_new, v_new, pos_b, write_mask=None):
    """Per-row write: row ``b``'s (Hkv, 1, D) K/V lands at ``pos_b[b]``.

    ``write_mask`` (B,) bool gates the write per row: a False row keeps its
    old content at ``pos_b[b]``.
    """
    B, L = k_new.shape[0], cache["k"].shape[2]
    rows = torch.arange(B, device=k_new.device)
    pos = torch.clamp(pos_b.to(torch.long), 0, L - 1)
    for name, new in _quantized_entries(cache, k_new, v_new).items():
        buf = cache[name]
        new = new[:, :, 0].to(buf.dtype)                  # (B, Hkv[, D])
        if write_mask is not None:
            gate = write_mask.reshape((B,) + (1,) * (new.ndim - 1))
            new = torch.where(gate, new, buf[rows, :, pos])
        buf[rows, :, pos] = new
    return cache


def cache_update_block_ragged(cache, k_new, v_new, pos_b, n_valid,
                              write_mask=None):
    """Multi-token ragged write: token ``j`` of row ``b`` lands at
    ``pos_b[b] + j`` when ``j < n_valid[b]``, the row's ``write_mask`` is
    set and the position is inside the cache; other lanes write nothing.

    One masked write per buffer, with no read back to the host.  The JAX
    package writes token by token; the result is the same because fp2fx8
    quantization is per (head, position).  Every lane writes: lane ``j``
    goes to ``(pos_b[b] + j) % L``, and a gated lane writes back the old
    value there.  A row's S <= L lanes land on distinct positions, so no
    two lanes of one write meet.
    """
    L = cache["k"].shape[2]
    k_new, v_new = k_new[:, :, :L], v_new[:, :, :L]   # lanes past L never write
    B, _, S, _ = k_new.shape
    j = torch.arange(S, device=k_new.device)
    pos = pos_b.to(torch.long)[:, None] + j[None, :]       # (B, S)
    gate = (j[None, :] < n_valid.to(torch.long)[:, None]) & (pos < L)
    if write_mask is not None:
        gate = gate & write_mask[:, None]
    rows, tgt = torch.arange(B, device=k_new.device)[:, None], pos % L
    for name, new in _quantized_entries(cache, k_new, v_new).items():
        buf = cache[name]
        new = new.transpose(1, 2).to(buf.dtype)            # (B, S, Hkv[, D])
        g = gate.reshape(gate.shape + (1,) * (new.ndim - 2))
        buf[rows, :, tgt] = torch.where(g, new, buf[rows, :, tgt])
    return cache


# --------------------------------------------------------------------------
# paged KV cache (block-table indirection over a global page pool)
# --------------------------------------------------------------------------
#
# ``kv_layout="paged"`` replaces the per-slot dense stripe with one global
# pool of fixed-size pages per layer, (n_pages + 1, Hkv, page_size, D) dense
# or fp2fx8, plus a per-sequence block table mapping virtual KV block j to a
# physical page.  Page 0 is the null page (``serve.kvpool.NULL_PAGE``):
# masked writes are redirected at it instead of gated, so a write never
# reads the pool first, and two rows never write one live page (slots own
# distinct tail pages; shared prefix pages are never written).


def paged_cache_init(cfg, n_pages, page_size, dtype, device=None) -> dict[str, Any]:
    """One layer's page pool: ``n_pages`` usable pages + the null page 0."""
    shape = (n_pages + 1, cfg.n_kv_heads, page_size, cfg.d_head)
    if is_fp2fx8(dtype):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=F32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=F32, device=device)}
    dt = torch_dtype(str(dtype))
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _paged_write(cache, k_new, v_new, page, off):
    """Write token lanes through (page, offset) index tensors of one shape
    (B[, S]): k_new/v_new (B, Hkv, S, D) lane ``s`` of row ``b`` lands at
    ``pool[page[b, s], :, off[b, s]]``."""
    for name, new in _quantized_entries(cache, k_new, v_new).items():
        buf = cache[name]
        new = new.transpose(1, 2)                          # (B, S, Hkv[, D])
        if page.ndim == 1:
            new = new[:, 0]
        buf[page, :, off] = new.to(buf.dtype)
    return cache


def cache_update_paged(cache, k_new, v_new, pos_b, block_tables,
                       write_mask=None):
    """Per-row paged write: row ``b``'s (Hkv, 1, D) K/V lands in physical
    page ``block_tables[b, pos_b[b] // ps]`` at offset ``pos_b[b] % ps``.
    ``write_mask`` (B,) bool redirects masked rows to the null page."""
    ps, nb = cache["k"].shape[2], block_tables.shape[1]
    pos = pos_b.to(torch.long)
    blk = torch.clamp(pos // ps, max=nb - 1)   # a gather clamps, as in JAX
    page = torch.gather(block_tables.to(torch.long), 1, blk[:, None])[:, 0]
    if write_mask is not None:
        page = torch.where(write_mask, page, 0)
    return _paged_write(cache, k_new, v_new, page, pos % ps)


def cache_update_block_paged(cache, k_new, v_new, pos_b, block_tables,
                             n_valid, write_mask=None):
    """Paged twin of ``cache_update_block_ragged``: token ``j`` of row ``b``
    lands through the block table at virtual position ``pos_b[b] + j``.
    Lanes past ``n_valid[b]``, rows with ``write_mask`` False and lanes past
    the table's virtual extent are redirected to the null page.

    One write per buffer for the whole chunk, where the JAX package writes
    token by token: the pools come out the same, the fp2fx8 scales
    included (quantization is per (head, position)), except on the null
    page, which no unmasked read ever sees.
    """
    ps, nb = cache["k"].shape[2], block_tables.shape[1]
    Lv = nb * ps
    S = k_new.shape[2]
    j = torch.arange(S, device=k_new.device)
    pos = pos_b.to(torch.long)[:, None] + j[None, :]            # (B, S)
    gate = (j[None, :] < n_valid.to(torch.long)[:, None]) & (pos < Lv)
    if write_mask is not None:
        gate = gate & write_mask[:, None]
    pj = torch.clamp(pos, 0, Lv - 1)
    page = torch.gather(block_tables.to(torch.long), 1, pj // ps)
    page = torch.where(gate, page, 0)
    return _paged_write(cache, k_new, v_new, page, pj % ps)


def paged_gather_kv(cache, block_tables):
    """The virtual dense (B, Hkv, nb * ps, D) float K/V of each sequence,
    gathered through its block table: the unfused and chunked modes' view
    of the pool (the kernels read the pages in place)."""
    B, hkv = block_tables.shape[0], cache["k"].shape[1]

    def flat(pool):  # -> (B, Hkv, nb * ps[, D])
        x = gather_pages(pool, block_tables, hkv)
        return x.reshape(B, hkv, *x.shape[1:])

    if cache_is_quantized(cache):
        return (fp2fx8_dequantize(flat(cache["k"]), flat(cache["k_scale"])),
                fp2fx8_dequantize(flat(cache["v"]), flat(cache["v_scale"])))
    return flat(cache["k"]), flat(cache["v"])


# --------------------------------------------------------------------------
# decode and chunk attention against the cache
# --------------------------------------------------------------------------


def decode_attention_paged(q, cache, block_tables, cfg, *, kv_len_mask=None):
    """Sq=1 attention over a paged pool.  With a Hyft softmax and
    ``attn_mode="kernel"`` this is the paged split-K kernel (pages read
    through the block table, fp2fx8 dequantized in the page loads); every
    other combination gathers the virtual dense K/V and falls through to
    the mode dispatch."""
    hcfg = hyft_config_for(cfg.softmax_impl)
    mode = getattr(cfg, "attn_mode", "unfused")
    if hcfg is not None and mode == "kernel" and q.shape[2] == 1:
        return ops.hyft_paged_decode_attention(
            q, cache["k"], cache["v"], block_tables, hcfg,
            kv_len_mask=ops.as_mask_f(kv_len_mask),
            k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale")).to(q.dtype)
    k, v = paged_gather_kv(cache, block_tables)
    return attention_fwd(q, k, v, cfg, causal=False, kv_len_mask=kv_len_mask)


def decode_attention(q, cache, cfg, *, kv_len_mask=None):
    """Sq=1 attention over the KV cache — the serving fast path.

    With a Hyft softmax and ``attn_mode="kernel"`` this is the split-K
    decode kernel, reading fp2fx8 raws directly.  Every other combination
    dequantizes and falls through to the mode dispatch.
    """
    hcfg = hyft_config_for(cfg.softmax_impl)
    mode = getattr(cfg, "attn_mode", "unfused")
    if hcfg is not None and mode == "kernel" and q.shape[2] == 1:
        return ops.hyft_decode_attention(
            q, cache["k"], cache["v"], hcfg,
            kv_len_mask=ops.as_mask_f(kv_len_mask),
            k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale")).to(q.dtype)
    k, v = cache_kv(cache)
    return attention_fwd(q, k, v, cfg, causal=False, kv_len_mask=kv_len_mask)


def _verify_unfused(q, k, v, softmax_impl: str, kv_pos_mask):
    """Unfused reference with a per-token (B, Sq, Sk) mask."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, D).to(F32)
    z = torch.matmul(qg, k.to(F32)[:, :, None].transpose(-1, -2)) * (D ** -0.5)
    z = torch.where(kv_pos_mask[:, None, None, :, :] > 0, z, NEG_BIG)
    p = get_softmax(softmax_impl)(z).to(F32)
    o = torch.matmul(p, v.to(F32)[:, :, None])
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def verify_attention(q, cache, cfg, *, kv_pos_mask, block_tables=None):
    """Attend a token chunk at per-row offsets against the cache: ``q``
    holds Sq already-written tokens per row and ``kv_pos_mask`` (B, Sq, Lk)
    each token's causal frontier.  With a Hyft softmax and
    ``attn_mode="kernel"`` this is the split-K chunk kernel (dense stripes,
    or with ``block_tables`` the paged pool); chunked mode runs the
    online-Hyft loop under the same per-row mask; otherwise the unfused
    reference."""
    hcfg = hyft_config_for(cfg.softmax_impl)
    mode = getattr(cfg, "attn_mode", "unfused")
    if hcfg is not None and mode == "kernel":
        return ops.hyft_verify_attention(
            q, cache["k"], cache["v"], kv_pos_mask, hcfg,
            block_tables=block_tables,
            k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale")).to(q.dtype)
    if block_tables is not None:
        k, v = paged_gather_kv(cache, block_tables)
    else:
        k, v = cache_kv(cache)
    if hcfg is not None and mode == "chunked":
        chunk = min(getattr(cfg, "attn_chunk", 512), k.shape[2])
        if k.shape[2] % chunk == 0:
            return chunked_hyft_attention(
                q, k, v, hcfg, False, chunk, 0,
                ops.as_mask_f(kv_pos_mask)).to(q.dtype)
    return _verify_unfused(q, k, v, cfg.softmax_impl, kv_pos_mask)
