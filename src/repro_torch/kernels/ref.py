"""Plain-torch oracles for the kernels — the PyTorch counterpart of
``repro.kernels.ref``.

``hyft_softmax_ref`` / ``hyft_softmax_bwd_ref`` are the core emulation (the
standalone softmax kernels compute the identical arithmetic; see
``kernels/hyft_softmax.py`` for when the two agree bit for bit).
``flash_hyft_attention_ref`` replays the *blocked online* algorithm of the
fused kernel with the same block sizes, and ``attention_ref`` is the
unfused mathematical reference (tolerance-based comparison, quantifying the
online-rescale drift).
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics as nm
from repro_torch.core.hyft import HyftConfig, hyft_softmax_bwd, hyft_softmax_fwd

F32 = torch.float32
I32 = torch.int32
NEG_BIG = -3.0e38


def hyft_softmax_ref(z: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    return hyft_softmax_fwd(z, cfg)


def hyft_softmax_bwd_ref(s: torch.Tensor, dy: torch.Tensor, cfg: HyftConfig) -> torch.Tensor:
    return hyft_softmax_bwd(s, dy, cfg)


def attention_ref(q, k, v, cfg: HyftConfig | None, sm_scale=None, causal=True,
                  softmax_fn=None):
    """Unfused attention: QK^T -> (hyft|exact) softmax -> PV, with GQA."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    scale = sm_scale if sm_scale is not None else D ** -0.5
    kr = torch.repeat_interleave(k, Hq // Hkv, dim=1)
    vr = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    z = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kr.to(F32)) * scale
    if causal:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool, device=q.device),
                          diagonal=Sk - Sq)
        z = torch.where(mask, z, NEG_BIG)
    if softmax_fn is not None:
        p = softmax_fn(z)
    elif cfg is None:
        p = torch.softmax(z, dim=-1)
    else:
        p = hyft_softmax_fwd(z, cfg).to(F32)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.to(F32))


def flash_hyft_attention_ref(q, k, v, cfg: HyftConfig, sm_scale=None,
                             causal=True, block_q=128, block_k=128):
    """Blocked oracle: replays the fused kernel's online algorithm."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = Sq // bq, Sk // bk
    q3 = q.reshape(B * Hq, Sq, D).to(F32)
    k3 = k.reshape(B * Hkv, Sk, D).to(F32)
    v3 = v.reshape(B * Hkv, Sk, D).to(F32)
    out = torch.zeros((B * Hq, Sq, D), dtype=F32, device=q.device)
    ar_q = torch.arange(bq, device=q.device)[:, None]
    ar_k = torch.arange(bk, device=q.device)[None, :]

    for b in range(B * Hq):
        for i in range(nq):
            qt = q3[b, i * bq:(i + 1) * bq]
            m_run = torch.full((bq, 1), -(2 ** (cfg.total_bits - 1)), dtype=I32,
                               device=q.device)
            l_run = torch.zeros((bq, 1), dtype=F32, device=q.device)
            acc = torch.zeros((bq, D), dtype=F32, device=q.device)
            for j in range(nk):
                kt = k3[b // group, j * bk:(j + 1) * bk]
                vt = v3[b // group, j * bk:(j + 1) * bk]
                z = (qt @ kt.T) * scale
                if causal:
                    z = torch.where(i * bq + ar_q >= j * bk + ar_k, z, NEG_BIG)
                z_raw = nm.fp2fx(z, cfg.frac_bits, cfg.total_bits)
                zsub = z_raw[:, :: cfg.step] if cfg.step > 1 else z_raw
                m_new = torch.maximum(m_run, torch.amax(zsub, dim=-1, keepdim=True))
                e, m = nm.exp_unit(z_raw - m_new, cfg.frac_bits, cfg.mant_bits)
                addend = nm.expfloat_to_fx(e, m, cfg.mant_bits, cfg.acc_bits)
                l_blk = torch.sum(addend, dim=-1, keepdim=True)
                e_a, m_a = nm.exp_unit(m_run - m_new, cfg.frac_bits, cfg.mant_bits)
                alpha = ((1 << cfg.mant_bits) + m_a).to(F32) * \
                    nm.pow2_float(e_a - cfg.mant_bits)
                l_run = nm.fx_quantize(l_run * alpha, cfg.acc_bits) + l_blk
                p = ((1 << cfg.mant_bits) + m).to(F32) * \
                    nm.pow2_float(e - cfg.mant_bits)
                acc = acc * alpha + p @ vt
                m_run = m_new
            e_b, m_b = nm.lod_refloat(l_run, cfg.mant_bits)
            sg, e_n, m_n = nm.float_fields(acc, cfg.mant_bits)
            res = nm.log_div(e_n, m_n, e_b, m_b, cfg.mant_bits)
            res = torch.where(sg == 1, -res, res)
            res = torch.where(acc == 0.0, torch.zeros_like(res), res)
            out[b, i * bq:(i + 1) * bq] = res
    return out.reshape(B, Hq, Sq, D)
