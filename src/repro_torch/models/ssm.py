"""Mamba2 (SSD, state-space duality) block, the chunked matmul formulation.

The PyTorch counterpart of ``repro.models.ssm``.  The chunked SSD
algorithm: an intra-chunk quadratic term (attention-like, over the chunk's
``ssm_chunk`` positions) plus an inter-chunk state recurrence, which JAX
scans with ``lax.scan`` and the port walks with a loop over chunks.  The
block is softmax-free: the Hyft technique does not apply to it (DESIGN.md
§5), and it launches no Hyft kernel.  Its products are ``torch.matmul``
and ``einsum``, as the JAX package computes them outside any Pallas
kernel.

Decode is O(1) per token: one state update carried in the cache,
``{"ssm": (B, H, P, N) fp32, "conv": (B, K - 1, conv_dim)}``.

The reference's dtypes and orders are kept, since parity depends on them:
the training conv sums its K taps in the input's dtype (bf16 when serving),
in tap order, then adds the bias in that dtype; the decode conv runs in
fp32 over the concatenated window; ``A_log``, ``D``, ``dt_bias`` and the
state are fp32 whatever the parameters' dtype.  A sequence whose length
``ssm_chunk`` does not divide fails in the reshape into chunks, as in JAX:
it is not padded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def ssm_init(generator: torch.Generator, cfg, dtype, device=None, n_layers=None):
    """The JAX package's keys, shapes and scales: ``in_proj`` (dm, 2 *
    d_inner + 2 N + H) and ``out_proj`` (d_inner, dm) fan-in normal, the conv
    (K, conv_dim) at ``K ** -0.5`` with a zero bias, ``A_log = log(linspace(1,
    16, H))``, ``D`` ones and ``dt_bias`` zeros in fp32, the gated norm's
    scale ones.  ``n_layers`` stacks a leading layer axis, drawn one layer
    at a time (a stack's fp32 draws would be twice its size)."""
    dm, N, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    d_inner, H, conv_dim = ssm_dims(cfg)
    lead = () if n_layers is None else (n_layers,)

    def rnd(shape, scale):
        if n_layers is None:
            return torch.randn(shape, generator=generator, dtype=F32,
                               device=device).mul_(scale).to(dtype)
        out = torch.empty(lead + shape, dtype=dtype, device=device)
        for layer in out:
            layer.copy_(torch.randn(shape, generator=generator, dtype=F32,
                                    device=device).mul_(scale))
        return out

    def const(v, dt):
        return v.to(dtype=dt, device=device).expand(lead + v.shape).clone()
    return {
        "in_proj": rnd((dm, 2 * d_inner + 2 * N + H), dm ** -0.5),
        "conv_w": rnd((K, conv_dim), K ** -0.5),
        "conv_b": const(torch.zeros(conv_dim), dtype),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H)), F32),
        "D": const(torch.ones(H), F32),
        "dt_bias": const(torch.zeros(H), F32),
        "norm_scale": const(torch.ones(d_inner), dtype),
        "out_proj": rnd((d_inner, dm), d_inner ** -0.5),
    }


def _split_proj(proj, cfg):
    """(z, x, B, C, dt) along the last axis."""
    d_inner, H, _ = ssm_dims(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: torch's ``logaddexp`` is the
    same formula (the larger plus ``log1p(exp(-|a - b|))``), without the
    threshold of ``F.softplus``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _gated_norm(p, y, z, eps=1e-6):
    """y (fp32) gated by silu(z), RMS-normalised, scaled; in fp32 (a bf16
    scale widens exactly in the product)."""
    y32 = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return y32 * torch.rsqrt(var + eps) * p["norm_scale"]


def ssm_train(p, x, cfg, return_state=False):
    """x: (B, S, dm) -> (B, S, dm): causal depthwise conv + chunked SSD.

    ``return_state=True`` also returns the decode cache after the prompt,
    the final SSD state (B, H, P, N) and the last K - 1 pre-conv columns:
    this is what makes the parallel prefill possible."""
    Bsz, S, _ = x.shape
    d_inner, H, conv_dim = ssm_dims(cfg)
    N, P, Q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xs, Bm, Cm, dt = _split_proj(proj, cfg)
    # causal depthwise conv over (x, B, C), in the input's dtype, tap order
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    K = cfg.ssm_conv
    conv_tail = xbc[:, S - (K - 1):, :] if K > 1 else xbc[:, :0, :]
    xbc_pad = torch.nn.functional.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].to(x.dtype)
    conv = xbc_pad[:, 0:S] * w[0]
    for i in range(1, K):
        conv = conv + xbc_pad[:, i:i + S] * w[i]
    conv = F.silu((conv + p["conv_b"].to(x.dtype)).to(F32))
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)

    A = -torch.exp(p["A_log"])                                   # (H,) < 0
    dt = _softplus(dt.to(F32) + p["dt_bias"])                    # (B, S, H)
    nC = S // Q
    xh = xs.reshape(Bsz, nC, Q, H, P)
    dtc = dt.reshape(Bsz, nC, Q, H)
    Bc = Bm.reshape(Bsz, nC, Q, N)
    Cc = Cm.reshape(Bsz, nC, Q, N)
    dA = dtc * A                                                 # (B, c, Q, H) <= 0
    cum = torch.cumsum(dA, dim=2)
    xdt = xh * dtc[..., None]

    # intra-chunk: M[i, j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j
    G = torch.matmul(Cc, Bc.transpose(-1, -2))                   # (B, c, Q, Q)
    ldecay = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B, c, Q, K, H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked in log space before the exp: the exp of a masked large value
    # is inf, and inf * 0 poisons the gradient through the select
    ldecay = torch.where(mask[None, None, :, :, None], ldecay, -math.inf)
    M = G[..., None] * torch.exp(ldecay)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xdt)

    # chunk boundary states, then the inter-chunk recurrence
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B, c, Q, H)
    chunk_state = torch.einsum("bckn,bckh,bckhp->bchpn", Bc, decay_end, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B, c, H)
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + chunk_state[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                         # (B, c, H, P, N)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum), h_prev)

    y = y_intra + y_inter + xh.to(F32) * p["D"][None, None, None, :, None]
    y = y.reshape(Bsz, S, d_inner)
    out = _gated_norm(p, y, z)
    out = torch.matmul(out.to(x.dtype), p["out_proj"].to(x.dtype))
    if return_state:
        return out, {"ssm": h, "conv": conv_tail}
    return out


def ssm_cache_init(cfg, batch, dtype, device=None):
    """The decode cache: the fp32 state and the conv tail in ``dtype``."""
    _, H, conv_dim = ssm_dims(cfg)
    return {"ssm": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                                device=device)}


def ssm_decode(p, x1, cache, cfg):
    """One token: x1 (B, 1, dm) -> (B, 1, dm) and the new cache leaves (new
    tensors; the caller writes them into the cache).  The conv window is
    the stored tail and this token's column, in their promoted dtype."""
    Bsz = x1.shape[0]
    d_inner, H, conv_dim = ssm_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    proj = torch.matmul(x1[:, 0], p["in_proj"].to(x1.dtype))    # (B, proj)
    # (x, B, C) lie side by side in the projection: the conv's column
    z, xbc, dt = torch.split(proj, [d_inner, conv_dim, H], dim=-1)
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)      # (B, K, conv)
    # the decode has few rows and one op costs a launch: the products below
    # are written out, and a bf16 weight or bias widens exactly inside an
    # fp32 product (no separate cast)
    conv = F.silu((window.to(F32) * p["conv_w"]).sum(1) + p["conv_b"])
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    A = -torch.exp(p["A_log"])
    dtv = _softplus(dt.to(F32) + p["dt_bias"])                    # (B, H)
    xh = xs.reshape(Bsz, H, P)
    dA = torch.exp(dtv * A)                                       # (B, H)
    h = torch.addcmul(cache["ssm"] * dA[:, :, None, None],
                      (dtv[:, :, None] * xh)[..., None], Bm[:, None, None, :])
    y = torch.bmm(h.reshape(Bsz, H * P, N), Cm[:, :, None]).reshape(Bsz, H, P)
    y = torch.addcmul(y, xh, p["D"][None, :, None]).reshape(Bsz, 1, d_inner)
    out = _gated_norm(p, y, z[:, None])
    out = torch.matmul(out.to(x1.dtype), p["out_proj"].to(x1.dtype))
    return out, {"ssm": h, "conv": window[:, 1:]}
