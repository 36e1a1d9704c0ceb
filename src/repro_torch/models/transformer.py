"""Decoder-only LM stack, dense family: init, the training forward and loss,
cache, decode step, chunk prefill.

The PyTorch counterpart of the dense branch of ``repro.models.transformer``.
Parameters keep the JAX tree — per-layer leaves stacked on a leading layer
axis under ``"blocks"`` — and a Python loop over layers takes the place of
``lax.scan``.  Remat: ``"full"`` wraps each block in
``torch.utils.checkpoint`` (only the residual stream is kept; the block's
forward runs again in the backward).  The cache is ``{"blocks": {"k",
"v"[, "k_scale", "v_scale"]}}``, stacked the same way, and updated in
place.  The MoE, SSM, hybrid and VLM families come with later slices
(ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import NORMS, embed_lookup, make_norm, unembed

F32 = torch.float32
I32 = torch.int32


def _check_dense(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 item 9")


def _layers(tree, n: int) -> list:
    """Every layer of a layer-stacked tree, by one ``unbind`` per leaf.
    The layers are views, so cache writes land in the stacked tensors, and
    the backward stacks the per-layer gradients once, where indexing layer
    by layer would write a full-size zero gradient per layer."""
    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        return torch.unbind(t)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]
    parts = split(tree)
    return [pick(parts, i) for i in range(n)]


def _normal(generator, shape, scale, dtype, device):
    x = torch.randn(shape, generator=generator, dtype=F32, device=device)
    return (x * scale).to(dtype)


def init(generator: torch.Generator, cfg, device=None) -> dict[str, Any]:
    """Fresh weights with the JAX package's keys, shapes and scales
    (fan-in normal, unit-scale embedding, ones for norms, zeros for
    biases).  The values are torch's: the weights bridge
    (``repro_torch.convert``) carries the JAX package's values instead."""
    _check_dense(cfg)
    L, dm, dff = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pd = cfg.pdtype
    rnd = lambda shape, scale: _normal(generator, shape, scale, pd, device)  # noqa: E731

    def norm():
        p, _ = make_norm(cfg.norm, dm, pd, device)
        return {k: v.expand(L, *v.shape).clone() for k, v in p.items()}

    a = {"wq": rnd((L, dm, hq, dh), dm ** -0.5),
         "wk": rnd((L, dm, hkv, dh), dm ** -0.5),
         "wv": rnd((L, dm, hkv, dh), dm ** -0.5),
         "wo": rnd((L, hq, dh, dm), (hq * dh) ** -0.5)}
    if cfg.qkv_bias:
        a["bq"] = torch.zeros((L, hq, dh), dtype=pd, device=device)
        a["bk"] = torch.zeros((L, hkv, dh), dtype=pd, device=device)
        a["bv"] = torch.zeros((L, hkv, dh), dtype=pd, device=device)
    m = {"w_up": rnd((L, dm, dff), dm ** -0.5),
         "w_down": rnd((L, dff, dm), dff ** -0.5)}
    if cfg.mlp_gated:
        m["w_gate"] = rnd((L, dm, dff), dm ** -0.5)
    p: dict[str, Any] = {"embed": {"table": rnd((cfg.vocab, dm), 1.0)}}
    p["final_norm"], _ = make_norm(cfg.norm, dm, pd, device)
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": rnd((cfg.vocab, dm), 1.0)}
    p["blocks"] = {"norms": {"pre_attn": norm(), "pre_mlp": norm()},
                   "attn": a, "mlp": m}
    return p


def init_cache(params, cfg, batch, max_len, dtype, device=None):
    """``dtype`` is a dtype name or "fp2fx8" (int8 FP2FX raws + scales)."""
    _check_dense(cfg)
    c = attn.cache_init(cfg, batch, max_len, dtype, device)
    return {"blocks": {k: v.expand(cfg.n_layers, *v.shape).clone()
                       for k, v in c.items()}}


def _block_apply(p, x, cfg, positions, *, causal=True, decode_cache=None,
                 pos_offset=0, kv_len_mask=None, write_mask=None):
    """One block: returns (x, cache).

    Without ``decode_cache`` the block attends over its own sequence
    (training, ``causal``) and the cache is None.  With one, it is a decode
    step: ``pos_offset`` may be a (B,) tensor (ragged decode: each row
    writes its KV at its own position) and ``write_mask`` (B,) gates the
    cache write per row.
    """
    norm_fn = NORMS[cfg.norm]
    h = norm_fn(p["norms"]["pre_attn"], x)
    q, k, v = attn.qkv_proj(p["attn"], h, h, cfg, positions, positions)
    if decode_cache is None:
        cache = None
        o = attn.attention_fwd(q, k, v, cfg, causal=causal)
    else:
        if torch.is_tensor(pos_offset) or write_mask is not None:
            pos_b = torch.as_tensor(pos_offset, dtype=I32, device=x.device)
            cache = attn.cache_update_ragged(decode_cache, k, v,
                                             pos_b.expand(x.shape[0]), write_mask)
        else:
            cache = attn.cache_update(decode_cache, k, v, pos_offset)
        o = attn.decode_attention(q, cache, cfg, kv_len_mask=kv_len_mask)
    x = x + attn.out_proj(p["attn"], o.to(x.dtype))
    h = norm_fn(p["norms"]["pre_mlp"], x)
    return x + mlp_mod.mlp_apply(p["mlp"], h, cfg).to(x.dtype), cache


# --------------------------------------------------------------------------
# training forward and loss
# --------------------------------------------------------------------------


def _remat(fn, policy: str):
    """``"none"`` runs ``fn`` as is; ``"full"`` keeps only its inputs and
    runs it again in the backward."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs) is not ported yet: ROADMAP "
            "queue 1 item 8")
    raise ValueError(f"unknown remat policy {policy!r}")


def forward(params, tokens, cfg, *, remat="full", causal=True):
    """tokens: (B, S) -> hidden states (B, S, dm) and the scalar MoE aux
    (zero for the dense family)."""
    _check_dense(cfg)
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=I32, device=x.device).expand(B, S)
    block = _remat(lambda y, lp: _block_apply(lp, y, cfg, positions,
                                              causal=causal)[0], remat)
    for lp in _layers(params["blocks"], cfg.n_layers):
        x = block(x, lp)
    x = NORMS[cfg.norm](params["final_norm"], x)
    return x, torch.zeros((), dtype=F32, device=x.device)


def lm_loss(params, batch, cfg, *, remat="full", z_loss=1e-4,
            moe_aux_weight=0.01):
    """Teacher-forced LM loss.  batch: tokens, targets, (mask).  Returns
    (loss, {"nll", "aux"}), 0-d fp32 tensors."""
    hidden, aux = forward(params, batch["tokens"], cfg, remat=remat)
    logits = logits_fn(params, hidden, cfg)
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=F32, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * torch.sum((lse * mask) ** 2)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll) / denom + zl / denom + moe_aux_weight * aux
    return loss, {"nll": torch.sum(nll) / denom, "aux": aux}


# --------------------------------------------------------------------------
# serving: decode step and chunk prefill
# --------------------------------------------------------------------------


def decode_step(params, cache, tokens1, pos, cfg, write_mask=None):
    """One decode step.  tokens1: (B, 1); pos: int (current length) or a
    (B,) tensor of per-row lengths.  Each layer appends its K/V at ``pos``
    and attends over [0, pos].  Returns (logits (B, 1, V) fp32, cache)."""
    _check_dense(cfg)
    B = tokens1.shape[0]
    dev = tokens1.device
    x = embed_lookup(params["embed"], tokens1).to(cfg.cdtype)
    if torch.is_tensor(pos):
        positions = pos.to(I32).reshape(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=I32, device=dev)
    max_len = cache["blocks"]["k"].shape[3]
    kv_mask = torch.arange(max_len, device=dev)[None, :] <= positions
    for lp, lc in zip(_layers(params["blocks"], cfg.n_layers),
                      _layers(cache["blocks"], cfg.n_layers)):
        x, _ = _block_apply(lp, x, cfg, positions, decode_cache=lc,
                            pos_offset=pos, kv_len_mask=kv_mask,
                            write_mask=write_mask)
    norm_fn = NORMS[cfg.norm]
    x = norm_fn(params["final_norm"], x)
    return logits_fn(params, x, cfg), cache


def prefill_chunk(params, cache, tokens, start, cfg, lengths=None,
                  write_mask=None):
    """Chunked attend-at-offset: score a (B, S) token chunk in one forward
    pass against the cached history.

    Row ``b``'s tokens write at ``start[b] .. start[b] + S - 1``
    (write-then-attend) and each token attends under its own causal
    frontier ``kv_index <= start[b] + j``.  ``lengths`` (B,) bounds each
    row's real tokens; ``write_mask`` (B,) gates whole rows.  Returns
    (logits (B, S, V) fp32, cache).
    """
    _check_dense(cfg)
    B, S = tokens.shape
    dev = tokens.device
    pos_b = (torch.as_tensor(start, dtype=I32, device=dev).reshape(-1)
             .expand(B))
    nv = (torch.full((B,), S, dtype=I32, device=dev) if lengths is None
          else torch.as_tensor(lengths, dtype=I32, device=dev))
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    positions = pos_b[:, None] + torch.arange(S, dtype=I32, device=dev)[None, :]
    max_len = cache["blocks"]["k"].shape[3]
    kv_mask = (torch.arange(max_len, device=dev)[None, None, :]
               <= positions[:, :, None])
    norm_fn = NORMS[cfg.norm]
    for lp, lc in zip(_layers(params["blocks"], cfg.n_layers),
                      _layers(cache["blocks"], cfg.n_layers)):
        h = norm_fn(lp["norms"]["pre_attn"], x)
        q, k, v = attn.qkv_proj(lp["attn"], h, h, cfg, positions, positions)
        attn.cache_update_block_ragged(lc, k, v, pos_b, nv, write_mask)
        o = attn.verify_attention(q, lc, cfg, kv_pos_mask=kv_mask)
        y = x + attn.out_proj(lp["attn"], o.to(x.dtype))
        h2 = norm_fn(lp["norms"]["pre_mlp"], y)
        x = y + mlp_mod.mlp_apply(lp["mlp"], h2, cfg).to(y.dtype)
    x = norm_fn(params["final_norm"], x)
    return logits_fn(params, x, cfg), cache


def logits_fn(params, hidden, cfg):
    table = params["embed" if cfg.tie_embeddings else "unembed"]
    return unembed(table, hidden.to(cfg.cdtype)).to(F32)
