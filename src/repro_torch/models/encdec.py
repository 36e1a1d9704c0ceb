"""Encoder-decoder stack (Whisper-style): a stub frontend, the encoder and
the decoder.

The PyTorch counterpart of ``repro.models.encdec``.  As there, the modality
frontend is a stub: the caller supplies precomputed frame embeddings (B,
T_frames, frontend_dim) and one projection (``"frontend_proj"``) stands in
for the conv stack.  Encoder blocks are non-causal self-attention; decoder
blocks are causal self-attention, then cross-attention into the encoder
memory, then the MLP.  Every attention goes through
``attention.attention_fwd`` (kernel mode: the flash kernels, kernels 3-5),
but the decoder's cached self-attention, which is ``decode_attention``
(kernel 6).  The cross-attention of a decode step is ``attention_fwd`` at
Sq = 1 over the whole memory, as in the JAX package, so it runs the flash
forward's KV blocks of ``min(128, T_frames)`` keys, not split-K's.

Parameters keep the JAX tree, layer-stacked: ``frontend_proj``,
``enc_blocks`` (``{"norms": {"pre_attn", "pre_mlp"}, "attn", "mlp"}``),
``enc_norm``, ``embed``, ``dec_blocks`` (``{"norms": {"pre_attn",
"pre_cross", "pre_mlp"}, "attn", "cross", "mlp"}``), ``final_norm``; the
embedding is tied.  The cache is ``{"self": stacked KV, "memory": (B,
frontend_len, d_model)}``, the memory in ``cache_storage_dtype``: the
sequential prefill and the decode step read it rounded to that dtype, and
the parallel prefill attends to the encoder's output itself and only
stores the rounded copy, as in the JAX package.  The decode step computes
the cross K/V from the memory anew every step, as JAX does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import NORMS, embed_lookup, make_norm
from repro_torch.models.transformer import (_block_init, _layers,
                                            _prefill_chunk_scan, _remat, _stack_leaves,
                                            _stacked, attn_init, logits_fn)

F32 = torch.float32
I32 = torch.int32


def _dec_block_init(generator, cfg, device):
    """The decoder blocks: an encoder block's tree with ``"cross"``, a
    second attention layer, and its norm ``"pre_cross"``."""
    blocks = _block_init(generator, cfg, device, cfg.n_layers)
    _, norm = _stacked(generator, cfg, cfg.n_layers, device)
    blocks["norms"]["pre_cross"] = norm()
    blocks["cross"] = attn_init(generator, cfg, device, cfg.n_layers)
    return blocks


def init(generator: torch.Generator, cfg, device=None) -> dict[str, Any]:
    """Fresh weights with the JAX package's keys, shapes and scales; the
    values are torch's (``repro_torch.convert`` bridges JAX's)."""
    dm, pd = cfg.d_model, cfg.pdtype
    rnd, _ = _stacked(generator, cfg, None, device)
    p: dict[str, Any] = {
        "frontend_proj": {"w": rnd((cfg.frontend_dim, dm), cfg.frontend_dim ** -0.5,
                                   (None, "embed"))},
        "enc_blocks": _block_init(generator, cfg, device, cfg.enc_layers),
        "embed": {"table": rnd((cfg.vocab, dm), 1.0, ("vocab", "embed"))},
        "dec_blocks": _dec_block_init(generator, cfg, device),
    }
    p["enc_norm"], _ = make_norm(cfg.norm, dm, pd, device)
    p["final_norm"], _ = make_norm(cfg.norm, dm, pd, device)
    return p


def _positions(n: int, batch: int, device):
    return torch.arange(n, dtype=I32, device=device).expand(batch, n)


def encode(params, frames, cfg, remat="full"):
    """frames: (B, T, frontend_dim) -> memory (B, T, dm) in the compute
    dtype."""
    x = torch.matmul(frames.to(cfg.cdtype), params["frontend_proj"]["w"].to(cfg.cdtype))
    B, T, _ = x.shape
    positions = _positions(T, B, x.device)
    norm_fn = NORMS[cfg.norm]

    def block(x_c, lp):
        h = norm_fn(lp["norms"]["pre_attn"], x_c)
        q, k, v = attn.qkv_proj(lp["attn"], h, h, cfg, positions, positions)
        o = attn.attention_fwd(q, k, v, cfg, causal=False)
        x_c = x_c + attn.out_proj(lp["attn"], o.to(x_c.dtype))
        h = norm_fn(lp["norms"]["pre_mlp"], x_c)
        return x_c + mlp_mod.mlp_apply(lp["mlp"], h, cfg).to(x_c.dtype)

    body = _remat(block, remat)
    for lp in _layers(params["enc_blocks"], cfg.enc_layers):
        x = body(x, lp)
    return norm_fn(params["enc_norm"], x)


def _dec_block(lp, x, memory, cfg, positions, mem_pos, self_attn):
    """One decoder block: ``self_attn(q, k, v)`` (training, a prompt or a
    cached step), then the cross-attention into ``memory`` (queries at the
    text positions, keys at ``mem_pos``), then the MLP."""
    norm_fn = NORMS[cfg.norm]
    h = norm_fn(lp["norms"]["pre_attn"], x)
    q, k, v = attn.qkv_proj(lp["attn"], h, h, cfg, positions, positions)
    y = x + attn.out_proj(lp["attn"], self_attn(q, k, v).to(x.dtype))
    h = norm_fn(lp["norms"]["pre_cross"], y)
    q, k, v = attn.qkv_proj(lp["cross"], h, memory, cfg, positions, mem_pos)
    o = attn.attention_fwd(q, k, v, cfg, causal=False)
    y = y + attn.out_proj(lp["cross"], o.to(y.dtype))
    h = norm_fn(lp["norms"]["pre_mlp"], y)
    return y + mlp_mod.mlp_apply(lp["mlp"], h, cfg).to(y.dtype)


def decode_train(params, tokens, memory, cfg, remat="full"):
    """The teacher-forced decoder pass: tokens (B, S), memory (B, T, dm) ->
    hidden states (B, S, dm)."""
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    B, S, _ = x.shape
    positions = _positions(S, B, x.device)
    mem_pos = _positions(memory.shape[1], B, x.device)
    causal = lambda q, k, v: attn.attention_fwd(q, k, v, cfg, causal=True)  # noqa: E731
    body = _remat(lambda x_c, lp, mem: _dec_block(lp, x_c, mem, cfg, positions, mem_pos,
                                                  causal), remat)
    memory = memory.to(x.dtype)
    for lp in _layers(params["dec_blocks"], cfg.n_layers):
        x = body(x, lp, memory)
    return NORMS[cfg.norm](params["final_norm"], x)


def loss(params, batch, cfg, *, remat="full", z_loss=1e-4, **_):
    """Teacher-forced loss over the decoder.  batch: frames, tokens,
    targets, (mask).  Returns (loss, {"nll", "aux"}), 0-d fp32 tensors (aux
    zero)."""
    memory = encode(params, batch["frames"], cfg, remat=remat)
    hidden = decode_train(params, batch["tokens"], memory, cfg, remat=remat)
    logits = logits_fn(params, hidden, cfg.with_(tie_embeddings=True))
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=F32, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(nll) / denom + z_loss * torch.sum((lse * mask) ** 2) / denom
    return total, {"nll": torch.sum(nll) / denom,
                   "aux": torch.zeros((), dtype=F32, device=logits.device)}


def init_cache(params, cfg, batch, max_len, dtype, device=None):
    """``dtype`` is a dtype name or "fp2fx8" (int8 FP2FX self-attention
    cache; the encoder memory then stays fp32)."""
    c = attn.cache_init(cfg, batch, max_len, dtype, device)
    return {"self": _stack_leaves(c, cfg.n_layers),
            "memory": torch.zeros((batch, cfg.frontend_len, cfg.d_model),
                                  dtype=attn.cache_storage_dtype(dtype), device=device)}


def prefill_parallel(params, cache, batch, cfg):
    """One-pass prefill: encode once, then a teacher-forced decoder pass that
    writes the whole prompt's self-attention K/V into the cache at position
    0, against the token-by-token prefill.  ``batch["lengths"]`` (B,) makes
    it ragged: right-padded prompts, each row's padded keys masked
    (``kv_len_mask``), and the logits at each row's ``lengths[b] - 1``.
    Returns (logits (B, 1, V) fp32, cache, S)."""
    memory = encode(params, batch["frames"], cfg, remat="none")
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    B, S = tokens.shape
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    positions = _positions(S, B, dev)
    mem_pos = _positions(memory.shape[1], B, dev)
    mem_c = memory.to(cfg.cdtype)
    kv_mask = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.long, device=dev)
        kv_mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    for lp, lc in zip(_layers(params["dec_blocks"], cfg.n_layers),
                      _layers(cache["self"], cfg.n_layers)):
        def self_attn(q, k, v, lc=lc):
            attn.cache_update(lc, k, v, 0)
            return attn.attention_fwd(q, k, v, cfg, causal=True, kv_len_mask=kv_mask)
        x = _dec_block(lp, x, mem_c, cfg, positions, mem_pos, self_attn)
    if lengths is not None:
        x = torch.gather(x, 1, (lengths - 1)[:, None, None].expand(B, 1, x.shape[-1]))
    else:
        x = x[:, -1:]
    x = NORMS[cfg.norm](params["final_norm"], x)
    cache["memory"].copy_(memory)
    return logits_fn(params, x, cfg.with_(tie_embeddings=True)), cache, S


def decode_step(params, cache, tokens1, pos, cfg, write_mask=None):
    """One decoder token against the cached encoder memory and self KV.

    ``pos`` is an int (the current length) or a (B,) tensor (ragged
    slot-pool decode: each row writes and attends at its own position);
    ``write_mask`` (B,) gates the self-KV write per row.  The cache is
    updated in place.  Returns (logits (B, 1, V) fp32, cache)."""
    B = tokens1.shape[0]
    dev = tokens1.device
    x = embed_lookup(params["embed"], tokens1).to(cfg.cdtype)
    ragged = torch.is_tensor(pos)
    positions = (pos.to(I32).reshape(B, 1) if ragged
                 else torch.full((B, 1), pos, dtype=I32, device=dev))
    memory = cache["memory"].to(cfg.cdtype)
    mem_pos = _positions(memory.shape[1], B, dev)
    kv_mask = torch.arange(cache["self"]["k"].shape[3], device=dev)[None, :] <= positions
    for lp, lc in zip(_layers(params["dec_blocks"], cfg.n_layers),
                      _layers(cache["self"], cfg.n_layers)):
        def self_attn(q, k, v, lc=lc):
            if ragged or write_mask is not None:
                pos_b = torch.as_tensor(pos, dtype=I32, device=dev).expand(B)
                attn.cache_update_ragged(lc, k, v, pos_b, write_mask)
            else:
                attn.cache_update(lc, k, v, pos)
            return attn.decode_attention(q, lc, cfg, kv_len_mask=kv_mask)
        x = _dec_block(lp, x, memory, cfg, positions, mem_pos, self_attn)
    x = NORMS[cfg.norm](params["final_norm"], x)
    return logits_fn(params, x, cfg.with_(tie_embeddings=True)), cache


def prefill(params, cache, batch, cfg):
    """The whole prompt: ``prefill_parallel`` under ``cfg.parallel_prefill``,
    else encode, install the memory (rounded to the cache's dtype) and run
    one ``decode_step`` a prompt token; a ragged row's steps past its
    ``lengths`` are gated off and its logits kept at its last.  Returns
    (logits (B, 1, V) fp32, cache, S)."""
    if cfg.parallel_prefill:
        return prefill_parallel(params, cache, batch, cfg)
    cache["memory"].copy_(encode(params, batch["frames"], cfg, remat="none"))
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.long, device=tokens.device)
    last = None
    for t in range(tokens.shape[1]):
        wm = None if lengths is None else t < lengths
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg, write_mask=wm)
        if lengths is None:
            last = logits
        else:
            at = (lengths - 1 == t)[:, None, None]
            last = logits if last is None else torch.where(at, logits, last)
    return last, cache, tokens.shape[1]


def prefill_chunk(params, cache, tokens, start, cfg, lengths=None, write_mask=None):
    """Chunked attend-at-offset over the decoder (``transformer.prefill_chunk``'s
    contract): lane ``i`` of the (B, S) chunk writes self-KV at ``start +
    i``, gated by ``write_mask & (i < lengths)``, and cross-attends the
    cached memory, which must already hold each row's encoding.  One gated
    ``decode_step`` a lane.  Returns (logits (B, S, V) fp32, cache)."""
    B, S = tokens.shape
    dev = tokens.device
    pos_b = torch.as_tensor(start, dtype=I32, device=dev).reshape(-1).expand(B)
    nv = (torch.full((B,), S, dtype=I32, device=dev) if lengths is None
          else torch.as_tensor(lengths, dtype=I32, device=dev))
    return _prefill_chunk_scan(
        params, cache, tokens, pos_b, nv, write_mask,
        lambda p, c, t, pos, wm: decode_step(p, c, t, pos, cfg, write_mask=wm))
