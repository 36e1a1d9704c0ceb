"""Decoder-only LM stack, dense, MoE, VLM, SSM and hybrid families: init,
the training forward and loss, cache, decode step, prefill and chunk
prefill.

The PyTorch counterpart of ``repro.models.transformer``.  Parameters keep
the JAX tree — per-layer leaves stacked on a leading layer axis under
``"blocks"``, an MoE block's experts under ``"moe"`` in place of ``"mlp"``,
a Mamba2 block's ``{"norm", "ssm"}`` — and a Python loop over layers takes
the place of ``lax.scan``.  The hybrid (zamba2) runs Mamba2 blocks and,
after every ``attn_every``-th, the shared attention block
``"shared_attn"``: one parameter set (an attention block's tree without the
layer axis) with its own KV cache per invocation.  Remat: ``"full"`` wraps
each block in ``torch.utils.checkpoint`` (only the residual stream is
kept; the block's forward runs again in the backward); ``"dots"`` keeps
the outputs of the products without batch dimensions and recomputes the
rest, JAX's ``checkpoint_dots_with_no_batch_dims``.  The hybrid's shared
block is its own remat region after its Mamba2 block's, as JAX wraps it.
The VLM (internvl2) is the dense stack with ``"frontend_proj"``, which
projects precomputed patch embeddings to ``d_model``: ``forward`` prepends
them to the text (``embeds_prefix``) and ``lm_loss`` scores the text
positions only; serving is text-only, as in the JAX package.

The cache is ``{"blocks": ...}``, stacked the same way and updated in
place: ``{"k", "v"[, "k_scale", "v_scale"]}`` for the attention families
(the paged cache holds page pools there and its ``"block_tables"`` (B, nb)
beside them), the Mamba2 state ``{"ssm", "conv"}`` for the recurrent ones,
and for the hybrid also ``"shared_attn"``, the shared block's KV stacked
on a leading invocation axis, ``(n_invocations, B, Hkv, L, D)``.  The
recurrent families keep the conv tail in the cache's storage dtype: where
that differs from the promoted dtype of the decode's conv window (a bf16
cache under fp32 compute), JAX's functional cache takes the window's
dtype and the port's in-place one rounds to its own.  The encoder-decoder
family lives in ``models/encdec.py`` and reuses ``_layers``, ``_remat``,
``_prefill_chunk_scan`` and ``logits_fn``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import NORMS, embed_lookup, make_norm, unembed

F32 = torch.float32
I32 = torch.int32


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")   # this module's families
ATTENTION_FAMILIES = ("dense", "moe", "vlm")          # of those, the ones with a paged cache


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only family: "
                         f"have {FAMILIES} (encdec: models/encdec.py)")


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


def _stacked(generator, cfg, n_layers, device):
    """``rnd(shape, scale)`` and ``norm()`` for leaves stacked on a leading
    axis of ``n_layers`` (None: no layer axis)."""
    lead = () if n_layers is None else (n_layers,)

    def rnd(shape, scale):
        return _normal(generator, lead + shape, scale, cfg.pdtype, device)

    def norm():
        p, _ = make_norm(cfg.norm, cfg.d_model, cfg.pdtype, device)
        return {k: v.expand(lead + v.shape).clone() for k, v in p.items()}
    return rnd, norm


def attn_init(generator, cfg, device, n_layers=None):
    """An attention layer's tree (q/k/v/o projections, the biases with
    ``qkv_bias``), stacked on a leading axis of ``n_layers`` (None: none)."""
    dm, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pd = cfg.pdtype
    lead = () if n_layers is None else (n_layers,)
    rnd, _ = _stacked(generator, cfg, n_layers, device)
    a = {"wq": rnd((dm, hq, dh), dm ** -0.5),
         "wk": rnd((dm, hkv, dh), dm ** -0.5),
         "wv": rnd((dm, hkv, dh), dm ** -0.5),
         "wo": rnd((hq, dh, dm), (hq * dh) ** -0.5)}
    if cfg.qkv_bias:
        a["bq"] = torch.zeros(lead + (hq, dh), dtype=pd, device=device)
        a["bk"] = torch.zeros(lead + (hkv, dh), dtype=pd, device=device)
        a["bv"] = torch.zeros(lead + (hkv, dh), dtype=pd, device=device)
    return a


def _block_init(generator, cfg, device, n_layers=None):
    """An attention block's tree (norms, attention, MLP or experts), its
    leaves stacked on a leading axis of ``n_layers`` (None: the hybrid's
    shared block, one parameter set)."""
    dm, dff = cfg.d_model, cfg.d_ff
    pd = cfg.pdtype
    rnd, norm = _stacked(generator, cfg, n_layers, device)
    a = attn_init(generator, cfg, device, n_layers)
    blocks = {"norms": {"pre_attn": norm(), "pre_mlp": norm()}, "attn": a}
    if cfg.family == "moe":
        blocks["moe"] = moe_mod.moe_init(generator, cfg, pd, device, n_layers=n_layers)
    else:
        m = {"w_up": rnd((dm, dff), dm ** -0.5),
             "w_down": rnd((dff, dm), dff ** -0.5)}
        if cfg.mlp_gated:
            m["w_gate"] = rnd((dm, dff), dm ** -0.5)
        blocks["mlp"] = m
    return blocks


def init(generator: torch.Generator, cfg, device=None) -> dict[str, Any]:
    """Fresh weights with the JAX package's keys, shapes and scales
    (fan-in normal, unit-scale embedding, ones for norms, zeros for
    biases; the Mamba2 block's constants as ``ssm.ssm_init`` sets them).
    The values are torch's: the weights bridge (``repro_torch.convert``)
    carries the JAX package's values instead."""
    _check_family(cfg)
    L, dm = cfg.n_layers, cfg.d_model
    pd = cfg.pdtype
    rnd = lambda shape, scale: _normal(generator, shape, scale, pd, device)  # noqa: E731
    # the blocks are drawn first, then the embeddings (the attention
    # families' draws, as they were before the recurrent families came)
    if cfg.family in ATTENTION_FAMILIES:
        blocks = _block_init(generator, cfg, device, L)
    else:
        _, norm = _stacked(generator, cfg, L, device)
        blocks = {"norm": norm(),
                  "ssm": ssm_mod.ssm_init(generator, cfg, pd, device, n_layers=L)}
    p: dict[str, Any] = {"embed": {"table": rnd((cfg.vocab, dm), 1.0)}}
    p["final_norm"], _ = make_norm(cfg.norm, dm, pd, device)
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": rnd((cfg.vocab, dm), 1.0)}
    p["blocks"] = blocks
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_init(generator, cfg, device)
    if cfg.family == "vlm":
        p["frontend_proj"] = {"w": rnd((cfg.frontend_dim, dm), cfg.frontend_dim ** -0.5)}
    return p


def hybrid_attn_flags(cfg) -> list[bool]:
    """True after every ``attn_every``-th Mamba2 block (the zamba2
    pattern); never without a shared block (``attn_every`` 0)."""
    n = cfg.attn_every
    return [bool(n) and i % n == n - 1 for i in range(cfg.n_layers)]


def hybrid_n_invocations(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def hybrid_inv_idx(cfg) -> list[int]:
    """The shared block's invocation index at each layer (valid where the
    flag is True; -1 before the first).  The invocations share weights but
    each has its own KV cache, the ``"shared_attn"`` cache's slice at that
    index."""
    idx, n = [], -1
    for flag in hybrid_attn_flags(cfg):
        n += flag
        idx.append(n)
    return idx


def _stack_leaves(tree, n: int):
    return {k: _stack_leaves(v, n) if isinstance(v, dict)
            else v.expand(n, *v.shape).clone() for k, v in tree.items()}


def init_cache(params, cfg, batch, max_len, dtype, device=None):
    """``dtype`` is a dtype name or "fp2fx8" (int8 FP2FX raws + scales for
    the attention cache; the Mamba2 state and conv tail then stay fp32,
    ``attention.cache_storage_dtype``)."""
    _check_family(cfg)
    if cfg.family in ATTENTION_FAMILIES:
        c = attn.cache_init(cfg, batch, max_len, dtype, device)
        return {"blocks": _stack_leaves(c, cfg.n_layers)}
    sdtype = attn.cache_storage_dtype(dtype)
    c = ssm_mod.ssm_cache_init(cfg, batch, sdtype, device)
    cache = {"blocks": _stack_leaves(c, cfg.n_layers)}
    if cfg.family == "hybrid":
        sc = attn.cache_init(cfg, batch, max_len, dtype, device)
        cache["shared_attn"] = _stack_leaves(sc, hybrid_n_invocations(cfg))
    return cache


def init_paged_cache(params, cfg, n_pages, page_size, dtype, device=None):
    """Paged serving cache: per-layer page pools, each leaf ``(n_layers,
    n_pages + 1, Hkv, page_size, D)`` (page 0 the null page).  The caller
    owns the block tables and puts them in the dict as
    ``cache["block_tables"]`` (B, nb) int32; ``decode_step`` and
    ``prefill_chunk`` take the paged path when they are there.  Attention
    families only: a recurrent state is a fixed-size tensor, not a stream
    of pages."""
    _check_family(cfg)
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(
            f"kv_layout='paged' needs an attention-family model, got "
            f"family={cfg.family!r} (SSM/hybrid/encdec serve with the dense "
            f"slot-pool layout)")
    c = attn.paged_cache_init(cfg, n_pages, page_size, dtype, device)
    return {"blocks": _stack_leaves(c, cfg.n_layers)}


def _block_apply(p, x, cfg, positions, *, causal=True, decode_cache=None,
                 pos_offset=0, kv_len_mask=None, write_mask=None,
                 paged_bt=None):
    """One block: returns (x, aux, cache); ``aux`` is the MoE block's
    load-balancing loss (None for a dense block).

    Without ``decode_cache`` the block attends over its own sequence
    (training, ``causal``) and the cache is None.  With one, it is a decode
    step: ``pos_offset`` may be a (B,) tensor (ragged decode: each row
    writes its KV at its own position) and ``write_mask`` (B,) gates the
    cache write per row.  ``paged_bt`` (B, nb) switches the cache to the
    paged layout: the write goes through the block table (masked rows to
    the null page) and attention reads the pages.
    """
    norm_fn = NORMS[cfg.norm]
    h = norm_fn(p["norms"]["pre_attn"], x)
    q, k, v = attn.qkv_proj(p["attn"], h, h, cfg, positions, positions)
    if decode_cache is None:
        cache = None
        o = attn.attention_fwd(q, k, v, cfg, causal=causal)
    elif paged_bt is not None:
        pos_b = torch.as_tensor(pos_offset, dtype=I32, device=x.device)
        cache = attn.cache_update_paged(decode_cache, k, v,
                                        pos_b.expand(x.shape[0]), paged_bt,
                                        write_mask)
        o = attn.decode_attention_paged(q, cache, paged_bt, cfg,
                                        kv_len_mask=kv_len_mask)
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
    y, aux = _ffn(p, h, cfg)
    return x + y.to(x.dtype), aux, cache


def _ffn(p, h, cfg):
    """The block's feed-forward half: (y, aux), the experts' or the MLP's
    (aux None)."""
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], h, cfg)
    return mlp_mod.mlp_apply(p["mlp"], h, cfg), None


def _mamba_block_apply(p, x, cfg, *, decode_cache=None, write_mask=None):
    """One Mamba2 block: x + ssm(norm(x)).  Without ``decode_cache`` it runs
    the chunked SSD over the sequence; with one it is a decode step that
    writes the new state into the cache in place, a row whose
    ``write_mask`` is False keeping its old state."""
    h = NORMS[cfg.norm](p["norm"], x)
    if decode_cache is None:
        return x + ssm_mod.ssm_train(p["ssm"], h, cfg)
    y, new = ssm_mod.ssm_decode(p["ssm"], h, decode_cache, cfg)
    for name, leaf in new.items():
        old = decode_cache[name]
        if write_mask is not None:
            gate = write_mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
            leaf = torch.where(gate, leaf, old.to(leaf.dtype))
        old.copy_(leaf)
    return x + y


# --------------------------------------------------------------------------
# training forward and loss
# --------------------------------------------------------------------------


def dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims``: keep the output of every
    product without batch dimensions and recompute the rest.  Those products
    are ``torch.matmul`` of 3-D by 2-D (the q/k/v/o projections, the MLP,
    the MoE router), which lower to ``aten.mm``; the batched ones (unfused
    attention, the experts, dispatch and combine) lower to ``bmm`` and run
    again, as do the CUDA kernels, which the dispatcher does not see."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``"none"`` runs ``fn`` as is; ``"full"`` keeps only its inputs and
    runs it again in the backward; ``"dots"`` also keeps what
    ``dots_policy`` saves."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {policy!r}")


def forward(params, tokens, cfg, *, embeds_prefix=None, remat="full", causal=True):
    """tokens: (B, S) -> hidden states (B, S, dm) and the scalar MoE aux,
    summed over the layers (zero for the other families).  The VLM's
    ``embeds_prefix`` (B, P, frontend_dim), projected by
    ``frontend_proj``, goes before the text: the states are then (B, P +
    S, dm)."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    if embeds_prefix is not None:
        pe = torch.matmul(embeds_prefix.to(cfg.cdtype),
                          params["frontend_proj"]["w"].to(cfg.cdtype))
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=I32, device=x.device).expand(B, S)
    block = _remat(lambda y, lp: _block_apply(lp, y, cfg, positions,
                                              causal=causal)[:2], remat)
    auxs = []
    layers = _layers(params["blocks"], cfg.n_layers)
    if cfg.family in ATTENTION_FAMILIES:
        for lp in layers:
            x, aux = block(x, lp)
            if aux is not None:
                auxs.append(aux)
    else:
        mamba = _remat(lambda y, lp: _mamba_block_apply(lp, y, cfg), remat)
        shared = _remat(lambda y, lp: _block_apply(lp, y, cfg, positions,
                                                   causal=causal)[0], remat)
        for lp, flag in zip(layers, hybrid_attn_flags(cfg)):
            x = mamba(x, lp)
            if flag:
                x = shared(x, params["shared_attn"])
    x = NORMS[cfg.norm](params["final_norm"], x)
    if not auxs:
        return x, torch.zeros((), dtype=F32, device=x.device)
    return x, torch.sum(torch.stack(auxs))


def lm_loss(params, batch, cfg, *, remat="full", z_loss=1e-4,
            moe_aux_weight=0.01):
    """Teacher-forced LM loss.  batch: tokens, targets, (mask), (embeds: the
    VLM's patches, scored not).  Returns (loss, {"nll", "aux"}), 0-d fp32
    tensors."""
    embeds = batch.get("embeds")
    hidden, aux = forward(params, batch["tokens"], cfg, embeds_prefix=embeds,
                          remat=remat)
    if embeds is not None:
        hidden = hidden[:, embeds.shape[1]:]           # the text positions
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
# serving: decode step, prefill and chunk prefill
# --------------------------------------------------------------------------


def _kv_length(cache) -> int:
    """The KV length a mask spans: the dense cache's (the hybrid's shared
    block's), or the paged layout's virtual length ``nb * page_size``."""
    bt = cache.get("block_tables")
    if bt is not None:
        return bt.shape[1] * cache["blocks"]["k"].shape[3]
    kv = cache["shared_attn"] if "shared_attn" in cache else cache["blocks"]
    return kv["k"].shape[3]


def decode_step(params, cache, tokens1, pos, cfg, write_mask=None):
    """One decode step.  tokens1: (B, 1); pos: int (current length) or a
    (B,) tensor of per-row lengths.  Each attention layer (each invocation
    of the hybrid's shared block, in its own slice of the stacked cache)
    appends its K/V at ``pos`` and attends over [0, pos]; each Mamba2 layer
    updates its state.  ``write_mask`` (B,) gates every cache and state
    write per row.  With ``cache["block_tables"]`` the cache is the paged
    layout.  Returns (logits (B, 1, V) fp32, cache)."""
    _check_family(cfg)
    B = tokens1.shape[0]
    dev = tokens1.device
    x = embed_lookup(params["embed"], tokens1).to(cfg.cdtype)
    if torch.is_tensor(pos):
        positions = pos.to(I32).reshape(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=I32, device=dev)
    layers = zip(_layers(params["blocks"], cfg.n_layers),
                 _layers(cache["blocks"], cfg.n_layers))
    if cfg.family == "ssm":
        for lp, lc in layers:
            x = _mamba_block_apply(lp, x, cfg, decode_cache=lc, write_mask=write_mask)
    else:
        bt = cache.get("block_tables")
        kv_mask = torch.arange(_kv_length(cache), device=dev)[None, :] <= positions
        kw = dict(pos_offset=pos, kv_len_mask=kv_mask, write_mask=write_mask)
        if cfg.family == "hybrid":
            shared = _layers(cache["shared_attn"], hybrid_n_invocations(cfg))
            for (lp, lc), flag, inv in zip(layers, hybrid_attn_flags(cfg),
                                           hybrid_inv_idx(cfg)):
                x = _mamba_block_apply(lp, x, cfg, decode_cache=lc,
                                       write_mask=write_mask)
                if flag:
                    x = _block_apply(params["shared_attn"], x, cfg, positions,
                                     decode_cache=shared[inv], **kw)[0]
        else:
            for lp, lc in layers:
                x = _block_apply(lp, x, cfg, positions, decode_cache=lc,
                                 paged_bt=bt, **kw)[0]
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
    row's real tokens; ``write_mask`` (B,) gates whole rows.  With
    ``cache["block_tables"]`` the writes and the attention go through the
    page pool.  The recurrent families' state is a sequential recurrence,
    so they run one gated ``decode_step`` per lane (``_prefill_chunk_scan``):
    the same contract, O(S) steps.  Returns (logits (B, S, V) fp32, cache).
    """
    _check_family(cfg)
    B, S = tokens.shape
    dev = tokens.device
    pos_b = (torch.as_tensor(start, dtype=I32, device=dev).reshape(-1)
             .expand(B))
    nv = (torch.full((B,), S, dtype=I32, device=dev) if lengths is None
          else torch.as_tensor(lengths, dtype=I32, device=dev))
    if cfg.family not in ATTENTION_FAMILIES:
        return _prefill_chunk_scan(
            params, cache, tokens, pos_b, nv, write_mask,
            lambda p, c, t, pos, wm: decode_step(p, c, t, pos, cfg, write_mask=wm))
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    positions = pos_b[:, None] + torch.arange(S, dtype=I32, device=dev)[None, :]
    bt = cache.get("block_tables")
    kv_mask = (torch.arange(_kv_length(cache), device=dev)[None, None, :]
               <= positions[:, :, None])
    norm_fn = NORMS[cfg.norm]
    for lp, lc in zip(_layers(params["blocks"], cfg.n_layers),
                      _layers(cache["blocks"], cfg.n_layers)):
        h = norm_fn(lp["norms"]["pre_attn"], x)
        q, k, v = attn.qkv_proj(lp["attn"], h, h, cfg, positions, positions)
        if bt is not None:
            attn.cache_update_block_paged(lc, k, v, pos_b, bt, nv, write_mask)
        else:
            attn.cache_update_block_ragged(lc, k, v, pos_b, nv, write_mask)
        o = attn.verify_attention(q, lc, cfg, kv_pos_mask=kv_mask,
                                  block_tables=bt)
        y = x + attn.out_proj(lp["attn"], o.to(x.dtype))
        h2 = norm_fn(lp["norms"]["pre_mlp"], y)
        x = y + _ffn(lp, h2, cfg)[0].to(y.dtype)
    x = norm_fn(params["final_norm"], x)
    return logits_fn(params, x, cfg), cache


def _prefill_chunk_scan(params, cache, tokens, pos_b, nv, write_mask, step_fn):
    """``prefill_chunk`` for the recurrent families and encdec: one gated
    ``step_fn(params, cache, tokens1, pos, write_mask)`` (their
    ``decode_step``) per lane.  Lane ``i`` feeds ``tokens[:, i]`` at
    position ``pos_b + i`` with its writes gated by ``write_mask & (i <
    nv)``, the per-lane gate of the one-pass attention chunk, so the
    contract and the stacked (B, S, V) logits are the same."""
    B, S = tokens.shape
    base = (torch.ones((B,), dtype=torch.bool, device=tokens.device)
            if write_mask is None else torch.as_tensor(write_mask, dtype=torch.bool))
    logits = []
    for i in range(S):
        lg, cache = step_fn(params, cache, tokens[:, i:i + 1], pos_b + i, base & (i < nv))
        logits.append(lg[:, -1, :])
    return torch.stack(logits, dim=1), cache


def _prefill_block(lp, lc, x, cfg, positions, kv_mask=None):
    """One attention block over a whole prompt that also writes its K/V at
    position 0 of its cache ``lc``: the dense prefill's body and the
    hybrid parallel prefill's shared block."""
    norm_fn = NORMS[cfg.norm]
    h = norm_fn(lp["norms"]["pre_attn"], x)
    q, k, v = attn.qkv_proj(lp["attn"], h, h, cfg, positions, positions)
    attn.cache_update(lc, k, v, 0)
    o = attn.attention_fwd(q, k, v, cfg, causal=True, kv_len_mask=kv_mask)
    y = x + attn.out_proj(lp["attn"], o.to(x.dtype))
    h2 = norm_fn(lp["norms"]["pre_mlp"], y)
    return y + _ffn(lp, h2, cfg)[0].to(y.dtype)


def prefill(params, cache, tokens, cfg, lengths=None):
    """Fill the cache with a prompt: (last logits (B, 1, V) fp32, cache, S).

    The attention families compute K/V for the whole prompt in one pass
    (``attention_fwd``, causal) and write them at position 0.  The
    recurrent families take the parallel prefill (``_prefill_ssm_parallel``)
    when ``cfg.parallel_prefill`` is set, there are no ``lengths`` and the
    chunk size divides S (a padded tail would poison the state); else they
    build the state token by token through ``decode_step``.

    ``lengths`` (B,) makes the prefill ragged: ``tokens`` is right-padded
    and the logits are each row's at position ``lengths[b] - 1``.  The
    attention families mask the padded keys and write garbage K/V past each
    length, which the ``kv_len_mask`` contract hides until decode
    overwrites it; the recurrent families gate each step per row, so a
    padded step leaves the state as it was.
    """
    _check_family(cfg)
    B, S = tokens.shape
    dev = tokens.device
    norm_fn = NORMS[cfg.norm]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.long, device=dev)
    if cfg.family in ATTENTION_FAMILIES:
        x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
        positions = torch.arange(S, dtype=I32, device=dev).expand(B, S)
        kv_mask = (None if lengths is None
                   else torch.arange(S, device=dev)[None, :] < lengths[:, None])
        for lp, lc in zip(_layers(params["blocks"], cfg.n_layers),
                          _layers(cache["blocks"], cfg.n_layers)):
            x = _prefill_block(lp, lc, x, cfg, positions, kv_mask)
        if lengths is not None:
            x = torch.gather(x, 1, (lengths - 1)[:, None, None].expand(B, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
        return logits_fn(params, norm_fn(params["final_norm"], x), cfg), cache, S
    if lengths is None and cfg.parallel_prefill and S % cfg.ssm_chunk == 0:
        return _prefill_ssm_parallel(params, cache, tokens, cfg)
    # the sequential state build: one decode step per token; a ragged row's
    # steps past its length are gated off, and its logits kept at its last
    last = None
    for t in range(S):
        wm = None if lengths is None else t < lengths
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg,
                                    write_mask=wm)
        if lengths is None:
            last = logits
        else:
            at = (lengths - 1 == t)[:, None, None]
            last = logits if last is None else torch.where(at, logits, last)
    return last, cache, S


def _prefill_ssm_parallel(params, cache, tokens, cfg):
    """One-pass prefill of the recurrent families: the chunked SSD forward
    gives each layer's state after the prompt directly
    (``ssm_train(..., return_state=True)``), written into the cache in its
    dtype; the hybrid's shared block writes each invocation's K/V for the
    whole prompt as the dense prefill does (kernel 3 in kernel mode)."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(cfg.cdtype)
    positions = torch.arange(S, dtype=I32, device=tokens.device).expand(B, S)
    norm_fn = NORMS[cfg.norm]
    shared = (_layers(cache["shared_attn"], hybrid_n_invocations(cfg))
              if cfg.family == "hybrid" else [])
    layers = zip(_layers(params["blocks"], cfg.n_layers),
                 _layers(cache["blocks"], cfg.n_layers))
    for (lp, lc), flag, inv in zip(layers, hybrid_attn_flags(cfg), hybrid_inv_idx(cfg)):
        y, state = ssm_mod.ssm_train(lp["ssm"], norm_fn(lp["norm"], x), cfg,
                                     return_state=True)
        x = x + y
        for name, leaf in state.items():
            lc[name].copy_(leaf)
        if flag:
            x = _prefill_block(params["shared_attn"], shared[inv], x, cfg, positions)
    x = norm_fn(params["final_norm"], x[:, -1:])
    return logits_fn(params, x, cfg), cache, S


def logits_fn(params, hidden, cfg):
    table = params["embed" if cfg.tie_embeddings else "unembed"]
    return unembed(table, hidden.to(cfg.cdtype)).to(F32)
