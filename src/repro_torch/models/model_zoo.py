"""Model zoo: one uniform interface over the ported architecture families.

``build_model(cfg)`` returns a ``Model`` with:
  init(seed=0, device=None)             -> param tree (the JAX layout)
  loss(params, batch, **opts)           -> (scalar, metrics)  [train step body]
  prefill(params, cache, batch)         -> (logits (B, 1, V), cache, len)
  prefill_chunk(params, cache, tokens, start, lengths=, write_mask=)
                                        -> (logits (B, S, V), cache)
  decode_step(params, cache, tok, pos)  -> (logits (B, 1, V), cache)
  init_cache(params, batch, max_len, dtype, device=None)
  init_paged_cache(params, n_pages, page_size, dtype, device=None), None
                                           for the recurrent families and encdec
  encode(params, frames)                -> encoder memory, encdec only (None
                                           for the others)
Every family of the JAX package: dense, MoE, VLM, SSM, hybrid and encdec.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    # the whole prompt in one call: (params, cache, {"tokens"[, "lengths"]})
    prefill: Callable
    prefill_chunk: Callable
    decode_step: Callable
    init_cache: Callable
    # the paged serving cache (page pools; the caller adds block tables);
    # None where the layout does not apply (the recurrent families, encdec)
    init_paged_cache: Optional[Callable]
    # encdec only: (params, frames) -> encoder memory, which the slot pool's
    # admission installs into the slot's cache before any prefill_chunk
    encode: Optional[Callable] = None


def resolve_attn_mode(model: Model, attn_mode) -> Model:
    """Rebuild the model with an attention-mode override (no-op when the
    override is unset or already active)."""
    if attn_mode and attn_mode != model.cfg.attn_mode:
        model = build_model(model.cfg.with_(attn_mode=attn_mode))
    return model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in transformer.FAMILIES + ("encdec",):
        raise ValueError(f"unknown family {cfg.family!r}")
    mod = encdec if cfg.family == "encdec" else transformer

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mod.init(gen, cfg, dev)

    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=init,
            loss=lambda p, b, **kw: encdec.loss(p, b, cfg, **kw),
            prefill=lambda p, c, b: encdec.prefill(p, c, b, cfg),
            prefill_chunk=lambda p, c, t, start, **kw: encdec.prefill_chunk(
                p, c, t, start, cfg, **kw),
            decode_step=lambda p, c, t, pos, **kw: encdec.decode_step(
                p, c, t, pos, cfg, **kw),
            init_cache=lambda p, batch, max_len, dtype, device=None:
                encdec.init_cache(p, cfg, batch, max_len, dtype, resolve_device(device)),
            init_paged_cache=None,
            encode=lambda p, frames: encdec.encode(p, frames, cfg, remat="none"),
        )
    return Model(
        cfg=cfg,
        init=init,
        loss=lambda p, b, **kw: transformer.lm_loss(p, b, cfg, **kw),
        prefill=lambda p, c, b: transformer.prefill(
            p, c, b["tokens"], cfg, lengths=b.get("lengths")),
        prefill_chunk=lambda p, c, t, start, **kw: transformer.prefill_chunk(
            p, c, t, start, cfg, **kw),
        decode_step=lambda p, c, t, pos, **kw: transformer.decode_step(
            p, c, t, pos, cfg, **kw),
        init_cache=lambda p, batch, max_len, dtype, device=None:
            transformer.init_cache(p, cfg, batch, max_len, dtype,
                                   resolve_device(device)),
        init_paged_cache=(
            (lambda p, n_pages, page_size, dtype, device=None:
             transformer.init_paged_cache(p, cfg, n_pages, page_size, dtype,
                                          resolve_device(device)))
            if cfg.family in transformer.ATTENTION_FAMILIES else None),
    )
