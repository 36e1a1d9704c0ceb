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
                                           for the recurrent families
The dense, MoE, SSM and hybrid families so far (ROADMAP queue 1, the other
families).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


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
    # None where the layout does not apply (the recurrent families)
    init_paged_cache: Optional[Callable]


def resolve_attn_mode(model: Model, attn_mode) -> Model:
    """Rebuild the model with an attention-mode override (no-op when the
    override is unset or already active)."""
    if attn_mode and attn_mode != model.cfg.attn_mode:
        model = build_model(model.cfg.with_(attn_mode=attn_mode))
    return model


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP queue 1, the other families")

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init(gen, cfg, dev)

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
