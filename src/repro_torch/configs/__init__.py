"""Config registry: ``get_config(arch_id)`` + smoke-test reduction."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ServeConfig, TrainConfig  # noqa: F401

# the architectures the port serves so far; the others of the JAX package
# come with the slices that port their families (ROADMAP queue 1 item 9)
ARCHS = {
    "qwen2-1.5b": "qwen2_1_5b",
}


def get_config(name: str) -> ModelConfig:
    try:
        mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet; have {sorted(ARCHS)}") from None
    return mod.CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers (the same
    reduction as the JAX package's, so smoke configs agree)."""
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, heads) if cfg.n_kv_heads else 0
    if kv and heads % kv:
        kv = 1
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64, n_heads=heads, n_kv_heads=kv,
        d_head=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        max_seq=256,
    )
    if cfg.n_experts:
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["moe_group"] = 16
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    if cfg.frontend_dim:
        kw.update(frontend_dim=16, frontend_len=8)
    kw["param_dtype"] = "float32"
    return cfg.with_(**kw)
