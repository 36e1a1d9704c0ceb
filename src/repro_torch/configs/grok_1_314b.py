"""Grok-1 (314B MoE): 8 experts top-2, GQA. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072, act="gelu", mlp_gated=True, norm="rms",
    rope_theta=10000.0, max_seq=8192, param_dtype="bfloat16",
    n_experts=8, moe_top_k=2,
)
