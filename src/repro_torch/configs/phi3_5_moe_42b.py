"""Phi-3.5-MoE (42B total / 6.6B active): 16 experts top-2, GQA.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab=32064, act="silu", mlp_gated=True, norm="ln",
    rope_theta=10000.0, max_seq=131072, param_dtype="bfloat16",
    n_experts=16, moe_top_k=2,
)
