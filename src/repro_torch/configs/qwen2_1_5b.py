"""Qwen2-1.5B: GQA (kv=2), QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936, act="silu", mlp_gated=True, norm="rms",
    qkv_bias=True, rope_theta=1e6, max_seq=131072, tie_embeddings=True,
)
