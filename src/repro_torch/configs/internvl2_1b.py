"""InternVL2-1B: ViT frontend (STUB patch embeddings) + 24L LM backbone.
[arXiv:2404.16821; hf].  frontend_len patches of frontend_dim arrive
precomputed per the assignment; a single projection maps them to d_model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab=151655, act="silu", mlp_gated=True, norm="rms",
    qkv_bias=True, rope_theta=1e6, max_seq=32768, tie_embeddings=True,
    frontend_dim=1024, frontend_len=256,
)
