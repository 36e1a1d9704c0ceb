"""OLMo-1B: non-parametric LayerNorm, tied embeddings. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=8192, vocab=50304, act="silu", mlp_gated=True, norm="np_ln",
    rope_theta=10000.0, max_seq=2048, tie_embeddings=True,
)
