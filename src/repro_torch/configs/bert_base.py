"""BERT-base proxy — the paper's own evaluation model (Tables 1-2).
Used by the accuracy benchmarks (bidirectional forward + pooling head)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-base", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab=30522, act="gelu", mlp_gated=False, norm="ln",
    rope_theta=10000.0, max_seq=512, tie_embeddings=True,
)
