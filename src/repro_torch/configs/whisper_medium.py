"""Whisper-medium: enc-dec, conv frontend STUB (precomputed frame embeds).
[arXiv:2212.04356].  24 encoder + 24 decoder layers; rope stands in for the
learned absolute positions (DESIGN.md §7)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=4096, vocab=51865, act="gelu", mlp_gated=False,
    norm="ln", rope_theta=10000.0, max_seq=32768, tie_embeddings=True,
    frontend_dim=80, frontend_len=1500,
)
