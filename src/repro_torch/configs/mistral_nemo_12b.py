"""Mistral-Nemo-Base-2407 (12B). [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072, act="silu", mlp_gated=True, norm="rms",
    rope_theta=1e6, max_seq=131072, param_dtype="bfloat16",
)
