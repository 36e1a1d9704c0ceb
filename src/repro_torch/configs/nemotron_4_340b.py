"""Nemotron-4-340B: GQA + squared-ReLU (ungated). [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73728, vocab=256000, act="squared_relu", mlp_gated=False, norm="ln",
    rope_theta=10000.0, max_seq=4096, param_dtype="bfloat16",
)
