"""Zamba2-7B: Mamba2 backbone + SHARED attention block every 6 layers.
[arXiv:2411.15242].  The shared block is one parameter set reused at every
invocation (the paper adds per-invocation LoRA deltas; omitted — noted in
DESIGN.md §7)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14336, vocab=32000, act="silu", mlp_gated=True, norm="rms",
    rope_theta=10000.0, max_seq=1048576,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=64,
    attn_every=6, subquadratic=True, param_dtype="bfloat16",
)
