"""Mamba2-370M: pure SSD (attention/softmax-free). [arXiv:2405.21060]
The paper's softmax technique is INAPPLICABLE here (DESIGN.md §5); the arch
exercises sharding/remat/long-context decode."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, d_ff=0, vocab=50280, norm="rms",
    rope_theta=None, max_seq=1048576, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=64,
    subquadratic=True,
)
