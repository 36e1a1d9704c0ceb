"""Config dataclasses: model, train and serve (own copies of
``repro.configs.base``).

The fields and defaults are those of the JAX package, so a configuration
means the same thing on both sides; ``pdtype``/``cdtype`` give torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab: int = 0

    act: str = "silu"
    mlp_gated: bool = True
    norm: str = "rms"                # rms | ln | np_ln
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    max_seq: int = 131072
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_group: int = 512

    # SSM (Mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    attn_every: int = 0

    # enc-dec / stub frontends
    enc_layers: int = 0
    frontend_dim: int = 0
    frontend_len: int = 0

    # the paper's technique + execution knobs
    softmax_impl: str = "hyft32"
    attn_mode: str = "unfused"       # unfused | chunked | kernel
    attn_chunk: int = 512

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    subquadratic: bool = False
    parallel_prefill: bool = False

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int = 0              # 0 = no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # adamw | sgd | adafactor
    remat: str = "full"              # none | full | dots
    z_loss: float = 1e-4
    moe_aux_weight: float = 0.01
    grad_compression: str = "none"   # none | int8
    master_dtype: str = "float32"
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    # attention-mode override (None = use the model config's attn_mode);
    # "kernel" trains through the fused CUDA forward and backward kernels
    attn_mode: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving knobs the lockstep ``generate`` path reads.  The
    scheduler, paged, speculative and observability fields of the JAX
    ``ServeConfig`` come with the slices that port those layers."""

    max_len: int = 256
    # KV-cache storage: a dtype name, or "fp2fx8" = int8 FP2FX raws +
    # per-(head, position) fp32 scale (dequant fused into the kernels)
    cache_dtype: str = "bfloat16"
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # attention-mode override (None = use the model config's attn_mode)
    attn_mode: Optional[str] = None
    # "scan" and "host" both run a loop that reads nothing back from the
    # device until the end
    decode_loop: str = "scan"
