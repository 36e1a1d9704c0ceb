"""Config dataclasses: model, train, serve and mesh (own copies of
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
    """The serving knobs of the lockstep ``generate`` path, of the
    slot-pool scheduler (``repro_torch.serve.scheduler``) and of its
    speculative mode (``repro_torch.serve.spec``), with the JAX defaults.
    ``seq_parallel`` is the JAX field, read by no serving path of either
    package: the sequence-parallel decode is
    ``models.attention.sp_decode_attention``, called over a process group."""

    max_len: int = 256
    # KV-cache storage: a dtype name, or "fp2fx8" = int8 FP2FX raws +
    # per-(head, position) fp32 scale (dequant fused into the kernels)
    cache_dtype: str = "bfloat16"
    seq_parallel: bool = False       # sequence-parallel decode attention
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # attention-mode override (None = use the model config's attn_mode)
    attn_mode: Optional[str] = None
    # "scan" and "host" both run a loop that reads nothing back from the
    # device until the end
    decode_loop: str = "scan"
    # --- continuous batching (repro_torch/serve/scheduler.py) ---
    # per-sequence stop token: a slot that emits it is freed on the device
    # (None = run every request to its own max_new)
    eos_id: Optional[int] = None
    # slot-pool size: the fixed batch dimension of the serving KV cache
    n_slots: int = 8
    # "continuous" = admit queued requests into freed slots mid-decode;
    # "lockstep" = drain the whole pool before admitting the next group;
    # "spec" = continuous admission + speculative decode bursts
    scheduler: str = "lockstep"
    # masked decode steps per burst between host admission checks
    decode_burst: int = 8
    # --- paged KV cache + prefix caching (repro_torch/serve/kvpool.py) ---
    # "dense" = one (max_len,) KV stripe per slot; "paged" = fixed-size
    # pages from a global pool with per-slot block tables (decode appends
    # pages on demand, exhaustion preempts the latest arrival)
    kv_layout: str = "dense"
    # tokens per KV page (paged layout)
    page_size: int = 16
    # usable pages in the pool (0 = auto: n_slots * ceil(max_len/page_size))
    n_pages: int = 0
    # radix-trie prefix cache: admissions sharing a cached prompt prefix
    # reuse its pages and skip prefill for the cached tokens (paged only)
    prefix_cache: bool = False
    # --- chunked + packed prefill ---
    # max prompt tokens written per prefill_chunk call (0 = whole prompt):
    # long prompts split into chunks scheduled between decode bursts
    prefill_chunk: int = 0
    # pack every prefilling slot into one chunk call; False = one prompt at
    # a time in arrival order
    pack_prefill: bool = True
    # --- speculative decoding (repro_torch/serve/spec.py) ---
    # drafter for scheduler="spec": "ngram" = deterministic prompt-lookup
    # self-drafting (no second model: greedy outputs provably unchanged);
    # "model" = a small zoo model sharing the slot pool (inject it via
    # SlotPoolEngine(draft=(model, params)))
    spec_mode: str = "ngram"
    # draft tokens verified per slot per spec step (the verify chunk is
    # draft_k + 1 lanes: [last_token, draft_1..draft_k])
    draft_k: int = 4
    # longest trailing n-gram the prompt-lookup drafter matches
    ngram_max: int = 3
    # zoo arch name for spec_mode="model" launched from the CLI (random
    # init unless params are injected: a demo drafter, not a good one)
    draft_model: Optional[str] = None
    # --- serving robustness ---
    # recompute page-pool/radix-trie refcounts from live slots + trie edges
    # after every admission / finish / preemption checkpoint
    # (kvpool.AuditError on drift)
    audit: bool = False
    # bounded admission queue: an arrival that would push the waiting queue
    # past this many requests fails with "queue_full" (0 = unbounded;
    # requeues from preemption and quarantine are exempt)
    max_queue: int = 0
    # per-request requeue budget (preemptions + numeric quarantines): one
    # more requeue fails with "retries_exhausted" and the partial tokens
    max_retries: int = 32
    # --- hybrid-format telemetry (repro_torch/obs/numerics.py) ---
    # per-burst device-side numeric stats (softmax-input exponent range
    # before and after the max subtraction; fp2fx8 scale histogram and int8
    # saturation of the cache after the burst), read back once per burst
    telemetry: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The production mesh's geometry (``launch/mesh.py``)."""
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes
