"""The roofline bound of a counted cost, and the analytic model FLOPs.

The PyTorch counterpart of ``repro.roofline.analysis``, against the H100's
peaks (``roofline/hw.py``):

  compute    = (flops - flops_fp32) / PEAK_FLOPS_BF16
               + flops_fp32 / PEAK_FLOPS_FP32
  memory     = bytes / HBM_BW
  collective = collective bytes / NVLINK_BW

``flops_fp32`` is the share of ``flops`` that runs outside the tensor
cores: the Hyft kernels' fp32 FMAs and any fp32 product.  Counting those at
the bf16 tensor-core peak would loosen their bound 15x; with
``flops_fp32 = 0`` the compute term is the JAX module's.  The JAX module
reads its collective bytes from the post-SPMD HLO text; eager PyTorch has
none, so the caller passes them: the dry-run counts the per-device operand
bytes of each collective a sharded step issues, by kind
(``launch/dryrun_meter.py``), the JAX module's convention.  Without them
(one card) the term is 0.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), with N the (active)
parameter count, as in the JAX module.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_global: float
    hlo_bytes_global: float
    coll_bytes_device: float
    coll_breakdown: dict
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The perfectly overlapped bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / step_time_s: 1.0 = purely compute-bound."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def to_dict(self):
        return {**dataclasses.asdict(self),
                "dominant": self.dominant,
                "step_time_s": self.step_time_s,
                "roofline_fraction": self.roofline_fraction}


def analyze(cost: dict, chips: int = 1, collectives: dict | None = None) -> Roofline:
    """The bound of ``cost`` (``flops``, ``bytes accessed``, optional
    ``flops_fp32``; the JAX cost analysis' keys) on ``chips`` cards, each
    running the counted program.  ``collectives`` is {kind: per-device
    bytes}: the operand bytes of each all-reduce, all-gather,
    reduce-scatter, all-to-all or permute a card issues, summed by kind;
    their total over the NVLink rate is the collective term.  The JAX
    module's ``trip_factor`` (a scan body's trips) has no counterpart:
    eager execution counts every layer."""
    flops_dev = float(cost.get("flops", 0.0))
    fp32_dev = float(cost.get("flops_fp32", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll = {k: float(v) for k, v in (collectives or {}).items()}
    coll_dev = float(sum(coll.values()))
    return Roofline(
        compute_s=((flops_dev - fp32_dev) / hw.PEAK_FLOPS_BF16
                   + fp32_dev / hw.PEAK_FLOPS_FP32),
        memory_s=bytes_dev / hw.HBM_BW,
        collective_s=coll_dev / hw.NVLINK_BW,
        hlo_flops_global=flops_dev * chips,
        hlo_bytes_global=bytes_dev * chips,
        coll_bytes_device=coll_dev,
        coll_breakdown=coll,
        chips=chips,
    )


def scan_trip_factor(cfg, shape_kind: str, seq: int, global_batch: int,
                     microbatch: int) -> float:
    """The JAX module's product of the statically known scan trip counts
    (XLA counts a scan body once).  Kept for parity with it; the port's
    counts need no such factor, since eager execution runs every body.

    train: layers (forward and backward bodies both scale with L) x
    gradient-accumulation microbatch trips.  prefill/decode: layers; the
    SSM, hybrid and encdec sequential prefill also scans over tokens.
    """
    layers = cfg.n_layers + (cfg.enc_layers if shape_kind == "train" else 0)
    if shape_kind == "train":
        mb_trips = (global_batch // microbatch) if microbatch else 1
        return float(max(layers, 1) * max(mb_trips, 1))
    if shape_kind == "prefill":
        sequential = (cfg.family in ("ssm", "hybrid", "encdec")
                      and not cfg.parallel_prefill)
        token_scan = seq if sequential else 1
        return float(max(cfg.n_layers, 1) * token_scan)
    return float(max(cfg.n_layers, 1))  # decode


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count from the config (embedding included once)."""
    dm, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    attn = 0
    if cfg.n_heads:
        attn = dm * cfg.n_heads * cfg.d_head + 2 * dm * cfg.n_kv_heads * cfg.d_head \
            + cfg.n_heads * cfg.d_head * dm
    mlp = dm * dff * (3 if cfg.mlp_gated else 2) if dff else 0
    ssm = 0
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * dm
        H = d_inner // cfg.ssm_head_dim
        proj = dm * (2 * d_inner + 2 * cfg.ssm_state + H)
        ssm = proj + d_inner * dm + cfg.ssm_conv * (d_inner + 2 * cfg.ssm_state)
    emb = V * dm * (1 if cfg.tie_embeddings else 2)

    if cfg.family in ("dense", "vlm"):
        core = cfg.n_layers * (attn + mlp)
    elif cfg.family == "moe":
        e = cfg.moe_top_k if active_only else cfg.n_experts
        core = cfg.n_layers * (attn + mlp * e + dm * cfg.n_experts)
    elif cfg.family == "ssm":
        core = cfg.n_layers * ssm
    elif cfg.family == "hybrid":
        # the shared attention block's parameters count once; its
        # activations count once an invocation
        core = cfg.n_layers * ssm + attn + mlp
        if active_only:
            core = cfg.n_layers * ssm + (cfg.n_layers // cfg.attn_every) * (attn + mlp)
    elif cfg.family == "encdec":
        core = cfg.n_layers * (2 * attn + mlp) + cfg.enc_layers * (attn + mlp)
    else:
        core = 0
    return core + emb


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6*N*D for train, 2*N*D for inference (active params for MoE)."""
    n = count_params(cfg, active_only=True)
    return (6.0 if kind == "train" else 2.0) * n * tokens
