"""The assigned input-shape cells and their input specs per (arch, shape).

Own copy of ``repro.configs.shapes``:

  train_4k     seq 4096,   global_batch 256   -> the train step
  prefill_32k  seq 32768,  global_batch 32    -> prefill (serve)
  decode_32k   seq 32768,  global_batch 128   -> one decode step (1 new
                                                 token, KV/state cache of seq)
  long_500k    seq 524288, global_batch 1     -> one decode step; ONLY for
               the sub-quadratic archs (ssm/hybrid), skipped and recorded
               for the pure full-attention ones.

``input_specs`` returns ``(shape, dtype)`` pairs, the JAX package's
``ShapeDtypeStruct``s (int32 tokens, fp32 masks, frames and patches); no
tensor is made.  The decode cache's specs come from the model's
``init_cache`` on ``device="meta"`` in the dry-run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token decode requires "
                       "a sub-quadratic path (DESIGN.md §5)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The model inputs of one cell as {name: (shape, dtype)} (nothing is
    allocated)."""
    B, S = shape.batch, shape.seq
    frames = ((B, cfg.frontend_len, cfg.frontend_dim), F32)
    if shape.kind == "train":
        s_txt = S - cfg.frontend_len if cfg.family == "vlm" else S
        text = {"tokens": ((B, s_txt), I32), "targets": ((B, s_txt), I32),
                "mask": ((B, s_txt), F32)}
        if cfg.family == "encdec":
            return {"frames": frames, **text}
        if cfg.family == "vlm":
            return {"embeds": frames, **text}
        return text
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": frames, "tokens": ((B, S), I32)}
        if cfg.family == "vlm":
            return {"embeds": frames, "tokens": ((B, S - cfg.frontend_len), I32)}
        return {"tokens": ((B, S), I32)}
    # decode: one new token against a cache of length S
    return {"tokens": ((B, 1), I32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec,
                   generator: torch.Generator, device=None) -> dict:
    """A small concrete batch matching ``input_specs`` (smoke tests), drawn
    from ``generator`` in the order of the specs: int32 tokens uniform in
    [0, vocab), fp32 inputs standard normal, the mask all ones."""
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype == I32:
            out[k] = torch.randint(0, max(cfg.vocab, 2), shp, generator=generator,
                                   dtype=I32, device=device)
        else:
            out[k] = torch.randn(shp, generator=generator, dtype=F32, device=device)
    if "mask" in out:
        out["mask"] = torch.ones_like(out["mask"])
    return out
