"""Deterministic synthetic LM batches (own copy of ``repro.data.synthetic``).

Batches are keyed by ``(seed, step, host_id)``, so a restarted job resumes
bit-identically and each data-parallel host makes only its own shard of the
global batch.  The token stream is the JAX package's order-2 Markov chain
(``next = (shift1[prev] + prev) % vocab``, replaced by a uniform token with
probability 0.15), with targets shifted by one.  The random stream is
``torch.Generator``'s on the CPU, so it is the same on every device but
not the JAX package's: tests that compare the two hand both sides the same
tokens.
"""
from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _generator(*vals: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (an FNV-1a fold)."""
    h = 0xCBF29CE484222325
    for v in vals:
        h = ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(h >> 1)


def lm_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Markov-chain tokens: the local shard of the global batch at ``step``.
    Returns int32 ``tokens`` and ``targets`` (B, S) and an fp32 ``mask``."""
    per_host = cfg.global_batch // cfg.n_hosts
    gen = _generator(cfg.seed, step, cfg.host_id)
    # fixed transition structure derived from the seed only
    shift1 = torch.randint(0, cfg.vocab, (cfg.vocab,),
                           generator=torch.Generator().manual_seed(cfg.seed + 7919))
    t0 = torch.randint(0, cfg.vocab, (per_host,), generator=gen)
    noise = torch.rand((per_host, cfg.seq_len + 1), generator=gen) < 0.15
    rand_tok = torch.randint(0, cfg.vocab, (per_host, cfg.seq_len + 1), generator=gen)
    toks = [t0]
    for i in range(cfg.seq_len + 1):
        prev = toks[-1]
        toks.append(torch.where(noise[:, i], rand_tok[:, i],
                                (shift1[prev] + prev) % cfg.vocab))
    toks = torch.stack(toks, dim=1).to(I32)                 # (B, S + 2)
    tokens, targets = toks[:, :cfg.seq_len], toks[:, 1:cfg.seq_len + 1]
    return {"tokens": tokens.to(device), "targets": targets.to(device),
            "mask": torch.ones(targets.shape, dtype=F32, device=device)}
