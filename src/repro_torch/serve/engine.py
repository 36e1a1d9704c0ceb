"""Serving engine: prefill the prompt as one chunk, then decode.

The PyTorch counterpart of the lockstep ``generate`` of
``repro.serve.engine``.  The prompt goes through ``prefill_chunk`` (the same
attend-at-offset primitive the JAX engine uses for attention families) and
each new token through ``decode_step``.

``ServeConfig.decode_loop``: ``"scan"`` and ``"host"`` run the same Python
loop.  Its body never reads the device (no ``.item()``, ``.cpu()`` or
``.tolist()``), so the host queues the steps ahead of the card; the
tokens come back once, at the end.  Capturing the step as a CUDA graph is
later work.  Greedy decode (``temperature == 0``) never draws from the
generator.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import resolve_attn_mode

I32 = torch.int32


def _sample(logits, generator, temperature, top_k: int = 0,
            top_p: float = 1.0):
    """logits (B, V) -> token ids (B,).  Greedy (argmax, ties to the first
    index) when temperature == 0.

    ``top_k`` (0 = off) keeps the k highest logits; ``top_p`` (1.0 = off)
    keeps the smallest set of tokens whose mass reaches p (the top token
    always survives).  Both filter the temperature-scaled logits, top-k
    first, then the nucleus.
    """
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    V = logits.shape[-1]
    use_k = bool(top_k) and 0 < top_k < V
    if use_k or top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            logits = torch.where(logits < srt[..., top_k - 1:top_k],
                                 -torch.inf, logits)
            ranks = torch.arange(V, device=logits.device)
            srt = torch.where(ranks < top_k, srt, -torch.inf)
        if top_p < 1.0:
            prob = torch.softmax(srt, dim=-1)
            keep = (torch.cumsum(prob, dim=-1) - prob) < top_p
            thresh = torch.amin(torch.where(keep, srt, torch.inf), dim=-1,
                                keepdim=True)
            logits = torch.where(logits < thresh, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def build_prefill_chunk(model, scfg: ServeConfig, width: int):
    """(params, cache, toks (B, width), start (B,), n_valid (B,), gate (B,))
    -> (last_logits (B, V) fp32, cache).

    One ``model.prefill_chunk`` call writes row ``b``'s first
    ``n_valid[b]`` tokens at ``start[b] ..`` and attends each against the
    cached history; the returned logits are each row's lane
    ``n_valid - 1``.  ``width`` is the chunk width the call expects.
    """
    def chunk(params, cache, toks, start, n_valid, gate):
        if toks.shape[1] != width:
            raise ValueError(f"chunk width {toks.shape[1]} != {width}")
        logits, cache = model.prefill_chunk(params, cache, toks, start,
                                            lengths=n_valid, write_mask=gate)
        pick = torch.clamp(n_valid.to(torch.long) - 1, min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), pick]
        return last.float(), cache
    return chunk


def generate(model, params, batch: dict, scfg: ServeConfig, max_new: int,
             generator: torch.Generator | None = None, device=None):
    """Prefill the prompt then decode ``max_new`` tokens; returns (B,
    max_new) int32 on ``device`` (None = the card).

    ``batch["tokens"]`` (B, S) int; optional ``batch["lengths"]`` (B,)
    bounds ragged prompts.  ``params`` must live on ``device``.
    """
    dev = resolve_device(device)
    model = resolve_attn_mode(model, scfg.attn_mode)
    if scfg.decode_loop not in ("scan", "host"):
        raise ValueError(f"decode_loop {scfg.decode_loop!r} not in ('scan', 'host')")
    toks = torch.as_tensor(batch["tokens"], dtype=I32, device=dev)
    B, S = toks.shape
    cache = model.init_cache(params, B, scfg.max_len, scfg.cache_dtype,
                             device=dev)
    lens = batch.get("lengths")
    nv = (torch.as_tensor(lens, dtype=I32, device=dev) if lens is not None
          else torch.full((B,), S, dtype=I32, device=dev))
    last, cache = build_prefill_chunk(model, scfg, S)(
        params, cache, toks, torch.zeros((B,), dtype=I32, device=dev), nv,
        torch.ones((B,), dtype=torch.bool, device=dev))
    sample = lambda lg: _sample(lg, generator, scfg.temperature,  # noqa: E731
                                scfg.top_k, scfg.top_p).to(I32)[:, None]
    tok = sample(last)
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, S + i)
        tok = sample(logits[:, -1, :])
        out.append(tok)
    return torch.cat(out, dim=1)
