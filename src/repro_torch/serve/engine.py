"""Serving engine: prefill the prompt, then decode.

The PyTorch counterpart of the lockstep ``generate`` of
``repro.serve.engine``.  As in the JAX engine, the attention families'
prompt goes through ``prefill_chunk`` as one chunk (the attend-at-offset
primitive the slot pool admits with) and the recurrent families' and
encdec's through ``model.prefill`` (``build_prefill``: the parallel or the
sequential build; encdec's encodes ``batch["frames"]`` first); each new
token goes through ``decode_step``.

``ServeConfig.decode_loop``: ``"scan"`` and ``"host"`` run the same Python
loop.  Its body never reads the device (no ``.item()``, ``.cpu()`` or
``.tolist()``), so the host queues the steps ahead of the card; the
tokens come back once, at the end.  Capturing the step as a CUDA graph is
later work.  Greedy decode (``temperature == 0``) never draws from the
generator.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import resolve_attn_mode
from repro_torch.obs.profile import block_until_ready
from repro_torch.obs.trace import NULL_TRACER

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


def build_prefill(model):
    """(params, cache, batch) -> (logits (B, 1, V), cache, len): the whole
    prompt through ``model.prefill``, the recurrent families' and encdec's
    prompt path."""
    return model.prefill


def build_encode(model):
    """(params, frames (B, T, frontend_dim)) -> encoder memory (B, T, dm):
    the slot pool's encdec admission encodes its admitted rows with it and
    installs each row's memory before the first chunk."""
    if model.encode is None:
        raise ValueError(f"family {model.cfg.family!r} has no encoder")
    return model.encode


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
             generator: torch.Generator | None = None, device=None, tracer=None,
             profile=None):
    """Prefill the prompt then decode ``max_new`` tokens; returns (B,
    max_new) int32 on ``device`` (None = the card).

    ``batch["tokens"]`` (B, S) int; optional ``batch["lengths"]`` (B,)
    bounds ragged prompts; encdec takes ``batch["frames"]`` (B, T,
    frontend_dim).  ``params`` must live on ``device``.
    ``tracer``: an optional ``obs.trace.Tracer``, which records the decode
    loop as one span named as the JAX package's (``decode_scan`` or
    ``decode_host_loop``).
    ``profile``: an optional ``obs.profile.CostBook``.  When it is enabled,
    the JAX engine's executables are counted before their dispatch and
    joined with their measured walls, under its names: the attention
    families' ``prefill_chunk[w=S]`` (counted by one more call with the
    writes gated off), and the decode loop, as ``decode_loop[steps=N]``
    (one ``decode_step`` with its writes gated off, times N) under
    ``decode_loop="scan"`` or ``serve_step`` (one step; its wall the
    loop's mean a step) under ``"host"``.  The waits for the card that a
    wall needs happen only with a book; the tokens are the same.
    """
    if profile is not None and not profile.enabled:
        profile = None
    dev = resolve_device(device)
    model = resolve_attn_mode(model, scfg.attn_mode)
    if scfg.decode_loop not in ("scan", "host"):
        raise ValueError(f"decode_loop {scfg.decode_loop!r} not in ('scan', 'host')")
    toks = torch.as_tensor(batch["tokens"], dtype=I32, device=dev)
    B, S = toks.shape
    cache = model.init_cache(params, B, scfg.max_len, scfg.cache_dtype,
                             device=dev)
    lens = batch.get("lengths")
    if model.init_paged_cache is not None:
        # attention families: the slot pool's admission primitive, so solo
        # outputs match pooled serving for every cache dtype
        nv = (torch.as_tensor(lens, dtype=I32, device=dev) if lens is not None
              else torch.full((B,), S, dtype=I32, device=dev))
        pc = build_prefill_chunk(model, scfg, S)
        start = torch.zeros((B,), dtype=I32, device=dev)
        if profile is None:
            last, cache = pc(params, cache, toks, start, nv,
                             torch.ones((B,), dtype=torch.bool, device=dev))
        else:
            name = f"prefill_chunk[w={S}]"
            profile.record(name, pc, params, cache, toks, start, nv,
                           torch.zeros((B,), dtype=torch.bool, device=dev))
            t_pc = time.perf_counter()
            last, cache = pc(params, cache, toks, start, nv,
                             torch.ones((B,), dtype=torch.bool, device=dev))
            block_until_ready(dev)
            profile.observe(name, time.perf_counter() - t_pc)
    else:
        pb = {"tokens": toks}
        if lens is not None:
            pb["lengths"] = torch.as_tensor(lens, dtype=I32, device=dev)
        if batch.get("frames") is not None:
            pb["frames"] = torch.as_tensor(batch["frames"], device=dev)
        logits, cache, _ = build_prefill(model)(params, cache, pb)
        last = logits[:, -1, :]
    sample = lambda lg: _sample(lg, generator, scfg.temperature,  # noqa: E731
                                scfg.top_k, scfg.top_p).to(I32)[:, None]
    tok = sample(last)
    out = [tok]
    scan = scfg.decode_loop == "scan"
    name = f"decode_loop[steps={max_new - 1}]" if scan else "serve_step"
    if profile is not None and max_new > 1 and name not in profile:
        # one step with its writes gated off: the cache keeps its content
        off = torch.zeros((B,), dtype=torch.bool, device=dev)
        profile.record(name, lambda p, c, t: model.decode_step(p, c, t, S, write_mask=off),
                       params, cache, tok, trip_factor=max_new - 1 if scan else 1)
    span = "decode_scan" if scan else "decode_host_loop"
    with (tracer or NULL_TRACER).span(span, steps=max_new - 1):
        t_loop = time.perf_counter()
        for i in range(max_new - 1):
            logits, cache = model.decode_step(params, cache, tok, S + i)
            tok = sample(logits[:, -1, :])
            out.append(tok)
        if profile is not None and max_new > 1:
            block_until_ready(dev)
            wall = time.perf_counter() - t_loop
            profile.observe(name, wall if scan else wall / (max_new - 1))
    return torch.cat(out, dim=1)
