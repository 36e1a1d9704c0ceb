#!/usr/bin/env python3
"""Time the PyTorch port's split-K or flash attention of one source tree on the card.

    python3 scripts/torch_splitk_ab.py [--tree DIR] [--label NAME] [--kernels-only]
    python3 scripts/torch_splitk_ab.py --flash [--tree DIR] [--label NAME] [--save DIR]
    python3 scripts/torch_splitk_ab.py --softmax [--tree DIR] [--label NAME]
    python3 scripts/torch_splitk_ab.py --compare A.pt B.pt

``--tree`` is the root of a checkout of this repository (default: the one
holding this script); its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``.  To compare two commits on one card,
unpack the other into a directory that git ignores (``git archive``) and
run parent, change, change, parent in one call.

Prints one JSON object per line, each naming the card (``nvidia-smi``
name and power limit):

* ``kernels``: at the main path's shapes (qwen2-1.5b, B 4, Hq 12, Hkv 2,
  D 128, HYFT16, splits of 256), the contiguous decode (Sk 1057, rotating
  over 28 caches as a decode step does) and the causal prompt (Sq 1024
  over 1057 keys), fp32 and fp2fx8; and the paged decode and the paged
  chunk of 256 lanes from key 768 at the continuous-serving shape (8
  slots, 128 pages of 16); each at D 128 (Hkv 2) and again at D 64 (bert-base's
  12 / 12 heads, a GQA group of 1).  Per variant: ``event_ms``, CUDA events per
  call over many calls (the wrapper's host time included), ``device_ms``,
  the device time per call of every kernel the call launched
  (torch.profiler), and a sha256 of the output of the first call, so that
  two trees can be compared bit for bit: on a tree whose contiguous
  kernels return per-split stats, the call is that kernel followed by the
  torch ``_splitk_combine``, as its wrappers ran them;
* ``generate``: greedy ``generate`` of qwen2-1.5b at full width (28
  layers, random weights from seed 0, hyft16, kernel mode, bf16 compute,
  fp2fx8 cache, batch 4, prompt 1024) under torch.profiler: the prompt
  alone, then the prompt and 3 decode steps; wall ms, device busy ms and
  launches of each, the decode step's as the difference over 3.

With ``--flash`` it times the training path's flash kernels instead:

* ``flash_kernels``: the forward, dq and dk/dv kernels at the training shape
  (B 4, Hq 12, Hkv 2, S 1024, D 128, causal, fp32 q/k/v, HYFT16) and at
  bert-base's (B 32, 12 / 12 heads, S 128, D 64, non-causal, bf16),
  ``event_ms`` and ``device_ms`` as above;
* ``flash_bits``: on fixed seeded inputs (fp32 and bf16, HYFT16, the
  training shape, and bert-base's at D 64: B 32, 12 / 12 heads, S 128,
  non-causal) a sha256 of the bytes of o, m, l, dq, dk and dv, and of
  ``dq_full``, dq with the causal skip turned off where the tree's wrapper
  has ``skip_masked`` (else its dq, which walks every key), so that two
  trees can be compared bit for bit; the elements of dq that the skip
  moves; dk/dv against the plain versions on the kernel's own stats
  (``grad_errors``); with ``--save`` the tensors go to
  ``DIR/<label>_<dtype>.pt``, and ``--compare`` counts the elements of two
  saved files that differ;
* ``train_step``: qwen2-1.5b at full width through the launcher's functions
  (hyft16, kernel mode, bf16 compute, remat "full", AdamW, 4 x 1024
  tokens): one warm-up step, 3 timed steps (wall ms), then one step under
  torch.profiler: wall, device busy time, and each flash kernel's device
  time and launches.

With ``--softmax`` it times the standalone softmax kernels instead:

* ``softmax_kernels``: ``hyft_softmax_fwd`` under HYFT16 (fp32 scores in,
  fp16 out) at the unfused path's three shapes, training (49,152 x 1024),
  prompt (49,152 x 1057) and decode (48 x 1057), each over as many input
  buffers as it takes to exceed twice the L2, ``event_ms`` and
  ``device_ms`` as above, and a sha256 of the output on a seeded input;
* ``softmax_bwd_kernels``: ``hyft_softmax_bwd`` at the training shape
  (HYFT16, fp16 s from the forward and a seeded fp16 dy) with dz as the
  training step takes it, fp32 (one launch where the tree's wrapper has
  ``out_dtype``, else the kernel's fp16 dz and a cast, as the step ran it
  before), and with fp16 dz; ``device_ms`` counts every kernel of the call,
  the cast included; a sha256 of each dz on a seeded input;
* ``train_step``: the training step above with ``hyft16_kernel`` in the
  unfused mode, each softmax kernel's device time and launches.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

B, HQ, HKV, D = 4, 12, 2, 128
PROMPT, MAX_LEN = 1024, 1057
SLOTS, SERVE_LEN, PAGE, CHUNK = 8, 2048, 16, 256


def _device_ms(torch, fn, calls):
    """Device time per call of every kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in dev)
    return us / calls / 1e3, sum(e.count for e in dev) / calls


def _event_ms(torch, fn, calls):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _kv(torch, gen, fp2fx8, shape):
    from repro_torch.models.attention import fp2fx8_quantize
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if fp2fx8:
        (kr, ks), (vr, vs) = fp2fx8_quantize(k), fp2fx8_quantize(v)
        return kr, vr, ks, vs
    return k, v, None, None


def kernels(torch, card):
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import flash_attention as fa

    if hasattr(fa, "_splitk_attention_cuda"):
        contiguous = fa._splitk_attention_cuda
    else:   # per-split stats, merged by the torch combine
        def contiguous(*args, **kw):
            return fa._splitk_combine(*fa._splitk_tiles_cuda(*args, **kw), kw["cfg"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for d, hkv in ((D, HKV), (64, HQ)):
        _kernels_at(torch, card, fa, contiguous, gen, d, hkv)


def _kernels_at(torch, card, fa, contiguous, gen, D, HKV):
    """The split-K and paged rows of ``kernels`` at head width D over HKV
    KV heads (of HQ query heads)."""
    from repro_torch.core.hyft import HYFT16

    BH, g = B * HKV, HQ // HKV
    kw = dict(cfg=HYFT16, sm_scale=D ** -0.5, hkv=HKV)
    for kind in ("decode", "verify"):
        for dtype in ("float32", "fp2fx8"):
            nbuf = 28 if kind == "decode" else 1
            bufs = [_kv(torch, gen, dtype == "fp2fx8", (BH, MAX_LEN, D)) for _ in range(nbuf)]
            if kind == "decode":
                q3 = torch.randn(BH, g, D, generator=gen, device="cuda")
                mask, sq = torch.ones(B, MAX_LEN, device="cuda"), None
            else:
                q3 = torch.randn(BH, g * PROMPT, D, generator=gen, device="cuda")
                mask = (torch.arange(MAX_LEN, device="cuda")[None, None]
                        <= torch.arange(PROMPT, device="cuda")[None, :, None])
                mask, sq = mask.float().expand(B, PROMPT, MAX_LEN).contiguous(), PROMPT

            def fn(i):
                return contiguous(q3, *bufs[i % nbuf], mask, **kw, bk=256, sq=sq)
            calls = 200 if kind == "decode" else 10
            ms, launches = _device_ms(torch, fn, calls)
            emit({"part": "kernels", "card": card, "kernel": f"hyft_splitk_{kind}",
                  "d_head": D, "kv": dtype, "event_ms": _event_ms(torch, fn, calls),
                  "device_ms": ms,
                  "launches_per_call": launches, "sha256": _sha(fn(0))})
            del bufs
    nb = SERVE_LEN // PAGE
    start = 768     # the paged chunk: 256 lanes from key 768 of each slot
    lanes = (torch.arange(SERVE_LEN, device="cuda")[None, None]
             <= start + torch.arange(CHUNK, device="cuda")[None, :, None])
    lanes = lanes.float().expand(SLOTS, CHUNK, SERVE_LEN).contiguous()
    for kind, sq in (("decode", None), ("verify", CHUNK)):
        for dtype in ("float32", "fp2fx8"):
            nbuf = 28 if sq is None else 1
            pools = []
            for _ in range(nbuf):
                k, v, ks, vs = _kv(torch, gen, dtype == "fp2fx8",
                                   (SLOTS * nb + 1, HKV, PAGE, D))
                bt = (torch.randperm(SLOTS * nb, generator=gen, device="cuda") + 1).int()
                pools.append((k, v, ks, vs, bt.reshape(SLOTS, nb)))
            rows = g if sq is None else g * sq
            q3 = torch.randn(SLOTS * HKV, rows, D, generator=gen, device="cuda")
            mask = torch.ones(SLOTS, SERVE_LEN, device="cuda") if sq is None else lanes

            def fn(i):
                return fa._paged_attention_cuda(q3, *pools[i % nbuf], mask, **kw, sq=sq)
            calls = 200 if sq is None else 10
            ms, launches = _device_ms(torch, fn, calls)
            emit({"part": "kernels", "card": card, "kernel": f"hyft_paged_{kind}",
                  "d_head": D, "kv": dtype, "event_ms": _event_ms(torch, fn, calls),
                  "device_ms": ms,
                  "launches_per_call": launches, "sha256": _sha(fn(0))})
            del pools


def generate_profile(torch, card):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import generate

    cfg = get_config("qwen2-1.5b").with_(softmax_impl="hyft16")
    model = build_model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    scfg = ServeConfig(max_len=MAX_LEN, cache_dtype="fp2fx8", attn_mode="kernel")
    generate(model, params, {"tokens": tokens}, scfg, max_new=2)   # warm-up
    parts = {}
    for name, n in (("prefill", 1), ("prefill+3_decode_steps", 4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(model, params, {"tokens": tokens}, scfg, max_new=n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        parts[name] = {"wall_ms": wall * 1e3, "launches": sum(e.count for e in dev),
                       "device_busy_ms": sum(
                           getattr(e, "self_device_time_total", 0.0) for e in dev) / 1e3}
    a, b = parts["prefill"], parts["prefill+3_decode_steps"]
    step = {k: (b[k] - a[k]) / 3 for k in a}
    emit({"part": "generate", "card": card, "prefill": a, "decode_step": step,
          "decode_step_idle_share": 1.0 - step["device_busy_ms"] / step["wall_ms"],
          "prefill_idle_share": 1.0 - a["device_busy_ms"] / a["wall_ms"]})


FLASH_S = 1024
# (batch, hkv, S, d, causal): the training shape, and bert-base's at D 64
FLASH_SHAPES = {"train": (B, HKV, FLASH_S, D, True), "bert_d64": (32, HQ, 128, 64, False)}


def _flash_operands(torch, gen, dtype, batch=B, hkv=HKV, S=FLASH_S, d=D):
    q3 = torch.randn(batch * HQ, S, d, generator=gen, device="cuda").to(dtype)
    k3 = torch.randn(batch * hkv, S, d, generator=gen, device="cuda").to(dtype)
    v3 = torch.randn(batch * hkv, S, d, generator=gen, device="cuda").to(dtype)
    do3 = torch.randn(batch * HQ, S, d, generator=gen, device="cuda")
    return q3, k3, v3, do3


def flash_kernels(torch, card):
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, (batch, hkv, S, d, causal) in FLASH_SHAPES.items():
        dtype = torch.float32 if shape == "train" else torch.bfloat16
        q3, k3, v3, do3 = _flash_operands(torch, gen, dtype, batch, hkv, S, d)
        kw = dict(cfg=HYFT16, sm_scale=d ** -0.5, causal=causal, bk=128, group=HQ // hkv,
                  q_offset=0)
        o, m, l = fa._flash_fwd_cuda(q3, k3, v3, None, **kw)
        args = (q3, k3, v3, None, do3, fa._flash_delta(do3, o).contiguous(), m, l)
        for name, fn in (
                ("hyft_flash_fwd", lambda i: fa._flash_fwd_cuda(q3, k3, v3, None, **kw)),
                ("hyft_flash_bwd_dq", lambda i: fa._flash_bwd_dq_cuda(*args, **kw)),
                ("hyft_flash_bwd_dkv", lambda i: fa._flash_bwd_dkv_cuda(*args, **kw))):
            ms, launches = _device_ms(torch, fn, 20)
            emit({"part": "flash_kernels", "card": card, "kernel": name, "shape": shape,
                  "event_ms": _event_ms(torch, fn, 20), "device_ms": ms,
                  "launches_per_call": launches})


def flash_bits(torch, card):
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import flash_attention as fa

    for shape, (batch, hkv, S, d, causal) in FLASH_SHAPES.items():
        kw = dict(cfg=HYFT16, sm_scale=d ** -0.5, causal=causal, bk=128, group=HQ // hkv,
                  q_offset=0)
        for dtype in (torch.float32, torch.bfloat16):
            _flash_bits_at(torch, card, fa, kw, dtype, shape, batch, hkv, S, d)


def _flash_bits_at(torch, card, fa, kw, dtype, shape, batch, hkv, S, d):
    """One ``flash_bits`` line: one input type at one shape."""
    from repro_torch.core.hyft import HYFT16

    gen = torch.Generator(device="cuda").manual_seed(11)
    q3, k3, v3, do3 = _flash_operands(torch, gen, dtype, batch, hkv, S, d)
    o, m, l = fa._flash_fwd_cuda(q3, k3, v3, None, **kw)
    args = (q3, k3, v3, None, do3, fa._flash_delta(do3, o).contiguous(), m, l)
    dq = fa._flash_bwd_dq_cuda(*args, **kw)
    dk, dv = fa._flash_bwd_dkv_cuda(*args, **kw)
    if "skip_masked" in inspect.signature(fa._flash_bwd_dq_cuda).parameters:
        dq_full = fa._flash_bwd_dq_cuda(*args, **kw, skip_masked=False)
    else:   # a dq kernel that walks every key
        dq_full = dq
    out = {"o": o, "m": m, "l": l, "dq": dq, "dk": dk, "dv": dv, "dq_full": dq_full}
    gerr = fa.grad_errors((dq, dk, dv), (dq, *fa._flash_bwd_dkv_plain(*args, **kw)),
                          HYFT16)
    emit({"part": "flash_bits", "card": card, "shape": shape,
          "dtype": str(dtype).split(".")[1],
          "sha256": {k: _sha(t) for k, t in out.items()},
          "dq_skip_differing": int((dq != dq_full).sum()),
          "dq_skip_vs_full": fa.grad_errors((dq,), (dq_full,), HYFT16)["dq"],
          "dkv_vs_plain": {k: gerr[k] for k in ("dk", "dv", "dk_max_abs_err",
                                                  "dv_max_abs_err")}})
    if ARGS.save:
        ARGS.save.mkdir(parents=True, exist_ok=True)
        tag = "" if shape == "train" else f"_{shape}"
        torch.save({k: t.cpu() for k, t in out.items()},
                   ARGS.save / f"{ARGS.label.replace('/', '_')}{tag}_{dtype}.pt")


def train_step(torch, card, softmax="hyft16", attn_mode="kernel", kernels="flash_"):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as launch

    run = launch.build(launch.parse_args([
        "--arch", "qwen2-1.5b", "--softmax", softmax, "--attn-mode", attn_mode,
        "--global-batch", str(B), "--seq", str(FLASH_S), "--steps", "8",
        "--remat", "full", "--optimizer", "adamw", "--lr", "1e-3", "--seed", "0"]))
    state, walls = run["state"], []
    for i in range(4):
        batch = run["batch_fn"](i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run["step"](state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    batch = run["batch_fn"](4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = run["step"](state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    emit({"part": "train_step", "card": card, "softmax": softmax, "attn_mode": attn_mode,
          "warmup_ms": walls[0], "step_ms": walls[1:],
          "profiled_wall_ms": wall * 1e3, "device_busy_ms": sum(map(us, dev)) / 1e3,
          "launches": sum(e.count for e in dev),
          "kernels": {e.key[:40]: {"device_ms": us(e) / 1e3, "count": e.count}
                      for e in dev if kernels in e.key}})


L2_BYTES = 50 * 2 ** 20
SOFTMAX_SHAPES = {"train": (B * HQ * FLASH_S, FLASH_S), "prompt": (B * HQ * PROMPT, MAX_LEN),
                  "decode": (B * HQ, MAX_LEN)}


def softmax_kernels(torch, card):
    """Kernel 1 at the unfused path's shapes: rows of causal scores (row r
    keeps its first r % cols + 1 keys, the rest masked), fp32 in, fp16
    out."""
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import hyft_softmax as hs
    from repro_torch.kernels.flash_attention import NEG_BIG

    gen = torch.Generator(device="cuda").manual_seed(13)
    for name, (rows, cols) in SOFTMAX_SHAPES.items():
        nbuf = max(1, -(-2 * L2_BYTES // (rows * cols * 6)))
        keep = torch.arange(rows, device="cuda") % min(cols, PROMPT) + 1
        live = torch.arange(cols, device="cuda")[None] < keep[:, None]
        bufs = [torch.where(live, torch.randn(rows, cols, generator=gen, device="cuda") * 3,
                            NEG_BIG) for _ in range(nbuf)]

        def fn(i):
            return hs.hyft_softmax_fwd_kernel(bufs[i % nbuf], HYFT16)
        calls = 20 if rows > 1024 else 2 * nbuf
        ms, launches = _device_ms(torch, fn, calls)
        emit({"part": "softmax_kernels", "card": card, "kernel": "hyft_softmax_fwd",
              "shape": [rows, cols], "buffers": nbuf, "event_ms": _event_ms(torch, fn, calls),
              "device_ms": ms, "launches_per_call": launches,
              "sha256": hashlib.sha256(fn(0).cpu().numpy().tobytes()).hexdigest()[:16]})
        del bufs


def softmax_bwd_kernels(torch, card):
    """Kernel 2 at the training shape, dz as fp32 and as fp16."""
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import hyft_softmax as hs
    from repro_torch.kernels.flash_attention import NEG_BIG

    widen = "out_dtype" in inspect.signature(hs.hyft_softmax_bwd_kernel).parameters
    rows, cols = SOFTMAX_SHAPES["train"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    nbuf = max(1, -(-2 * L2_BYTES // (rows * cols * 8)))
    live = torch.arange(cols, device="cuda")[None] < (torch.arange(rows, device="cuda")
                                                      % cols + 1)[:, None]
    bufs = []
    for _ in range(nbuf):
        z = torch.where(live, torch.randn(rows, cols, generator=gen, device="cuda") * 3,
                        NEG_BIG)
        bufs.append((hs.hyft_softmax_fwd_kernel(z, HYFT16),
                     torch.randn(rows, cols, generator=gen, device="cuda").half()))
        del z

    def f32(i):
        if widen:
            return hs.hyft_softmax_bwd_kernel(*bufs[i % nbuf], HYFT16, out_dtype=torch.float32)
        return hs.hyft_softmax_bwd_kernel(*bufs[i % nbuf], HYFT16).to(torch.float32)

    def f16(i):
        return hs.hyft_softmax_bwd_kernel(*bufs[i % nbuf], HYFT16)
    for out, fn in (("float32", f32), ("float16", f16)):
        ms, launches = _device_ms(torch, fn, 20)
        emit({"part": "softmax_bwd_kernels", "card": card, "kernel": "hyft_softmax_bwd",
              "shape": [rows, cols], "dz": out, "one_launch": widen or out == "float16",
              "buffers": nbuf, "event_ms": _event_ms(torch, fn, 20), "device_ms": ms,
              "launches_per_call": launches,
              "sha256": hashlib.sha256(fn(0).cpu().numpy().tobytes()).hexdigest()[:16]})
    del bufs


def compare(torch, a, b):
    """Per tensor of two ``--save`` files: how many elements differ."""
    ta, tb = torch.load(a), torch.load(b)
    for k in ta:
        x, y = ta[k], tb[k]
        diff = (x.double() - y.double()).abs()
        print(json.dumps({"part": "compare", "a": str(a), "b": str(b), "tensor": k,
                          "elements": x.numel(), "differing": int((x != y).sum()),
                          "max_abs_diff": float(diff.max()),
                          "max_abs": float(y.double().abs().max())}), flush=True)


def emit(obj):
    obj["label"] = ARGS.label
    print(json.dumps(obj), flush=True)


def main():
    import torch
    if ARGS.compare:
        compare(torch, *ARGS.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_splitk_ab: no CUDA device")
    sys.path.insert(0, str(ARGS.tree / "src"))
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(ARGS.tree), repro_torch.__file__
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"part": "build", "card": card, "seconds": build.build()["seconds"]})
    if ARGS.softmax:
        softmax_kernels(torch, card)
        softmax_bwd_kernels(torch, card)
        if not ARGS.kernels_only:
            train_step(torch, card, "hyft16_kernel", "unfused", "softmax_")
        return
    if ARGS.flash:
        flash_kernels(torch, card)
        flash_bits(torch, card)
        if not ARGS.kernels_only:
            train_step(torch, card)
        return
    kernels(torch, card)
    if not ARGS.kernels_only:
        generate_profile(torch, card)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    parser.add_argument("--kernels-only", action="store_true",
                        help="time the kernels, skip the profiled generate or train step")
    parser.add_argument("--flash", action="store_true",
                        help="the training path's flash kernels instead of split-K")
    parser.add_argument("--softmax", action="store_true",
                        help="the standalone softmax kernels and an unfused training step")
    parser.add_argument("--save", type=Path, default=None,
                        help="with --flash: save the hashed tensors under this directory")
    parser.add_argument("--compare", type=Path, nargs=2, default=None,
                        help="count the differing elements of two --save files")
    ARGS = parser.parse_args()
    ARGS.tree = ARGS.tree.resolve()
    main()
