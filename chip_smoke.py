#!/usr/bin/env python3
"""Drive the PyTorch port of Hyft serving on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON object per line; any failure raises and the
script exits non-zero without its last line:

  1. device   the card's name, count and power limit (nvidia-smi);
  2. build    the split-K CUDA kernels, compiled by nvcc from this checkout;
  3. check    each kernel against its plain PyTorch version on the card at
              the main path's shapes (qwen2-1.5b: Hq 12, Hkv 2, D 128, B 4):
              decode at Sk 1057 with ragged lengths, fp32 / fp2fx8 / bf16
              K/V, HYFT16, HYFT32 and HYFT16 with step 2; chunk attention
              at Sq 1024 over Lk 1057 with the causal per-lane mask; chunk
              attention at Sq 1 bitwise equal to decode.  Kernel and plain
              version are called by name on the same folded inputs; their
              level-1 stats and the output of the shared combine must stay
              within the bounds that ``tile_errors`` states;
  4. serve    greedy ``generate`` of qwen2-1.5b at full width (28 layers,
              random weights from a seed), hyft16, attn_mode="kernel", bf16
              compute, batch 4, prompt 1024, 32 new tokens, once per KV
              cache (fp2fx8, float32); the kernels' launch counts over that
              run must be exactly 28 chunk launches and 28 * 31 decode
              launches;
  5. parity   fp32 compute and HYFT32: prefill + the first decode step with
              attn_mode="kernel" against attn_mode="unfused" (the reference
              mode, no kernel) on the same weights;
  6. profile  torch.profiler over generate (the prompt, then the prompt
              and 3 decode steps): wall, device busy time and idle share,
              launches, the top kernels;
  7. kernels  per kernel variant: ``ms``, its device time per launch
              (torch.profiler); ``kernel_ms``, CUDA events over many
              launches from Python after a warm-up (the wrapper's host time
              included: it bounds decode, whose kernel is short);
              ``plain_ms``, its plain version's time (CUDA events); and
              ``bound_ms``, the least time the card could take (bytes over
              3.35 TB/s or fp32 FLOPs over 67 TFLOP/s, whichever is larger);

and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# outside the tensor cores; the kernels use fp32 FMAs only
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

B, HQ, HKV, D = 4, 12, 2, 128
PROMPT, NEW = 1024, 32
MAX_LEN = PROMPT + NEW + 1            # 1057: the decode cache length
SEED = 0
# logits(kernel) vs logits(unfused), max |diff| / std.  The two modes are
# different approximations, not one computation in two orders: the split-K
# combine applies one extra Hyft rescale per split, an exponent approximated
# like every Hyft exponent.  The JAX reference shows the same gap (0.043 of
# the std for its own kernel vs unfused modes at 4 layers, 2 splits, fp32,
# HYFT32), and it grows with depth and splits: 0.158 here at 28 layers and 5
# splits on the H100.  The bound leaves room for that growth and still
# catches a real fault, which moves the logits by a whole std.
PARITY_BOUND = 0.25


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi.splitlines()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def build_phase():
    from repro_torch.kernels import build
    res = build.build(verbose=True)
    ptxas = [ln.strip() for ln in res["log"].splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": round(res["seconds"], 3),
          "library": Path(res["path"]).name, "ptxas": ptxas})


def _cache_kv(torch, gen, cache_dtype, shape):
    from repro_torch.models.attention import fp2fx8_quantize
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if cache_dtype == "fp2fx8":
        (kr, ks), (vr, vs) = fp2fx8_quantize(k), fp2fx8_quantize(v)
        return kr, vr, {"k_scale": ks, "v_scale": vs}, v
    if cache_dtype == "bfloat16":
        return k.bfloat16(), v.bfloat16(), {}, v
    return k, v, {}, v


def check_phase(torch):
    """Each kernel against its plain version, both called by name on the
    same folded inputs: the level-1 stats and the output of the shared
    combine, each within the bound ``fa.tile_errors`` states; then, through
    the wrappers, chunk attention at Sq = 1 bitwise equal to decode."""
    from repro_torch.core.hyft import HYFT16, HYFT32
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errors = {}
    BH, g = B * HKV, HQ // HKV
    bk = fa._block_k(MAX_LEN, 256)
    valid = torch.tensor([1057, 900, 300, 5], device="cuda")
    mask = (torch.arange(MAX_LEN, device="cuda")[None] < valid[:, None]).float()
    lane = (torch.arange(MAX_LEN, device="cuda")[None, None]
            <= torch.arange(PROMPT, device="cuda")[None, :, None])
    lane = lane.float().expand(B, PROMPT, MAX_LEN).contiguous()
    for cache_dtype in ("float32", "fp2fx8", "bfloat16"):
        k, v, sc, vf = _cache_kv(torch, gen, cache_dtype, (B, HKV, MAX_LEN, D))
        flat = [t.reshape(BH, MAX_LEN, *t.shape[3:]) if t is not None else None
                for t in (k, v, sc.get("k_scale"), sc.get("v_scale"))]
        q1 = torch.randn(B, HQ, 1, D, generator=gen, device="cuda")
        qc = torch.randn(BH, g * PROMPT, D, generator=gen, device="cuda")
        cases = [("decode", q1.reshape(BH, g, D), mask, None)]
        if cache_dtype != "bfloat16":     # not on the main path: decode only
            cases.append(("verify", qc, lane, PROMPT))
        # step=2: the strided max counts from each split's start
        for cfg in (HYFT16, HYFT32, dataclasses.replace(HYFT16, step=2)):
            kw = dict(cfg=cfg, sm_scale=D ** -0.5, bk=bk, hkv=HKV)
            for kind, q3, m, sq in cases:
                got = fa._splitk_tiles_cuda(q3, *flat, m, **kw, sq=sq)
                ref = fa.splitk_tiles_plain(q3, *flat, m, **kw, sq=sq)
                err = fa.tile_errors(got, ref, cfg, float(vf.abs().max()), bk)
                emit({"phase": "check", "kernel": kind, "kv": cache_dtype,
                      "cfg": cfg.io_dtype, "step": cfg.step, **err})
                assert torch.isfinite(got[0]).all(), f"{kind}: non-finite acc"
                assert err["m_loc"] <= 1 and err["l_loc"] <= 1 and err["out"] <= 1, \
                    f"{kind} disagrees with its plain version"
                if cfg is HYFT16:     # the main path's config
                    errors[(kind, cache_dtype)] = err["max_abs_err"]
                del got, ref
            out = fa.flash_hyft_decode(q1, k, v, cfg, kv_len_mask=mask, **sc)
            one = fa.flash_hyft_verify(q1, k, v, mask[:, None], cfg, **sc)
            assert torch.equal(one, out), "chunk at Sq=1 is not bitwise decode"
        emit({"phase": "check", "kv": cache_dtype, "sq1_bitwise_decode": True})
        torch.cuda.synchronize()
    return errors


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_phase(torch, params, cfg):
    """Greedy generate at full width through the kernels, per KV cache."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.serve.engine import generate

    model = build_model(cfg.with_(softmax_impl="hyft16"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    launches, outs = {}, {}
    for cache_dtype in ("fp2fx8", "float32"):
        scfg = ServeConfig(max_len=MAX_LEN,
                           cache_dtype=cache_dtype, attn_mode="kernel")
        run = lambda n: generate(model, params, {"tokens": tokens}, scfg,  # noqa: E731
                                 max_new=n)
        _timed(torch, lambda: run(2))                  # warm-up
        _, t_prefill = _timed(torch, lambda: run(1))
        torch.cuda.reset_peak_memory_stats()
        for name in fa.LAUNCHES:                       # the main path's run
            fa.LAUNCHES[name] = 0
        out, t_all = _timed(torch, lambda: run(NEW))
        got = dict(fa.LAUNCHES)
        want = {"hyft_splitk_verify": cfg.n_layers,
                "hyft_splitk_decode": cfg.n_layers * (NEW - 1)}
        t_decode = t_all - t_prefill
        emit({"phase": "serve", "cache": cache_dtype, "launches": got,
              "expected": want, "prefill_ms": t_prefill * 1e3,
              "decode_ms_per_token": t_decode / (NEW - 1) * 1e3,
              "decode_tokens_per_s": B * (NEW - 1) / t_decode,
              "generate_ms": t_all * 1e3,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        assert got == want, f"launch counts {got} != {want}"
        assert out.shape == (B, NEW) and out.dtype == torch.int32
        assert bool(((out >= 0) & (out < cfg.vocab)).all())
        launches[cache_dtype] = got
        outs[cache_dtype] = out
    agree = float((outs["fp2fx8"] == outs["float32"]).float().mean())
    emit({"phase": "serve", "token_agreement_fp2fx8_vs_float32": agree})
    return launches


def parity_phase(torch, params, cfg):
    """attn_mode="kernel" against the unfused reference mode, fp32 compute
    and HYFT32, on the same weights: prefill and the first decode step."""
    from repro_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    base = cfg.with_(softmax_impl="hyft32", compute_dtype="float32")
    logits = {}
    for mode in ("kernel", "unfused"):
        model = build_model(base.with_(attn_mode=mode))
        cache = model.init_cache(params, B, MAX_LEN, "float32")
        lp, cache = model.prefill_chunk(params, cache, tokens,
                                        torch.zeros(B, dtype=torch.int32,
                                                    device="cuda"))
        ld, _ = model.decode_step(params, cache, tokens[:, :1], PROMPT)
        logits[mode] = (lp[:, -1], ld[:, -1])
        del cache, lp
    res = {"phase": "parity"}
    for i, name in enumerate(("prefill", "decode")):
        a, b = logits["kernel"][i], logits["unfused"][i]
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        rel = float((a - b).abs().max() / b.std())
        res[f"{name}_maxdiff_over_std"] = rel
        res[f"{name}_argmax_agreement"] = float(
            (a.argmax(-1) == b.argmax(-1)).float().mean())
    res["bound"] = PARITY_BOUND
    emit(res)
    assert res["prefill_maxdiff_over_std"] <= PARITY_BOUND, "prefill parity"
    assert res["decode_maxdiff_over_std"] <= PARITY_BOUND, "decode parity"


def _profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(torch, fn)
    return prof.key_averages(), wall


def _self_device_us(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def _device_events(torch, events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_phase(torch, params, cfg):
    """torch.profiler over generate with the fp2fx8 cache: once for the
    prompt alone (max_new=1) and once for the prompt plus 3 decode steps;
    the decode figures are the difference.  Per part: wall, device busy
    time (the kernels' own device time), the device's idle share, launches;
    and the top kernels of the longer run."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models import build_model
    from repro_torch.serve.engine import generate

    model = build_model(cfg.with_(softmax_impl="hyft16"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    scfg = ServeConfig(max_len=MAX_LEN,
                       cache_dtype="fp2fx8", attn_mode="kernel")
    parts = {}
    for name, n in (("prefill", 1), ("prefill+3_decode_steps", 4)):
        events, wall = _profiled(torch, lambda: generate(
            model, params, {"tokens": tokens}, scfg, max_new=n))
        kern = sorted(_device_events(torch, events), key=_self_device_us,
                      reverse=True)
        parts[name] = {"wall_ms": wall * 1e3,
                       "device_busy_ms": sum(map(_self_device_us, kern)) / 1e3,
                       "launches": sum(e.count for e in kern)}
    top = [{"name": e.key[:90], "count": e.count,
            "device_ms": _self_device_us(e) / 1e3} for e in kern[:12]]
    a, b = parts["prefill"], parts["prefill+3_decode_steps"]
    parts["3_decode_steps"] = {k: b[k] - a[k] for k in a}
    for part in parts.values():
        part["device_idle_share"] = 1.0 - part["device_busy_ms"] / part["wall_ms"]
    emit({"phase": "profile", "cache": "fp2fx8", **parts, "top_kernels": top})


def _event_ms(torch, fn, reps):
    for _ in range(2):
        fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernels_phase(torch, errors, launches):
    """Time each kernel variant at the main path's shapes against its plain
    version and its bound.  Decode rotates over 28 K/V buffers (one per
    layer, 240 MB of fp32) so that, as in a decode step, the cache comes
    from device memory and not from the 50 MB L2."""
    from repro_torch.core.hyft import HYFT16
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    BH, g, bk = B * HKV, HQ // HKV, 256
    ns = -(-MAX_LEN // bk)
    rows_of = {"decode": g, "verify": g * PROMPT}
    kernels = []
    for kind, sq in (("decode", None), ("verify", PROMPT)):
        for cache_dtype in ("float32", "fp2fx8"):
            rows = rows_of[kind]
            nbuf = 28 if kind == "decode" else 1
            bufs = [_cache_kv(torch, gen, cache_dtype, (BH, MAX_LEN, D))
                    for _ in range(nbuf)]
            q3 = torch.randn(BH, rows, D, generator=gen, device="cuda")
            if sq is None:
                mask = torch.ones(B, MAX_LEN, device="cuda")
            else:
                mask = (torch.arange(MAX_LEN, device="cuda")[None, None]
                        <= torch.arange(sq, device="cuda")[None, :, None])
                mask = mask.float().expand(B, sq, MAX_LEN).contiguous()

            def call(tiles):
                def fn(i):
                    k, v, sc, _ = bufs[i % nbuf]
                    return tiles(q3, k, v, sc.get("k_scale"), sc.get("v_scale"),
                                 mask, cfg=HYFT16, sm_scale=D ** -0.5, bk=bk,
                                 hkv=HKV, sq=sq)
                return fn
            reps = 200 if kind == "decode" else 10
            event_ms = _event_ms(torch, call(fa._splitk_tiles_cuda), reps)
            fn = call(fa._splitk_tiles_cuda)
            events, _ = _profiled(torch, lambda: [fn(i) for i in range(reps)])
            ours = [e for e in _device_events(torch, events)
                    if "splitk_tile_kernel" in e.key]
            n = sum(e.count for e in ours)
            device_ms = sum(map(_self_device_us, ours)) / n / 1e3 if n else None
            plain_ms = _event_ms(torch, call(fa.splitk_tiles_plain),
                                 50 if kind == "decode" else 3)
            kv_bytes = 1 if cache_dtype == "fp2fx8" else 4
            nbytes = (BH * rows * D * 4 + 2 * BH * MAX_LEN * D * kv_bytes
                      + (2 * BH * MAX_LEN * 4 if cache_dtype == "fp2fx8" else 0)
                      + mask.numel() * 4 + BH * ns * rows * (D + 2) * 4)
            flops = 4 * BH * rows * MAX_LEN * D   # QK^T + PV over the real keys
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOPS_PER_S * 1e3
            entry = "hyft_splitk_decode" if kind == "decode" else "hyft_splitk_verify"
            kernels.append({
                "name": f"{entry}[{cache_dtype}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/hyft_splitk.cu",
                "replaces": ("src/repro/kernels/flash_attention.py:541"
                             if kind == "decode"
                             else "src/repro/kernels/flash_attention.py:804"),
                "tpu_kernel": ("_decode_fwd_kernel" if kind == "decode"
                               else "_verify_fwd_kernel"),
                "launches": launches[cache_dtype][entry],
                "max_abs_err": errors[(kind, cache_dtype)],
                "ms": device_ms if device_ms is not None else event_ms,
                "ms_source": ("torch.profiler device time" if device_ms is not None
                              else "cuda events"),
                "kernel_ms": event_ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes,
                "flops": flops,
                "library_ms": None,
            })
            del bufs
    return kernels


def main():
    import torch

    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    info = device_phase(torch)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    errors = check_phase(torch)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2-1.5b")
    params = build_model(cfg).init(SEED)             # on the card
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"phase": "init", "arch": cfg.name, "params": n_params})
    launches = serve_phase(torch, params, cfg)
    parity_phase(torch, params, cfg)
    profile_phase(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    emit({"kernels": kernels_phase(torch, errors, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


if __name__ == "__main__":
    main()
