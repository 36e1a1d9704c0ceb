"""Serving launcher CLI: lockstep batch generate, or continuous batching
over a slot pool (dense or paged KV cache), on the card.

  # greedy decode of random prompts through the split-K CUDA kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --softmax hyft16 --attn-mode kernel --cache-dtype fp2fx8

  # the unfused mode: full score rows through the standalone Hyft softmax
  # kernel, for the prompt and every decode step
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --softmax hyft16_kernel --attn-mode unfused --cache-dtype fp2fx8

  # continuous batching over a paged pool with prefix caching: ragged
  # prompts and horizons, chunked prefill, the paged CUDA kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --scheduler continuous --kv-layout paged --prefix-cache \
      --n-slots 8 --batch 24 --prefill 512 --max-new 64 --prefill-chunk 256 \
      --attn-mode kernel --cache-dtype fp2fx8

  # speculative decoding: n-gram self-drafting (or --spec-mode model with
  # --draft-model, a random smoke drafter), one verify call per step
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --scheduler spec --draft-k 4 --kv-layout paged --n-slots 8 --batch 24 \
      --attn-mode kernel --cache-dtype fp2fx8

  # an MoE model (phi3.5-moe or grok-1): the router's softmax rows go
  # through the standalone Hyft softmax kernel under hyft16_kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \
      --softmax hyft16_kernel --scheduler continuous --kv-layout paged \
      --attn-mode kernel --cache-dtype fp2fx8

  # the encoder-decoder (whisper-medium: random frames from --seed, the
  # encoder once per request) and the VLM (internvl2-1b, text-only serving
  # as in the JAX package)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
      --scheduler continuous --attn-mode kernel --cache-dtype fp2fx8

  # any of them at smoke size on the CPU (plain PyTorch versions of the
  # kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
      --device cpu --scheduler continuous --kv-layout paged --prefix-cache \
      --attn-mode kernel --cache-dtype fp2fx8

  # observability: a Chrome trace, metrics JSONL snapshots, the numerics
  # telemetry summary, and a torch.profiler trace of the serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
      --device cpu --scheduler continuous --kv-layout paged --cache-dtype fp2fx8 \
      --telemetry --trace /tmp/t.json --metrics-out /tmp/m.jsonl \
      --xla-profile /tmp/prof

Weights are random, made from ``--seed``; so are encdec's frames (numpy,
``default_rng(seed + 1)``, one (frontend_len, frontend_dim) draw a request
or a batch row; the JAX launcher's ``jax.random`` stream is not
reproduced).  The paged layout, the prefix
cache, speculative decoding and chunked prefill live in the slot-pool
scheduler, so those flags route through it under ``--scheduler lockstep``
too.  ``--xla-profile`` keeps the JAX launcher's name; here it opens a
``torch.profiler`` window (``obs/profile.py``).
"""
import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--softmax", default="hyft16")
    ap.add_argument("--attn-mode", default=None,
                    choices=["unfused", "chunked", "kernel"],
                    help="attention path; 'kernel' = the split-K CUDA kernels")
    ap.add_argument("--cache-dtype", default="float32",
                    help="KV cache storage: a dtype name or 'fp2fx8' "
                         "(int8 FP2FX raws + per-head scales)")
    ap.add_argument("--decode-loop", default="scan", choices=["scan", "host"])
    ap.add_argument("--scheduler", default="lockstep",
                    choices=["lockstep", "continuous", "spec"],
                    help="'continuous' = slot-pool continuous batching with "
                         "ragged prompts and EOS early-exit; 'lockstep' = "
                         "one rectangular batch (or, with the slot-pool "
                         "flags, a pool drained before each admission); "
                         "'spec' = continuous admission + speculative "
                         "decode steps (draft K tokens, verify in one model "
                         "call)")
    ap.add_argument("--spec-mode", default="ngram", choices=["ngram", "model"],
                    help="drafter for --scheduler spec: 'ngram' = "
                         "deterministic prompt-lookup self-drafting; "
                         "'model' = a small zoo model (--draft-model)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens verified per slot per spec step")
    ap.add_argument("--ngram-max", type=int, default=3,
                    help="longest trailing n-gram the lookup drafter matches")
    ap.add_argument("--draft-model", default=None,
                    help="zoo arch for --spec-mode model (random init: a "
                         "demo drafter, whose acceptance floor is chance)")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="slot-pool size of the continuous scheduler")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token: a continuous slot that emits it is "
                         "freed at once")
    ap.add_argument("--decode-burst", type=int, default=8,
                    help="masked decode steps between admission checks")
    ap.add_argument("--kv-layout", default="dense", choices=["dense", "paged"],
                    help="'paged' = fixed-size KV pages from a global pool "
                         "with per-slot block tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page for --kv-layout paged")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="usable pages in the pool (0 = n_slots * "
                         "ceil(max_len / page_size))")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-trie prompt prefix cache (paged only)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max prompt tokens per prefill call (0 = whole "
                         "prompt)")
    ap.add_argument("--pack-prefill", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="pack every prefilling slot into one chunk call "
                         "(--no-pack-prefill = one prompt at a time in "
                         "arrival order)")
    ap.add_argument("--audit", action="store_true",
                    help="recompute page-pool and radix-trie refcounts at "
                         "every admission, finish and preemption; raise on "
                         "drift")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: arrivals past this many "
                         "waiting requests fail with 'queue_full' (0 = "
                         "unbounded)")
    ap.add_argument("--max-retries", type=int, default=32,
                    help="per-request requeue budget (preemptions + numeric "
                         "quarantines) before a structured "
                         "'retries_exhausted' failure")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request TTL in seconds: a request unfinished "
                         "at its deadline fails with reason 'deadline' and "
                         "frees its slot and pages")
    ap.add_argument("--batch", type=int, default=4,
                    help="lockstep batch size / continuous request count")
    ap.add_argument("--prefill", type=int, default=16,
                    help="prompt length (continuous: the maximum; prompts "
                         "are ragged in [prefill//2, prefill])")
    ap.add_argument("--max-new", type=int, default=16,
                    help="decode horizon (continuous: the maximum; horizons "
                         "are ragged in [max_new//2, max_new])")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the serve "
                         "(spans: admit/prefill/burst/spec-verify/compile/"
                         "preempt/evict/quarantine) to PATH — load it in "
                         "ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append periodic metrics-registry JSONL snapshots "
                         "to PATH and print the end-of-run metrics report")
    ap.add_argument("--xla-profile", default=None, metavar="DIR",
                    help="torch.profiler capture around the serve (the JAX "
                         "launcher's flag, whose window is jax.profiler's): "
                         "its Chrome trace lands in DIR/trace.json")
    ap.add_argument("--telemetry", action="store_true",
                    help="fold per-burst device-side numeric stats (softmax "
                         "exponent range, fp2fx8 scale histogram, int8 "
                         "saturation) into the burst outputs and print the "
                         "numerics summary")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import ServeConfig, get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.obs import Obs
    from repro_torch.obs.profile import TRACE_FILE, xla_profile
    from repro_torch.serve.engine import generate
    from repro_torch.serve.scheduler import Request, SlotPoolEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_(softmax_impl=args.softmax)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    scfg = ServeConfig(max_len=args.prefill + args.max_new + 1,
                       cache_dtype=args.cache_dtype,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, attn_mode=args.attn_mode,
                       decode_loop=args.decode_loop, scheduler=args.scheduler,
                       n_slots=args.n_slots, eos_id=args.eos_id,
                       decode_burst=args.decode_burst,
                       kv_layout=args.kv_layout, page_size=args.page_size,
                       n_pages=args.n_pages, prefix_cache=args.prefix_cache,
                       prefill_chunk=args.prefill_chunk,
                       pack_prefill=args.pack_prefill, spec_mode=args.spec_mode,
                       draft_k=args.draft_k, ngram_max=args.ngram_max,
                       draft_model=args.draft_model, audit=args.audit,
                       max_queue=args.max_queue, max_retries=args.max_retries,
                       telemetry=args.telemetry)
    obs = None
    if args.trace or args.metrics_out:
        obs = Obs.enabled(metrics_path=args.metrics_out)
        obs.tracer.enabled = args.trace is not None
    profile_note = (f"# wrote torch.profiler trace {args.xla_profile}/{TRACE_FILE} "
                    "(load in ui.perfetto.dev)")

    frames = None
    if cfg.family == "encdec":
        frames = np.random.default_rng(args.seed + 1).standard_normal(
            (args.batch, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32)

    if (args.scheduler in ("continuous", "spec") or args.kv_layout != "dense"
            or args.prefix_cache or args.prefill_chunk > 0):
        rng = np.random.default_rng(args.seed)
        reqs = []
        for rid in range(args.batch):
            plen = int(rng.integers(max(1, args.prefill // 2), args.prefill + 1))
            reqs.append(Request(
                rid=rid, tokens=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                max_new=int(rng.integers(max(1, args.max_new // 2),
                                         args.max_new + 1)),
                frames=None if frames is None else frames[rid],
                deadline=args.deadline))
        eng = SlotPoolEngine(model, params, scfg, generator=gen, device=dev, obs=obs)
        if obs is not None:
            # build the kernels and count every executable up front, so the
            # trace separates the build (its "compile" span) from
            # steady-state serving and the cost book has rows for the
            # roofline counter tracks
            eng.prewarm(max(len(r.tokens) for r in reqs))
        try:
            with xla_profile(args.xla_profile):
                done = eng.run(reqs)
        except KeyboardInterrupt:
            # graceful drain: every unfinished request ends cancelled with
            # its partial tokens
            done = eng.shutdown()
            print("\ninterrupted: drained "
                  f"{sum(1 for c in done.values() if c.cancelled)} "
                  "in-flight/queued requests as cancelled")
        for rid in sorted(done):
            c = done[rid]
            tag = ("" if c.ok else " CANCELLED" if c.cancelled
                   else f" FAILED({c.failure.reason})")
            print(f"[{rid}] prompt={c.prompt_len} new={len(c.tokens)}"
                  f"{tag} {c.tokens}")
        if args.scheduler == "spec":
            st = eng.stats
            acc = st["accepted_tokens"] / max(1, st["draft_tokens"])
            print(f"spec: steps={st['spec_steps']} "
                  f"drafted={st['draft_tokens']} "
                  f"accepted={st['accepted_tokens']} (rate {acc:.2f}) "
                  f"tokens/model-call="
                  f"{st['tokens_emitted'] / max(1, st['model_calls']):.2f}")
        print(f"stats: {eng.stats}")
        if args.trace:
            eng.obs.tracer.write(args.trace)
            print(f"# wrote trace {args.trace} ({len(eng.obs.tracer.events)} events; "
                  "load in ui.perfetto.dev)")
        if args.metrics_out:
            print(eng.obs.metrics.report())
            print(f"# wrote metrics {args.metrics_out}")
        if args.telemetry:
            print(f"numerics: {eng.obs.numerics.summary()}")
        if args.xla_profile:
            print(profile_note)
        return

    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prefill),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames).to(dev)
    with xla_profile(args.xla_profile):
        out = generate(model, params, batch, scfg,
                       max_new=args.max_new, generator=gen, device=dev,
                       tracer=obs.tracer if obs is not None else None,
                       profile=obs.profile if obs is not None else None)
    for i, row in enumerate(out.tolist()):
        print(f"[{i}] {row}")
    if args.xla_profile:
        print(profile_note)
    if args.trace:
        obs.tracer.write(args.trace)
        print(f"# wrote trace {args.trace} ({len(obs.tracer.events)} events; "
              "load in ui.perfetto.dev)")
    if args.metrics_out:
        print("# --metrics-out: serve.* metrics live in the slot-pool "
              "scheduler; rerun with --scheduler continuous|spec")


if __name__ == "__main__":
    main()
