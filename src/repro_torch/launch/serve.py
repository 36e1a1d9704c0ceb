"""Serving launcher CLI: lockstep batch generate on the card.

  # greedy decode of random prompts through the split-K CUDA kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --softmax hyft16 --attn-mode kernel --cache-dtype fp2fx8

  # the same at smoke size on the CPU (plain PyTorch versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
      --device cpu --attn-mode kernel --cache-dtype fp2fx8

Weights are random, made from ``--seed``.  The scheduler, paged, speculative
and observability flags of the JAX launcher come with the slices that port
those layers.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--softmax", default="hyft16")
    ap.add_argument("--attn-mode", default=None, choices=["unfused", "kernel"],
                    help="attention path; 'kernel' = the split-K CUDA kernels")
    ap.add_argument("--cache-dtype", default="float32",
                    help="KV cache storage: a dtype name or 'fp2fx8' "
                         "(int8 FP2FX raws + per-head scales)")
    ap.add_argument("--decode-loop", default="scan", choices=["scan", "host"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=16, help="prompt length")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ServeConfig, get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve.engine import generate

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_(softmax_impl=args.softmax)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prefill),
                           generator=gen, device=dev, dtype=torch.int32)
    scfg = ServeConfig(max_len=args.prefill + args.max_new + 1,
                       cache_dtype=args.cache_dtype,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, attn_mode=args.attn_mode,
                       decode_loop=args.decode_loop)
    out = generate(model, params, {"tokens": tokens}, scfg,
                   max_new=args.max_new, generator=gen, device=dev)
    for i, row in enumerate(out.tolist()):
        print(f"[{i}] {row}")


if __name__ == "__main__":
    main()
