"""Training launcher CLI: a few steps of a dense decoder on the card.

  # qwen2-1.5b at full width through the fused CUDA forward and backward
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 3 --global-batch 4 --seq 1024 --softmax hyft16 --attn-mode kernel

  # the unfused mode through the standalone Hyft softmax kernels (forward,
  # and the accelerator's own backward)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 3 --global-batch 4 --seq 1024 --softmax hyft16_kernel \
      --attn-mode unfused --remat full

  # the same at smoke size on the CPU (plain PyTorch versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
      --device cpu --steps 3 --attn-mode kernel

Weights are random, made from ``--seed``; batches come from the synthetic
Markov stream.  One device: ``--data-mesh`` and ``--model-mesh`` take only
1 (``distributed/``: ROADMAP queue 1, distributed and the mesh), and
checkpointing (``--ckpt-dir``: remat='dots' and checkpointing) raises.
"""
import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--softmax", default="hyft16")
    ap.add_argument("--attn-mode", default=None,
                    choices=["unfused", "chunked", "kernel"],
                    help="attention path; 'kernel' = fused CUDA fwd+bwd")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-mesh", type=int, default=1, choices=[1])
    ap.add_argument("--model-mesh", type=int, default=1, choices=[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> dict:
    """What a run needs: {"model", "state", "step", "batch_fn", "tcfg",
    "device"}.  The state is made on the device."""
    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_config, smoke_config
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import build_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = cfg.with_(softmax_impl=args.softmax)
    model = build_model(cfg)
    tcfg = TrainConfig(global_batch=args.global_batch, seq_len=args.seq,
                       microbatch=args.microbatch, lr=args.lr,
                       total_steps=args.steps, remat=args.remat,
                       optimizer=args.optimizer, attn_mode=args.attn_mode)
    ocfg = optim.OptConfig(name=args.optimizer, lr=args.lr)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.global_batch, seed=args.seed)
    return {"model": model, "state": init_state(model, ocfg, args.seed, device=dev),
            "step": build_train_step(model, tcfg, ocfg),
            "batch_fn": lambda s: lm_batch(dcfg, s, device=dev),
            "tcfg": tcfg, "device": dev}


def main(argv=None):
    from repro_torch.train.loop import run_train

    args = parse_args(argv)
    run = build(args)
    _, hist = run_train(run["state"], run["step"], run["batch_fn"], run["tcfg"],
                        ckpt_dir=args.ckpt_dir)
    print(f"final loss: {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
