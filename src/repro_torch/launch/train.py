"""Training launcher CLI: a few steps of a dense or MoE decoder on the card.

  # qwen2-1.5b at full width through the fused CUDA forward and backward
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 3 --global-batch 4 --seq 1024 --softmax hyft16 --attn-mode kernel

  # the unfused mode through the standalone Hyft softmax kernels (forward,
  # and the accelerator's own backward)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 3 --global-batch 4 --seq 1024 --softmax hyft16_kernel \
      --attn-mode unfused --remat full

  # phi3.5-moe (its router through the softmax kernels) under remat
  # "dots", checkpointed every 100 steps into DIR and resumed from its
  # latest checkpoint after a failure or a restart (a DIR that already
  # holds a run's checkpoints resumes that run)
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \
      --smoke --steps 3 --softmax hyft16_kernel --attn-mode kernel \
      --remat dots --ckpt-dir DIR

  # the same at smoke size on the CPU (plain PyTorch versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
      --device cpu --steps 3 --attn-mode kernel

  # a (data 2, model 2) mesh: 4 processes, one rank each, over gloo (on the
  # card the 4 ranks share the one H100: no scaling number comes of it)
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen2-1.5b --smoke --device cpu \
      --data-mesh 2 --model-mesh 2 --steps 2

Weights are random, made from ``--seed``; batches come from the synthetic
Markov stream.  ``--remat`` takes none, full or dots; on the card "dots"
is for now both slower and larger than "full" (a qwen2-1.5b step at full
width: 610.5 ms and 43.4 GB against 430.0 ms and 41.7 GB on an H100),
because its selective checkpoint calls a Python policy for every op and
keeps the products' outputs on top of the blocks' inputs.  ``--ckpt-dir`` runs
the loop under the restart manager (``train/loop.py``), saving every
``TrainConfig.checkpoint_every`` steps and keeping
``keep_checkpoints``.  ``--data-mesh`` and ``--model-mesh`` take any sizes
whose product is the world size that ``torch.distributed.run`` sets
(``RANK``, ``WORLD_SIZE``); above 1 every rank makes the same global state
and batch (the same seed) and keeps its blocks of them as DTensors laid
out by ``default_rules`` (the sharded step of ``train/step.py``), and only
rank 0 prints.  A product of 1 is the one-process run.
"""
import argparse
import os

import torch.distributed as dist


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
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> dict:
    """What a run needs: {"model", "state", "step", "batch_fn", "tcfg",
    "device", "rank", "state_sh"}.  The state is made on the device; under
    a mesh (a world above 1, whose process group this initializes) it is
    sharded."""
    from repro_torch import optim
    from repro_torch.configs import (ShapeSpec, TrainConfig, get_config, input_specs,
                                     smoke_config)
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import init_from_env, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.state import init_state, state_shardings
    from repro_torch.train.step import build_train_step

    dev = resolve_device(args.device)
    if args.data_mesh * args.model_mesh != int(os.environ.get("WORLD_SIZE", 1)):
        raise ValueError(
            f"mesh {args.data_mesh} x {args.model_mesh} needs that many processes "
            f"(WORLD_SIZE {os.environ.get('WORLD_SIZE', 1)}): launch it with "
            f"python -m torch.distributed.run --nproc-per-node "
            f"{args.data_mesh * args.model_mesh}")
    rank, world = init_from_env(dev)
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
    mesh = state_sh = batch_sh = None
    if world > 1:
        mesh = make_host_mesh((args.data_mesh, args.model_mesh), device=dev)
        rules = shd.default_rules(mesh, cfg)
        state_sh = state_shardings(mesh, model, ocfg, rules)
        specs = input_specs(cfg, ShapeSpec("cli", "train", args.seq, args.global_batch))
        batch_sh = shd.batch_shardings(mesh, {k: s for k, (s, _) in specs.items()}, rules)
    return {"model": model,
            "state": init_state(model, ocfg, args.seed, device=dev, shardings=state_sh),
            "step": build_train_step(model, tcfg, ocfg, mesh, state_sh, batch_sh),
            "batch_fn": lambda s: lm_batch(dcfg, s, device=dev),
            "tcfg": tcfg, "device": dev, "rank": rank, "state_sh": state_sh}


def main(argv=None):
    from repro_torch.train.loop import run_train

    args = parse_args(argv)
    run = build(args)
    lead = run["rank"] == 0
    _, hist = run_train(run["state"], run["step"], run["batch_fn"], run["tcfg"],
                        ckpt_dir=args.ckpt_dir, state_sh=run["state_sh"],
                        log_fn=print if lead else lambda *_: None)
    if lead:
        print(f"final loss: {hist[-1]['loss']:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
