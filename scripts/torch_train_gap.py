#!/usr/bin/env python3
"""The training gap between the attention modes at a given depth.

    PYTHONPATH=src python scripts/torch_train_gap.py --arch internvl2-1b \
        --layers 2 4 8 --device cpu

Builds ``--arch`` at its published widths cut to each ``--layers`` depth
(encdec: as many encoder layers as decoder layers), fp32 compute and
HYFT32, random weights from ``--seed``, and one sequence: the VLM's 256
patches and ``--text`` tokens, whisper's 1,500 frames and ``--text``
tokens, otherwise ``--text`` tokens of ``lm_batch``.  For each depth it
prints |dloss| / |loss| and ||dgrad|| / ||grad|| over all leaves between
kernel mode (the CUDA kernels on the card, their plain versions on the
CPU) and the unfused mode, the quantities ``chip_smoke.py`` holds to
``TRAIN_PARITY_BOUND``, with the leaves that differ most; with
``--exact``, also ||dgrad|| / ||grad|| against the unfused mode with the
exact softmax (autograd's VJP), the reference of a bidirectional model's
gradients (bert's, and whisper's encoder).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-1b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    ap.add_argument("--text", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--top", type=int, default=3, help="leaves to print per depth")
    ap.add_argument("--exact", action="store_true",
                    help="also the gap to the unfused mode with the exact softmax")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.train.step import grads_of, make_loss_fn
    from repro_torch.tree import tree_leaves

    dev = resolve_device(args.device)
    published = get_config(args.arch)

    def names(t, p=""):
        if not isinstance(t, dict):
            return [p]
        return [n for k in sorted(t) for n in names(t[k], f"{p}/{k}")]

    for n in args.layers:
        kw = {"enc_layers": n} if published.enc_layers else {}
        cfg = published.with_(n_layers=n, compute_dtype="float32", softmax_impl="hyft32", **kw)
        model = build_model(cfg)
        params = model.init(args.seed, device=dev)
        batch = lm_batch(DataConfig(vocab=cfg.vocab, seq_len=args.text, global_batch=1,
                                    seed=args.seed), 0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 100)
        if cfg.family == "vlm":
            batch["embeds"] = torch.randn(1, cfg.frontend_len, cfg.frontend_dim,
                                          generator=gen, device=dev)
        elif cfg.family == "encdec":
            batch["frames"] = torch.randn(1, cfg.frontend_len, cfg.frontend_dim,
                                          generator=gen, device=dev)
        res = {}
        runs = [("kernel", model), ("unfused", model)]
        if args.exact:
            runs.append(("exact", build_model(cfg.with_(softmax_impl="exact"))))
        for mode, m in runs:
            loss, _, grads = grads_of(make_loss_fn(m, TrainConfig(
                attn_mode="kernel" if mode == "kernel" else "unfused")), params, batch)
            res[mode] = float(loss), tree_leaves(grads)
        (lk, gk), (lu, gu) = res["kernel"], res["unfused"]

        def gap(ref):
            d2 = sum(float(((a - b) ** 2).sum()) for a, b in zip(gk, ref))
            return (d2 / sum(float((b ** 2).sum()) for b in ref)) ** 0.5
        exact = f" grad_gap_vs_exact={gap(res['exact'][1]):.6g}" if args.exact else ""
        print(f"{cfg.name} layers={n} text={args.text} device={dev.type} "
              f"loss_gap={abs(lk - lu) / abs(lu):.6g} grad_gap={gap(gu):.6g}{exact}",
              flush=True)
        worst = sorted(zip(names(params), gk, gu), key=lambda x: -float((x[1] - x[2]).norm()))
        for name, a, b in worst[:args.top]:
            print(f"  {name} {float((a - b).norm() / b.norm()):.4g} of {float(b.norm()):.4g}")
        del params, res


if __name__ == "__main__":
    main()
