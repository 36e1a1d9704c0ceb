#!/usr/bin/env python3
"""Where the port's two Hyft attention modes differ, by query position.

    PYTHONPATH=src python3 scripts/torch_mode_gap.py [--device cpu|cuda]
        [--heads 8] [--seq 1024] [--d 128] [--seed 0]

Random q, k, v (normal, fp32; one sequence of ``--seq`` tokens, ``--heads``
heads of ``--d``), causal, HYFT32.  Three attentions of the same inputs:

* ``exact``: softmax attention in fp64;
* ``unfused``: the unfused mode (``models/attention.py::unfused_attention``):
  the Hyft softmax over each full score row, one log-subtract divide per
  probability, then the PV product;
* ``kernel``: the kernel mode's chunk attention (``flash_hyft_verify``,
  kernel 8, the prefill's path; its plain version on the CPU): the PV sum
  of the Hyft exponents, one log-subtract divide per output.

For each band of query positions [lo, hi) it prints one JSON line: the rms
of the exact output over the band's positions, each mode's largest error
against the exact output over the band, and the largest gap between the
two modes, the last three divided by that rms and also absolute.  The
bands are ``chip_smoke.py``'s ``POS_BANDS`` (cut to ``--seq``).
"""
from __future__ import annotations

import argparse
import json

BANDS = ((0, 1), (1, 2), (2, 4), (4, 8), (8, 16), (16, 64), (64, 256), (256, 1024),
         (1024, 4096))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.hyft import HYFT32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn

    dev, S, D = torch.device(args.device), args.seq, args.d
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn(1, args.heads, S, D, generator=gen, device=dev)
               for _ in range(3))
    z = (q.double() @ k.double().transpose(-1, -2)) * D ** -0.5
    z = z.masked_fill(torch.ones(S, S, device=dev).triu(1).bool(), float("-inf"))
    exact = torch.softmax(z, -1) @ v.double()
    unfused = attn.unfused_attention(q, k, v, "hyft32", causal=True).double()
    frontier = torch.arange(S, device=dev)
    mask = (frontier[None, None, :] <= frontier[None, :, None])      # (1, S, S)
    kernel = fa.flash_hyft_verify(q, k, v, mask, HYFT32).double()

    def per_pos(x):  # (1, H, S, D) -> the largest |x| over heads and features, (S,)
        return x.abs().amax((0, 1, 3))
    rms = exact.pow(2).mean((0, 1, 3)).sqrt()
    err_u, err_k, gap = per_pos(unfused - exact), per_pos(kernel - exact), per_pos(unfused - kernel)
    for lo, hi in BANDS:
        if lo >= S:
            break
        band = slice(lo, hi)
        r = float(rms[band].mean())
        print(json.dumps({
            "positions": [lo, min(hi, S)], "keys_seen": [lo + 1, min(hi, S)],
            "rms_exact": r,
            "unfused_err_over_rms": float((err_u[band] / rms[band]).max()),
            "kernel_err_over_rms": float((err_k[band] / rms[band]).max()),
            "gap_over_rms": float((gap[band] / rms[band]).max()),
            "gap_abs": float(gap[band].max())}))


if __name__ == "__main__":
    main()
