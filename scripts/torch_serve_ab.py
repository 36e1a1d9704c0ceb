#!/usr/bin/env python3
"""Time the PyTorch port's serving cells of one source tree on the card.

    python3 scripts/torch_serve_ab.py [--tree DIR] [--label NAME] [--spec]

``--tree`` is the root of a checkout of this repository (default: the one
holding this script); its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``.  To compare two commits on one card,
unpack the other into a directory that git ignores (``git archive``) and
run parent, change, change, parent in one call.

The cells are ``chip_smoke.py``'s (this script's own copy, whatever the
tree): the 24 chat requests (``_chat_requests``) over ``SlotPoolEngine``
with the paged fp2fx8 pool (``_serve_config``: pages of 16, prefix cache,
8 slots, prefill chunks of 256, kernel mode), hyft16, bf16 compute, random
weights from seed 0, every arrival at 0 so that the wall times the engine
and not the arrival process:

* ``continuous``: qwen2-1.5b at full width, bursts of 8;
* with ``--spec`` also ``spec``: mistral-nemo-12b at its 40 layers, the
  n-gram drafter, draft_k 4.

Per cell, after a warm-up run of 2 requests, one timed run: one JSON line
with the wall, tokens/s, model calls (prefills, burst steps or spec steps)
and a sha256 of every request's tokens, so that two trees can be compared
token for token, each naming the card (``nvidia-smi`` name and power
limit).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(obj):
    obj["label"] = ARGS.label
    print(json.dumps(obj), flush=True)


def cell(torch, card, name, arch, **kw):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.scheduler import SlotPoolEngine

    cs = _chip_smoke()
    cfg = get_config(arch).with_(softmax_impl="hyft16")
    model = build_model(cfg)
    params = model.init(cs.SEED, device="cuda")
    reqs = [dataclasses.replace(r, arrival=0.0) for r in cs._chat_requests(np, cfg.vocab)]
    scfg = cs._serve_config(cache_dtype="fp2fx8", **kw)
    SlotPoolEngine(model, params, scfg, device="cuda").run(
        [dataclasses.replace(r, max_new=8) for r in reqs[:2]])
    eng = SlotPoolEngine(model, params, scfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [done[r.rid].tokens for r in reqs]
    st = eng.stats
    emit({"part": name, "card": card, "arch": arch, "wall_s": wall,
          "tokens": sum(map(len, toks)), "tokens_per_s": sum(map(len, toks)) / wall,
          **{k: st[k] for k in ("prefills", "burst_steps", "spec_steps") if k in st},
          "sha256": hashlib.sha256(json.dumps(toks).encode()).hexdigest()[:16]})
    del params, model, eng
    torch.cuda.empty_cache()


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.append(str(ROOT))
    import chip_smoke
    return chip_smoke


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: no CUDA device")
    sys.path.insert(0, str(ARGS.tree / "src"))
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(ARGS.tree), repro_torch.__file__
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"part": "build", "card": card, "seconds": build.build()["seconds"]})
    cell(torch, card, "continuous", "qwen2-1.5b")
    if ARGS.spec:
        cs = _chip_smoke()
        cell(torch, card, "spec", cs.SPEC_ARCH, scheduler="spec", spec_mode="ngram",
             draft_k=cs.SPEC_K)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT)
    parser.add_argument("--label", default="")
    parser.add_argument("--spec", action="store_true",
                        help="also the spec cell (mistral-nemo-12b, n-gram drafter)")
    ARGS = parser.parse_args()
    ARGS.tree = ARGS.tree.resolve()
    main()
