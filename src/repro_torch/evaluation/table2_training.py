"""Paper Table 2 (training accuracy) proxy, on the port.

The counterpart of ``benchmarks/table2_training.py``.  The paper fine-tunes
BERT *through* Hyft (forward + the accelerator's own backward) and shows
accuracy parity.  Proxy: train the tiny classifier of ``table1_accuracy``
from scratch with each softmax in the loop (the Hyft entries with their own
VJP) and compare the final accuracy and loss against exact-softmax
training.  ``IMPLS`` is the JAX list plus ``hyft16_kernel`` (the softmax
kernels' forward and backward on the card).
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.data.synthetic import classify_batch
from repro_torch.evaluation.table1_accuracy import (_bert_proxy_cfg, _classifier_init,
                                                    _logits, _train_step)

IMPLS = ["exact", "hyft32", "hyft16", "base2", "hyft16_kernel"]


def _train_with(softmax, steps=120, seed=0, loss_scale=1.0, device=None):
    cfg = _bert_proxy_cfg(softmax)
    params = _classifier_init(seed, cfg, device=device)
    dev = params["head"]["w"].device
    ocfg = optim.OptConfig(name="adamw", lr=2e-3, weight_decay=0.0)
    ost = optim.init(ocfg, params)
    loss = torch.tensor(float("inf"))
    for s in range(steps):
        b = classify_batch(seed, s, 64, 24, vocab=cfg.vocab, device=dev)
        params, ost, loss = _train_step(params, ost, b["tokens"], b["labels"], cfg, ocfg,
                                        loss_scale)

    # eval accuracy with the SAME softmax it was trained with
    correct = total = 0
    with torch.no_grad():
        for s in range(8):
            b = classify_batch(seed, 2000 + s, 64, 24, vocab=cfg.vocab, device=dev)
            lg = _logits(params, b["tokens"], cfg)
            correct += int(torch.sum(torch.argmax(lg, -1) == b["labels"]))
            total += lg.shape[0]
    return correct / total, float(loss)


def run(report, device=None):
    """Key reproduction finding: the accelerator's fixed-point backward adder
    tree (bwd_acc_bits fractional bits) underflows small gradients; with
    standard AMP-style loss scaling (the universal practice for fp16
    training, which Hyft16's FP16 I/O implies) training parity holds."""
    base_acc = None
    for impl in IMPLS:
        for scale in (1.0, 256.0):
            acc, loss = _train_with(impl, loss_scale=scale, device=device)
            if base_acc is None:
                base_acc = acc
            report(f"table2,{impl},loss_scale={scale:.0f},"
                   f"train_acc={acc:.4f},delta={acc - base_acc:+.4f},"
                   f"final_loss={loss:.4f}")
