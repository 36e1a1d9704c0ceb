"""Paper Table 1 (inference accuracy) proxy, on the port.

The counterpart of ``benchmarks/table1_accuracy.py``.  The paper drops Hyft
into a fine-tuned BERT and reports GLUE/SQuAD accuracy unchanged against
the original softmax, while [13]/[29] degrade.  The proxy (no GLUE here):
train a small BERT-style classifier on the synthetic marker-classification
task with the EXACT softmax, then swap the softmax at inference and measure
the accuracy deltas, the paper's drop-in protocol.  Also reports
distribution-level softmax errors (mean/max abs, KL) on
attention-logit-shaped inputs.

``IMPLS`` is the JAX list plus ``hyft16_kernel``.  The proxy runs in the
config's default unfused mode, so on the card ``hyft16_kernel`` goes
through the standalone softmax kernels (``kernels/ops.py``); on the CPU
through their plain versions.  Entry points take ``device=None``, which
means the card, and raise without one unless given ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.registry import get_softmax
from repro_torch.data.synthetic import classify_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.train.step import grads_of
from repro_torch.tree import tree_map

F32 = torch.float32
IMPLS = ["exact", "hyft32", "hyft16", "koca", "base2", "lut8", "hyft16_kernel"]


def _bert_proxy_cfg(softmax="exact"):
    return smoke_config(get_config("bert-base")).with_(
        softmax_impl=softmax, vocab=64, n_layers=2, compute_dtype="float32")


def _classifier_init(seed, cfg, n_classes=4, device=None):
    """The backbone's fresh weights and a linear head (fan-in normal), from
    one generator seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    backbone = transformer.init(gen, cfg, dev)
    w = torch.randn((cfg.d_model, n_classes), generator=gen, dtype=F32, device=dev)
    return {"backbone": backbone, "head": {"w": w * cfg.d_model ** -0.5}}


def _logits(params, tokens, cfg):
    """The bidirectional backbone, a mean pool over positions, the head."""
    hid, _ = transformer.forward(params["backbone"], tokens, cfg, remat="none",
                                 causal=False)
    pooled = torch.mean(hid.to(F32), dim=1)
    return pooled @ params["head"]["w"]


def _xent(logits, labels):
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[rows, labels.long()])


def _loss_and_grads(params, tokens, labels, cfg, loss_scale=1.0):
    """The mean cross-entropy and its gradient: the loss scaled by
    ``loss_scale`` for the backward, the gradients divided by it again."""
    def loss_fn(p, b):
        return loss_scale * _xent(_logits(p, b["tokens"], cfg), b["labels"]), {}
    loss, _, grads = grads_of(loss_fn, params, {"tokens": tokens, "labels": labels})
    return loss / loss_scale, tree_map(lambda g: g / loss_scale, grads)


def _train_step(params, ost, tokens, labels, cfg, ocfg, loss_scale=1.0):
    """One AdamW step, in place.  Returns (params, ost, loss)."""
    loss, grads = _loss_and_grads(params, tokens, labels, cfg, loss_scale)
    params, ost = optim.update(ocfg, grads, ost, params)
    return params, ost, loss


def _train_classifier(steps=150, seed=0, device=None):
    cfg = _bert_proxy_cfg("exact")
    params = _classifier_init(seed, cfg, device=device)
    dev = params["head"]["w"].device
    ocfg = optim.OptConfig(name="adamw", lr=2e-3, weight_decay=0.0)
    ost = optim.init(ocfg, params)
    for s in range(steps):
        b = classify_batch(seed, s, 64, 24, vocab=cfg.vocab, device=dev)
        params, ost, _ = _train_step(params, ost, b["tokens"], b["labels"], cfg, ocfg)
    return cfg, params


@torch.no_grad()
def _accuracy(params, cfg, softmax, n_batches=8, seed=99):
    cfg2 = cfg.with_(softmax_impl=softmax)
    dev = params["head"]["w"].device
    correct = total = 0
    for s in range(n_batches):
        b = classify_batch(seed, 1000 + s, 64, 24, vocab=cfg.vocab, device=dev)
        lg = _logits(params, b["tokens"], cfg2)
        correct += int(torch.sum(torch.argmax(lg, -1) == b["labels"]))
        total += lg.shape[0]
    return correct / total


@torch.no_grad()
def softmax_error_metrics(impl, z=None, device=None):
    """Distribution-level errors on attention-shaped logits: ``z`` (256,
    128) normal x 3 from a CPU generator seeded 0 unless given."""
    if z is None:
        z = torch.randn((256, 128), generator=torch.Generator().manual_seed(0),
                        dtype=F32) * 3.0
        z = z.to(resolve_device(device))
    s = get_softmax(impl)(z).to(F32)
    ref = torch.softmax(z, dim=-1)
    p = s / torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=1e-9)
    kl = torch.sum(ref * (torch.log(ref + 1e-12) - torch.log(p + 1e-12)), dim=-1)
    return dict(mean_abs=float(torch.mean(torch.abs(s - ref))),
                max_abs=float(torch.max(torch.abs(s - ref))),
                mean_kl=float(torch.mean(kl)))


def run(report, device=None):
    cfg, params = _train_classifier(device=device)
    base = _accuracy(params, cfg, "exact")
    for impl in IMPLS:
        acc = _accuracy(params, cfg, impl)
        em = softmax_error_metrics(impl, device=device)
        report(f"table1,{impl},acc={acc:.4f},delta={acc - base:+.4f},"
               f"mean_abs={em['mean_abs']:.5f},max_abs={em['max_abs']:.4f},"
               f"kl={em['mean_kl']:.5f}")
    return base
