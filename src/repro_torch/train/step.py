"""Train-step factory: grad accumulation, clipping, schedule, optimizer.

Own copy of ``repro.train.step``.  ``make_step_fn`` returns a (state, batch)
-> (state, metrics) function.  Microbatch accumulation is a Python loop
over the leading batch split (sum of the gradients, then ``/ n``).  The
metrics stay 0-d tensors on the device: reading them is the caller's
choice, so a step waits for nothing on the host.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs.base import TrainConfig
from repro_torch.models import resolve_attn_mode
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def make_loss_fn(model, tcfg: TrainConfig):
    # attention-mode override: "kernel" trains through the fused CUDA
    # forward and backward kernels (the autograd Function of
    # flash_hyft_attention)
    model = resolve_attn_mode(model, tcfg.attn_mode)

    def loss_fn(params, batch):
        return model.loss(params, batch, remat=tcfg.remat, z_loss=tcfg.z_loss,
                          moe_aux_weight=tcfg.moe_aux_weight)
    return loss_fn


def grads_of(loss_fn, params, batch):
    """(loss, metrics, grads): the gradient of ``loss_fn`` with respect to
    every parameter leaf (zero for a leaf the loss does not use)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(live, batch)
    leaves = tree_leaves(live)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, gs))


def make_step_fn(model, tcfg: TrainConfig, opt_cfg: optim.OptConfig):
    loss_fn = make_loss_fn(model, tcfg)
    schedule = SCHEDULES["warmup_cosine"]

    def step_fn(state, batch):
        params = state["params"]
        n_rows = batch["tokens"].shape[0]
        if tcfg.microbatch and tcfg.microbatch < n_rows:
            n, mb = n_rows // tcfg.microbatch, tcfg.microbatch
            grads, loss, history = None, None, []
            for i in range(n):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, m_i, g_i = grads_of(loss_fn, params, part)
                g_i = tree_map(lambda g: g.to(F32), g_i)
                grads = g_i if grads is None else tree_map(torch.add, grads, g_i)
                loss = l_i if loss is None else loss + l_i
                history.append(m_i)
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = {k: torch.mean(torch.stack([m[k] for m in history]))
                       for k in history[0]}
        else:
            loss, metrics, grads = grads_of(loss_fn, params, batch)

        with torch.no_grad():
            grads, gnorm = optim.clip_by_global_norm(grads, tcfg.grad_clip)
            lr_scale = schedule(state["step"], warmup=tcfg.warmup_steps,
                                total=tcfg.total_steps)
            params, opt = optim.update(opt_cfg, grads, state["opt"], params,
                                       lr_scale=lr_scale)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale,
                           **metrics}

    return step_fn


def build_train_step(model, tcfg: TrainConfig, opt_cfg: optim.OptConfig):
    """The step for one device (the JAX version adds shardings and state
    donation; the port's optimizer updates in place instead)."""
    return make_step_fn(model, tcfg, opt_cfg)
