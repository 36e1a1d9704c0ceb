"""The ranks of ``tests/test_torch_mesh.py``: spawned CPU processes over
gloo, one per rank, that import the port only (no JAX).

``Spawned(world, inputs)`` starts ``world`` processes that join a gloo
group through a file store and run ``TASKS[task](rank, world, inputs)``
for each task; its ``result()`` returns rank 0's results.  Inputs and
results pass through ``torch.save`` files in a temporary directory.  A
failing rank fails the run.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import optim
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.core.hyft import HYFT16, HYFT32
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import elastic_remesh
from repro_torch.kernels.flash_attention import flash_hyft_decode
from repro_torch.launch.dryrun_meter import CollectiveMeter
from repro_torch.launch.mesh import make_host_mesh, mesh_over
from repro_torch.models import attention, build_model
from repro_torch.obs.profile import count_cost
from repro_torch.optim.compression import compressed_psum_tree
from repro_torch.train.state import state_shardings
from repro_torch.train.step import build_train_step
from repro_torch.tree import tree_map

HYFT = {"hyft32": HYFT32, "hyft16": HYFT16}


def _whole(tree):
    return tree_map(lambda t: (t.full_tensor() if shd.is_dtensor(t) else t).clone(), tree)


def train_case(case, params, batches):
    """Two steps of the sharded step on ``case["mesh"]``: the losses and
    the parameters after each (whole, on every rank), the collectives of
    the first step (the dry-run's meter: calls and bytes by kind) and the
    cost of the second (``count_cost``: its state is placed already, as the
    dry-run's is)."""
    cfg = smoke_config(get_config(case["arch"])).with_(**case["cfg"])
    model = build_model(cfg)
    ocfg = optim.OptConfig(**case["opt"])
    tcfg = TrainConfig(**case["train"])
    mesh = make_host_mesh(case["mesh"], device="cpu")
    rules = shd.default_rules(mesh, cfg)
    state_sh = state_shardings(mesh, model, ocfg, rules)
    batch_sh = shd.batch_shardings(mesh, batches[0], rules)
    params = tree_map(torch.clone, params)
    state = {"params": params, "opt": optim.init(ocfg, params),
             "step": torch.tensor(case["step0"], dtype=torch.int32)}
    step = build_train_step(model, tcfg, ocfg, mesh, state_sh, batch_sh)
    out, meter, cost = [], CollectiveMeter(), None
    for i, batch in enumerate(batches):
        if i == 1:
            (state, metrics), cost = count_cost(step, state, batch)
        else:
            with meter if i == 0 else contextlib.nullcontext():
                state, metrics = step(state, batch)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": _whole(state["params"])})
    placements = tree_map(lambda t: tuple(t.placements), state["params"])
    return {"steps": out, "placements": placements, "collectives": meter.counts,
            "cost": cost}


def _train(rank, world, inputs):
    return {name: train_case(case, inputs["params"][case["weights"]],
                             inputs["batches"][case["weights"]])
            for name, case in inputs["cases"].items()}


def _sp_decode(rank, world, inputs):
    """sp_decode_attention over groups of 1, 2 and 4 ranks, each rank
    holding its contiguous slice of the keys."""
    # every rank takes part in every new_group, in one order
    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]),
              4: dist.new_group(list(range(world)))}
    out = {}
    for W, group in groups.items():
        if rank >= W:
            continue
        for name, cfg in HYFT.items():
            x = inputs[name]
            out[(W, name)] = _sp_part(x["q"], x["k"], x["v"], x["valid"], cfg, group, rank, W)
    # chip_smoke.py's shape over the 4 ranks, against kernel 6's plain version
    x = inputs["chip"]
    valid = torch.arange(x["k"].shape[2])[None, :] < x["lengths"][:, None]
    sp = _sp_part(x["q"], x["k"], x["v"], valid, HYFT16, groups[4], rank, world)
    fl = flash_hyft_decode(x["q"], x["k"], x["v"], HYFT16, kv_len_mask=valid.float())
    out["chip"] = {"sp": sp, "gap": float((sp - fl).abs().max())}
    return out


def _sp_part(q, k, v, valid, cfg, group, rank, W):
    """This rank's contiguous slice of the keys through sp_decode_attention."""
    Ss = k.shape[2] // W
    sl = slice(rank * Ss, (rank + 1) * Ss)
    return attention.sp_decode_attention(q, k[:, :, sl], v[:, :, sl], valid[:, sl], cfg,
                                         group=group)


def _collectives(rank, world, inputs):
    """compressed_psum_tree over the world (each rank its own tree and its
    own noise), elastic_remesh at model sizes 1, 2, 3, and a checkpoint
    restored on a (2, 2) mesh and saved from it."""
    gen = torch.Generator().manual_seed(100 + rank)
    trees = inputs["trees"]
    summed = compressed_psum_tree(trees[rank], None, gen)
    def seen(mesh):      # rank 0's view; a rank outside the mesh has no coordinate
        return tuple(mesh.shape), mesh.mesh.tolist(), mesh.get_coordinate()
    meshes = {m: seen(elastic_remesh(m, device="cpu")) for m in (1, 2, 3)}
    meshes["lost"] = seen(elastic_remesh(2, ranks=[0, 1, 3], device="cpu"))
    try:
        elastic_remesh(4, ranks=[0, 1, 2], device="cpu")
        meshes["too_few"] = None
    except RuntimeError as e:
        meshes["too_few"] = str(e)
    # the checkpoint: written by one process (a (1, 1) run), restored on
    # (2, 2) by shardings, saved again from (2, 2)
    ck = inputs["ckpt"]
    mesh = make_host_mesh((2, 2), device="cpu")
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(vocab=64)
    model = build_model(cfg)
    ocfg = optim.OptConfig(name=ck["opt"])
    sh = state_shardings(mesh, model, ocfg, shd.default_rules(mesh, cfg))
    from repro_torch.train.state import abstract_state
    like, _ = abstract_state(model, ocfg)
    state, step = checkpointer.restore(ck["src"], ck["step"], like, shardings=sh)
    placements = tree_map(lambda t: tuple(t.placements), state)
    copies = []                  # the leaves this rank copies to the host
    to_numpy = checkpointer._to_numpy
    checkpointer._to_numpy = lambda t: (copies.append(1), to_numpy(t))[1]
    try:
        checkpointer.save(ck["dst"], step, state)
    finally:
        checkpointer._to_numpy = to_numpy
    host_copies = [None] * world
    dist.all_gather_object(host_copies, len(copies))
    return {"summed": summed, "meshes": meshes, "restored": _whole(state),
            "restored_placements": placements, "mesh_coord": mesh.get_coordinate(),
            "host_copies": host_copies}


def _gqa(rank, world, inputs):
    """attention_fwd on a (1, 4) mesh with the q heads over ``model`` and
    the kv heads whole (the GQA trap), in each mode: the output and the
    q/k/v gradients, whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = mesh_over(range(world), (1, world), ("data", "model"), device="cpu")
    cfg = smoke_config(get_config("qwen2-1.5b")).with_(**inputs["cfg"])

    def put(t, placements):
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    out = {}
    for heads, x in inputs["cases"].items():
        for mode in ("kernel", "unfused", "chunked"):
            q = put(x["q"], (Replicate(), Shard(1))).detach().requires_grad_()
            k, v = (put(x[n], (Replicate(), Replicate())).detach().requires_grad_()
                    for n in ("k", "v"))
            o = attention.attention_fwd(q, k, v, cfg.with_(attn_mode=mode), causal=True)
            torch.autograd.backward(o, put(x["do"], o.placements))
            out[(heads, mode)] = {
                "o": o.full_tensor(), "dq": q.grad.full_tensor(),
                "dk": k.grad.full_tensor(), "dv": v.grad.full_tensor(),
                "placements": (tuple(o.placements), tuple(k.grad.placements))}
    return out


def _ssm(rank, world, inputs):
    """mamba2 smoke's loss and gradients on mesh (2, 1), the SSD on each
    rank's batch rows (``ssm._ssm_train_sharded``): whole, on every rank."""
    from repro_torch.train.step import grads_of, make_loss_fn
    cfg = smoke_config(get_config("mamba2-370m")).with_(**inputs["cfg"])
    model = build_model(cfg)
    mesh = make_host_mesh((2, 1), device="cpu")
    rules = shd.default_rules(mesh, cfg)
    psh = shd.param_shardings(mesh, inputs["params"], model.axes(), rules)
    params = tree_map(lambda t, s: shd.place(t.clone(), s), inputs["params"], psh)
    batch = tree_map(shd.place, inputs["batch"],
                     shd.batch_shardings(mesh, inputs["batch"], rules))
    with shd.mesh_compute(mesh, cfg):
        loss, _, grads = grads_of(make_loss_fn(model, TrainConfig(remat="full")), params, batch)
    return {"loss": float(loss.full_tensor()), "grads": _whole(grads)}


TASKS = {"train": _train, "sp_decode": _sp_decode, "collectives": _collectives,
         "gqa": _gqa, "ssm": _ssm}


def _rank(rank, world, store, tasks, inputs_path, out_dir):
    torch.set_flush_denormal(True)
    torch.set_num_threads(1)       # smoke sizes: one thread a rank
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        for task in tasks:
            res = TASKS[task](rank, world, inputs[task])
            if rank == 0:
                torch.save(res, os.path.join(out_dir, f"{task}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


class Spawned:
    """``world`` ranks running each task of ``inputs`` ({task: its
    inputs}) in one group, started at once; ``result()`` waits for them
    (a failing rank raises there) and returns {task: rank 0's result};
    ``close()`` ends them."""

    def __init__(self, world: int, inputs: dict):
        self.tmp = pathlib.Path(tempfile.mkdtemp(prefix="mesh_ranks_"))
        self.tasks = list(inputs)
        torch.save(inputs, self.tmp / "inputs.pt")
        self.ctx = mp.start_processes(
            _rank, args=(world, str(self.tmp / "store"), self.tasks,
                         str(self.tmp / "inputs.pt"), str(self.tmp)),
            nprocs=world, join=False, start_method="spawn")

    def result(self) -> dict:
        deadline = time.monotonic() + 600
        while not self.ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError("the mesh ranks ran past 600 s")
        return {t: torch.load(self.tmp / f"{t}.pt", weights_only=False) for t in self.tasks}

    def close(self):
        """Stop any rank still running and remove the directory."""
        for proc in self.ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        shutil.rmtree(self.tmp, ignore_errors=True)
