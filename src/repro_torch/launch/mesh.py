"""Mesh construction: the production meshes (16x16 and 2x16x16), a small
host mesh, and the device-free ``AbstractMesh`` for spec math.

The PyTorch counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed`` ``DeviceMesh`` over the initialized process group,
one rank a process (the port is SPMD, where JAX has one controller over
the mesh).  The group must exist before a mesh is made: a launcher under
``python -m torch.distributed.run`` initializes it from ``RANK`` and
``WORLD_SIZE`` (``init_from_env``).  Meshes run on the card unless the
caller asks for ``device="cpu"``.  Ranks that share one card (one H100)
talk over gloo, which moves CUDA tensors through host memory; the compute
stays on the card.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: JAX's ``AbstractMesh``, for spec
    math at production geometry in one process."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def init_from_env(device=None) -> tuple[int, int]:
    """(rank, world size) as ``torch.distributed.run`` sets them (1 process:
    (0, 1)).  Above one process it initializes the gloo group, on the card
    unless ``device`` says otherwise (each rank takes ``cuda:0``: the ranks
    share the one card)."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 and not dist.is_initialized():
        if resolve_device(device).type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return rank, world


def mesh_over(ranks, shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (row-major); every rank of
    the process group calls it, those outside the mesh too."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    mesh = torch.tensor(list(ranks), dtype=torch.int).reshape(shape)
    return DeviceMesh(dev.type, mesh, mesh_dim_names=tuple(axes))


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device=None):
    """A mesh over the first ``prod(shape)`` ranks of the initialized group
    (tests, the launcher)."""
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < size:
        raise RuntimeError(f"mesh {tuple(shape)} needs {size} ranks, the "
                           f"process group has {world}")
    return mesh_over(range(size), shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16x16 ("data", "model") mesh of ``MeshConfig()``, or its 2x16x16
    variant with "pod"."""
    mcfg = (MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model")) if multi_pod
            else MeshConfig())
    shape, axes = mcfg.shape, mcfg.axes
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < size:
        raise RuntimeError(
            f"need {size} ranks, have {world}; the production mesh runs under "
            f"python -m torch.distributed.run with {size} processes")
    return mesh_over(range(size), shape, axes, device)
