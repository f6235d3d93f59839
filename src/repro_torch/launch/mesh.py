"""Device meshes for the distributed engine (port of `repro.launch.mesh`).

A `torch.distributed.device_mesh.DeviceMesh` is the counterpart of a JAX
`Mesh`: named dimensions, their sizes, and a process group a dimension.
A mesh is made over the default process group, which the caller starts on
every rank with `torch.distributed.init_process_group` (its address, world
size, rank and a timeout): nothing here starts one. On the card the mesh
runs over NCCL with each rank on `cuda:<local rank>`; `device_type="cpu"`
gives gloo and CPU tensors. Nothing falls back from the one to the other.

The TPU pods' `make_production_mesh` is not ported.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

# The collective backend each mesh device type runs over.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_host_mesh(n: Optional[int] = None, name: str = "workers", *,
                   device_type: Optional[str] = None):
    """A flat mesh of shape (n,) named (name,) over the whole default
    process group (n defaults to, and must equal, its world size). By
    default on the card over NCCL, each rank on `cuda:<local rank>`
    (`LOCAL_RANK`, else the rank modulo the cards); `device_type="cpu"`
    for gloo and CPU tensors. Raises without an initialised default group,
    without a card unless the CPU is asked for, and when the group's
    backend is not the device type's."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device_type='cpu' for a mesh of CPU ranks over gloo"
            )
        device_type = "cuda"
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {tuple(BACKENDS)}, got {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call torch.distributed.init_process_group(backend, "
            "init_method=..., world_size=..., rank=..., timeout=...) on every rank first"
        )
    backend = dist.get_backend()
    if BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type} mesh runs over {BACKENDS[device_type]}, but the "
                         f"default process group's backend is {backend!r}")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a host mesh spans the whole world: n={n}, world size {world}")
    if device_type == "cuda":
        rank = dist.get_rank()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(name,))


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod','data') multi-pod, ('data',) single-pod."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension `name`."""
    dims = tuple(mesh.mesh_dim_names or ())
    if name not in dims:
        raise ValueError(f"mesh has no dimension {name!r}; its dimensions are {dims}")
    return int(mesh.shape[dims.index(name)])


def mesh_size(mesh) -> int:
    return math.prod(int(s) for s in mesh.shape)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if mesh.device_type != "cpu":
        raise ValueError(f"mesh device type must be 'cuda' or 'cpu', got {mesh.device_type!r}")
    return torch.device("cpu")


def axes_group(mesh, axes) -> tuple:
    """(process group, this rank's index along them, their size) of the
    mesh dimensions `axes` taken together: one name, or a tuple naming
    every dimension, in order, of a mesh laid over the world's ranks in
    row-major order (as `init_device_mesh` lays them): the group is then
    the world's, and the index the global rank."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = [axis_size(mesh, a) for a in names]
    if len(names) == 1:
        return mesh.get_group(names[0]), mesh.get_local_rank(names[0]), sizes[0]
    world = dist.get_world_size()
    if names != tuple(mesh.mesh_dim_names) or mesh.mesh.flatten().tolist() != list(range(world)):
        raise ValueError(f"mesh axes {names} must name every dimension, in order, of a mesh "
                         f"laid over ranks 0..{world - 1}; the mesh has "
                         f"{tuple(mesh.mesh_dim_names)} over {mesh.mesh.tolist()}")
    return dist.group.WORLD, dist.get_rank(), math.prod(sizes)
