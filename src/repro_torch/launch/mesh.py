"""Device meshes for the distributed engine (port of `repro.launch.mesh`).

A `torch.distributed.device_mesh.DeviceMesh` is the counterpart of a JAX
`Mesh`: named dimensions, their sizes, and a process group a dimension.
A mesh is made over the default process group, which the caller starts on
every rank with `torch.distributed.init_process_group` (its address, world
size, rank and a timeout): nothing here starts one. On the card the mesh
runs over NCCL with each rank on `cuda:<local rank>`; `device_type="cpu"`
gives gloo and CPU tensors. Nothing falls back from the one to the other.

`make_production_mesh` lays the production meshes, 16 × 16 over ("data",
"model") or 2 × 16 × 16 over ("pod", "data", "model"), over a default
group of 256 or 512 ranks: NCCL across real nodes, or the fake world of
`fake_world`, in which one process runs rank 0 of the production world
and no collective moves data (the graph engine's dry-run).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# The collective backend each mesh device type runs over.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# The production meshes: one pod of 16 x 16 ranks, or two.
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}
FAKE = "fake"  # the backend `fake_world` starts


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

    device_type = _mesh_device_type(device_type)
    backend = dist.get_backend()
    if BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type} mesh runs over {BACKENDS[device_type]}, but the "
                         f"default process group's backend is {backend!r}")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a host mesh spans the whole world: n={n}, world size {world}")
    if device_type == "cuda":
        _bind_card()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(name,))


def _mesh_device_type(device_type: Optional[str]) -> str:
    """The mesh's device type (the card unless the CPU is asked for), once
    the default process group is known to exist."""
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
    return device_type


def _bind_card() -> None:
    """This rank's card: `LOCAL_RANK`, else the rank modulo the cards."""
    rank = dist.get_rank()
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The production mesh: (16, 16) over ("data", "model"), or with
    `multi_pod` (2, 16, 16) over ("pod", "data", "model"), over the whole
    default process group, which must hold 256 or 512 ranks. It takes the
    backend the caller started: the device type's (NCCL on the card, gloo
    on the CPU) across real nodes, or the fake world of `fake_world`. By
    default on the card; `device_type="cpu"` for CPU tensors. Raises
    without an initialised default group, without a card unless the CPU is
    asked for, on another backend, and on a world of another size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    device_type = _mesh_device_type(device_type)
    backend = dist.get_backend()
    if backend != FAKE and BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type} production mesh runs over {BACKENDS[device_type]} "
                         f"or in a fake world, but the default process group's backend is "
                         f"{backend!r}")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} over {names} needs a world of "
                         f"{math.prod(shape)} ranks, the default group has {world}")
    if device_type == "cuda":
        _bind_card()
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


class _FakeExchange(TorchDispatchMode):
    """Gives the fake backend's all-to-all one meaning on every PyTorch: its
    receive buffer becomes the send buffer (PyTorch 2.13's fake backend
    copies it; 2.11's leaves the receive buffer as it was, whatever memory
    it held). DTensor's functional collectives get the same: an all-gather
    fills every slot with this rank's input, a reduce-scatter hands this
    rank the first piece of its own input, an all-to-all and an all-reduce
    hand back the input. Every other op passes through."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional" and isinstance(out, torch.Tensor):
            name, src = func._overloadpacket.__name__, args[0]
            if name == "all_gather_into_tensor":
                out.view(-1, *src.shape[1:]).unflatten(0, (-1, src.shape[0])).copy_(src)
            elif name == "reduce_scatter_tensor":
                out.copy_(src[:out.shape[0]])
            elif name in ("all_to_all_single", "all_reduce"):
                out.copy_(src.reshape(out.shape))
            return out
        if func.namespace == "c10d" and func._overloadpacket.__name__ in ("alltoall_base_",
                                                                          "alltoall_"):
            bound = dict(zip((a.name for a in func._schema.arguments), args))
            bound.update(kwargs)
            if "output" in bound:
                bound["output"].copy_(bound["input"].reshape(bound["output"].shape))
            else:
                for o, i in zip(bound["output_tensors"], bound["input_tensors"]):
                    o.copy_(i.reshape(o.shape))
        return out


@contextlib.contextmanager
def fake_world(n: int):
    """A fake world of n ranks in this process, as rank 0: the default
    process group on PyTorch's `fake` backend, destroyed on exit. Its
    collectives move no data and return at once: an all-to-all hands each
    rank its own send buffer back (made so here on every PyTorch), an
    all-gather fills every slot with this rank's input, an all-reduce
    leaves the tensor as it was. So one process runs one rank of a
    production world on its real shapes, with each collective it makes
    counted (`launch.roofline.record_collectives`) and none run: the graph
    engine's dry-run (`launch.graph_dryrun`). The only place the port
    starts the fake backend; refuses when a default group exists."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: a fake world needs a "
                           "process of its own (destroy the group first)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group(FAKE, store=FakeStore(), rank=0, world_size=int(n))
    try:
        with _FakeExchange():
            yield
    finally:
        dist.destroy_process_group()


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
