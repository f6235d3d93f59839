"""Activation-sharding context (port of `repro.models.pspec`): the launcher
declares which mesh axes carry data parallelism / tensor parallelism, and
the model constrains its activations at the reference's points (after the
embedding, at each group boundary, on the logits, around the MoE buffer)
so that a sharded run never silently replicates them.

The port runs sharded through DTensor: `constrain` redistributes a DTensor
to the placements (`placements`) of the `PartitionSpec` it builds.
Outside `activation_axes`, or on a plain tensor, it returns its input
unchanged, so every single-card path runs exactly as it did. The spec type
and its placements live here, under the model, and the launcher's rules
(`launch.sharding`) build on them.

The reference's `unroll_scan` / `scan_unroll` have no counterpart: the
port loops over its layers (no scan), so a dry-run counts every layer.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of names
    (the port's counterpart of `jax.sharding.PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry) -> tuple:
    """The mesh axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: one a mesh dimension,
    `Shard(d)` where tensor dim d names it, else `Replicate()`. A tensor
    dim over ("pod", "data") is `Shard(d)` on both mesh dims; DTensor
    splits it over the first, then each piece over the second, which is
    JAX's row-major layout of a tuple entry in mesh order. Raises when a
    mesh axis is named twice, or a tuple entry names its axes out of mesh
    order."""
    from torch.distributed.tensor import Replicate, Shard

    dims = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(dims)
    seen: set = set()
    for d, entry in enumerate(spec):
        names = entry_axes(entry)
        idx = [dims.index(a) if a in dims else -1 for a in names]
        if -1 in idx:
            raise ValueError(f"spec {spec} names an axis the mesh {dims} does not have")
        if idx != sorted(idx) or seen & set(names):
            raise ValueError(f"spec {spec}: each mesh axis once, a tuple entry in mesh order "
                             f"{dims}")
        seen |= set(names)
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@contextlib.contextmanager
def activation_axes(mesh, dp=("data",), tp="model", sp=None, ep_shard_map=False):
    """dp: data-parallel axes (batch dim); tp: tensor axis; sp: sequence axis.

    ep_shard_map=True routes MoE through the manual expert-parallel
    dispatch (`models.moe.moe_ffn_ep` on the local shards over the `tp`
    axis's group, one all-reduce of the partial outputs) instead of
    DTensor's propagation through the sorted dispatch."""
    _register_rules()
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    prev = getattr(_state, "axes", None)
    _state.axes = dict(dp=dp, tp=tp, sp=sp, sizes=sizes, ep_shard_map=ep_shard_map, mesh=mesh)
    try:
        yield
    finally:
        _state.axes = prev


_RULES: list = []


def _register_rules() -> None:
    """DTensor sharding rules for the ops of the models that have none: the
    MoE dispatch's `searchsorted` runs on any layout of its values over a
    whole sorted sequence, and gives the values' layout."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def searchsorted(sorted_sequence, values, *args, **kwargs):
        rest = [None] * (len(args) + len(kwargs))
        out = [([Replicate()], [Replicate(), Replicate()] + rest)]
        for d in range(values.ndim):
            out.append(([Shard(d)], [Replicate(), Shard(d)] + rest))
        return out

    _RULES.append(searchsorted)


@contextlib.contextmanager
def restored(a):
    """Re-enter the context `a` (an earlier `axes()`) where none is active:
    a checkpointed segment's recompute runs in autograd's thread, which has
    no context of its own."""
    prev = getattr(_state, "axes", None)
    if prev is None and a is not None:
        _state.axes = a
    try:
        yield
    finally:
        _state.axes = prev


def ep_shard_map():
    """Returns (mesh, dp_axes, tp_axis) when the manual EP path is on."""
    a = axes()
    if a and a.get("ep_shard_map"):
        return a["mesh"], a["dp"], a["tp"]
    return None


def axes():
    return getattr(_state, "axes", None)


def fits(n: int, axis: str = "tp") -> bool:
    """Whether n divides the size of the context's `axis` (True outside
    `activation_axes`, where nothing is sharded)."""
    a = axes()
    return a is None or (a.get(axis) is not None and n % _size(a["sizes"], a[axis]) == 0)


def _size(sizes, v) -> int:
    if v is None:
        return 1
    if isinstance(v, str):
        return sizes.get(v, 1)
    return math.prod(sizes.get(a, 1) for a in v)


def _entries(a, x, dims) -> list:
    entries = []
    used: set = set()
    for i, d in enumerate(dims):
        v = a.get(d) if d is not None else None
        flat = (v,) if isinstance(v, str) else tuple(v or ())
        if (v is not None and x.shape[i] % _size(a["sizes"], v) == 0
                and not (set(flat) & used)):
            entries.append(v)
            used |= set(flat)
        else:
            entries.append(None)
    return entries


def is_dtensor(x) -> bool:
    """Whether x is a DTensor (a plain tensor answers without a lookup in
    torch.distributed: the check sits on every single-card step)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(x):
    """The context's axes when x is a DTensor inside it, else None."""
    a = axes()
    return a if a is not None and is_dtensor(x) else None


def _to(x, entries):
    return _Redistribute.apply(x, placements(P(*entries), x.device_mesh))


class _Redistribute(torch.autograd.Function):
    """`DTensor.redistribute` whose gradient goes back to the input's
    layout (a partial input's gradient replicated), whatever PyTorch's own
    backward would leave it in, so that the view a gradient meets next (a
    head split undone) never sees a layout it cannot take."""

    @staticmethod
    def forward(ctx, t, placements):
        from torch.distributed.tensor import Replicate

        ctx.back = tuple(Replicate() if p.is_partial() else p for p in t.placements)
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.back), None


def constrain(x, *dims):
    """dims entries: 'dp' | 'tp' | 'sp' | None per tensor dim; an axis is
    used when it divides the dim and no earlier dim took it. A DTensor is
    redistributed to that spec (left as it is when the spec is all None,
    as the reference leaves it unconstrained); anything else is returned as
    it is."""
    a = _sharded(x)
    if a is None:
        return x
    entries = _entries(a, x, dims)
    return x if all(e is None for e in entries) else _to(x, entries)


def layout(x, *dims):
    """`constrain`, but an all-None spec replicates: the explicit layout of
    a weight before a product (the FSDP all-gather of its DP dims), so
    that neither the product nor its gradient takes a layout a reshape
    cannot undo."""
    a = _sharded(x)
    return x if a is None else _to(x, _entries(a, x, dims))


def local(x, partial=()):
    """x's local tensor, for a block a rank computes on its own: its
    gradient comes back contiguous (DTensor views a local gradient as if it
    were) and is a partial sum over the mesh dims of the context's roles in
    `partial` ("dp", "tp"): the ones over which x's users are split while x
    is not."""
    from torch.distributed.tensor import Partial

    a = axes()
    names = set()
    for role in partial:
        v = a.get(role)
        names |= {v} if isinstance(v, str) else set(v or ())
    dims = tuple(x.device_mesh.mesh_dim_names)
    grad = tuple(Partial() if dims[i] in names else p for i, p in enumerate(x.placements))
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad))


class _ContiguousGrad(torch.autograd.Function):
    """Identity; its gradient made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def shard_index(x, dim: int) -> tuple:
    """(this rank's index, the count) of the even pieces DTensor `x` splits
    tensor dim `dim` into over its mesh (row-major over the mesh dims that
    shard it): its local piece starts at index · local size."""
    from torch.distributed.tensor import Shard

    mesh, idx, n = x.device_mesh, 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx, n = idx * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return idx, n

