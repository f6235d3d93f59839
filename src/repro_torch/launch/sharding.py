"""Sharding rules: config + mesh → partition specs for parameters, optimizer
states, batches and caches (port of `repro.launch.sharding`).

Baseline layout (the named variants are `launch.plans`):
  - 2D FSDP×TP: every big matrix shards its input-ish dim over the
    data-parallel axes and its output-ish dim over `model`;
  - MoE experts shard over `model` (expert parallelism), expert weights'
    d_model dim over FSDP;
  - KV caches: batch over DP; kv-heads over `model` when divisible, else
    the sequence dim when divisible, else replicated;
  - optimizer states inherit the parameter specs (ZeRO-1 for free).
A dim is only assigned a mesh axis when its size divides the axis size —
`_fit` degrades gracefully for the reduced configs.

The port keeps its own small `PartitionSpec` (`models.pspec`: one entry
per tensor dim, None, a mesh axis name, or a tuple of names) and maps it
onto a `torch.distributed` `DeviceMesh` as DTensor placements
(`pspec.placements`): mesh dimension i is `Shard(d)` when tensor dim d
names it, else `Replicate()`.

Parameters are addressed by their dotted `LM.named_parameters()` names
(`layers.3.attn.wq`); the rule reads only the last name and whether
"moe" is in the path. The port keeps one tensor a layer, where the
reference stacks a group axis in front: its rules pad that axis with None,
so the port's spec is the reference's without its leading None.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models.pspec import P, PartitionSpec, entry_axes, placements


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of `jax.sharding.NamedSharding`)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _axis_size(mesh, axes) -> int:
    return math.prod(axis_size(mesh, a) for a in entry_axes(axes))


def _fit(mesh, axes, dim: int):
    """Return axes if dim divides their product size, else None."""
    return axes if axes is not None and dim % _axis_size(mesh, axes) == 0 else None


def local_shape(shape, spec, mesh) -> tuple:
    """This rank's shard shape of a tensor of `shape` under `spec` (every
    sharded dim divides its axes' size, as `_fit` makes sure)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def param_spec(path: str, shape: tuple, mesh, *, fsdp) -> PartitionSpec:
    """Spec for one parameter; `path` is its dotted (or '/'-joined) name."""
    name = path.replace("/", ".").split(".")[-1]
    nd = len(shape)

    def spec(*entries):
        return P(*([None] * (nd - len(entries)) + list(entries)))

    if name in ("embed", "unembed"):
        return P(_fit(mesh, fsdp, shape[-2]), _fit(mesh, "model", shape[-1]))
    if name in ("wq", "wk", "wv"):  # [d, H, hd]
        return spec(_fit(mesh, fsdp, shape[-3]), _fit(mesh, "model", shape[-2]), None)
    if name == "wo":  # [H, hd, d]
        return spec(_fit(mesh, "model", shape[-3]), None, _fit(mesh, fsdp, shape[-1]))
    if name in ("bq", "bk", "bv"):  # [H, hd]
        return spec(_fit(mesh, "model", shape[-2]), None)
    if name in ("w_gate", "w_in", "w_out"):
        if "moe" in path:
            # experts: EP over model on E; FSDP on the d_model dim
            if name == "w_out":  # [E, f, d]
                return spec(_fit(mesh, "model", shape[-3]), None, _fit(mesh, fsdp, shape[-1]))
            return spec(_fit(mesh, "model", shape[-3]), _fit(mesh, fsdp, shape[-2]), None)
        if name == "w_out":  # [f, d]
            return spec(_fit(mesh, "model", shape[-2]), _fit(mesh, fsdp, shape[-1]))
        return spec(_fit(mesh, fsdp, shape[-2]), _fit(mesh, "model", shape[-1]))
    if name == "router":  # [d, E]
        return spec(_fit(mesh, fsdp, shape[-2]), None)
    if name == "in_proj":  # [d, e]
        return spec(_fit(mesh, fsdp, shape[-2]), _fit(mesh, "model", shape[-1]))
    if name == "out_proj":  # [d_in, d]
        return spec(_fit(mesh, "model", shape[-2]), _fit(mesh, fsdp, shape[-1]))
    if name == "conv_w":  # [K, c]
        return spec(None, _fit(mesh, "model", shape[-1]))
    if name in ("conv_b", "out_norm", "dt_bias", "A_log", "D"):
        return spec(_fit(mesh, "model", shape[-1]))
    # norms, scalars → replicated
    return P(*([None] * nd))


def param_shardings(cfg, params, mesh, fsdp=None) -> dict:
    """{name: NamedSharding} for every parameter of `params` (an `LM`, on
    any device, "meta" too). fsdp=() replicates weights over the DP axes
    (the serving layout: no per-step parameter all-gathers, at the cost of
    memory)."""
    del cfg  # the rules read the names and shapes alone, as the reference's
    if fsdp is None:
        fsdp = dp_axes(mesh)
    fsdp = fsdp if fsdp else None
    return {n: NamedSharding(mesh, param_spec(n, tuple(p.shape), mesh, fsdp=fsdp))
            for n, p in params.named_parameters()}


def opt_state_shardings(param_shard: dict, mesh) -> dict:
    """mu/nu inherit parameter shardings; step replicated (ZeRO-1)."""
    return dict(mu=param_shard, nu=param_shard, step=NamedSharding(mesh, P()))


def cache_spec(field: str, shape: tuple, mesh) -> PartitionSpec:
    """The spec of one cache tensor, by its field name: the reference's
    rules without the leading group None."""
    fsdp = dp_axes(mesh)
    if field in ("k", "v"):  # [B, S, Hkv, hd]
        heads = _fit(mesh, "model", shape[2])
        seq = None if heads else _fit(mesh, "model", shape[1])
        return P(_fit(mesh, fsdp, shape[0]), seq, heads, None)
    if field == "state":  # [B, nh, p, n]
        return P(_fit(mesh, fsdp, shape[0]), _fit(mesh, "model", shape[1]), None, None)
    if field == "conv":  # [B, K-1, c]
        return P(_fit(mesh, fsdp, shape[0]), None, _fit(mesh, "model", shape[2]))
    return P(*([None] * len(shape)))


CACHE_FIELDS = {"KVCache": ("k", "v"), "SSMCache": ("state", "conv")}


def lay_out_caches(caches: list, mesh) -> list:
    """`caches` (from `init_caches` on the meta device) as zeros laid out on
    `mesh` by `cache_spec`: a sharded prefill step's `cache_layout`."""
    from torch.distributed.tensor import zeros

    for c in caches:
        for f in CACHE_FIELDS[type(c).__name__]:
            t = getattr(c, f)
            pl = placements(cache_spec(f, tuple(t.shape), mesh), mesh)
            setattr(c, f, zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh, placements=pl))
    return caches


def cache_specs(cfg, caches: list, mesh) -> list:
    """One {field: NamedSharding} a layer's cache of `caches` (from
    `transformer.init_caches`, any device)."""
    del cfg
    return [{f: NamedSharding(mesh, cache_spec(f, tuple(getattr(c, f).shape), mesh))
             for f in CACHE_FIELDS[type(c).__name__]} for c in caches]


def batch_shardings(batch: dict, mesh) -> dict:
    """Token/embed batches: leading batch dim over DP axes; scalars (a
    0-d tensor, or the decode step's Python `pos`) replicated."""
    fsdp = dp_axes(mesh)
    out = {}
    for k, leaf in batch.items():
        nd = getattr(leaf, "ndim", 0)
        out[k] = NamedSharding(mesh, P() if nd == 0 else
                               P(_fit(mesh, fsdp, leaf.shape[0]), *([None] * (nd - 1))))
    return out
