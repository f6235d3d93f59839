"""Carry the reference's data across: numpy arrays (as `repro` holds or
returns them) → the port's objects on a given device.

This is the port's counterpart of loading weights: the parity tests build a
graph, a partition or a `SubgraphSet` with the reference package, hand its
arrays across, and run both packages on the very same structure — which
isolates, e.g., engine parity from build parity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import Graph, PartitionResult
from repro_torch.graph.build import ARRAY_FIELDS, SubgraphSet, check_addressing
from repro_torch.kernels.dispatch import resolve_device

_FIELD_DTYPES = {
    "lsrc": np.int32, "ldst": np.int32, "weight": np.float32, "edge_mask": np.bool_,
    "lsrc_s": np.int32, "ldst_s": np.int32, "weight_s": np.float32, "edge_mask_s": np.bool_,
    "gid": np.int32, "vmask": np.bool_, "is_master": np.bool_, "out_degree": np.float32,
    "send_idx": np.int32, "recv_idx": np.int32, "msg_mask": np.bool_, "recv_mask": np.bool_,
}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C", copy=True)).to(device)


def graph_from_numpy(src, dst, num_vertices: int, *, device="cpu") -> Graph:
    """A `Graph` over int32 copies of the edge arrays (on the host by
    default: the partitioners and the build read the edge list there)."""
    dev = resolve_device(device)
    return Graph(src=_tensor(src, np.int32, dev), dst=_tensor(dst, np.int32, dev),
                 num_vertices=int(num_vertices))


def partition_from_numpy(part, num_parts: int, order=None, *, device=None) -> PartitionResult:
    """A `PartitionResult` (assignments in stream order, and the stream's
    edge permutation `order` if the partitioner reordered the edges)."""
    dev = resolve_device(device)
    return PartitionResult(
        part=_tensor(part, np.int32, dev), num_parts=int(num_parts),
        order=None if order is None else _tensor(order, np.int64, torch.device("cpu")),
    )


def subgraphs_from_numpy(fields: dict, *, num_parts: int, max_v: int, max_e: int,
                         max_msg: int, addressing: str = "two_level",
                         device=None) -> SubgraphSet:
    """A `SubgraphSet` from its sixteen arrays (`fields`, keyed by field
    name) and its static sizes; shapes are checked against the sizes."""
    check_addressing(addressing)
    dev = resolve_device(device)
    missing = set(ARRAY_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"subgraph fields missing: {sorted(missing)}")
    p = int(num_parts)
    shapes = {"e": (p, max_e), "v": (p, max_v), "m": (p, p, max_msg)}
    kind = dict.fromkeys(("lsrc", "ldst", "weight", "edge_mask", "lsrc_s", "ldst_s",
                          "weight_s", "edge_mask_s"), "e")
    kind.update(dict.fromkeys(("gid", "vmask", "is_master", "out_degree"), "v"))
    kind.update(dict.fromkeys(("send_idx", "recv_idx", "msg_mask", "recv_mask"), "m"))
    tensors = {}
    for name in ARRAY_FIELDS:
        arr = np.asarray(fields[name])
        want = shapes[kind[name]]
        if arr.shape != want:
            raise ValueError(f"subgraph field {name} has shape {arr.shape}, expected {want}")
        tensors[name] = _tensor(arr, _FIELD_DTYPES[name], dev)
    return SubgraphSet(**tensors, num_parts=p, max_v=int(max_v), max_e=int(max_e),
                       max_msg=int(max_msg), addressing=addressing)


def subgraph_fields(sub) -> tuple[dict, dict]:
    """(arrays, statics) of any object with the `SubgraphSet` fields — the
    reference's or the port's — as host numpy arrays and Python ints."""
    arrays = {}
    for name in ARRAY_FIELDS:
        a = getattr(sub, name)
        arrays[name] = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    statics = dict(num_parts=int(sub.num_parts), max_v=int(sub.max_v), max_e=int(sub.max_e),
                   max_msg=int(sub.max_msg), addressing=str(sub.addressing))
    return arrays, statics


def to_port(sub, *, device: Optional[str] = None) -> SubgraphSet:
    """Carry a reference `SubgraphSet` across in one call."""
    arrays, statics = subgraph_fields(sub)
    return subgraphs_from_numpy(arrays, **statics, device=device)


def keep_bits_from_numpy(bits, *, device=None) -> torch.Tensor:
    """A packed membership bitset as the reference holds it ([p, Vw] uint32)
    → the port's int32 words, bit for bit."""
    words = np.ascontiguousarray(bits, dtype=np.uint32)
    if words.ndim != 2:
        raise ValueError(f"keep bits must be [p, Vw], got shape {words.shape}")
    return _tensor(words.view(np.int32), np.int32, resolve_device(device))


def keep_bits_to_numpy(bits: torch.Tensor) -> np.ndarray:
    """The inverse of `keep_bits_from_numpy`: int32 words → [p, Vw] uint32."""
    if bits.dtype != torch.int32 or bits.ndim != 2:
        raise ValueError(f"keep bits must be a [p, Vw] int32 tensor, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    return bits.detach().cpu().numpy().view(np.uint32).copy()


def _leaf_tensor(a, device) -> torch.Tensor:
    """One parameter leaf (numpy, as JAX hands it back: f32, or bf16 as
    ml_dtypes' bfloat16) → a tensor of the same dtype, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def lm_params_from_numpy(cfg, params: dict, *, device=None):
    """The reference's LM parameters (the pytree of `repro.models.
    transformer.init_params` as numpy arrays; `groups` and `enc_groups`
    stacked along their group axis) → the port's `LM` on `device`, each
    leaf in its own dtype (the MoE router and the SSM's dt_bias, A_log and
    D are f32 in any model), bit for bit. Layer l is group
    l // len(cfg.group), slot l % len(cfg.group); encoder layer l is
    `enc_groups` group l. Every leaf of a layer's slot is carried across,
    and a leaf the port's layer does not hold raises."""
    from repro_torch.models.transformer import empty_params

    dev = resolve_device(device)
    embed = _leaf_tensor(params["embed"], dev)
    out = empty_params(cfg, device="meta", dtype=embed.dtype)

    def put(module, name, leaf):
        owner, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner)
        t = _leaf_tensor(leaf, dev)
        want = tuple(getattr(owner, attr).shape)
        if tuple(t.shape) != want:
            raise ValueError(f"parameter {name} has shape {tuple(t.shape)}, expected {want}")
        setattr(owner, attr, torch.nn.Parameter(t, requires_grad=False))

    def leaves(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    def put_layer(mod, slot, g):
        names = {name for name, _ in mod.named_parameters()}
        got = dict(leaves(slot))
        if set(got) != names:
            raise ValueError(f"layer leaves {sorted(set(got) ^ names)} differ between the "
                             f"packages")
        for name, leaf in got.items():
            put(mod, name, np.asarray(leaf)[g])

    for name in ("embed", "final_norm") + (() if cfg.tie_embeddings else ("unembed",)):
        put(out, name, params[name])
    n = len(cfg.group)
    for layer, mod in enumerate(out.layers):
        put_layer(mod, params["groups"][f"layer_{layer % n}"], layer // n)
    if cfg.is_encdec:
        put(out, "enc_final_norm", params["enc_final_norm"])
        for layer, mod in enumerate(out.enc_layers):
            put_layer(mod, params["enc_groups"]["layer_0"], layer)
    return out


def _leaf_numpy(t: torch.Tensor) -> np.ndarray:
    """One parameter tensor → a host numpy array of the same dtype, bit for
    bit (bf16 as ml_dtypes' bfloat16, the type JAX hands back)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def lm_params_to_numpy(cfg, params) -> dict:
    """The inverse of `lm_params_from_numpy`: the port's `LM` → the
    reference's parameter pytree of numpy arrays, `groups` and
    `enc_groups` stacked along their group axis (layer l is group
    l // len(cfg.group), slot l % len(cfg.group)), each leaf in its own
    dtype, bit for bit."""

    def nest(pairs):
        out: dict = {}
        for name, t in pairs:
            *path, leaf = name.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
        return out

    def stacked(layers, n):
        groups = {}
        for slot in range(n):
            mods = [layers[l] for l in range(slot, len(layers), n)]
            names = [name for name, _ in mods[0].named_parameters()]
            leaves = [(name, np.stack([_leaf_numpy(m.get_parameter(name)) for m in mods]))
                      for name in names]
            groups[f"layer_{slot}"] = nest(leaves)
        return groups

    out = {name: _leaf_numpy(getattr(params, name))
           for name in ("embed", "final_norm") + (() if cfg.tie_embeddings else ("unembed",))}
    out["groups"] = stacked(params.layers, len(cfg.group))
    if cfg.is_encdec:
        out["enc_groups"] = stacked(params.enc_layers, 1)
        out["enc_final_norm"] = _leaf_numpy(params.enc_final_norm)
    return out
