"""Roofline terms of a dry-run, from recorded collectives (port of
`repro.launch.roofline`).

compute    = FLOPs (one device) / peak FLOP/s
memory     = bytes (one device) / HBM bandwidth
collective = one device's link bytes (collectives × ring factors) / link bandwidth

The reference reads its collectives from the compiled HLO text. PyTorch
compiles nothing ahead of time, so the port records the collectives a run
makes through `torch.distributed` (`record_collectives`) and sums them
with the reference's ring factors, kind by kind (`summarize_collectives`).
Hardware: one NVIDIA H100 SXM (the constants below, each with its source).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet: dense bf16 in the tensor cores. The graph
# engine's f32 work never binds at 2 operations per 12-13 bytes.
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BW = 3.35e12
# One 400 Gb/s network port a card, as an eight-card H100 node has
# (NVIDIA DGX H100: eight ConnectX-7 ports). A world of 256 or 512 ranks
# spans 32 or 64 nodes, so its all-to-all crosses them. NVLink's 450 GB/s
# a direction (900 GB/s both ways, the data sheet) holds only inside a node.
LINK_BW = 50e9

# The reference's kind names: the c10d op of each public collective, and the
# argument that holds its output. Any other c10d op (a broadcast, say) is
# recorded under its own name with its "tensors".
_C10D_KINDS = {
    "allreduce_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "output_tensors"),
    "_allgather_base_": ("all-gather", "output_tensor"),
    "reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "alltoall_": ("all-to-all", "output_tensors"),
    "alltoall_base_": ("all-to-all", "output"),
    "send": ("collective-permute", "tensors"),
}
# The functional collectives DTensor issues (`torch.ops._c10d_functional`),
# under the same kind names; their output is the op's return value. The
# `wait_tensor` that completes each moves nothing and is left out.
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective: the reference's kind name (or, for a c10d op with no
    counterpart there, the op's own name), its output bytes on this rank and
    the size of its group. `host_s` is the host clock just after the call
    was issued; `event`, for a call on CUDA tensors, a CUDA event recorded
    on the current stream just after it."""

    kind: str
    out_bytes: int
    group_size: int
    op: str = ""
    host_s: float = 0.0
    event: Optional[object] = None


@dataclasses.dataclass
class CollectiveSummary:
    total_link_bytes: float  # one device's bytes over the links (ring model)
    per_op: dict  # op kind → {count, bytes}

    def row(self):
        return dict(
            total_link_bytes=self.total_link_bytes,
            **{k: v["bytes"] for k, v in self.per_op.items()},
        )


def ring_link_bytes(kind: str, out_bytes: float, g: int) -> float:
    """One device's link bytes for a collective of `kind` whose output on
    the device is `out_bytes`, over a group of g ranks: the reference's ring
    factors. A kind the reference has no name for (a c10d broadcast, say)
    counts its output once, as a collective-permute does."""
    ring = (g - 1) / g
    if kind == "all-gather":
        return out_bytes * ring
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)  # input = out*g; each rank ships in*(g-1)/g
    if kind == "all-reduce":
        return 2 * out_bytes * ring
    if kind == "all-to-all":
        return out_bytes * ring
    return out_bytes  # collective-permute


def summarize_collectives(records: Iterable) -> CollectiveSummary:
    """The counterpart of the reference's `parse_collectives`: the same sums
    over recorded (kind, out_bytes, group_size) entries (tuples or
    `Collective`s) in place of HLO lines. A collective over one rank moves
    nothing and is skipped, as the reference skips it."""
    per_op: dict = {}
    total = 0.0
    for rec in records:
        kind, out_bytes, g = (rec.kind, rec.out_bytes, rec.group_size) \
            if isinstance(rec, Collective) else rec
        if g <= 1:
            continue
        link = ring_link_bytes(kind, out_bytes, g)
        d = per_op.setdefault(kind, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += link
        total += link
    return CollectiveSummary(total_link_bytes=total, per_op=per_op)


def _group_size(group) -> int:
    """The size of a functional collective's group: its registered name, or
    the group itself."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return group.size()


class _Recorder(TorchDispatchMode):
    """Sees every op dispatched while it is on the mode stack and keeps the
    collectives: the `torch.ops.c10d` ops (barriers move no data and are
    left out) and the functional ones DTensor issues
    (`torch.ops._c10d_functional`, but `wait_tensor`)."""

    def __init__(self, events: bool = True):
        super().__init__()
        self.records: list[Collective] = []
        self.events = events  # a CUDA event after each collective on CUDA tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in COLLECTIVE_NAMESPACES:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out=None):
        from torch._C._distributed_c10d import ProcessGroup

        name = func._overloadpacket.__name__
        if name in ("barrier", "monitored_barrier_", "wait_tensor"):
            return
        bound = dict(zip((a.name for a in func._schema.arguments), args))
        bound.update(kwargs)
        if func.namespace == "_c10d_functional":
            kind, value = _FUNCTIONAL_KINDS.get(name, name), out
            group = (int(bound["group_size"]) if "group_size" in bound
                     else _group_size(bound["group_name"]))
        else:
            kind, out_arg = _C10D_KINDS.get(name, (name, "tensors"))
            value = bound.get(out_arg, bound.get("tensors"))
            group = ProcessGroup.unbox(bound["process_group"]).size()
        event = None
        first = value
        while isinstance(first, (list, tuple)) and first:
            first = first[0]
        if self.events and isinstance(first, torch.Tensor) and first.is_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.records.append(Collective(kind, _tensor_bytes(value), group, name,
                                       time.perf_counter(), event))

    def summary(self) -> CollectiveSummary:
        return summarize_collectives(self.records)


@contextlib.contextmanager
def record_collectives():
    """Record every collective made through `torch.distributed` while the
    block runs (any backend: NCCL, gloo, the fake world of
    `launch.mesh.fake_world`): a `TorchDispatchMode` over the
    `torch.ops.c10d` ops and DTensor's functional collectives, so the
    engine needs no hook. Yields the recorder:
    `.records` (a list of `Collective`) and `.summary()`."""
    rec = _Recorder()
    with rec:
        yield rec


def roofline_terms(flops: float, hbm_bytes: float, link_bytes: float) -> dict:
    c = flops / PEAK_FLOPS
    m = hbm_bytes / HBM_BW
    n = link_bytes / LINK_BW
    dom = max(("compute", c), ("memory", m), ("collective", n), key=lambda kv: kv[1])
    return dict(
        compute_s=c,
        memory_s=m,
        collective_s=n,
        bottleneck=dom[0],
        bound_s=dom[1],
    )


def model_flops(cfg, shape_kind: str, seq: int, gb: int, *, chips: int) -> float:
    """MODEL_FLOPS per chip per step: 6·N·D train, 2·N·D prefill/decode."""
    n_active = cfg.num_active_params()
    if shape_kind == "train":
        tokens = seq * gb
        mult = 6
    elif shape_kind == "prefill":
        tokens = seq * gb
        mult = 2
    else:  # decode: one token per sequence
        tokens = gb
        mult = 2
    return mult * n_active * tokens / chips
