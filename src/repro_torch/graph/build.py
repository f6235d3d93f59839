"""Partition result → padded subgraph structures for the BSP engine
(port of `repro.graph.build`).

One subgraph binds to one worker. The build runs on the host in numpy
(sorting and grouping), exactly as the reference does, and its outputs
become device tensors at the boundary:

  - per-subgraph local edge lists in BOTH destination-sorted and
    source-sorted order (dst-sorted drives forward relaxation; src-sorted
    drives the reverse direction of undirected programs);
  - master/mirror tables: every replicated vertex has one master subgraph
    (the covering subgraph with most incident edges, ties -> lowest id);
    mirror→master reduction and master→mirror broadcast use the same
    (send_idx, recv_idx) pair tables.

All leading axes are the worker axis `p`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.kernels.dispatch import resolve_device

ADDRESSING_MODES = ("two_level", "flat")


@dataclasses.dataclass(frozen=True)
class SubgraphSet:
    # Edges, destination-sorted.
    lsrc: torch.Tensor  # [p, max_e] int32 local src ids (pad: 0)
    ldst: torch.Tensor  # [p, max_e] int32 local dst ids (pad: max_v → dump row)
    weight: torch.Tensor  # [p, max_e] f32 (pad: 0)
    edge_mask: torch.Tensor  # [p, max_e] bool
    # Same edges, source-sorted (for the reverse direction).
    lsrc_s: torch.Tensor  # [p, max_e] int32 (pad: max_v)
    ldst_s: torch.Tensor  # [p, max_e] int32 (pad: 0)
    weight_s: torch.Tensor  # [p, max_e] f32
    edge_mask_s: torch.Tensor  # [p, max_e] bool
    # Vertices.
    gid: torch.Tensor  # [p, max_v] int32 global id (pad: -1)
    vmask: torch.Tensor  # [p, max_v] bool
    is_master: torch.Tensor  # [p, max_v] bool
    out_degree: torch.Tensor  # [p, max_v] f32 GLOBAL out-degree (for PageRank)
    # Exchange tables; send_idx[i, j, m] (local id at sender i, master at j)
    # pairs recv_idx[j, i, m] (local id at receiver j).
    send_idx: torch.Tensor  # [p, p, max_msg] int32 (pad: 0)
    recv_idx: torch.Tensor  # [p, p, max_msg] int32 (pad: max_v)
    msg_mask: torch.Tensor  # [p, p, max_msg] bool, sender-rowed: [i, j, m]
    recv_mask: torch.Tensor  # [p, p, max_msg] bool, receiver-rowed: [j, i, m]
    num_parts: int
    max_v: int
    max_e: int
    max_msg: int
    # "two_level": kernels index (worker, local-id) space and the engine
    # checks per-worker VALUE maxima against 2^24; "flat": `gid` doubles as
    # the kernel-visible label domain, so global ids must stay below 2^24.
    addressing: str = "two_level"

    @property
    def device(self) -> torch.device:
        return self.lsrc.device

    def to(self, device) -> "SubgraphSet":
        """This set with every tensor on `device` (itself if already there)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dev) for k in ARRAY_FIELDS}
        )

    @property
    def num_local_vertices(self) -> torch.Tensor:
        return self.vmask.sum(dim=1)

    @property
    def local_to_global(self) -> np.ndarray:
        """Per-worker local-id → global-id map, int64 on the host (pad: -1)."""
        return as_numpy(self.gid).astype(np.int64)


ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(SubgraphSet)
    if f.name not in ("num_parts", "max_v", "max_e", "max_msg", "addressing")
)


def check_addressing(mode) -> str:
    if mode not in ADDRESSING_MODES:
        raise ValueError(f"addressing must be one of {ADDRESSING_MODES}, got {mode!r}")
    return mode


def _prepare_edges(graph: Graph, result: PartitionResult, weights, symmetrize):
    src = as_numpy(graph.src).astype(np.int64)
    dst = as_numpy(graph.dst).astype(np.int64)
    part = result.part_in_input_order().astype(np.int64)
    p = result.num_parts
    if weights is None:
        weights = np.ones(src.shape[0], dtype=np.float32)
    weights = as_numpy(weights)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        part = np.concatenate([part, part])
        weights = np.concatenate([weights, weights])
    return src, dst, part, weights, p


def _elect_masters(src, dst, part, p, num_vertices):
    """Master part per covered vertex + the unique (part, vertex) incidence
    pairs (v_of, p_of), plus the inverse map `inv` (endpoint occurrence ->
    unique-pair index; the first E entries are src endpoints, the rest dst)."""
    ends = np.concatenate([src, dst])
    pp = np.concatenate([part, part])
    key = ends * p + pp
    uk, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    v_of = uk // p
    p_of = (uk % p).astype(np.int64)
    # Per covered vertex: part with max count, tie → lowest part id.
    sel = np.lexsort((p_of, -cnt, v_of))
    v_sorted = v_of[sel]
    first = np.ones(v_sorted.shape[0], dtype=bool)
    first[1:] = v_sorted[1:] != v_sorted[:-1]
    master_part = np.full(num_vertices, -1, dtype=np.int64)
    master_part[v_sorted[first]] = p_of[sel][first]
    return master_part, v_of, p_of, inv


def _exchange_tables(vp, vcol, vv, vkeys, v_off, master_part, *, p, N, max_v, pad_multiple):
    """Mirror↔master exchange tables from the grouped local vertex space
    (vp: owning part per unique (part, vertex) pair, nondecreasing; vcol:
    local id; vv: global id; vkeys/v_off: the fused lookup key and per-part
    offsets)."""
    mp_all = master_part[vv]
    is_mir = mp_all != vp
    mi = vp[is_mir]  # sender (mirror-holding) part i
    mj = mp_all[is_mir]  # receiver (master) part j
    lv = vcol[is_mir]  # local id at sender
    lm = np.searchsorted(vkeys, mj * N + vv[is_mir]) - v_off[mj]  # local id at master
    # Group by (i, j); within a pair, entries ascend by sender-local id.
    stride = np.int64(max_v + 1)
    mo = np.argsort((mi * p + mj) * stride + lv, kind="stable")
    gi, gj, glv, glm = mi[mo], mj[mo], lv[mo], lm[mo]
    pairkey = gi * p + gj
    cnts = np.bincount(pairkey, minlength=p * p).astype(np.int64)
    max_msg = max(int(cnts.max()) if cnts.size else 1, 1)
    max_msg = int(-(-max_msg // pad_multiple) * pad_multiple)
    pair_off = np.zeros(p * p + 1, np.int64)
    np.cumsum(cnts, out=pair_off[1:])
    m_idx = np.arange(gi.shape[0], dtype=np.int64) - pair_off[pairkey]

    send_idx = np.zeros((p, p, max_msg), np.int32)
    recv_idx = np.full((p, p, max_msg), max_v, np.int32)
    msg_mask = np.zeros((p, p, max_msg), bool)
    recv_mask = np.zeros((p, p, max_msg), bool)
    send_idx[gi, gj, m_idx] = glv
    recv_idx[gj, gi, m_idx] = glm
    msg_mask[gi, gj, m_idx] = True
    recv_mask[gj, gi, m_idx] = True
    return send_idx, recv_idx, msg_mask, recv_mask, max_msg


def build_subgraphs(
    graph: Graph,
    result: PartitionResult,
    *,
    weights=None,
    symmetrize: bool = False,
    pad_multiple: int = 8,
    addressing: str = "two_level",
    device=None,
) -> SubgraphSet:
    """Vectorized builder (grouped sorts, no per-part loops), field for field
    the reference's `build_subgraphs`; the result lives on `device`."""
    check_addressing(addressing)
    dev = resolve_device(device)
    src, dst, part, weights, p = _prepare_edges(graph, result, weights, symmetrize)
    N = graph.num_vertices
    if N > np.iinfo(np.int32).max:
        raise ValueError(
            f"subgraph gid table is int32: num_vertices={N} >= 2^31 is past the engine ceiling"
        )
    E = src.shape[0]
    master_part, v_of, p_of, inv = _elect_masters(src, dst, part, p, N)
    out_deg_global = np.bincount(src, minlength=N).astype(np.float32)

    # ---- per-part local vertex spaces (sorted global ids).
    vsel = np.argsort(p_of * N + v_of, kind="stable")
    vp = p_of[vsel]  # owning part, nondecreasing
    vv = v_of[vsel]  # vertex ids, ascending within each part
    nv = np.bincount(p_of, minlength=p).astype(np.int64)
    v_off = np.zeros(p + 1, np.int64)
    np.cumsum(nv, out=v_off[1:])
    vcol = np.arange(vv.shape[0], dtype=np.int64) - v_off[vp]  # local vertex id
    vkeys = vp * N + vv
    lid_of_pair = np.empty(vv.shape[0], np.int64)
    lid_of_pair[vsel] = vcol

    ne = np.bincount(part, minlength=p).astype(np.int64)
    max_v = int(-(-max(int(nv.max()) if nv.size else 1, 1) // pad_multiple) * pad_multiple)
    max_e = int(-(-max(int(ne.max()) if ne.size else 1, 1) // pad_multiple) * pad_multiple)

    gid = np.full((p, max_v), -1, np.int32)
    vmask = np.zeros((p, max_v), bool)
    is_master = np.zeros((p, max_v), bool)
    out_degree = np.zeros((p, max_v), np.float32)
    gid[vp, vcol] = vv
    vmask[vp, vcol] = True
    is_master[vp, vcol] = master_part[vv] == vp
    out_degree[vp, vcol] = out_deg_global[vv]

    # ---- local edges (both sort orders).
    ls = lid_of_pair[inv[:E]].astype(np.int32)
    ld = lid_of_pair[inv[E:]].astype(np.int32)
    e_off = np.zeros(p + 1, np.int64)
    np.cumsum(ne, out=e_off[1:])

    lsrc = np.zeros((p, max_e), np.int32)
    ldst = np.full((p, max_e), max_v, np.int32)
    weight_arr = np.zeros((p, max_e), np.float32)
    edge_mask = np.zeros((p, max_e), bool)
    lsrc_s = np.full((p, max_e), max_v, np.int32)
    ldst_s = np.zeros((p, max_e), np.int32)
    weight_s = np.zeros((p, max_e), np.float32)
    edge_mask_s = np.zeros((p, max_e), bool)

    # Stable sort on a fused (part, local-id) key: part-major, local-id
    # minor, original order on ties.
    stride = np.int64(max_v + 1)
    o = np.argsort(part * stride + ld, kind="stable")
    row = part[o]
    col = np.arange(E, dtype=np.int64) - e_off[row]
    lsrc[row, col] = ls[o]
    ldst[row, col] = ld[o]
    weight_arr[row, col] = weights[o]
    edge_mask[row, col] = True

    o2 = np.argsort(part * stride + ls, kind="stable")
    row2 = part[o2]
    col2 = np.arange(E, dtype=np.int64) - e_off[row2]
    lsrc_s[row2, col2] = ls[o2]
    ldst_s[row2, col2] = ld[o2]
    weight_s[row2, col2] = weights[o2]
    edge_mask_s[row2, col2] = True

    send_idx, recv_idx, msg_mask, recv_mask, max_msg = _exchange_tables(
        vp, vcol, vv, vkeys, v_off, master_part,
        p=p, N=N, max_v=max_v, pad_multiple=pad_multiple,
    )
    arrays = dict(
        lsrc=lsrc, ldst=ldst, weight=weight_arr, edge_mask=edge_mask,
        lsrc_s=lsrc_s, ldst_s=ldst_s, weight_s=weight_s, edge_mask_s=edge_mask_s,
        gid=gid, vmask=vmask, is_master=is_master, out_degree=out_degree,
        send_idx=send_idx, recv_idx=recv_idx, msg_mask=msg_mask, recv_mask=recv_mask,
    )
    return SubgraphSet(
        **{k: torch.from_numpy(a).to(dev) for k, a in arrays.items()},
        num_parts=p, max_v=max_v, max_e=max_e, max_msg=max_msg, addressing=addressing,
    )
