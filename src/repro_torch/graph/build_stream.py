"""Streamed two-pass subgraph builder for the out-of-core pipeline (port of
`repro.graph.build_stream`, host numpy as in the reference).

`build_subgraphs` consumes a materialized int64 edge list; this builder
consumes a RE-ITERABLE stream of (src, dst, part) blocks (e.g.
`OutOfCoreResult.edge_part_stream`) and never holds the global edge list:

  pass 1  O(p·V) incidence counts (uint32) + global out-degrees — enough
          to elect masters (max incidence count, tie → lowest part: the
          exact `_elect_masters` lexsort order, realized as an argmax),
          lay out the per-worker sorted local vertex spaces, and size the
          padded tensors;
  pass 2  stage each block's edges into per-worker stream-ordered int32
          staging rows (local ids via one searchsorted against the fused
          (part, vertex) key), then per-worker stable argsorts produce
          the dst-/src-sorted views — the same (part, local-id, stream
          position) order as the in-memory vectorized builder's fused
          global sort, so the output equals `build_subgraphs` on the same
          partition, field for field (tests pin this).

Exchange tables come from the SAME `_exchange_tables` helper the
in-memory builder uses — parity there is shared code, not a re-derivation.

Peak host memory: p·V·4 bytes of counts + the padded per-worker tensors
the engine needs anyway + 2 int32 staging arrays; the int64 edge list
itself never materializes. Each padded tensor goes to the device as soon
as it is assembled.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.graph.build import SubgraphSet, _exchange_tables, check_addressing
from repro_torch.kernels.dispatch import resolve_device

EdgeBlockStream = Callable[[], Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]]


def _add_counts(counts: np.ndarray, part: np.ndarray, vert: np.ndarray) -> None:
    """counts[part, vert] += 1 for every pair (repeats add up), through the
    distinct flat keys — `np.add.at` without its per-element cost."""
    keys, cnt = np.unique(part * counts.shape[1] + vert, return_counts=True)
    flat = counts.reshape(-1)
    flat[keys] += cnt.astype(counts.dtype)


def build_subgraphs_stream(
    stream_factory: EdgeBlockStream,
    num_vertices: int,
    num_parts: int,
    *,
    symmetrize: bool = False,
    pad_multiple: int = 8,
    addressing: str = "two_level",
    device=None,
) -> SubgraphSet:
    """Build the padded SubgraphSet on `device` (the CUDA card unless the
    caller asks for the CPU) from a re-iterable (src, dst, part) block
    stream. `stream_factory()` is called once per pass (twice, or three
    times with `symmetrize=True` — the reversed edges replay the stream
    rather than buffering it). Unit edge weights (the engine's weighted
    programs derive weights from `out_degree`, not these)."""
    check_addressing(addressing)
    p = int(num_parts)
    N = int(num_vertices)
    if N > np.iinfo(np.int32).max:
        raise ValueError(
            f"subgraph gid table is int32: num_vertices={N} >= 2^31 is past the "
            "engine ceiling (two-level addressing lifts the 2^24 KERNEL bound, "
            "not the global-id width)"
        )
    dev = resolve_device(device)

    # ---- pass 1: incidence counts, out-degrees, per-part edge counts.
    counts = np.zeros((p, N), np.uint32)
    out_deg_global = np.zeros(N, np.int64)
    ne = np.zeros(p, np.int64)
    for s, d, pt in stream_factory():
        s = np.asarray(s, np.int64)
        d = np.asarray(d, np.int64)
        pt = np.asarray(pt, np.int64)
        _add_counts(counts, pt, s)
        _add_counts(counts, pt, d)
        out_deg_global += np.bincount(s, minlength=N)
        if symmetrize:
            out_deg_global += np.bincount(d, minlength=N)
        ne += np.bincount(pt, minlength=p)
    if symmetrize:
        # Forward + reversed double every (part, vertex) incidence count
        # uniformly, so the un-symmetrized counts elect identical masters.
        ne *= 2

    # Master election: max incidence count, tie → lowest part (argmax
    # returns the first maximum — exactly `_elect_masters`' lexsort pick).
    covered = counts.max(axis=0) > 0
    master_part = np.where(covered, counts.argmax(axis=0), -1).astype(np.int64)

    # ---- per-part sorted local vertex spaces (ascending global ids).
    verts = [np.flatnonzero(counts[i]).astype(np.int64) for i in range(p)]
    nv = np.array([v.shape[0] for v in verts], np.int64)
    v_off = np.zeros(p + 1, np.int64)
    np.cumsum(nv, out=v_off[1:])
    vv = np.concatenate(verts) if verts else np.zeros(0, np.int64)
    vp = np.repeat(np.arange(p, dtype=np.int64), nv)
    vcol = np.arange(vv.shape[0], dtype=np.int64) - v_off[vp]
    vkeys = vp * N + vv  # strictly increasing (part-major, vertex-minor)

    max_v = int(-(-max(int(nv.max()) if nv.size else 1, 1) // pad_multiple) * pad_multiple)
    max_e = int(-(-max(int(ne.max()) if ne.size else 1, 1) // pad_multiple) * pad_multiple)

    gid = np.full((p, max_v), -1, np.int32)
    vmask = np.zeros((p, max_v), bool)
    is_master = np.zeros((p, max_v), bool)
    out_degree = np.zeros((p, max_v), np.float32)
    odg32 = out_deg_global.astype(np.float32)
    gid[vp, vcol] = vv
    vmask[vp, vcol] = True
    is_master[vp, vcol] = master_part[vv] == vp
    out_degree[vp, vcol] = odg32[vv]

    # ---- pass 2: stage per-part edges in stream order, then sort locally.
    ls_stage = np.zeros((p, max_e), np.int32)
    ld_stage = np.zeros((p, max_e), np.int32)
    cur = np.zeros(p, np.int64)

    def _stage(s, d, pt):
        nonlocal cur
        ls = (np.searchsorted(vkeys, pt * N + s) - v_off[pt]).astype(np.int32)
        ld = (np.searchsorted(vkeys, pt * N + d) - v_off[pt]).astype(np.int32)
        # Per-part append positions: cursor + within-block rank of this part.
        bc = np.bincount(pt, minlength=p).astype(np.int64)
        boff = np.zeros(p + 1, np.int64)
        np.cumsum(bc, out=boff[1:])
        o = np.argsort(pt, kind="stable")
        rank = np.empty(pt.shape[0], np.int64)
        rank[o] = np.arange(pt.shape[0], dtype=np.int64) - boff[pt[o]]
        col = cur[pt] + rank
        ls_stage[pt, col] = ls
        ld_stage[pt, col] = ld
        cur += bc

    for s, d, pt in stream_factory():
        _stage(np.asarray(s, np.int64), np.asarray(d, np.int64), np.asarray(pt, np.int64))
    if symmetrize:
        # The in-memory builder symmetrizes by concatenating the reversed
        # list AFTER the forward list; replaying the stream reversed-edge
        # second reproduces that stream order exactly.
        for s, d, pt in stream_factory():
            _stage(np.asarray(d, np.int64), np.asarray(s, np.int64), np.asarray(pt, np.int64))
    if not np.array_equal(cur, ne):
        raise ValueError("the edge stream changed length between passes")
    del counts  # p*V*4 bytes — not needed past election/vertex layout

    # Assemble the padded tensors one at a time, moving each to the device
    # and freeing the host copy: peak here is ONE extra (p, max_e) array.
    def _edge_tensor(fill, dtype, per_part):
        arr = np.full((p, max_e), fill, dtype)
        for i in range(p):
            n = int(ne[i])
            arr[i, :n] = per_part(i, n)
        return torch.from_numpy(arr).to(dev)

    tensors = {}
    # dst-sorted main view, then src-sorted exchange view; only ONE set of
    # per-part sort permutations is alive at a time (int32: ne[i] < 2^31).
    orders = [np.argsort(ld_stage[i, : int(ne[i])], kind="stable").astype(np.int32)
              for i in range(p)]
    tensors["lsrc"] = _edge_tensor(0, np.int32, lambda i, n: ls_stage[i, :n][orders[i]])
    tensors["ldst"] = _edge_tensor(max_v, np.int32, lambda i, n: ld_stage[i, :n][orders[i]])
    orders = [np.argsort(ls_stage[i, : int(ne[i])], kind="stable").astype(np.int32)
              for i in range(p)]
    tensors["lsrc_s"] = _edge_tensor(max_v, np.int32, lambda i, n: ls_stage[i, :n][orders[i]])
    tensors["ldst_s"] = _edge_tensor(0, np.int32, lambda i, n: ld_stage[i, :n][orders[i]])
    del ls_stage, ld_stage, orders
    for nm in ("weight", "weight_s"):
        tensors[nm] = _edge_tensor(0.0, np.float32, lambda i, n: 1.0)
    for nm in ("edge_mask", "edge_mask_s"):
        tensors[nm] = _edge_tensor(False, bool, lambda i, n: True)

    send_idx, recv_idx, msg_mask, recv_mask, max_msg = _exchange_tables(
        vp, vcol, vv, vkeys, v_off, master_part,
        p=p, N=N, max_v=max_v, pad_multiple=pad_multiple,
    )
    arrays = dict(gid=gid, vmask=vmask, is_master=is_master, out_degree=out_degree,
                  send_idx=send_idx, recv_idx=recv_idx, msg_mask=msg_mask, recv_mask=recv_mask)
    return SubgraphSet(
        **tensors,
        **{k: torch.from_numpy(a).to(dev) for k, a in arrays.items()},
        num_parts=p,
        max_v=max_v,
        max_e=max_e,
        max_msg=max_msg,
        addressing=addressing,
    )
