"""METIS-style multilevel vertex partitioner (stand-in for the METIS binary);
port of `repro.core.metis_like`.

The class of algorithm the paper evaluates (and criticizes on power-law
graphs): multilevel coarsening by heavy-edge matching (vectorized
Luby-style propose/accept rounds), greedy graph-growing initial partition
balanced on VERTEX weight, and label-propagation refinement minimizing
edge-cut under a balance cap. The derived EDGE partition (each edge goes to
its source's owner) therefore balances vertices and minimizes replication,
but — on power-law graphs — produces the large edge-imbalance factors of
the paper's Table III.

It runs on the host, as the reference does, and hands `part` to the
caller's device at the end. The initial growth walks a Python set in its
iteration order and the matching's tie-breaking jitter comes from numpy's
PCG64 stream; a device version would have to reproduce both, and one split
between host and device would copy every level back and forth. Moving the
vectorized phases (`_to_undirected_arrays`, `_propose_match`,
`_build_coarse`, `_lp_refine`'s connectivity and argmax) onto the card is
later speed work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.config import MetisLikeConfig
from repro_torch.api.registry import register_partitioner
from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.kernels.dispatch import resolve_device


def _to_undirected_arrays(src, dst, V):
    """Deduplicated undirected weighted edge list (u < v)."""
    u = np.minimum(src, dst)
    v = np.maximum(src, dst)
    m = u != v
    key = u[m].astype(np.int64) * V + v[m]
    uk, w = np.unique(key, return_counts=True)
    return (uk // V).astype(np.int64), (uk % V).astype(np.int64), w.astype(np.int64)


def _csr(heads, tails, ww, V):
    order = np.argsort(heads, kind="stable")
    heads, tails, ww = heads[order], tails[order], ww[order]
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(heads, minlength=V))
    return indptr, tails, ww


def _propose_match(eu, ev, ew, V, rng, rounds: int = 4):
    """Vectorized heavy-edge matching: each vertex proposes to its heaviest
    unmatched neighbor; mutual proposals match. A few rounds per level."""
    match = np.arange(V, dtype=np.int64)  # self = unmatched
    matched = np.zeros(V, bool)
    heads = np.concatenate([eu, ev])
    tails = np.concatenate([ev, eu])
    ww = np.concatenate([ew, ew])
    for _ in range(rounds):
        live = ~(matched[heads] | matched[tails])
        if not live.any():
            break
        h, t, w = heads[live], tails[live], ww[live]
        # heaviest neighbor per head: sort by (head, weight desc, jitter)
        jitter = rng.random(h.shape[0])
        order = np.lexsort((jitter, -w, h))
        hs = h[order]
        first = np.ones(hs.shape[0], bool)
        first[1:] = hs[1:] != hs[:-1]
        propose = np.full(V, -1, np.int64)
        propose[hs[first]] = t[order][first]
        # mutual proposals match
        cand = np.flatnonzero(propose >= 0)
        mutual = cand[propose[propose[cand]] == cand]
        a = mutual[mutual < propose[mutual]]
        b = propose[a]
        match[a], match[b] = b, a
        matched[a] = matched[b] = True
    rep = np.minimum(np.arange(V), match)  # representative = smaller id
    uniq, cmap_all = np.unique(rep, return_inverse=True)
    return cmap_all.astype(np.int64), uniq.shape[0]


def _build_coarse(cmap, nc, eu, ev, ew, vw):
    hu, hv = cmap[eu], cmap[ev]
    m = hu != hv
    u = np.minimum(hu[m], hv[m])
    v = np.maximum(hu[m], hv[m])
    key = u * nc + v
    uk, inv = np.unique(key, return_inverse=True)
    ws = np.zeros(uk.shape[0], np.int64)
    np.add.at(ws, inv, ew[m])
    cvw = np.zeros(nc, np.int64)
    np.add.at(cvw, cmap, vw)
    return (uk // nc).astype(np.int64), (uk % nc).astype(np.int64), ws, cvw


def _grow_initial(eu, ev, vw, V, p):
    indptr, adj, _ = _csr(np.concatenate([eu, ev]), np.concatenate([ev, eu]),
                          np.concatenate([np.ones_like(eu)] * 2), V)
    part = np.full(V, -1, np.int32)
    cap = vw.sum() / p
    unused = set(range(V))
    for k in range(p):
        if not unused:
            break
        frontier = [next(iter(unused))]
        load = 0
        while load < cap and (frontier or unused):
            if not frontier:
                frontier.append(next(iter(unused)))
            v = frontier.pop()
            if part[v] >= 0:
                continue
            part[v] = k
            unused.discard(v)
            load += vw[v]
            frontier.extend(int(n) for n in adj[indptr[v]:indptr[v + 1]] if part[n] < 0)
    for v in list(unused):
        part[v] = p - 1
    return part


def _lp_refine(eu, ev, ew, vw, part, p, passes=6, tol=1.05):
    """Vectorized label-propagation refinement with a balance cap."""
    V = vw.shape[0]
    cap = vw.sum() / p * tol
    heads = np.concatenate([eu, ev])
    tails = np.concatenate([ev, eu])
    ww = np.concatenate([ew, ew]).astype(np.int64)
    for _ in range(passes):
        conn = np.zeros((V, p), np.int64)
        np.add.at(conn, (heads, part[tails]), ww)
        cur_conn = conn[np.arange(V), part]
        tgt = conn.argmax(axis=1).astype(np.int32)
        gain = conn[np.arange(V), tgt] - cur_conn
        want = (tgt != part) & (gain > 0)
        if not want.any():
            break
        # apply moves greedily by gain, respecting the balance cap
        loads = np.bincount(part, weights=vw, minlength=p).astype(np.float64)
        idx = np.flatnonzero(want)
        idx = idx[np.argsort(-gain[idx])]
        moved = 0
        for v in idx:
            t = tgt[v]
            if loads[t] + vw[v] <= cap:
                loads[part[v]] -= vw[v]
                loads[t] += vw[v]
                part[v] = t
                moved += 1
        if moved == 0:
            break
    return part


@register_partitioner(
    "metis",
    config=MetisLikeConfig,
    deterministic=True,
    description="Multilevel METIS-style vertex partitioner (derived edge cut)",
)
def metis_like_partition(
    graph: Graph,
    num_parts: int,
    *,
    seed: int = 0,
    coarsen_to: int = 4096,
    refine_passes: int = 6,
    device=None,
) -> PartitionResult:
    dev = resolve_device(device)
    src = as_numpy(graph.src).astype(np.int64)
    dst = as_numpy(graph.dst).astype(np.int64)
    V = graph.num_vertices
    rng = np.random.default_rng(seed)

    eu, ev, ew = _to_undirected_arrays(src, dst, V)
    vw = np.ones(V, np.int64)
    levels = []
    n = V
    while n > coarsen_to:
        cmap, nc = _propose_match(eu, ev, ew, n, rng)
        if nc >= n * 0.98:  # stalled
            break
        levels.append((cmap, eu, ev, ew, vw))
        eu, ev, ew, vw = _build_coarse(cmap, nc, eu, ev, ew, vw)
        n = nc

    part = _grow_initial(eu, ev, vw, n, num_parts)
    part = _lp_refine(eu, ev, ew, vw, part, num_parts, refine_passes)

    for cmap, fu, fv, fw, fvw in reversed(levels):
        part = part[cmap]
        part = _lp_refine(fu, fv, fw, fvw, part, num_parts, passes=2)

    epart = part[src].astype(np.int32)
    return PartitionResult(part=torch.from_numpy(epart).to(dev), num_parts=num_parts)
