"""Neighbor Expansion (NE) edge partitioner [Zhang et al., KDD'17]; port of
`repro.core.ne`.

Search-based: each partition grows from a seed vertex by repeatedly
expanding the boundary vertex with the fewest unassigned incident edges,
claiming those edges, until the partition reaches its edge capacity
|E|/p. Produces near-perfect EDGE balance but (on power-law graphs) poor
VERTEX balance — the pathology Table III of the paper reports (NE vertex
imbalance 2.1–3.6 on power-law graphs).

It runs on the host, as the reference does (numpy and a heap): each
expansion depends on the heap the one before left, one vertex at a time,
so the loop has no data-parallel form and no device version to stand in
for. Seeds are drawn from `np.random.default_rng(seed)`, as in the
reference, so both packages give the same partition; `part` is handed to
the caller's device at the end.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.api.config import NEConfig
from repro_torch.api.registry import register_partitioner
from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.kernels.dispatch import resolve_device


@register_partitioner(
    "ne",
    config=NEConfig,
    deterministic=True,
    description="Neighbor Expansion search baseline [Zhang et al., KDD'17]",
)
def ne_partition(graph: Graph, num_parts: int, *, seed: int = 0,
                 device=None) -> PartitionResult:
    dev = resolve_device(device)
    src = as_numpy(graph.src).astype(np.int64)
    dst = as_numpy(graph.dst).astype(np.int64)
    E, V, p = src.shape[0], graph.num_vertices, num_parts

    # CSR over the undirected view (each directed edge indexed once; a
    # vertex's incident list holds the edge ids where it is src or dst).
    ends = np.concatenate([src, dst])
    eids = np.concatenate([np.arange(E), np.arange(E)])
    order = np.argsort(ends, kind="stable")
    incident = eids[order]  # incident[indptr[v]:indptr[v+1]] = edge ids at v
    counts = np.bincount(ends, minlength=V)
    indptr = np.zeros(V + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(counts)

    part = np.full(E, -1, dtype=np.int32)
    unassigned_deg = counts.astype(np.int64).copy()
    rng = np.random.default_rng(seed)
    capacity = int(np.ceil(E / p))

    assigned_total = 0
    for k in range(p):
        remaining_parts = p - k
        target = min(capacity, int(np.ceil((E - assigned_total) / remaining_parts)))
        size = 0
        heap: list[tuple[int, int]] = []  # (unassigned_deg, vertex)
        in_boundary = np.zeros(V, dtype=bool)

        def push(v: int) -> None:
            if not in_boundary[v] and unassigned_deg[v] > 0:
                in_boundary[v] = True
                heapq.heappush(heap, (int(unassigned_deg[v]), int(v)))

        while size < target and assigned_total < E:
            # The expansion vertex: the least unassigned degree in the boundary.
            x = -1
            while heap:
                d, v = heapq.heappop(heap)
                in_boundary[v] = False
                if unassigned_deg[v] > 0:
                    if d != unassigned_deg[v]:
                        push(v)  # stale entry: back in with its current key
                        continue
                    x = v
                    break
            if x < 0:
                # A fresh random seed vertex with unassigned edges.
                scan = np.flatnonzero(unassigned_deg > 0)
                if scan.size == 0:
                    break
                x = int(scan[rng.integers(0, scan.size)])
            # Claim every unassigned edge incident to x.
            for e in incident[indptr[x] : indptr[x + 1]]:
                if part[e] >= 0 or size >= target:
                    continue
                part[e] = k
                size += 1
                assigned_total += 1
                for v in (src[e], dst[e]):
                    unassigned_deg[v] -= 1
                    if v != x:
                        push(int(v))

    # Leftovers (capacity rounding) go to the last partition.
    part[part < 0] = p - 1
    return PartitionResult(part=torch.from_numpy(part).to(dev), num_parts=p)
