"""Edge processing order for EBV (paper §IV-C; port of `repro.core.order`).

Edges are sorted ascending by the sum of their end-vertices' total degrees,
so low-degree edges seed the subgraphs and high-degree hubs are cut late.
Ties are broken by original edge index (stable sort).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import Graph, as_numpy


def degree_sum_order(graph: Graph) -> np.ndarray:
    """Return a permutation of edge indices, ascending by degree-sum."""
    deg = graph.degrees()
    key = deg[as_numpy(graph.src)] + deg[as_numpy(graph.dst)]
    return np.argsort(key, kind="stable").astype(np.int64)
