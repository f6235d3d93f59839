"""Synthetic power-law query trace for serving benchmarks (port of
`repro.serve.trace`: the same trace for the same graph and seed).

Production graph services see power-law QUERY traffic on top of their
power-law graphs: a few hub entities are asked about constantly, the
long tail rarely. We model that by sampling source vertices proportional
to degree (the graph's own skew becomes the query popularity skew),
Poisson arrivals at `rate_qps`, and a program mix over the registered
`VertexProgram`s (point queries: BFS hops, s-t distance via SSSP, plus
whole-graph refreshes like CC/PageRank if the mix asks for them).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import Graph
from repro_torch.graph.engine import get_program


def synthetic_trace(
    graph: Graph,
    num_queries: int,
    *,
    rate_qps: float = 1000.0,
    mix=(("bfs", 0.5), ("sssp", 0.5)),
    seed: int = 0,
    t0: float = 0.0,
) -> list:
    """[(t, program, source)] sorted by arrival time.

    `mix` is ((program_name, weight), ...); weights are normalized.
    Source-rooted programs get a degree-proportional source draw;
    source-free programs get source=None.
    """
    if num_queries < 1:
        raise ValueError(f"num_queries must be >= 1, got {num_queries}")
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    progs = [get_program(name) for name, _ in mix]
    weights = np.asarray([w for _, w in mix], np.float64)
    weights = weights / weights.sum()
    rng = np.random.default_rng(seed)
    cov = graph.covered_vertices()
    deg = graph.degrees()[cov].astype(np.float64)
    popularity = deg / deg.sum()
    times = t0 + np.cumsum(rng.exponential(1.0 / rate_qps, num_queries))
    picks = rng.choice(len(progs), size=num_queries, p=weights)
    sources = rng.choice(cov, size=num_queries, p=popularity)
    return [
        (
            float(times[i]),
            progs[picks[i]].name,
            int(sources[i]) if progs[picks[i]].needs_source else None,
        )
        for i in range(num_queries)
    ]
