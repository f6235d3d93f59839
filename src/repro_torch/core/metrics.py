"""Partition-quality metrics from the paper (§III) + message balance (§V-C);
port of `repro.core.metrics` (numpy on the host)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import Graph, PartitionResult, as_numpy


@dataclasses.dataclass(frozen=True)
class PartitionMetrics:
    replication_factor: float  # sum_i |V_i| / |V|
    edge_imbalance: float  # max_i |E_i| / (|E|/p)
    vertex_imbalance: float  # max_i |V_i| / (sum_i |V_i| / p)
    edges_per_part: np.ndarray
    vertices_per_part: np.ndarray

    def row(self) -> dict:
        return dict(
            replication_factor=round(self.replication_factor, 3),
            edge_imbalance=round(self.edge_imbalance, 3),
            vertex_imbalance=round(self.vertex_imbalance, 3),
        )


def partition_metrics(graph: Graph, result: PartitionResult) -> PartitionMetrics:
    part = result.part_in_input_order()
    p = result.num_parts
    src = as_numpy(graph.src).astype(np.int64)
    dst = as_numpy(graph.dst).astype(np.int64)
    V = graph.num_vertices

    e_counts = np.bincount(part, minlength=p).astype(np.int64)
    # |V_i| = #unique endpoints among edges of part i.
    keys = np.concatenate([part.astype(np.int64) * V + src, part.astype(np.int64) * V + dst])
    uniq = np.unique(keys)
    v_counts = np.bincount((uniq // V).astype(np.int64), minlength=p).astype(np.int64)
    # |V| over vertices covered by edges (isolated vertices have no replicas).
    covered = graph.covered_vertices().shape[0]

    E = part.shape[0]
    rep = float(v_counts.sum()) / max(covered, 1)
    e_imb = float(e_counts.max()) / (E / p) if E else 1.0
    v_imb = float(v_counts.max()) / (v_counts.sum() / p) if v_counts.sum() else 1.0
    return PartitionMetrics(rep, e_imb, v_imb, e_counts, v_counts)


def max_mean_ratio(per_worker_counts) -> float:
    """max/mean message-balance metric (paper Table V)."""
    c = np.asarray(per_worker_counts, dtype=np.float64)
    mean = c.mean()
    return float(c.max() / mean) if mean > 0 else 1.0


def theorem1_edge_bound(E: int, p: int, alpha: float, beta: float) -> float:
    """Worst-case edge imbalance bound (paper Theorem 1)."""
    return 1.0 + (p - 1) / E * (1 + np.floor(2 * E / (alpha * p) + (beta / alpha) * E))


def theorem2_vertex_bound(sum_vi: int, V: int, p: int, alpha: float, beta: float) -> float:
    """Worst-case vertex imbalance bound (paper Theorem 2)."""
    return 1.0 + (p - 1) / sum_vi * (1 + np.floor(2 * V / (beta * p) + (alpha / beta) * V))
