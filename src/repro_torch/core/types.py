"""Core graph / partition datatypes (port of `repro.core.types`).

A graph is a flat edge list (src, dst) of int32 vertex ids in
[0, num_vertices), held as torch tensors on the host. Undirected graphs
are represented by both directions (paper §III). Partitioners consume the
edge list and emit a per-edge partition assignment in [0, num_parts) —
an edge partition (vertex-cut), which the subgraph-centric model consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the device if needed) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Edge-list graph; int32 id tensors."""

    src: torch.Tensor  # [E]
    dst: torch.Tensor  # [E]
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> np.ndarray:
        """Total (in+out) degree per vertex, numpy."""
        src = as_numpy(self.src)
        dst = as_numpy(self.dst)
        deg = np.bincount(src, minlength=self.num_vertices)
        deg += np.bincount(dst, minlength=self.num_vertices)
        return deg.astype(np.int64)

    def covered_vertices(self) -> np.ndarray:
        """Sorted unique vertices incident to at least one edge. Isolated
        vertices have no replicas in any edge partition, so coverage is the
        domain for replication metrics, CC labels, and SSSP sources."""
        return np.unique(np.concatenate([as_numpy(self.src), as_numpy(self.dst)]))

    def validate(self) -> None:
        """Raise ValueError naming the offending field on malformed graphs."""
        src = as_numpy(self.src)
        dst = as_numpy(self.dst)
        if src.ndim != 1 or src.shape != dst.shape:
            raise ValueError(
                f"src/dst must be 1-D and the same shape; got src {src.shape}, dst {dst.shape}"
            )
        for name, arr in (("src", src), ("dst", dst)):
            if arr.min(initial=0) < 0:
                raise ValueError(f"{name} has negative vertex id {int(arr.min())}")
            if arr.max(initial=-1) >= self.num_vertices:
                raise ValueError(
                    f"{name} has vertex id {int(arr.max())} >= num_vertices={self.num_vertices}"
                )


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    """Result of an edge partitioner."""

    part: torch.Tensor  # [E] int32 in [0, num_parts)
    num_parts: int
    # Optional permutation applied to edges before assignment (EBG sorts
    # edges by degree-sum); part[i] corresponds to edge order[i] of the
    # ORIGINAL edge list when order is not None.
    order: Optional[torch.Tensor] = None

    def part_in_input_order(self) -> np.ndarray:
        """Per-edge assignment aligned with the original edge list."""
        part = as_numpy(self.part)
        if self.order is None:
            return part
        out = np.empty_like(part)
        out[as_numpy(self.order)] = part
        return out
