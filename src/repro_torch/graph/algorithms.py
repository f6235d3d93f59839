"""The benchmark algorithms on the BSP engine (port of
`repro.graph.algorithms`; the numpy host oracles stay with the reference).

Every algorithm is a `VertexProgram` executed by the generic engine
(`repro_torch.graph.engine.run_bsp`); the named wrappers fix the program
and strip the dump slot, and pass every engine keyword through, `driver=`
("fused", the default, or "host") among them. Values come back as host
numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import as_numpy
from repro_torch.graph.build import SubgraphSet
from repro_torch.graph.engine import BFS, CC, PR, REACH, SSSP, BSPStats, run_bsp


def run_program(
    sub: SubgraphSet, program, *, num_vertices: int = 0, source=None, **kw
) -> tuple[np.ndarray, BSPStats]:
    """Run any `VertexProgram` (instance or registered name) and return
    values indexed by (part, local) with the dump slot stripped."""
    val, stats = run_bsp(sub, program, num_vertices=num_vertices, source=source, **kw)
    return as_numpy(val[:, :-1]), stats


def connected_components(sub: SubgraphSet, **kw) -> tuple[np.ndarray, BSPStats]:
    """Min-label propagation CC. Returns labels indexed by (part, local)."""
    return run_program(sub, CC, **kw)


def sssp(sub: SubgraphSet, source: int, **kw) -> tuple[np.ndarray, BSPStats]:
    return run_program(sub, SSSP, source=source, **kw)


def bfs(sub: SubgraphSet, source: int, **kw) -> tuple[np.ndarray, BSPStats]:
    """Hop counts from `source` (min-plus over unit weights, int32)."""
    return run_program(sub, BFS, source=source, **kw)


def reachability(sub: SubgraphSet, **kw) -> tuple[np.ndarray, BSPStats]:
    """Max-label propagation: every vertex converges to the largest vertex id
    reachable from it over the undirected view (run as min over negations)."""
    return run_program(sub, REACH, **kw)


def pagerank(
    sub: SubgraphSet,
    num_vertices: int,
    *,
    damping: float = 0.85,
    num_iters: int = 20,
    tol: float = 0.0,
    **kw,
) -> tuple[np.ndarray, BSPStats]:
    prog = PR if damping == PR.damping else dataclasses.replace(PR, damping=float(damping))
    return run_program(
        sub, prog, num_vertices=num_vertices, max_supersteps=num_iters, tol=tol, **kw
    )


def scatter_to_global(sub: SubgraphSet, local_vals: np.ndarray, num_vertices: int,
                      reduce: str = "min") -> np.ndarray:
    """Collect per-(part, local) values into a global array via masters."""
    gid = as_numpy(sub.gid)
    is_m = as_numpy(sub.is_master)
    out = np.full(num_vertices, np.inf if reduce == "min" else 0.0)
    sel = is_m & (gid >= 0)
    out[gid[sel]] = np.asarray(local_vals)[sel]
    return out
