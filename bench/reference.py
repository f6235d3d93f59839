"""The plain reference of the benchmark's graph jobs, on the whole graph.

Straightforward torch over a CSR of the undirected graph (both arcs of
every edge), on any device, written from the algorithms' definitions and
independent of the program under test:

- `wcc`: each vertex's label is the least vertex id of its component
  (min-label propagation with pointer jumping);
- `bfs`: hop counts from a source, `UNREACHED_HOPS` where none;
- `sssp`: least path weight from a source, the path's weights added one
  after another from the source in `dtype` (the least fixpoint of
  d[v] = min(d[u] + w(u, v)), reached by frontier Bellman-Ford), +inf
  where unreached;
- `pagerank`: `iters` power iterations from 1/N of
  r'[v] = (1 - d)/N + d * sum over neighbours u of r[u] / deg(u).

`job_bytes` reckons the bytes a job needs on these inputs, each input byte
read once and each output byte written once: the least work any
implementation of the job must move, which the benchmark's roofline
metrics divide by the measured kernel time.
"""
from __future__ import annotations

import dataclasses

import torch

UNREACHED_HOPS = 2**31 - 1


@dataclasses.dataclass
class SymGraph:
    """CSR of an undirected edge list: the arcs leaving vertex v are
    nbr[off[v]:off[v + 1]], with weights w."""

    off: torch.Tensor  # [V + 1] int64
    nbr: torch.Tensor  # [2E] int64
    w: torch.Tensor  # [2E] float32
    src: torch.Tensor  # [2E] int64, the arc's tail (nondecreasing)
    deg: torch.Tensor  # [V] int64
    num_vertices: int

    @classmethod
    def from_edges(cls, src, dst, weight, num_vertices: int, device) -> "SymGraph":
        dev = torch.device(device)
        s = torch.as_tensor(src).to(dev, torch.int64)
        d = torch.as_tensor(dst).to(dev, torch.int64)
        w = torch.as_tensor(weight).to(dev, torch.float32)
        tail = torch.cat([s, d])
        head = torch.cat([d, s])
        order = torch.argsort(tail)
        tail, head, w = tail[order], head[order], torch.cat([w, w])[order]
        del order
        deg = torch.bincount(tail, minlength=num_vertices)
        off = torch.zeros(num_vertices + 1, dtype=torch.int64, device=dev)
        off[1:] = torch.cumsum(deg, 0)
        return cls(off=off, nbr=head, w=w, src=tail, deg=deg, num_vertices=num_vertices)

    @property
    def num_arcs(self) -> int:
        return int(self.nbr.shape[0])

    def arcs_of(self, frontier: torch.Tensor) -> torch.Tensor:
        """Indices of the arcs leaving the vertices in `frontier`."""
        counts = self.deg[frontier]
        total = int(counts.sum())
        if total == 0:
            return torch.zeros(0, dtype=torch.int64, device=frontier.device)
        seg = torch.repeat_interleave(torch.arange(frontier.shape[0], device=frontier.device),
                                      counts, output_size=total)
        first = torch.cumsum(counts, 0) - counts
        return torch.arange(total, device=frontier.device) - first[seg] + self.off[frontier][seg]


def wcc(g: SymGraph) -> torch.Tensor:
    """[V] int64: the least vertex id of each vertex's component."""
    label = torch.arange(g.num_vertices, device=g.off.device)
    while True:
        new = label.clone()
        new.scatter_reduce_(0, g.nbr, label[g.src], "amin")
        new = new[new]  # pointer jumping: a label is a vertex of the same component
        if torch.equal(new, label):
            return label
        label = new


def bfs(g: SymGraph, source: int) -> torch.Tensor:
    """[V] int64 hop counts from `source`; UNREACHED_HOPS where none."""
    dev = g.off.device
    hops = torch.full((g.num_vertices,), UNREACHED_HOPS, dtype=torch.int64, device=dev)
    hops[source] = 0
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    level = 0
    while frontier.numel():
        level += 1
        heads = g.nbr[g.arcs_of(frontier)]
        heads = torch.unique(heads[hops[heads] == UNREACHED_HOPS])
        hops[heads] = level
        frontier = heads
    return hops


def sssp(g: SymGraph, source: int, dtype=torch.float32) -> torch.Tensor:
    """[V] least path weights from `source` in `dtype`; +inf where none."""
    dev = g.off.device
    w = g.w.to(dtype)
    dist = torch.full((g.num_vertices,), float("inf"), dtype=dtype, device=dev)
    dist[source] = 0
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    while frontier.numel():
        arcs = g.arcs_of(frontier)
        cand = dist[g.src[arcs]] + w[arcs]
        new = dist.clone()
        new.scatter_reduce_(0, g.nbr[arcs], cand, "amin")
        frontier = torch.nonzero(new < dist).flatten()
        dist = new
    return dist


def pagerank(g: SymGraph, iters: int, damping: float, num_vertices: int,
             dtype=torch.float64) -> torch.Tensor:
    """[V] ranks after `iters` power iterations from 1/N, in `dtype`."""
    dev = g.off.device
    rank = torch.full((g.num_vertices,), 1.0 / num_vertices, dtype=dtype, device=dev)
    deg = g.deg.to(dtype)
    base = (1.0 - damping) / num_vertices
    for _ in range(iters):
        share = rank / deg
        acc = torch.zeros_like(rank).index_add_(0, g.nbr, share[g.src])
        rank = base + damping * acc
    return rank


# ------------------------------------------------------------------ bytes

# Bytes an arc costs a traversal: the head's id (4 B) and its value (4 B);
# SSSP reads the arc's f32 weight (4 B) besides. A vertex reached costs
# its CSR offset (4 B) and its value written once (4 B).
ARC_BYTES = {"bfs": 8, "sssp": 12, "cc": 8}
VERTEX_BYTES = 8
# A PageRank iteration reads every arc's tail id (4 B) and the tail's
# share (4 B), and a vertex's offset, rank and degree (12 B) and writes
# its share and its new rank (8 B).
PR_ARC_BYTES = 8
PR_VERTEX_BYTES = 20


@dataclasses.dataclass
class Components:
    """Vertices and arcs of each component, indexed by its label."""

    label: torch.Tensor  # [V] int64
    verts: torch.Tensor  # [V] int64, by label
    arcs: torch.Tensor  # [V] int64, by label

    @classmethod
    def of(cls, g: SymGraph, label: torch.Tensor) -> "Components":
        verts = torch.bincount(label, minlength=g.num_vertices)
        arcs = torch.bincount(label, weights=g.deg.to(torch.float64),
                              minlength=g.num_vertices).to(torch.int64)
        return cls(label=label, verts=verts, arcs=arcs)


def job_bytes(program: str, g: SymGraph, comps: Components, source=None, *,
              iters: int = 0) -> int:
    """Bytes a job needs on this graph: a traversal from `source` (BFS,
    SSSP) crosses each arc of the source's component once and reaches each
    of its vertices once, as a breadth-first or Dijkstra search does; CC
    crosses every arc and reaches every vertex once; PageRank does its
    iteration's work `iters` times."""
    if program == "pr":
        return iters * (PR_ARC_BYTES * g.num_arcs + PR_VERTEX_BYTES * g.num_vertices)
    if program == "cc":
        arcs, verts = g.num_arcs, g.num_vertices
    else:
        lab = int(comps.label[int(source)])
        arcs, verts = int(comps.arcs[lab]), int(comps.verts[lab])
    return ARC_BYTES[program] * arcs + VERTEX_BYTES * verts
