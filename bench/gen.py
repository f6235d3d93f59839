"""Graph500's Kronecker graph, generated with torch on the device from a seed.

The Graph500 specification (Kronecker generator, section 3) draws each of
`edge_factor * 2**scale` edges one bit level at a time: at every level the
edge falls into one of the adjacency matrix's four quadrants with
probabilities A, B, C and D = 1 - A - B - C. The vertex labels are then
permuted at random. LDBC Graphalytics' `graph500-<scale>` datasets are this
graph made undirected, with self-loops, duplicate edges and vertices
without an edge removed; this module does the same, renumbering the
remaining vertices in the order of their permuted labels. SSSP weights are
uniform in [0, 1), as Graph500's SSSP kernel draws them.

Every random stream is a `torch.Generator` on the device, seeded from the
run's seed and the stream's name, so the same seed gives the same graph,
weights and search keys on a given device type.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named random stream of run `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, name))
    return g


@dataclasses.dataclass
class EdgeList:
    """An undirected graph, each edge once with src < dst, sorted by
    (src, dst); ids are int32 in [0, num_vertices) and every vertex has an
    edge."""

    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32
    weight: torch.Tensor  # [E] float32 in [0, 1)
    num_vertices: int
    generated_edges: int  # edges drawn before the clean-up

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def kronecker(scale: int, edge_factor: int, a: float, b: float, c: float, *, seed: int,
              device) -> EdgeList:
    """Graph500's Kronecker graph at `scale` (2**scale vertex labels) with
    `edge_factor` edges a label, cleaned up as Graphalytics does."""
    dev = torch.device(device)
    if not (0 < a and 0 < b and 0 < c and a + b + c < 1):
        raise ValueError(f"initiator A={a}, B={b}, C={c} must be positive and sum below 1")
    n = 1 << scale
    m = edge_factor * n
    g = generator(seed, "kronecker", dev)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(m, dtype=torch.int64, device=dev)
    v = torch.zeros(m, dtype=torch.int64, device=dev)
    for level in range(scale):
        # The quadrant of this bit level, as the specification's reference
        # code draws it: first the row bit, then the column bit given it.
        ii = torch.rand(m, generator=g, device=dev) > ab
        jj = torch.rand(m, generator=g, device=dev) > torch.where(ii, c_norm, a_norm)
        u |= ii.long() << level
        v |= jj.long() << level
        del ii, jj
    perm = torch.randperm(n, generator=g, device=dev)
    u, v = perm[u], perm[v]
    del perm
    keep = u != v
    u, v = u[keep], v[keep]
    del keep
    key = torch.unique(torch.minimum(u, v) * n + torch.maximum(u, v))  # sorted
    del u, v
    lo, hi = key // n, key % n
    del key
    covered = torch.zeros(n, dtype=torch.bool, device=dev)
    covered[lo] = True
    covered[hi] = True
    new_id = torch.cumsum(covered, 0) - 1  # keeps the order, so src < dst stays
    num_vertices = int(covered.sum())
    src = new_id[lo].to(torch.int32)
    dst = new_id[hi].to(torch.int32)
    del lo, hi, new_id, covered
    weight = torch.rand(src.shape[0], generator=generator(seed, "weights", dev), device=dev)
    return EdgeList(src=src, dst=dst, weight=weight, num_vertices=num_vertices,
                    generated_edges=m)


def search_keys(num_vertices: int, count: int, *, seed: int, device) -> torch.Tensor:
    """`count` Graph500 search keys: vertices drawn uniformly among those
    with an edge (all of an `EdgeList`'s), int64 on `device`."""
    g = generator(seed, "search_keys", device)
    return torch.randint(0, num_vertices, (count,), generator=g, device=torch.device(device))
