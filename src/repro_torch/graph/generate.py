"""Synthetic graph generators (port of `repro.graph.generate`, numpy on the host).

  - rmat(...)      : R-MAT power-law graph; a/b/c/d control skew (eta).
  - barabasi(...)  : Barabasi-Albert preferential attachment.
  - road_grid(...) : 2D lattice with diagonal shortcuts — USARoad analogue.

All generators return directed Graphs without self loops, deduplicated.
The random streams are the reference's draw for draw, so the same seed
gives identical edge arrays in both packages.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.types import Graph


def _graph(src: np.ndarray, dst: np.ndarray, V: int) -> Graph:
    return Graph(
        src=torch.from_numpy(np.ascontiguousarray(src, np.int32)),
        dst=torch.from_numpy(np.ascontiguousarray(dst, np.int32)),
        num_vertices=V,
    )


def _finalize(src, dst, V) -> tuple[np.ndarray, np.ndarray]:
    m = src != dst
    src, dst = src[m], dst[m]
    key = np.unique(src.astype(np.int64) * V + dst)
    return (key // V).astype(np.int32), (key % V).astype(np.int32)


def _rmat_bitplane(src, dst, r, a: float, b: float, c: float):
    """One R-MAT recursion level: descend every edge one quadrant using a
    single uniform draw per edge."""
    ab, abc = a + b, a + b + c
    src = src * 2 + (r >= ab)
    dst = dst * 2 + ((r >= a) & (r < ab)) + (r >= abc)
    return src, dst


_CHUNK = 1 << 20  # edges an R-MAT worker descends through every level at once


def _rmat_descend(rng: np.random.Generator, n: int, scale: int, a: float, b: float, c: float):
    """The reference's `scale` levels of `_rmat_bitplane` over n edges, each
    level one `rng.random(n)` draw: the same doubles, so the same edges.

    Level k uses stream draws [k·n, (k+1)·n), so a chunk of edges can take
    its draws from a copy of the generator advanced to k·n + start (PCG64
    gives one double per 64-bit output). Chunks run on a thread pool (numpy
    releases the interpreter lock for the draws and the arithmetic), each
    through all levels while its edges stay in cache; `rng` ends advanced
    past all scale·n draws, as the reference's loop leaves it."""
    src = np.empty(n, dtype=np.int64)
    dst = np.empty(n, dtype=np.int64)
    state = rng.bit_generator.state

    def chunk(lo: int) -> None:
        hi = min(lo + _CHUNK, n)
        s = np.zeros(hi - lo, dtype=np.int64)
        d = np.zeros(hi - lo, dtype=np.int64)
        for k in range(scale):
            bits = np.random.PCG64()
            bits.state = state
            bits.advance(k * n + lo)
            s, d = _rmat_bitplane(s, d, np.random.Generator(bits).random(hi - lo), a, b, c)
        src[lo:hi], dst[lo:hi] = s, d

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in pool.map(chunk, range(0, n, _CHUNK)):
            pass
    rng.bit_generator.advance(scale * n)
    return src, dst


def rmat(
    num_vertices: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Graph:
    """R-MAT generator. Defaults (.57,.19,.19,.05) give Twitter-like skew."""
    if num_vertices & (num_vertices - 1):
        raise ValueError(f"num_vertices must be a power of 2, got {num_vertices}")
    scale = int(np.log2(num_vertices))
    rng = np.random.default_rng(seed)
    n = int(num_edges * 1.15)  # oversample to survive dedup
    src, dst = _rmat_descend(rng, n, scale, a, b, c)
    src, dst = _finalize(src, dst, num_vertices)
    if src.shape[0] > num_edges:
        idx = rng.choice(src.shape[0], size=num_edges, replace=False)
        idx.sort()
        src, dst = src[idx], dst[idx]
    return _graph(src, dst, num_vertices)


def barabasi(num_vertices: int, attach: int = 8, *, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment (eta ~= 3), vectorized with the
    reference's draw sequence (see `repro.graph.generate.barabasi`)."""
    rng = np.random.default_rng(seed)
    blocks = num_vertices - attach
    if blocks <= 0:
        return _graph(*_finalize(np.zeros(0, np.int64), np.zeros(0, np.int64), num_vertices),
                      num_vertices)
    two_a = 2 * attach
    idx = np.empty((blocks, attach), np.int64)
    idx[0] = np.arange(attach)  # unused; block 0's targets are fixed below
    for b in range(1, blocks):
        idx[b] = rng.integers(0, two_a * b, attach)
    blk, off = idx // two_a, idx % two_a
    # Entry e = b*attach + j resolves to the block's new vertex when
    # off >= attach, else chains to an earlier entry; pointer jumping
    # resolves the forest in O(log depth) passes.
    val = np.where(off >= attach, attach + blk, 0).ravel()
    known = (off >= attach).ravel()
    ee = np.arange(blocks * attach, dtype=np.int64)
    parent = np.where(known, ee, (blk * attach + off).ravel())
    val[:attach] = np.arange(attach)
    known[:attach] = True
    parent[:attach] = ee[:attach]
    while not known.all():
        val = np.where(known, val, val[parent])
        known = known | known[parent]
        parent = parent[parent]
    src = np.repeat(np.arange(attach, num_vertices, dtype=np.int64), attach)
    return _graph(*_finalize(src, val, num_vertices), num_vertices)


def road_grid(side: int, *, diag_prob: float = 0.1, seed: int = 0) -> Graph:
    """2D lattice (side x side) + sparse diagonals; undirected (both dirs)."""
    rng = np.random.default_rng(seed)
    V = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    right = vid[(jj < side - 1).ravel()]
    down = vid[(ii < side - 1).ravel()]
    edges = [(right, right + 1), (down, down + side)]
    diag = vid[((ii < side - 1) & (jj < side - 1)).ravel()]
    keep = rng.random(diag.shape[0]) < diag_prob
    edges.append((diag[keep], diag[keep] + side + 1))
    src = np.concatenate([e[0] for e in edges])
    dst = np.concatenate([e[1] for e in edges])
    return _graph(
        *_finalize(
            np.concatenate([src, dst]).astype(np.int64),
            np.concatenate([dst, src]).astype(np.int64),
            V,
        ),
        V,
    )


REGISTRY = {
    # name: (factory, kwargs) — the reference's registry, entry for entry.
    "livejournal_like": (rmat, dict(num_vertices=1 << 17, num_edges=1 << 21, a=0.57, b=0.19, c=0.19)),
    "twitter_like": (rmat, dict(num_vertices=1 << 17, num_edges=1 << 21, a=0.65, b=0.15, c=0.15)),
    "friendster_like": (rmat, dict(num_vertices=1 << 18, num_edges=1 << 22, a=0.55, b=0.19, c=0.19)),
    "road_like": (road_grid, dict(side=512)),
    "tiny_powerlaw": (rmat, dict(num_vertices=1 << 10, num_edges=1 << 13)),
    "tiny_road": (road_grid, dict(side=32)),
}


def make_graph(name: str, **overrides) -> Graph:
    fn, kw = REGISTRY[name]
    return fn(**dict(kw, **overrides))
