"""On-disk sharded edge store for out-of-core graph pipelines (port of
`repro.data.edgeshards`, host numpy in both packages).

The paper's target graphs (LiveJournal/Twitter/Friendster, Table IV) do
not fit an in-memory int64 edge list on one host. This module is the
disk format + external passes that let generation, degree computation,
the §IV-C degree-sum ordering, and the streaming partitioner all run
shard by shard, never materializing more than O(shard) edges:

  - `EdgeShardStore` / `ShardWriter`: fixed-size int64 chunk files
    (`shard-NNNNN.bin`, raw little-endian [n, 2] (src, dst) pairs) plus a
    JSON manifest carrying per-shard edge counts and log2-bucketed
    degree histograms (`manifest.json`, format "edgeshards-v1"). The
    files are the reference's byte for byte: a store written by either
    package is read by the other.
  - `rmat_to_store`: shard-by-shard R-MAT writer — candidate edges are
    drawn chunk-major through the same bit-plane core as
    `repro_torch.graph.generate.rmat` (the reference's draws for the same
    seed), deduplicated exactly with an external key-bucket pass, and
    streamed into shards in global key order.
  - `degrees_from_shards`: exact global total degrees in one pass.
  - `degree_sum_stream`: the §IV-C degree-sum edge order as an external
    sort — per-shard bucket sort into ascending key-range bucket files,
    then a stable merge of the per-shard sorted runs inside each bucket.
    The emitted permutation equals `repro_torch.core.order.degree_sum_order`
    (stable sort ≡ ascending disjoint buckets + stable within-bucket merge
    in stream order), which is what makes out-of-core ≡ in-memory
    partition parity exact.

Blocks are cut from shards and buckets in one linear pass (a block that
lies inside one shard or bucket is a view of it), so iterating costs
O(edges) whatever the block size.

Memory budget per pass (V vertices, E edges, shard size S):
  generation   O(chunk + E/num_buckets)   (candidate chunk + one dedup bucket)
  degrees      O(V)                        (one int64 degree array)
  order        O(V + bucket_edges)         (degrees + one bucket in flight)
  partition    O(V·p/32 + block)           (bitset state, see core.outofcore)
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.types import Graph, as_numpy
from repro_torch.graph.generate import _rmat_bitplane

MANIFEST_NAME = "manifest.json"
FORMAT_NAME = "edgeshards-v1"
_PAIR_DTYPE = np.dtype("<i8")  # on-disk: little-endian int64 (src, dst) pairs


def _degree_hist(src: np.ndarray, dst: np.ndarray) -> list[int]:
    """log2-bucketed histogram of within-shard endpoint multiplicities:
    hist[k] = #vertices whose incidence count inside this shard lies in
    [2^k, 2^(k+1)). Cheap per-shard skew fingerprint for the manifest."""
    if src.size == 0:
        return []
    _, cnt = np.unique(np.concatenate([src, dst]), return_counts=True)
    buckets = np.bincount(np.log2(cnt).astype(np.int64))
    return [int(x) for x in buckets]


def _validate_ids(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> None:
    for name, arr in (("src", src), ("dst", dst)):
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= num_vertices):
            bad = int(arr.min()) if int(arr.min()) < 0 else int(arr.max())
            raise ValueError(
                f"{name} has vertex id {bad} outside [0, num_vertices={num_vertices})"
            )


def _rebatch(chunks: Iterable[tuple], block: int) -> Iterator[tuple]:
    """Cut a stream of column tuples (equal-length arrays) into tuples of
    exactly `block` rows, the last one short. Linear: a block inside one
    chunk is a view of it, a block across chunks copies its own rows."""
    pending: collections.deque = collections.deque()
    held = 0

    def take(n):
        parts = []
        while n:
            head = pending[0]
            m = head[0].shape[0]
            if m <= n:
                parts.append(pending.popleft())
                n -= m
            else:
                parts.append(tuple(a[:n] for a in head))
                pending[0] = tuple(a[n:] for a in head)
                n = 0
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate(cols) for cols in zip(*parts))

    for chunk in chunks:
        if chunk[0].shape[0] == 0:
            continue
        pending.append(chunk)
        held += chunk[0].shape[0]
        while held >= block:
            held -= block
            yield take(block)
    if held:
        yield take(held)


class ShardWriter:
    """Buffered writer for an edge-shard directory.

    Appends int64 (src, dst) edge arrays; full shards of `shard_edges`
    edges are flushed to disk as they fill, so the writer holds at most
    one shard of edges. `close()` writes the manifest and returns the
    opened `EdgeShardStore`. Usable as a context manager.
    """

    def __init__(self, path, num_vertices: int, *, shard_edges: int = 1 << 20):
        if shard_edges < 1:
            raise ValueError(f"shard_edges must be >= 1, got {shard_edges}")
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.num_vertices = int(num_vertices)
        self.shard_edges = int(shard_edges)
        self._buf_src: list[np.ndarray] = []
        self._buf_dst: list[np.ndarray] = []
        self._buffered = 0
        self._shards: list[dict] = []
        self._closed = False

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()

    def append(self, src, dst) -> None:
        src = np.asarray(as_numpy(src), dtype=np.int64).ravel()
        dst = np.asarray(as_numpy(dst), dtype=np.int64).ravel()
        if src.shape != dst.shape:
            raise ValueError(f"src/dst shapes differ: {src.shape} vs {dst.shape}")
        _validate_ids(src, dst, self.num_vertices)
        self._buf_src.append(src)
        self._buf_dst.append(dst)
        self._buffered += src.size
        if self._buffered >= self.shard_edges:
            src = np.concatenate(self._buf_src)
            dst = np.concatenate(self._buf_dst)
            full = (src.size // self.shard_edges) * self.shard_edges
            for lo in range(0, full, self.shard_edges):
                hi = lo + self.shard_edges
                self._write_shard(src[lo:hi], dst[lo:hi])
            self._buf_src, self._buf_dst = [src[full:]], [dst[full:]]
            self._buffered = src.size - full

    def _write_shard(self, src: np.ndarray, dst: np.ndarray) -> None:
        n = src.size
        fname = f"shard-{len(self._shards):05d}.bin"
        pairs = np.empty((n, 2), dtype=_PAIR_DTYPE)
        pairs[:, 0] = src
        pairs[:, 1] = dst
        pairs.tofile(self.path / fname)
        self._shards.append({
            "file": fname,
            "num_edges": int(n),
            "degree_hist": _degree_hist(src, dst),
        })

    def close(self) -> "EdgeShardStore":
        if self._closed:
            return EdgeShardStore.open(self.path)
        if self._buffered > 0:
            self._write_shard(np.concatenate(self._buf_src), np.concatenate(self._buf_dst))
            self._buf_src, self._buf_dst, self._buffered = [], [], 0
        manifest = {
            "format": FORMAT_NAME,
            "num_vertices": self.num_vertices,
            "num_edges": int(sum(s["num_edges"] for s in self._shards)),
            "shard_edges": self.shard_edges,
            "dtype": "int64",
            "shards": self._shards,
        }
        (self.path / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        self._closed = True
        return EdgeShardStore.open(self.path)


@dataclasses.dataclass(frozen=True)
class EdgeShardStore:
    """Read view of an edge-shard directory (see module docstring)."""

    path: Path
    num_vertices: int
    num_edges: int
    shard_edges: int
    shards: tuple[dict, ...]

    @classmethod
    def open(cls, path) -> "EdgeShardStore":
        path = Path(path)
        mpath = path / MANIFEST_NAME
        if not mpath.exists():
            raise FileNotFoundError(f"no {MANIFEST_NAME} in {path} — not an edge-shard store")
        m = json.loads(mpath.read_text())
        if m.get("format") != FORMAT_NAME:
            raise ValueError(f"unsupported edge-shard format {m.get('format')!r} in {mpath}")
        return cls(
            path=path,
            num_vertices=int(m["num_vertices"]),
            num_edges=int(m["num_edges"]),
            shard_edges=int(m["shard_edges"]),
            shards=tuple(m["shards"]),
        )

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def read_shard(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        meta = self.shards[i]
        pairs = np.fromfile(self.path / meta["file"], dtype=_PAIR_DTYPE)
        pairs = pairs.reshape(-1, 2)
        if pairs.shape[0] != meta["num_edges"]:
            raise ValueError(
                f"shard {meta['file']} holds {pairs.shape[0]} edges, manifest says "
                f"{meta['num_edges']}"
            )
        return pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)

    def iter_shards(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for i in range(self.num_shards):
            yield self.read_shard(i)

    def iter_blocks(self, block: int) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Fixed-size (src, dst, orig_idx) blocks across shard boundaries,
        in store order; the final block may be short. orig_idx is the
        edge's global position in the store stream."""
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        base = 0
        for src, dst in _rebatch(self.iter_shards(), block):
            yield src, dst, np.arange(base, base + src.size, dtype=np.int64)
            base += src.size


def write_graph(graph: Graph, path, *, shard_edges: int = 1 << 20) -> EdgeShardStore:
    """Shard an in-memory Graph out to disk (tests + small-graph twins)."""
    with ShardWriter(path, graph.num_vertices, shard_edges=shard_edges) as w:
        w.append(graph.src, graph.dst)
    return EdgeShardStore.open(path)


def load_graph(store: EdgeShardStore) -> Graph:
    """Materialize a store into an in-memory Graph on the host (downscaled
    twins and parity oracles only — this is exactly the allocation the
    out-of-core pipeline exists to avoid)."""
    srcs, dsts = [], []
    for s, d in store.iter_shards():
        srcs.append(s)
        dsts.append(d)
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    if store.num_vertices <= np.iinfo(np.int32).max:
        src, dst = src.astype(np.int32), dst.astype(np.int32)
    return Graph(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                 num_vertices=store.num_vertices)


def degrees_from_shards(store: EdgeShardStore) -> np.ndarray:
    """Exact global total (in+out) degrees in one streaming pass; int64
    [V]. Matches `Graph.degrees()` of the materialized store bit-for-bit."""
    deg = np.zeros(store.num_vertices, np.int64)
    for src, dst in store.iter_shards():
        deg += np.bincount(src, minlength=store.num_vertices)
        deg += np.bincount(dst, minlength=store.num_vertices)
    return deg


# ------------------------------------------------- shard-by-shard R-MAT


def _rmat_candidate_chunk(rng, n: int, scale: int, a: float, b: float, c: float):
    """n candidate edges, drawing (scale, n) uniforms chunk-major."""
    src = np.zeros(n, dtype=np.int64)
    dst = np.zeros(n, dtype=np.int64)
    r = rng.random((scale, n))
    for lvl in range(scale):
        src, dst = _rmat_bitplane(src, dst, r[lvl], a, b, c)
    return src, dst


def _bucket_thin(counts: list[int], target: int) -> list[int]:
    """Per-bucket keep counts summing exactly to `target`, proportional to
    bucket sizes (largest-remainder rounding) — deterministic thinning
    spread across the whole key space instead of truncating a tail."""
    total = sum(counts)
    if target >= total:
        return list(counts)
    exact = [ct * target / total for ct in counts]
    keep = [min(int(math.floor(x)), ct) for x, ct in zip(exact, counts)]
    rem = target - sum(keep)
    frac = sorted(
        range(len(counts)), key=lambda i: (exact[i] - math.floor(exact[i]), -i), reverse=True
    )
    for i in frac:
        if rem == 0:
            break
        if keep[i] < counts[i]:
            keep[i] += 1
            rem -= 1
    return keep


def rmat_to_store(
    path,
    num_vertices: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    shard_edges: int = 1 << 20,
    chunk: int = 1 << 20,
    oversample: float = 1.15,
    workdir=None,
) -> EdgeShardStore:
    """Shard-by-shard R-MAT writer: generation never holds the full edge
    list. Candidates are drawn in `chunk`-sized batches through the same
    bit-plane core as the in-memory generator, self-loops stripped and
    exact global dedup done externally: candidate keys (src·V + dst) are
    range-partitioned by src high bits into bucket files, each bucket is
    uniq'ed independently, and buckets are emitted in ascending key order
    — the same global key-sorted edge order `generate._finalize` produces.
    When dedup leaves more than `num_edges` edges, a deterministic
    proportional thinning (evenly spaced within each bucket) trims to the
    requested count. Peak memory is O(chunk + max bucket size). The store
    is the reference's `rmat_to_store` for the same arguments, edge for
    edge.
    """
    if num_vertices & (num_vertices - 1) != 0:
        raise ValueError("num_vertices must be a power of 2")
    scale = int(np.log2(num_vertices))
    rng = np.random.default_rng(seed)
    n_cand = int(num_edges * oversample)
    work = Path(workdir) if workdir is not None else Path(path) / "_rmat_work"
    work.mkdir(parents=True, exist_ok=True)

    # Bucket by src high bits so bucket id is monotone in key = src*V + dst.
    n_buckets = max(1, 1 << max(0, int(np.ceil(np.log2(max(1, n_cand / (1 << 22)))))))
    n_buckets = min(n_buckets, num_vertices)
    shift = scale - int(np.log2(n_buckets))
    files = [open(work / f"bucket-{i:05d}.keys", "wb") for i in range(n_buckets)]
    try:
        left = n_cand
        while left > 0:
            m = min(chunk, left)
            left -= m
            src, dst = _rmat_candidate_chunk(rng, m, scale, a, b, c)
            keep = src != dst
            src, dst = src[keep], dst[keep]
            key = src * np.int64(num_vertices) + dst
            bucket = (src >> shift).astype(np.int64)
            o = np.argsort(bucket, kind="stable")
            key, bucket = key[o], bucket[o]
            bounds = np.searchsorted(bucket, np.arange(n_buckets + 1))
            for i in range(n_buckets):
                lo, hi = bounds[i], bounds[i + 1]
                if hi > lo:
                    key[lo:hi].astype(_PAIR_DTYPE).tofile(files[i])
    finally:
        for f in files:
            f.close()

    # Per-bucket exact dedup; ascending buckets = global key order.
    uniq_counts = []
    for i in range(n_buckets):
        keys = np.fromfile(work / f"bucket-{i:05d}.keys", dtype=_PAIR_DTYPE)
        keys = np.unique(keys)
        keys.astype(_PAIR_DTYPE).tofile(work / f"bucket-{i:05d}.keys")
        uniq_counts.append(int(keys.size))
    keep_counts = _bucket_thin(uniq_counts, num_edges)

    writer = ShardWriter(path, num_vertices, shard_edges=shard_edges)
    for i in range(n_buckets):
        bpath = work / f"bucket-{i:05d}.keys"
        keys = np.fromfile(bpath, dtype=_PAIR_DTYPE)
        if keep_counts[i] < keys.size:
            sel = np.linspace(0, keys.size - 1, keep_counts[i]).astype(np.int64)
            keys = keys[sel]
        writer.append(keys // num_vertices, keys % num_vertices)
        bpath.unlink()
    return writer.close()


# ------------------------------------------- external degree-sum ordering


@dataclasses.dataclass(frozen=True)
class OrderedEdgeStream:
    """Re-iterable §IV-C degree-sum-ordered edge stream backed by bucket
    files on disk: ascending disjoint key-range buckets, each holding its
    per-shard sorted runs, merged stably on iteration. The emitted
    permutation equals `np.argsort(deg[src]+deg[dst], kind="stable")` over
    the store stream bit-for-bit: a stable sort orders by (key, original
    position), and ascending buckets + stable within-bucket merge in
    stream order produce exactly that order."""

    workdir: Path
    store: EdgeShardStore
    degrees: np.ndarray  # int64 [V] exact global total degrees
    num_buckets: int
    bucket_counts: tuple[int, ...]

    @property
    def num_edges(self) -> int:
        return self.store.num_edges

    @property
    def num_vertices(self) -> int:
        return self.store.num_vertices

    def _read_bucket(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Bucket i's edges in final (degree-sum, stream-position) order:
        the k per-shard sorted runs are concatenated in shard order and
        merged with ONE stable key sort — equal keys keep run order, and
        run order IS ascending original position."""
        tri = np.fromfile(self.workdir / f"bucket-{i:05d}.bin", dtype=_PAIR_DTYPE)
        tri = tri.reshape(-1, 3)
        src, dst, idx = tri[:, 0], tri[:, 1], tri[:, 2]
        key = self.degrees[src] + self.degrees[dst]
        o = np.argsort(key, kind="stable")
        return src[o], dst[o], idx[o]

    def iter_blocks(self, block: int) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(src, dst, orig_idx) blocks of the ordered stream; the final
        block may be short. Holds at most one bucket plus one block."""
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        buckets = (self._read_bucket(i) for i in range(self.num_buckets)
                   if self.bucket_counts[i])
        yield from _rebatch(buckets, block)

    def permutation(self) -> np.ndarray:
        """Materialize the full order (int64 [E]) — parity tests only."""
        parts = [idx for _, _, idx in self.iter_blocks(1 << 20)]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def cleanup(self) -> None:
        for i in range(self.num_buckets):
            f = self.workdir / f"bucket-{i:05d}.bin"
            if f.exists():
                f.unlink()


def degree_sum_stream(
    store: EdgeShardStore,
    degrees: Optional[np.ndarray] = None,
    *,
    workdir=None,
    bucket_edges: int = 1 << 22,
) -> OrderedEdgeStream:
    """External §IV-C degree-sum sort (see `OrderedEdgeStream`). Two
    passes over the store:

      1. an exact coarse histogram of degree-sum keys (keys quantized by a
         power-of-two shift so the histogram stays <= 2^22 bins) picks
         ascending key-range boundaries with <= `bucket_edges` edges per
         bucket (a single over-full quantized key keeps its own bucket);
      2. every shard is bucket-sorted: its edges are appended to the
         matching bucket files as (src, dst, stream-position) triples, in
         stream order — each bucket then holds per-shard sorted runs.

    Iteration merges the runs bucket by bucket (see `_read_bucket`). The
    buckets are the reference's for the same store and arguments.
    """
    if degrees is None:
        degrees = degrees_from_shards(store)
    degrees = np.asarray(degrees, np.int64)
    work = Path(workdir) if workdir is not None else store.path / "_order_work"
    work.mkdir(parents=True, exist_ok=True)

    # Pass 1: exact histogram over quantized keys -> bucket boundaries.
    max_key = int(2 * degrees.max(initial=0))
    shift = max(0, int(max_key).bit_length() - 22)
    nbins = (max_key >> shift) + 2
    hist = np.zeros(nbins, np.int64)
    for src, dst in store.iter_shards():
        q = (degrees[src] + degrees[dst]) >> shift
        hist += np.bincount(q, minlength=nbins)
    bounds = [0]  # bucket i covers quantized keys [bounds[i], bounds[i+1])
    acc = 0
    for q in range(nbins):
        if acc and acc + int(hist[q]) > bucket_edges:
            bounds.append(q)
            acc = 0
        acc += int(hist[q])
    bounds.append(nbins)
    n_buckets = len(bounds) - 1
    upper = np.asarray(bounds[1:], np.int64)

    # Pass 2: per-shard bucket sort into (src, dst, orig_idx) triple files.
    files = [open(work / f"bucket-{i:05d}.bin", "wb") for i in range(n_buckets)]
    counts = [0] * n_buckets
    try:
        base = 0
        for src, dst in store.iter_shards():
            idx = np.arange(base, base + src.size, dtype=np.int64)
            base += src.size
            q = (degrees[src] + degrees[dst]) >> shift
            bucket = np.searchsorted(upper, q, side="right")
            o = np.argsort(bucket, kind="stable")  # keeps stream order per bucket
            tri = np.stack([src[o], dst[o], idx[o]], axis=1)
            edges = np.searchsorted(bucket[o], np.arange(n_buckets + 1))
            for i in range(n_buckets):
                lo, hi = edges[i], edges[i + 1]
                if hi > lo:
                    tri[lo:hi].astype(_PAIR_DTYPE).tofile(files[i])
                    counts[i] += int(hi - lo)
    finally:
        for f in files:
            f.close()
    return OrderedEdgeStream(
        workdir=work,
        store=store,
        degrees=degrees,
        num_buckets=n_buckets,
        bucket_counts=tuple(counts),
    )
