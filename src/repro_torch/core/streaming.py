"""Streaming vertex-cut partitioner core (port of `repro.core.streaming`):
a pluggable `EdgeScorer` over ONE blocked commit driver.

The paper's EBV algorithm (`ebg`), HDRF [Petroni et al., CIKM'15] and
PowerGraph Greedy [Gonzalez et al., OSDI'12] share one sequential state
machine and differ only in the per-edge score they minimize:

    state: keep[i] ⊆ V (membership per subgraph, a packed p×V bitset)
           e_count[i], v_count[i] (running balance counters)
    per edge (u, v):
        i* = argmin_i score(u, v, i, state)   (ties -> lowest subgraph id)
        e_count[i*] += 1; v_count[i*] += #endpoints new to keep[i*]
        keep[i*] |= {u, v}

    score(u,v,i) = wu·1[u∉keep[i]] + wv·1[v∉keep[i]]        (replication)
                 + ce · e_count[i] · norm_e                 (edge balance)
                 + cv · v_count[i] · (p/|V|)                (vertex balance)

| scorer   | wu, wv         | norm_e          | ce, cv      |
|----------|----------------|-----------------|-------------|
| `ebv`    | 1, 1           | p/|E| (static)  | alpha, beta |
| `hdrf`   | 2−θ(u), 2−θ(v) | 1/(eps+max−min) | lambda, 0   |
| `greedy` | 1, 1           | 1/(eps+max−min) | 1, 0        |

The blocked driver scores B edges against block-start membership and
commits the balance counters exactly and sequentially within the block
(block=1 is the faithful algorithm); every block runs through the fused
commit kernel (`repro_torch.kernels.ebg_commit`: the CUDA kernel on the
card, its plain PyTorch version on the CPU). commit="window" replays each
commit onto the block's later conflicted edges, so any block size is
bit-identical to the one-edge-at-a-time scan — which is how the scan
(`streaming_scan_partition`) runs here: the same kernel with window=True.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.config import EBGConfig, GreedyConfig, HDRFConfig, check_commit_mode
from repro_torch.api.registry import register_partitioner
from repro_torch.core.order import degree_sum_order
from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.kernels import ebg_commit as _ebg
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import resolve_device

MEMBERSHIP_TERMS = ("miss",)  # penalize endpoints absent from keep[i]
DEGREE_TERMS = ("none", "hdrf_theta")  # per-edge miss weights: 1 | 2−θ
BALANCE_MODES = ("static", "range")  # norm_e: p/|E| | 1/(eps+max−min)
TIE_POLICIES = ("lowest",)  # argmin ties -> lowest subgraph id
UPDATE_RULES = ("standard",)  # commit counters + endpoint membership

# Block size the scan runs at: with window commit every block size gives
# the scan's assignments, so this only sets the kernel's replay width.
SCAN_BLOCK = 256


def _check(value, valid, field: str) -> None:
    if value not in valid:
        raise ValueError(f"EdgeScorer.{field} must be one of {valid}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class EdgeScorer:
    """Frozen description of a streaming greedy edge-partitioner score.
    Default coefficients (`ce`/`cv`/`eps`) are overridable per call."""

    name: str
    membership: str = "miss"
    degree_term: str = "none"
    balance: str = "static"
    ce: float = 1.0  # edge-balance coefficient (EBV alpha, HDRF lambda)
    cv: float = 0.0  # vertex-balance coefficient (EBV beta)
    eps: float = 1.0  # range-normalizer epsilon
    tie: str = "lowest"
    update: str = "standard"
    sort_edges: bool = True  # default §IV-C degree-sum edge ordering
    description: str = ""

    def __post_init__(self) -> None:
        _check(self.membership, MEMBERSHIP_TERMS, "membership")
        _check(self.degree_term, DEGREE_TERMS, "degree_term")
        _check(self.balance, BALANCE_MODES, "balance")
        _check(self.tie, TIE_POLICIES, "tie")
        _check(self.update, UPDATE_RULES, "update")
        for field in ("ce", "cv", "eps"):
            v = getattr(self, field)
            if not isinstance(v, (int, float)) or not np.isfinite(v) or v < 0:
                raise ValueError(f"EdgeScorer.{field} must be finite and >= 0, got {v!r}")

    @property
    def weighted(self) -> bool:
        """Whether the replication term carries per-edge degree weights."""
        return self.degree_term != "none"

    def coefficients(self, ce=None, cv=None, eps=None) -> tuple[float, float, float]:
        """Resolve per-call coefficient overrides against the defaults."""
        return (
            float(self.ce if ce is None else ce),
            float(self.cv if cv is None else cv),
            float(self.eps if eps is None else eps),
        )


_SCORERS: dict[str, EdgeScorer] = {}


def register_scorer(scorer: EdgeScorer) -> EdgeScorer:
    """Register a scorer instance; returns it unchanged."""
    if scorer.name in _SCORERS:
        raise ValueError(f"scorer {scorer.name!r} already registered")
    _SCORERS[scorer.name] = scorer
    return scorer


def get_scorer(scorer: Union[str, EdgeScorer]) -> EdgeScorer:
    if isinstance(scorer, EdgeScorer):
        return scorer
    try:
        return _SCORERS[scorer]
    except KeyError:
        raise KeyError(f"unknown scorer {scorer!r}; registered: {sorted(_SCORERS)}") from None


def scorer_names() -> tuple[str, ...]:
    return tuple(_SCORERS)


EBV = register_scorer(EdgeScorer(
    name="ebv", ce=1.0, cv=1.0,
    description="Paper Algorithm 1: unit membership + static p/|E|, p/|V| balance",
))
HDRF = register_scorer(EdgeScorer(
    name="hdrf", degree_term="hdrf_theta", balance="range", ce=1.0, cv=0.0, sort_edges=False,
    description="HDRF [Petroni'15]: 2−θ degree-weighted membership + lambda range balance",
))
GREEDY = register_scorer(EdgeScorer(
    name="greedy", balance="range", ce=1.0, cv=0.0, sort_edges=False,
    description="PowerGraph Greedy [Gonzalez'12]: A(u)∩A(v) membership + range balance",
))


def validate_edge_stream(src, dst, *, num_vertices: int, weights=None) -> None:
    """Validate an edge stream at partitioner intake: raise ValueError naming
    the offending FIELD and the first offending ROW (input order). Checks
    matching 1-D shapes, ids in [0, num_vertices), no self-loops, and finite
    non-negative per-edge weights."""
    src = as_numpy(src)
    dst = as_numpy(dst)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(
            f"src/dst must be 1-D and the same shape; got src {src.shape}, dst {dst.shape}"
        )
    for name, arr in (("src", src), ("dst", dst)):
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{name} must be an integer array, got dtype {arr.dtype}")
        bad = np.flatnonzero((arr < 0) | (arr >= num_vertices))
        if bad.size:
            row = int(bad[0])
            raise ValueError(
                f"{name}[{row}] = {int(arr[row])} out of range [0, num_vertices={num_vertices})"
            )
    loops = np.flatnonzero(src == dst)
    if loops.size:
        row = int(loops[0])
        raise ValueError(
            f"self-loop at edge row {row}: src[{row}] == dst[{row}] == {int(src[row])} "
            "(streaming partitioners require loop-free streams; strip self-loops first)"
        )
    if weights is not None:
        w = as_numpy(weights)
        if w.shape != src.shape:
            raise ValueError(f"weights must match the edge stream shape {src.shape}, got {w.shape}")
        bad = np.flatnonzero(~np.isfinite(w.astype(np.float64)) | (w.astype(np.float64) < 0))
        if bad.size:
            row = int(bad[0])
            raise ValueError(f"weights[{row}] = {float(w[row])!r} must be finite and >= 0")


def degree_weights_np(deg32: np.ndarray, src: np.ndarray, dst: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The replication term's per-edge weights 2 − d/(du+dv) in f32, from
    exact total degrees `deg32` (f32), as the reference computes them."""
    du, dv = deg32[src], deg32[dst]
    tot = du + dv
    return np.float32(2.0) - du / tot, np.float32(2.0) - dv / tot


def edge_weights_np(scorer: EdgeScorer, graph: Graph, src: np.ndarray, dst: np.ndarray
                    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Per-edge replication-term weights (wu, wv) as f32 numpy, or None;
    host-side from exact total degrees, as the reference computes them."""
    if not scorer.weighted:
        return None
    return degree_weights_np(graph.degrees().astype(np.float32), src, dst)


def stream_coefficients(ce: float, cv: float, eps: float, *, num_parts: int, num_edges: int,
                        num_vertices: int, device) -> torch.Tensor:
    """The commit kernel's [5] f32 coefficient vector, with the balance
    normalizers in f32 as the reference computes them: float32(p) /
    float32(real edge count), float32(p) / float32(V)."""
    p = np.float32(num_parts)
    return ops.commit_coefficients(alpha=ce, beta=cv, inv_e=p / np.float32(max(num_edges, 1)),
                                   inv_v=p / np.float32(num_vertices), eps=eps, device=device)


def pad_blocks(src: np.ndarray, dst: np.ndarray, w: Optional[tuple[np.ndarray, np.ndarray]],
               block: int, device):
    """A stretch of the stream as the commit kernel takes it, on `device`:
    (u, v, valid, wu, wv), padded to whole blocks with self-loops on vertex
    0, masked out of the commit (and dropped from the result); their 1.0
    weights keep the scored lanes finite. The in-memory driver pads its
    whole stream here, the out-of-core driver each group of blocks, so the
    two feed the kernel the same lanes."""
    n = src.shape[0]
    padded = -(-n // block) * block

    def put(a, fill, dtype):
        out = np.full(padded, fill, dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    wu = wv = None
    if w is not None:
        wu, wv = put(w[0], 1.0, np.float32), put(w[1], 1.0, np.float32)
    return (put(src, 0, np.int32), put(dst, 0, np.int32), put(True, False, bool), wu, wv)


@dataclasses.dataclass(frozen=True)
class EdgeStream:
    """A partitioner's input as the commit kernel takes it, on one device:
    the (reordered, block-padded) endpoints, the valid mask (pads False),
    the scorer's weight streams (or None) and coefficient vector."""

    u: torch.Tensor  # [E + pad] int32
    v: torch.Tensor  # [E + pad] int32
    valid: torch.Tensor  # [E + pad] bool
    wu: Optional[torch.Tensor]  # [E + pad] f32, weighted scorers only
    wv: Optional[torch.Tensor]
    coef: torch.Tensor  # [5] f32: ce, cv, inv_e, inv_v, eps
    num_edges: int  # E, the real edges
    order: Optional[np.ndarray]  # the stream's permutation of the input edges
    balance: str
    block: int

    def new_state(self, num_parts: int, num_vertices: int):
        """Zeroed (keep_bits, e_count, v_count) for a fresh stream."""
        dev = self.u.device
        return (torch.zeros((num_parts, (num_vertices + 31) // 32), dtype=torch.int32, device=dev),
                torch.zeros((num_parts,), dtype=torch.float32, device=dev),
                torch.zeros((num_parts,), dtype=torch.float32, device=dev))


def prepare_stream(graph: Graph, num_parts: int, scorer: Union[str, EdgeScorer], *,
                   ce=None, cv=None, eps=None, block: int = 256, order=None,
                   sort_edges: Optional[bool] = None, device=None) -> EdgeStream:
    """Validate, order and pad a graph's edge stream for the blocked driver."""
    dev = resolve_device(device)
    sc = get_scorer(scorer)
    ce, cv, eps = sc.coefficients(ce, cv, eps)
    if sort_edges is None:
        sort_edges = sc.sort_edges
    src = as_numpy(graph.src).astype(np.int32)
    dst = as_numpy(graph.dst).astype(np.int32)
    # Validate BEFORE reorder and BEFORE the masked self-loop padding below
    # (pad rows are synthetic and exempt); rows are named in input order.
    validate_edge_stream(src, dst, num_vertices=graph.num_vertices)
    if order is None and sort_edges:
        order = degree_sum_order(graph)
    if order is not None:
        order = np.asarray(order, dtype=np.int64)
        src, dst = src[order], dst[order]
    w = edge_weights_np(sc, graph, src, dst)
    E = src.shape[0]
    u, v, valid, wu, wv = pad_blocks(src, dst, w, block, dev)
    coef = stream_coefficients(ce, cv, eps, num_parts=num_parts, num_edges=E,
                               num_vertices=graph.num_vertices, device=dev)
    return EdgeStream(u=u, v=v, valid=valid, wu=wu, wv=wv, coef=coef, num_edges=E, order=order,
                      balance=sc.balance, block=block)


def _partition(graph: Graph, num_parts: int, sc: EdgeScorer, *, window: bool, **kw
               ) -> PartitionResult:
    """The blocked driver behind both entry points: one stream launch
    updates the bitset and counters in place, block after block."""
    st = prepare_stream(graph, num_parts, sc, **kw)
    keep, e_count, v_count = st.new_state(num_parts, graph.num_vertices)
    parts = _ebg.ebg_commit_stream(
        keep, e_count, v_count, st.u, st.v, st.valid, st.coef, block=st.block,
        balance=st.balance, window=window, wu=st.wu, wv=st.wv,
    )
    return PartitionResult(
        part=parts[:st.num_edges], num_parts=num_parts,
        order=None if st.order is None else torch.from_numpy(st.order),
    )


def streaming_scan_partition(
    graph: Graph,
    num_parts: int,
    scorer: Union[str, EdgeScorer],
    *,
    ce: Optional[float] = None,
    cv: Optional[float] = None,
    eps: Optional[float] = None,
    order: Optional[np.ndarray] = None,
    sort_edges: Optional[bool] = None,
    device=None,
) -> PartitionResult:
    """Faithful sequential stream for any registered scorer, run as the
    blocked driver with window commit (bit-identical to one edge at a time)."""
    return _partition(graph, num_parts, get_scorer(scorer), ce=ce, cv=cv, eps=eps,
                      block=SCAN_BLOCK, order=order, sort_edges=sort_edges, window=True,
                      device=device)


def streaming_chunked_partition(
    graph: Graph,
    num_parts: int,
    scorer: Union[str, EdgeScorer],
    *,
    ce: Optional[float] = None,
    cv: Optional[float] = None,
    eps: Optional[float] = None,
    block: int = 256,
    sort_edges: Optional[bool] = None,
    commit: str = "frozen",
    device=None,
) -> PartitionResult:
    """Blocked throughput variant of the stream (block=1 ≡ faithful) for any
    registered scorer. commit="frozen" scores every edge of a block against
    block-start membership; commit="window" is bit-identical to the scan at
    every block size."""
    check_commit_mode(commit)
    if not isinstance(block, int) or block < 1:
        raise ValueError(f"block must be a positive int, got {block!r}")
    return _partition(graph, num_parts, get_scorer(scorer), ce=ce, cv=cv, eps=eps, block=block,
                      sort_edges=sort_edges, window=commit == "window", device=device)


# ----------------------------------------------- stock scorer partitioners


@register_partitioner("ebg", config=EBGConfig, scorer="ebv",
                      description="Faithful EBG scan (paper Algorithm 1 + degree-sum order)")
def ebg_partition(graph: Graph, num_parts: int, *, alpha: float = 1.0, beta: float = 1.0,
                  order: Optional[np.ndarray] = None, sort_edges: bool = True,
                  device=None) -> PartitionResult:
    """Faithful EBG (Algorithm 1 + §IV-C degree-sum ordering)."""
    return streaming_scan_partition(graph, num_parts, EBV, ce=alpha, cv=beta, order=order,
                                    sort_edges=sort_edges, device=device)


@register_partitioner("ebg_chunked", config=EBGConfig, chunked=True, scorer="ebv",
                      benchmark_default=False,
                      description="Blocked EBG throughput variant (block=1 ≡ faithful)")
def ebg_partition_chunked(graph: Graph, num_parts: int, *, alpha: float = 1.0, beta: float = 1.0,
                          block: int = 256, sort_edges: bool = True, commit: str = "frozen",
                          device=None) -> PartitionResult:
    """Blocked EBG (block=1 ≡ faithful, commit="window" ≡ faithful at any block)."""
    return streaming_chunked_partition(graph, num_parts, EBV, ce=alpha, cv=beta, block=block,
                                       sort_edges=sort_edges, commit=commit, device=device)


@register_partitioner("hdrf", config=HDRFConfig, chunked=True, scorer="hdrf",
                      description="HDRF [Petroni'15] on the streaming scorer core")
def hdrf_partition(graph: Graph, num_parts: int, *, lam: float = 1.0, eps: float = 1.0,
                   block: int = 256, sort_edges: bool = False, commit: str = "frozen",
                   device=None) -> PartitionResult:
    """HDRF: highest-degree-replicated-first (paper baseline)."""
    return streaming_chunked_partition(graph, num_parts, HDRF, ce=lam, eps=eps, block=block,
                                       sort_edges=sort_edges, commit=commit, device=device)


@register_partitioner("greedy", config=GreedyConfig, chunked=True, scorer="greedy",
                      description="PowerGraph Greedy [Gonzalez'12] on the streaming scorer core")
def greedy_partition(graph: Graph, num_parts: int, *, eps: float = 1.0, block: int = 256,
                     sort_edges: bool = False, commit: str = "frozen",
                     device=None) -> PartitionResult:
    """PowerGraph Greedy: A(u)∩A(v) heuristic (paper baseline)."""
    return streaming_chunked_partition(graph, num_parts, GREEDY, eps=eps, block=block,
                                       sort_edges=sort_edges, commit=commit, device=device)
