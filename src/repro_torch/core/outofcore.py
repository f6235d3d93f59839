"""Out-of-core streaming partition driver over an `EdgeShardStore` (port of
`repro.core.outofcore`).

Feeds sharded edge files through the SAME commit kernel as the in-memory
driver (`repro_torch.core.streaming`): the partition state — the packed
p×⌈V/32⌉ membership bitset and the edge/vertex counters — lives on the
pipeline's device for the whole stream, and the blocks stream from disk
through `kernels.ebg_commit.ebg_commit_stream` (the CUDA kernel on the
card, its plain version on the CPU), many whole blocks a call. The
stream's contract makes that equal to `ebg_commit_block` applied block
after block, so `out_of_core ≡ in_memory` assignments are bit-identical
whenever the edge stream order matches — and it does:
`edgeshards.degree_sum_stream` reproduces the §IV-C in-memory permutation
exactly.

The port has no `compute_backend` (its local stages run one kernel): its
state is the reference's bitset layout (`compute_backend="ref"` /
`"pallas"`), and its assignments are the reference's
`partition_store(compute_backend="ref")`.

State layouts:
  state_layout="replicated"  one device holds the whole membership bitset;
                             one `ebg_commit_stream` launch a group of
                             whole blocks.
  state_layout="sharded"     the bitset's rows sharded over the ranks of a
                             `torch.distributed` mesh (p/w rows a rank; the
                             counters replicated). A block's distinct
                             endpoints are renumbered 0..k-1, each rank
                             packs its rows' bits at them, one all_gather
                             makes the block-local bitset [p, ⌈k/32⌉], and
                             every rank runs the same `ebg_commit_block` on
                             it and ORs the bits it added into its own rows:
                             one launch and one all_gather a block. The
                             commit reads only the bits of u and v (its
                             `inv_v` comes from V, not the bitset's width),
                             so the assignments and counters are the
                             replicated layout's, bit for bit.

Memory: O(p·V/32 + block) on the device for the state and a group of
blocks (O(p·V/(32·w) + p·block) a rank, sharded); the edge list itself
never materializes (blocks stream from disk; the per-edge assignment,
int32, is the only O(E) array kept).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.config import check_commit_mode
from repro_torch.core.streaming import (
    EdgeScorer,
    degree_weights_np,
    get_scorer,
    pad_blocks,
    stream_coefficients,
    validate_edge_stream,
)
from repro_torch.core.types import PartitionResult
from repro_torch.data.edgeshards import (
    EdgeShardStore,
    OrderedEdgeStream,
    degree_sum_stream,
    degrees_from_shards,
)
from repro_torch.kernels import ebg_commit as _ebg
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import axes_group, make_host_mesh, mesh_size

STATE_LAYOUTS = ("replicated", "sharded")

# Edges a commit call takes (whole blocks): one call's host work (argument
# checks, the id check's sync, the bitset transposes on the card) is paid
# once a group, not once a block.
GROUP_EDGES = 1 << 20


def check_state_layout(layout) -> str:
    if layout not in STATE_LAYOUTS:
        raise ValueError(f"state_layout must be one of {STATE_LAYOUTS}, got {layout!r}")
    return layout


@dataclasses.dataclass(frozen=True)
class OutOfCoreResult:
    """Out-of-core partition output. `result.part` (on the pipeline's
    device) is aligned with the streamed (possibly degree-sum-ordered) edge
    order; `result.order` carries the original store positions, so
    `part_in_input_order()` recovers store alignment. `edge_part_stream`
    re-streams (src, dst, part) blocks in partition order — what the
    streamed builder (`repro_torch.graph.build_stream`) consumes."""

    result: PartitionResult
    e_count: np.ndarray  # [p] f32 committed edge counts
    v_count: np.ndarray  # [p] f32 committed new-vertex counts (|V(i)| under window commit)
    covered: int  # vertices with degree > 0
    num_blocks: int
    edge_part_stream: Callable[[int], Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]]

    @property
    def replication_factor(self) -> float:
        """Paper RF: total vertex replicas over covered vertices, from the
        commit counters alone (no part array scan). Exact under window
        commit (and at block 1); under frozen commit a vertex new to a part
        counts once for each edge of a block that brings it there, so the
        counters over-count |V(i)| (the reference's counters, the same)."""
        return float(self.v_count.sum() / max(self.covered, 1))


@dataclasses.dataclass
class _ShardedRows:
    """This rank's rows of the membership bitset under state_layout=
    "sharded", and the mesh group the blocks' bits are gathered over."""

    group: object
    w: int
    rows: slice  # this rank's parts
    keep: torch.Tensor  # [p/w, ⌈V/32⌉] int32
    bit_values: torch.Tensor  # [32] int32: the word of each single bit

    @classmethod
    def over(cls, mesh, p: int, V: int, dev: torch.device) -> "_ShardedRows":
        w = mesh_size(mesh)
        if p % w != 0:
            raise ValueError(f"num_parts={p} must divide evenly over {w} mesh devices")
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type} but the partition state on "
                             f"{dev}")
        group, rank, _ = axes_group(mesh, tuple(mesh.mesh_dim_names))
        pl = p // w
        keep = torch.zeros((pl, (V + 31) // 32), dtype=torch.int32, device=dev)
        bits = torch.tensor([_ebg._bit(b) for b in range(32)], dtype=torch.int32, device=dev)
        return cls(group, w, slice(rank * pl, (rank + 1) * pl), keep, bits)

    def commit_block(self, e_count, v_count, u, v, valid, coef, *, balance, window, wu, wv):
        """One block: (new e_count, new v_count, parts [block])."""
        B = u.shape[0]
        ids, local_ids = torch.unique(torch.cat([u, v]), sorted=True, return_inverse=True)
        ids = ids.long()
        word = self.keep[:, ids >> 5]
        mine = _ebg.pack_keep_bits(((word >> (ids & 31).to(torch.int32)) & 1).bool())
        gathered = [torch.empty_like(mine) for _ in range(self.w)]
        dist.all_gather(gathered, mine, group=self.group)
        local_ids = local_ids.to(torch.int32)
        kb, e_count, v_count, parts = _ebg.ebg_commit_block(
            torch.cat(gathered), e_count, v_count, local_ids[:B], local_ids[B:], valid, coef,
            balance=balance, window=window, wu=wu, wv=wv,
        )
        # The bits the commit added to this rank's rows, at distinct ids:
        # no two of them are one bit, and none was set, so adding them
        # into their words is their OR.
        added = _ebg._unpack(kb[self.rows] & ~mine)[:, : ids.shape[0]]
        self.keep.index_add_(1, ids >> 5, added.to(torch.int32) * self.bit_values[ids & 31])
        return e_count, v_count, parts


def partition_store(
    store: EdgeShardStore,
    num_parts: int,
    scorer: Union[str, EdgeScorer] = "ebv",
    *,
    ce: Optional[float] = None,
    cv: Optional[float] = None,
    eps: Optional[float] = None,
    block: int = 4096,
    sort_edges: Optional[bool] = None,
    commit: str = "frozen",
    state_layout: str = "replicated",
    mesh=None,
    degrees: Optional[np.ndarray] = None,
    ordered: Optional[OrderedEdgeStream] = None,
    order_workdir=None,
    validate: bool = True,
    device=None,
) -> OutOfCoreResult:
    """Partition a sharded on-disk edge store without materializing its
    edge list: blocks stream from disk through the commit kernel against
    the partition state on `device` (the CUDA card unless the caller asks
    for the CPU) — the arithmetic of `streaming_chunked_partition`, so the
    result on any graph is bit-identical to the in-memory driver given the
    same stream order, and the external degree-sum sort emits exactly the
    in-memory §IV-C order.

    `commit` is the chunked commit mode ("window" makes any block size
    bit-identical to the one-edge scan). Pass precomputed `degrees` / an
    `ordered` stream to reuse external passes.

    `state_layout="sharded"` shards the bitset's rows over the ranks of
    `mesh` (default `launch.mesh.make_host_mesh()`; its device type must be
    `device`'s) and is called on every rank; num_parts must divide evenly
    over the mesh. It commits one block a launch, with one all_gather a
    block (see the module docstring), to the replicated layout's result.
    """
    check_commit_mode(commit)
    check_state_layout(state_layout)
    dev = resolve_device(device)
    sc = get_scorer(scorer)
    ce, cv, eps = sc.coefficients(ce, cv, eps)
    if sort_edges is None:
        sort_edges = sc.sort_edges
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    p = int(num_parts)
    V = store.num_vertices
    E = store.num_edges
    if V > np.iinfo(np.int32).max:
        raise ValueError(
            f"streaming state addresses vertices in int32: num_vertices={V} >= 2^31"
        )
    if degrees is None and (sort_edges or sc.weighted):
        degrees = degrees_from_shards(store)
    deg32 = degrees.astype(np.float32) if sc.weighted else None

    if sort_edges:
        if ordered is None:
            ordered = degree_sum_stream(store, degrees, workdir=order_workdir)
        block_iter = ordered.iter_blocks
    else:
        block_iter = store.iter_blocks

    if state_layout == "sharded":
        sharded = _ShardedRows.over(make_host_mesh() if mesh is None else mesh, p, V, dev)
        group = block
    else:
        sharded = None
        keep = torch.zeros((p, (V + 31) // 32), dtype=torch.int32, device=dev)
        group = block * max(1, GROUP_EDGES // block)
    e_count = torch.zeros((p,), dtype=torch.float32, device=dev)
    v_count = torch.zeros((p,), dtype=torch.float32, device=dev)
    coef = stream_coefficients(ce, cv, eps, num_parts=p, num_edges=E, num_vertices=V,
                               device=dev)
    window = commit == "window"
    parts_out: list[torch.Tensor] = []
    order_out: list[np.ndarray] = []
    num_blocks = 0

    # A group of whole blocks (one block, sharded) is the ordered stream cut
    # at a multiple of `block`, so its blocks are the stream's blocks; only
    # the last group's last block may be short, padded with masked edges as
    # the reference pads each block.
    for gsrc, gdst, gidx in block_iter(group):
        n = gsrc.shape[0]
        if validate:
            validate_edge_stream(gsrc, gdst, num_vertices=V)
        w = degree_weights_np(deg32, gsrc, gdst) if sc.weighted else None
        u, v, valid, wu, wv = pad_blocks(gsrc, gdst, w, block, dev)
        if sharded is not None:
            e_count, v_count, parts = sharded.commit_block(
                e_count, v_count, u, v, valid, coef, balance=sc.balance, window=window,
                wu=wu, wv=wv,
            )
        else:
            parts = _ebg.ebg_commit_stream(
                keep, e_count, v_count, u, v, valid, coef, block=block, balance=sc.balance,
                window=window, wu=wu, wv=wv,
            )
        parts_out.append(parts[:n])
        order_out.append(np.asarray(gidx, np.int64))
        num_blocks += -(-n // block)

    part = torch.cat(parts_out) if parts_out else torch.zeros(0, dtype=torch.int32, device=dev)
    part_np = part.cpu().numpy()
    order_np = np.concatenate(order_out) if order_out else np.zeros(0, np.int64)
    e_np, v_np = e_count.cpu().numpy(), v_count.cpu().numpy()
    # The reference's count: degree > 0, or, with no degrees, the distinct
    # sources of the stream.
    covered = int((degrees > 0).sum()) if degrees is not None else int(
        np.unique(np.concatenate([s for s, _ in store.iter_shards()] or [np.zeros(0)])).size
    )
    result = PartitionResult(
        part=part, num_parts=p, order=torch.from_numpy(order_np) if sort_edges else None
    )

    def edge_part_stream(b: int) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        off = 0
        for s, d, _ in block_iter(b):
            yield s, d, part_np[off: off + s.shape[0]].astype(np.int64)
            off += s.shape[0]

    return OutOfCoreResult(
        result=result,
        e_count=e_np,
        v_count=v_np,
        covered=covered,
        num_blocks=num_blocks,
        edge_part_stream=edge_part_stream,
    )
