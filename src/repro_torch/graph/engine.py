"""Subgraph-centric bulk-synchronous-parallel engine (paper §IV-B; port of
`repro.graph.engine`).

One subgraph == one worker. A superstep is
  1. compute:   local work over the subgraph's own edges — a min-plus
                fixpoint relaxation iterated to local convergence
                (min/max-semiring programs) or one push-sum sweep
                (PageRank), both through the `bsp_superstep` kernel;
  2. exchange:  mirror→master reduction then master→mirror broadcast over
                fixed padded tables (in simulation all p workers live on one
                device as an axis, so the exchange is a transpose);
  3. barrier:   the end of the step.

Every algorithm is a `VertexProgram`; ONE generic superstep body runs any
of them over a batch of B queries, values [B, p, max_v+1] (a single run is
B = 1; the kernel runs the B·p value rows on the p shared edge streams).
CC, SSSP, PageRank, BFS and max-label reachability are the stock
instances in `PROGRAMS`.

Two single-query drivers (`DRIVERS`), bit for bit equal in values and
every `BSPStats` field:
  - "fused" (the default): the value carry, the step counters, the
    per-step [max_supersteps + 1, B, p] message and iteration buffers and
    the convergence flags stay on the device; a chunk of K = `FUSED_CHUNK`
    supersteps (raised to a multiple of the exchange period, so each
    step's exchange is static) runs masked — a finished query keeps its
    values, counts no step and writes its stats into the spare last row —
    and the host reads the stop flag once a chunk. On the card the chunk
    is one CUDA graph, captured after one eager chunk and cached per
    (SubgraphSet, exec program, knobs, batch): a warm run captures
    nothing. On the CPU the same chunk runs eagerly.
  - "host": one superstep per Python iteration and one host sync per
    superstep for the convergence flag.
The batched driver (`run_bsp_batch`, `BatchExecutable`) is the fused loop
over B queries with per-query masking, so each query's stats are its own
run's. The distributed stepper (`make_distributed_stepper`) runs the same
superstep with the p subgraphs sharded over the ranks of a
`torch.distributed` device mesh and the exchange an all_to_all across
them. `DISPATCH_COUNTS` counts runs ("fused", "batch") and host
supersteps ("host", "dist"); `HOST_SYNCS` counts the host syncs of each.

Messages are counted with delta semantics for semiring programs (a
mirror/master "sends" only if its value changed since the last exchange —
the paper's Tables IV/V metric) and every-step semantics for PageRank.

The local stage always runs on the kernel: a CPU `SubgraphSet` runs its
plain PyTorch version, a CUDA one the CUDA kernel. The kernel computes in
f32, so int32 programs (CC/BFS/REACH) run on an f32 view of their values
(exact below 2^24, enforced at the run boundary), and max-combine programs
run as min over negated values. Both remaps are made once per run.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.metrics import max_mean_ratio
from repro_torch.graph.build import SubgraphSet, check_addressing
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.bsp_superstep import check_flag
from repro_torch.launch.mesh import axes_group, mesh_device

INF_F32 = 3.0e38  # the f32 "unreached" value (the kernels' min identity)
INF_I32 = 2**31 - 1  # the int32 "unreached" value

# The single-query drivers: "fused" keeps the loop's state on the device
# and runs chunks of supersteps (a CUDA graph on the card); "host" runs one
# superstep per Python iteration (the readable reference of the loop).
DRIVERS = ("fused", "host")

# Runs by driver: "fused" and "batch" add 1 a run, "host" and "dist" (the
# distributed stepper) 1 a superstep.
DISPATCH_COUNTS: collections.Counter = collections.Counter()
# Host syncs by driver ("fused", "host", "batch", "dist"): flag reads and
# the stats' read at the end of a run.
HOST_SYNCS: collections.Counter = collections.Counter()
# Fused loops built ("loops") and CUDA graphs captured ("graphs"); a warm
# run adds to neither.
CAPTURES: collections.Counter = collections.Counter()

# Supersteps a fused chunk runs between two reads of the stop flag, raised
# to a multiple of the exchange period. A run makes ceil(steps / K) flag
# reads; once converged, the rest of its last chunk is masked steps, each
# a kernel launch that runs no pass and one exchange's tensor ops. On an
# H100 a masked step costs ~1.1 ms at chip_smoke.py's full width and a flag
# read ~0.03 ms (PERF.md §6), so K is short.
FUSED_CHUNK = 2


def check_driver(driver) -> str:
    if driver not in DRIVERS:
        raise ValueError(f"driver must be one of {DRIVERS}, got {driver!r}")
    return driver


@dataclasses.dataclass
class BSPStats:
    supersteps: int
    messages_per_worker: np.ndarray  # [p] total messages sent by each worker
    messages_per_step: np.ndarray  # [steps]
    comp_work_per_worker: np.ndarray  # [p] edge-relaxation work proxy
    inner_iters_per_step: np.ndarray  # [steps, p]
    messages_per_step_worker: np.ndarray  # [steps, p]; the two above are its marginals

    @property
    def total_messages(self) -> int:
        return int(self.messages_per_worker.sum())

    @property
    def max_mean(self) -> float:
        """Paper Table-V max/mean message balance."""
        return max_mean_ratio(self.messages_per_worker)


# ----------------------------------------------------------- VertexProgram


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Everything that varies between BSP algorithms, in one value.

    | field | meaning |
    |---|---|
    | dtype       | value dtype: "int32" or "float32" |
    | combine     | exchange reduction & local semiring: "min" | "max" | "sum" |
    | local       | "fixpoint" (relax to local convergence) or "sweep" (one out-degree-normalized push-sum pass) |
    | weight      | what the semiring adds along an edge: "none", "edge" (the f32 edge weight) or "unit" (+1) |
    | bidirectional | relax both edge directions (undirected algorithms) |
    | apply       | master-side post-combine step: "none" or "pagerank" (damping + renormalize) |
    | message_policy | "delta" (count only changed values) or "always" |
    | convergence | "no_change" (fixpoint reached) or "tol" (L1 step delta below `tol`) |
    | damping     | apply="pagerank" damping factor |
    | init_fn     | (sub, *, num_vertices, source) -> [p, max_v+1] initial values |
    | needs_source | the facade resolves a default source vertex (SSSP/BFS) |
    | default_steps | driver step budget when the caller passes none |
    """

    name: str
    dtype: str
    combine: str = "min"
    local: str = "fixpoint"
    weight: str = "none"
    bidirectional: bool = False
    apply: str = "none"
    message_policy: str = "delta"
    convergence: str = "no_change"
    damping: float = 0.85
    init_fn: Optional[Callable] = None
    needs_source: bool = False
    default_steps: Optional[int] = None
    aliases: tuple = ()

    def __post_init__(self):
        checks = (
            ("dtype", self.dtype, ("int32", "float32")),
            ("combine", self.combine, ("min", "max", "sum")),
            ("local", self.local, ("fixpoint", "sweep")),
            ("weight", self.weight, ("none", "edge", "unit")),
            ("apply", self.apply, ("none", "pagerank")),
            ("message_policy", self.message_policy, ("delta", "always")),
            ("convergence", self.convergence, ("no_change", "tol")),
        )
        for field, got, allowed in checks:
            if got not in allowed:
                raise ValueError(f"VertexProgram.{field} must be one of {allowed}, got {got!r}")
        if self.combine == "sum" and self.local != "sweep":
            raise ValueError("combine='sum' has no fixpoint semantics; use local='sweep'")
        if self.apply == "pagerank" and self.combine != "sum":
            raise ValueError("apply='pagerank' renormalizes summed partials; use combine='sum'")

    @property
    def inf(self):
        """Largest representable "unreached" value of the program's dtype."""
        return INF_I32 if self.dtype == "int32" else INF_F32

    @property
    def identity(self):
        """Identity of the exchange combine (fills masked recv slots)."""
        if self.combine == "sum":
            return 0.0
        return -self.inf if self.combine == "max" else self.inf

    def init(self, sub: SubgraphSet, *, num_vertices: int = 0, source=None) -> torch.Tensor:
        if self.init_fn is None:
            raise ValueError(
                f"program {self.name!r} has no init_fn — pass init_val explicitly to run_bsp"
            )
        if self.needs_source and source is None:
            raise ValueError(
                f"program {self.name!r} is source-rooted: pass source= "
                "(GraphPipeline defaults it to the highest-degree covered vertex)"
            )
        return self.init_fn(sub, num_vertices=num_vertices, source=source)


def _exec_view(prog: VertexProgram) -> tuple[VertexProgram, bool]:
    """The program actually executed: max-combine programs run as min over
    negated values, and int32 programs on an f32 view of their values (the
    kernels compute in f32). Returns (program, negate?)."""
    negate = prog.combine == "max"
    changes = dict(combine="min") if negate else {}
    if prog.dtype == "int32":
        changes["dtype"] = "float32"
    return (dataclasses.replace(prog, **changes) if changes else prog), negate


# --------------------------------------------------------- program registry

PROGRAMS: dict[str, VertexProgram] = {}


def register_program(prog: VertexProgram) -> VertexProgram:
    """Register a program under its name and aliases (lowercased); all keys
    are validated before any is inserted."""
    keys = tuple(k.lower() for k in (prog.name, *prog.aliases))
    for key in keys:
        if key in PROGRAMS:
            raise ValueError(f"program name {key!r} already registered")
    for key in keys:
        PROGRAMS[key] = prog
    return prog


def get_program(program) -> VertexProgram:
    """Resolve a program handle (VertexProgram instance or registered name)."""
    if isinstance(program, VertexProgram):
        return program
    key = str(program).lower()
    if key not in PROGRAMS:
        names = sorted({p.name for p in PROGRAMS.values()})
        raise ValueError(f"unknown program {program!r}; registered programs: {names}")
    return PROGRAMS[key]


def program_names() -> tuple:
    """Primary (alias-free) names of all registered programs."""
    return tuple(sorted({p.name for p in PROGRAMS.values()}))


# ------------------------------------------------------------- init values


def check_source(sub: SubgraphSet, source, num_vertices: int = 0) -> int:
    """Validate a query source vertex id and return it as a Python int: it
    must lie in [0, num_vertices) when the caller knows the vertex count,
    else in [0, max covered gid]."""
    if source is None:
        raise ValueError("source must be a vertex id, got None")
    s = int(source)
    hi = int(num_vertices) if num_vertices > 0 else int(sub.gid.max()) + 1
    if not 0 <= s < hi:
        raise ValueError(f"source={s} is out of range: valid vertex ids are [0, {hi})")
    return s


def _with_dump(val: torch.Tensor, fill) -> torch.Tensor:
    """Append the dump slot (index max_v of the last axis) holding `fill`."""
    dump = torch.full((*val.shape[:-1], 1), fill, dtype=val.dtype, device=val.device)
    return torch.cat([val, dump], dim=-1)


def init_cc(sub: SubgraphSet, *, num_vertices: int = 0, source=None) -> torch.Tensor:
    val = torch.where(sub.vmask, sub.gid, INF_I32)
    return _with_dump(val, INF_I32)


def init_sssp(sub: SubgraphSet, source: int, *, num_vertices: int = 0) -> torch.Tensor:
    source = check_source(sub, source, num_vertices)
    val = torch.where(sub.gid == source, 0.0, INF_F32).to(torch.float32)
    return _with_dump(val, INF_F32)


def init_pr(sub: SubgraphSet, num_vertices: int, *, source=None) -> torch.Tensor:
    # Every present vertex replica holds the global initial rank 1/N.
    val = torch.where(sub.vmask, 1.0 / num_vertices, 0.0).to(torch.float32)
    return _with_dump(val, 0.0)


def init_bfs(sub: SubgraphSet, source: int, *, num_vertices: int = 0) -> torch.Tensor:
    source = check_source(sub, source, num_vertices)
    val = torch.where(sub.gid == source, 0, INF_I32).to(torch.int32)
    return _with_dump(val, INF_I32)


def init_reach(sub: SubgraphSet, *, num_vertices: int = 0, source=None) -> torch.Tensor:
    # Max-label propagation: absent slots hold the max identity (-INF).
    val = torch.where(sub.vmask, sub.gid, -INF_I32)
    return _with_dump(val, -INF_I32)


# ---------------------------------------------------------- stock programs

CC = register_program(VertexProgram(
    name="cc", dtype="int32", combine="min", bidirectional=True,
    init_fn=lambda sub, *, num_vertices=0, source=None: init_cc(sub),
    aliases=("components", "connected_components"),
))

SSSP = register_program(VertexProgram(
    name="sssp", dtype="float32", combine="min", weight="edge",
    init_fn=lambda sub, *, num_vertices=0, source=None: init_sssp(
        sub, source, num_vertices=num_vertices
    ),
    needs_source=True,
))

PR = register_program(VertexProgram(
    name="pr", dtype="float32", combine="sum", local="sweep", apply="pagerank",
    message_policy="always", convergence="tol",
    init_fn=lambda sub, *, num_vertices=0, source=None: init_pr(sub, num_vertices),
    default_steps=20,  # the classic fixed-iteration power-method budget
    aliases=("pagerank",),
))

BFS = register_program(VertexProgram(
    name="bfs", dtype="int32", combine="min", weight="unit",
    init_fn=lambda sub, *, num_vertices=0, source=None: init_bfs(
        sub, source, num_vertices=num_vertices
    ),
    needs_source=True,
))

REACH = register_program(VertexProgram(
    name="reach", dtype="int32", combine="max", bidirectional=True,
    init_fn=lambda sub, *, num_vertices=0, source=None: init_reach(sub),
    aliases=("reachability",),
))


# ---------------------------------------------------------------- helpers


def _gather_rows(val: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """val: [B, p, max_v+1]; idx: [p, p*m] int64 →
    out[b, i, j, m] = val[b, i, idx[i, j*m]] (the index expanded, not copied)."""
    B = val.shape[0]
    return torch.gather(val, 2, idx.expand(B, *idx.shape)).reshape(B, *shape)


def _scatter(val: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor, reduce: str) -> torch.Tensor:
    """out[b, j, idx[j, i*m]] combined with upd[b, j, i, m] ("amin" | "sum" |
    "set"); idx: [rows, p*m] int64 (expanded over the batch, not copied),
    upd: [B, rows, p, m] (rows = p, or a rank's shard of them). "sum" adds
    one sender i at a time, in sender order: within a sender a destination
    occurs once (pads hit the dump slot with 0), so no two adds race and
    the f32 sums are the same on every run and every device (a single
    scatter-add on the card adds in the atomics' order)."""
    B = val.shape[0]
    if reduce == "sum":
        senders = upd.shape[2]  # all p senders; the rows may be a rank's shard
        idx = idx.reshape(idx.shape[0], senders, -1)
        out = val.clone()
        for i in range(senders):
            out.scatter_add_(2, idx[:, i].expand(B, *idx[:, i].shape), upd[:, :, i])
        return out
    idx = idx.expand(B, *idx.shape)
    upd = upd.reshape(idx.shape)
    if reduce == "set":
        return val.scatter(2, idx, upd)
    return val.scatter_reduce(2, idx, upd, reduce, include_self=True)


# -------------------------------------------------- local compute (stage 1)


def _edge_addend(prog: VertexProgram, weight: torch.Tensor) -> Optional[torch.Tensor]:
    """What the semiring adds along an edge (f32), or None for weight='none'."""
    if prog.weight == "edge":
        return weight.to(torch.float32)
    if prog.weight == "unit":
        return torch.ones_like(weight, dtype=torch.float32)
    return None


def _relax_stream(prog: VertexProgram, sub: SubgraphSet):
    """[p, E(+E)] (lsrc, ldst, weight) edge stream for the fixpoint kernel:
    the forward dst-sorted half and, for bidirectional programs, the
    reversed (src-sorted) half behind it. Weights are the semiring addend in
    f32 with padded edges carrying the INF identity."""

    def edge_w(weight, mask):
        w = _edge_addend(prog, weight)
        if w is None:
            w = torch.zeros_like(weight, dtype=torch.float32)
        return torch.where(mask, w, INF_F32)

    lsrc, ldst, w = sub.lsrc, sub.ldst, edge_w(sub.weight, sub.edge_mask)
    if prog.bidirectional:
        # Reverse direction: reduce into sources using the src-sorted copy.
        lsrc = torch.cat([lsrc, sub.ldst_s], dim=1)
        ldst = torch.cat([ldst, sub.lsrc_s], dim=1)
        w = torch.cat([w, edge_w(sub.weight_s, sub.edge_mask_s)], dim=1)
    return lsrc.contiguous(), ldst.contiguous(), w.contiguous()


@dataclasses.dataclass(frozen=True)
class _RunPlan:
    """The run-invariant inputs of a superstep over the set's rows (all p
    workers, or a rank's shard of them): the local stage's edge
    stream (padded to `block_e` at the dump slot) and, for sweeps, the
    out-degree with the dump slot's 1 appended; and the exchange tables as
    the int64 indices that gather/scatter take; and the device flag that
    the superstep launches OR their id guard's bits into, zeroed at the
    start of a run and read with the syncs the run makes anyway."""

    lsrc: torch.Tensor
    ldst: torch.Tensor
    weight: torch.Tensor
    out_degree: Optional[torch.Tensor]
    num_out: int
    block_e: int
    send_idx: torch.Tensor  # [rows, p*max_msg] int64
    recv_idx: torch.Tensor  # [rows, p*max_msg] int64
    bcast_idx: torch.Tensor  # [rows, p*max_msg] int64: send_idx, dump slot where unmasked
    err: torch.Tensor  # [1] int32


def _run_plan(prog: VertexProgram, sub: SubgraphSet, block_e: int) -> _RunPlan:
    num_out = sub.max_v + 1
    # The rows the set holds: num_parts, or fewer on a rank's shard (whose
    # tables are [rows, p, max_msg]).
    rows = sub.send_idx.shape[0]
    if prog.local == "fixpoint":
        lsrc, ldst, w = _relax_stream(prog, sub)
        outdeg = None
        identity = INF_F32
    else:
        # Pads carry weight 0: the sum identity and the kernel's pad mask.
        lsrc, ldst, w = sub.lsrc, sub.ldst, sub.edge_mask.to(torch.float32)
        ones = torch.ones((rows, 1), dtype=torch.float32, device=sub.device)
        outdeg = torch.cat([sub.out_degree, ones], dim=1)
        identity = 0.0
    lsrc, ldst, w = ops.pad_stream(lsrc, ldst, w, num_out=num_out, block_e=block_e,
                                   identity=identity)
    return _RunPlan(
        lsrc, ldst, w, outdeg, num_out, block_e,
        send_idx=sub.send_idx.reshape(rows, -1).long(),
        recv_idx=sub.recv_idx.reshape(rows, -1).long(),
        bcast_idx=torch.where(sub.msg_mask, sub.send_idx, sub.max_v).reshape(rows, -1).long(),
        err=torch.zeros((1,), dtype=torch.int32, device=lsrc.device),
    )


def _sub_cache(sub: SubgraphSet) -> dict:
    """Per-SubgraphSet cache of run plans and fused loops; it lives as long
    as the set (entries pin device memory: the streams and the loops'
    state)."""
    cache = sub.__dict__.get("_engine_cache")
    if cache is None:
        cache = {}
        object.__setattr__(sub, "_engine_cache", cache)
    return cache


def _plan_for(prog: VertexProgram, sub: SubgraphSet, block_e: int) -> _RunPlan:
    """The cached run plan of an exec program: programs with the same
    local stage and edge semiring (CC and REACH; SSSP and BFS differ in
    weights) share one stream."""
    key = ("plan", prog.local, prog.weight, prog.bidirectional, int(block_e))
    cache = _sub_cache(sub)
    if key not in cache:
        cache[key] = _run_plan(prog, sub, block_e)
    return cache[key]


def _local_fixpoint(plan: _RunPlan, val: torch.Tensor, inner_cap: int, live=None):
    """Batched local fixpoint on the f32 exec values [B, p, max_v+1] (last
    slot = dump): every relaxation pass and the per-worker convergence flag
    in one kernel launch over the B·p value rows, which share the p streams
    (its ids' flag left in plan.err); the rows of a query that is not
    `live` run no pass. Returns (values, per-worker inner iterations [B, p])."""
    B, p, n = val.shape
    new, iters = ops.bsp_superstep(
        plan.lsrc, plan.ldst, plan.weight, val.reshape(B * p, n), num_out=plan.num_out,
        combine="min", inner_cap=inner_cap, block_e=plan.block_e, err=plan.err, live=live,
    )
    return new.reshape(B, p, n), iters.reshape(B, p)


def _local_sweep(plan: _RunPlan, val: torch.Tensor) -> torch.Tensor:
    """One out-degree-normalized push-sum pass (PageRank's local compute):
    each vertex pushes val/outdeg along its out-edges, summed at dst."""
    B, p, n = val.shape
    new, _ = ops.bsp_superstep(
        plan.lsrc, plan.ldst, plan.weight, val.reshape(B * p, n), num_out=plan.num_out,
        combine="sum", out_degree=plan.out_degree, block_e=plan.block_e, err=plan.err,
    )
    return new.reshape(B, p, n)


# --------------------------------------------------- THE generic superstep


def _apply_step(prog: VertexProgram, sub: SubgraphSet, combined: torch.Tensor, num_vertices: int):
    """Master-side post-combine step. "none" passes the combined value
    through; "pagerank" turns summed partials into damped, renormalized
    ranks at masters (mirrors zeroed until the broadcast)."""
    if prog.apply == "none":
        return combined
    base = (1.0 - prog.damping) / num_vertices
    new = torch.where(sub.is_master, base + prog.damping * combined[..., : sub.max_v], 0.0)
    return _with_dump(new.to(torch.float32), 0.0)


def _sim_exchange(S: torch.Tensor) -> torch.Tensor:
    """[B, i, j, m] sender-rowed ↔ [B, j, i, m] receiver-rowed: all p
    workers on one device, so the exchange is a transpose."""
    return S.transpose(1, 2)


def _superstep(prog: VertexProgram, sub: SubgraphSet, plan: _RunPlan, val: torch.Tensor,
               inner_cap: int, do_exchange: bool = True, count_ref=None, num_vertices: int = 0,
               live=None, exchange=_sim_exchange):
    """ONE BSP superstep for ANY program (exec view: f32 values, combine
    "min" or "sum") over a batch of B queries: val [B, rows, max_v+1] (a
    single run is B = 1; rows = p, or a rank's shard of the workers).
    Returns (new_val, per-worker msg count [B, rows], per-worker inner
    iters [B, rows], each row's L1 delta [B, rows] or None; `l1_total`
    adds a query's rows).

    `exchange` maps [B, rows, p, m] tables rowed by the local workers to
    the same shape rowed by the local workers and columned by the other
    end: the transpose in simulation, an all_to_all across ranks in the
    distributed stepper; it serves both directions.

    Stages: local compute → mirror→master exchange + combine → apply →
    master→mirror broadcast. `count_ref` is the value snapshot of the LAST
    exchange — delta messages are counted against it (matters under bounded
    staleness). The L1 delta is only computed for convergence='tol'.
    `live` ([B] bool, the fused loop's mask) spares the fixpoint kernel the
    rows of finished queries: their outputs are then the inputs, and the
    caller discards them. The body holds no host sync, so a CUDA graph can
    capture it.
    """
    B, p, _ = val.shape
    start = val if count_ref is None else count_ref

    # 1. local compute. Sweep programs carry the per-vertex partial
    # aggregate (one sweep = one inner iteration of comp work per worker).
    if prog.local == "fixpoint":
        state, iters = _local_fixpoint(plan, val, inner_cap, live)
    else:
        state = _local_sweep(plan, val)
        iters = torch.ones((B, p), dtype=torch.int32, device=val.device)
    if not do_exchange:  # bounded-staleness local step
        return state, torch.zeros((B, p), dtype=torch.int32, device=val.device), iters, None

    # 2. mirror → master (forward): send current state of mirror slots.
    shape = sub.send_idx.shape
    S = _gather_rows(state, plan.send_idx, shape)  # [b, i, j, m]
    if prog.message_policy == "delta":
        ch_send = _gather_rows(state != start, plan.send_idx, shape)
        msgs_fwd = (ch_send & sub.msg_mask).sum(dim=(2, 3))
    else:
        msgs_fwd = sub.msg_mask.sum(dim=(1, 2)).expand(B, p)
    R = exchange(S)  # receiver-rowed [b, j, i, m]
    upd = torch.where(sub.recv_mask, R, prog.identity)
    combined = _scatter(state, plan.recv_idx, upd, "sum" if prog.combine == "sum" else "amin")

    # 3. apply at masters, then master → mirror (broadcast).
    new_val = _apply_step(prog, sub, combined, num_vertices)
    Bm = _gather_rows(new_val, plan.recv_idx, shape)  # [b, j, i, m] master values
    if prog.message_policy == "delta":
        ch_b = _gather_rows(new_val != start, plan.recv_idx, shape)
        msgs_bwd = (ch_b & sub.recv_mask).sum(dim=(2, 3))
    else:
        msgs_bwd = sub.recv_mask.sum(dim=(1, 2)).expand(B, p)
    Rb = exchange(Bm)  # sender-rowed view at mirrors: [b, i, j, m]
    out = _scatter(new_val, plan.bcast_idx, Rb, "set")

    delta = l1_rows(out, val, sub.max_v) if prog.convergence == "tol" else None
    return out, (msgs_fwd + msgs_bwd).to(torch.int32), iters, delta


def l1_rows(new: torch.Tensor, old: torch.Tensor, max_v: int) -> torch.Tensor:
    """Each subgraph's L1 step delta: [B, rows, n] values → [B, rows]."""
    return (new[..., :max_v] - old[..., :max_v]).abs().sum(dim=2)


def l1_total(rows: torch.Tensor) -> torch.Tensor:
    """[B, p] per-subgraph deltas → [B], added in one fixed order whatever
    the driver or the world: a pairwise tree over the subgraphs in index
    order, the rows padded with zeros to a power of two (a delta is >= 0,
    so a zero adds nothing). The simulation and the distributed stepper
    (after an all_gather of the ranks' rows) both stop on this sum, so they
    stop at the same superstep even at a `tol` equal to a delta."""
    p = rows.shape[1]
    width = 1 << max(p - 1, 0).bit_length()
    if width > p:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], width - p))], dim=1)
    while rows.shape[1] > 1:
        rows = rows[:, 0::2] + rows[:, 1::2]
    return rows[:, 0]


# ----------------------------------------- the kernels' 2^24 value boundary


def check_int32_kernel_gid(prog: VertexProgram, gid: torch.Tensor) -> None:
    """FLAT-addressing guard: the kernels run int32 programs in f32, exact
    only for magnitudes below 2^24; under flat addressing the kernel label
    domain IS the global id space, so max(gid) bounds every finite value."""
    if prog.dtype == "int32":
        max_label = int(gid.max())
        if max_label >= 1 << 24:
            raise ValueError(
                f"the kernels run int32 {prog.name} in f32, exact only for vertex ids "
                f"< 2^24; graph has id {max_label} — use addressing='two_level'"
            )


def check_int32_kernel_values(prog: VertexProgram, bound) -> None:
    """TWO-LEVEL-addressing guard at the kernel VALUE boundary: `bound` is
    the run's proven ceiling on every finite kernel value's magnitude."""
    if prog.dtype == "int32":
        bound = int(bound)
        if bound >= 1 << 24:
            raise ValueError(
                f"the kernels run int32 {prog.name} in f32, exact only for kernel values "
                f"< 2^24; this run's per-worker value bound is {bound}"
            )


def check_int32_kernel_labels(prog: VertexProgram, sub: SubgraphSet) -> None:
    """Addressing-aware guard: flat addressing checks the global ids here;
    two-level addressing defers to the value boundary in `run_bsp`."""
    check_addressing(sub.addressing)
    if sub.addressing == "flat":
        check_int32_kernel_gid(prog, sub.gid)


def _label_domain(prog: VertexProgram) -> bool:
    """True for programs whose finite values form a CLOSED label set
    (CC/REACH label propagation) — exactly those admit rank compression."""
    return (
        prog.dtype == "int32"
        and prog.weight == "none"
        and prog.apply == "none"
        and prog.local == "fixpoint"
        and prog.combine in ("min", "max")
    )


@dataclasses.dataclass(frozen=True)
class _ValueCodec:
    """Order-preserving bijection between a closed finite label set and
    dense int32 ranks [0, size), with the ±INF_I32 sentinels fixed. min/max,
    delta message counts and no-change convergence commute with a strictly
    monotone map, so a run over encoded values is step-for-step the raw run,
    while the kernels only see ranks far below 2^24."""

    table: torch.Tensor  # sorted distinct finite exec-domain values, int32

    @classmethod
    def from_values(cls, values: torch.Tensor) -> "_ValueCodec":
        finite = values.abs() != INF_I32
        return cls(table=torch.unique(values[finite]).to(torch.int32))

    @property
    def size(self) -> int:
        return int(self.table.shape[0])

    def encode(self, val: torch.Tensor) -> torch.Tensor:
        finite = val.abs() != INF_I32
        ranks = torch.searchsorted(self.table, val.contiguous()).to(torch.int32)
        return torch.where(finite, ranks, val)

    def decode(self, val: torch.Tensor) -> torch.Tensor:
        finite = val.abs() != INF_I32
        idx = val.clamp(0, max(self.size - 1, 0)).long()
        return torch.where(finite, self.table[idx] if self.size else val, val)


def _kernel_value_boundary(prog: VertexProgram, sub: SubgraphSet, val: torch.Tensor
                           ) -> tuple[torch.Tensor, Optional[_ValueCodec]]:
    """Two-level enforcement where values cross into the kernels (exec
    domain, after any max→min negation). Returns (kernel-ready values,
    codec-or-None); the driver decodes its output with the codec.

    label-domain programs → rank-compress (bound = codec size); unit-weight
    programs (BFS hops) → bound = current max + covered vertices; any other
    int32 program falls back to the global-id guard.
    """
    if prog.dtype != "int32" or sub.addressing == "flat":
        return val, None
    if _label_domain(prog):
        codec = _ValueCodec.from_values(val)
        check_int32_kernel_values(prog, max(codec.size - 1, 0))
        return codec.encode(val), codec
    if prog.weight == "unit":
        covered = int(sub.is_master.sum())
        mag = val.abs()
        finite = mag != INF_I32
        base = int(mag[finite].max()) if bool(finite.any()) else 0
        check_int32_kernel_values(prog, base + covered)
        return val, None
    check_int32_kernel_gid(prog, sub.gid)
    return val, None


def _to_f32(val: torch.Tensor) -> torch.Tensor:
    """int32 values → the kernels' f32 view (INF_I32 ↔ INF_F32)."""
    return torch.where(val == INF_I32, INF_F32, val.to(torch.float32))


def _to_i32(val: torch.Tensor) -> torch.Tensor:
    return torch.where(val >= INF_F32, INF_I32, val.to(torch.int32))


# ------------------------------------------------------------ entry points


def _assemble_stats(steps: int, msgs_sw: np.ndarray, iters_sw: np.ndarray,
                    edges: np.ndarray) -> BSPStats:
    return BSPStats(
        supersteps=steps,
        messages_per_worker=msgs_sw.sum(axis=0),
        messages_per_step=msgs_sw.sum(axis=1),
        comp_work_per_worker=(iters_sw * edges[None, :]).sum(axis=0),
        inner_iters_per_step=iters_sw,
        messages_per_step_worker=msgs_sw,
    )


def _to_exec(prog: VertexProgram, sub: SubgraphSet, val: torch.Tensor):
    """Values in the program's domain → the exec domain: (exec program, f32
    values, negate?, codec-or-None). The driver undoes each step on exit
    (`_from_exec`)."""
    # Max-combine runs as min over negated values; delta message counts and
    # no-change convergence are negation-invariant.
    exec_prog, negate = _exec_view(prog)
    val = -val if negate else val
    # Two-level runs rank-compress label-domain values so the kernels only
    # ever see ranks < 2^24; codec=None means values pass raw. A batch has
    # one codec, over the union of its queries' values.
    val, codec = _kernel_value_boundary(prog, sub, val)
    # The kernels compute in f32: int32 programs run on an f32 view of their
    # values for the whole run (the remap is a bijection on every value
    # that occurs, so values, counts and convergence are unchanged).
    if prog.dtype == "int32":
        val = _to_f32(val)
    return exec_prog, val.contiguous(), negate, codec


def _from_exec(prog: VertexProgram, val: torch.Tensor, negate: bool, codec) -> torch.Tensor:
    if prog.dtype == "int32":
        val = _to_i32(val)
    if codec is not None:
        val = codec.decode(val)
    return -val if negate else val


def _exec_values(prog: VertexProgram, sub: SubgraphSet, init_val, num_vertices, source):
    """The run's entry into the exec domain (`_to_exec` of its init)."""
    if init_val is None:
        init_val = prog.init(sub, num_vertices=num_vertices, source=source)
    return _to_exec(prog, sub, init_val.to(sub.device))


def kernel_inputs(sub: SubgraphSet, program, *, num_vertices: int = 0, source=None,
                  block_e: int = 512):
    """The local stage's kernel inputs at the start of a run of `program`:
    ((lsrc, ldst, weight, out_degree-or-None), f32 values, num_out) — what
    the first superstep hands `ops.bsp_superstep`. For holding the kernel
    against its plain version at the shapes a real run gives it. `source`
    may be a sequence of B sources: the values are then a batch's,
    [B·p, num_out], each query's p rows encoded on its own."""
    prog = get_program(program)
    sources = source if isinstance(source, (list, tuple)) else [source]
    vals = [_exec_values(prog, sub, None, num_vertices, s) for s in sources]
    exec_prog = vals[0][0]
    plan = _run_plan(exec_prog, sub, block_e)
    val = torch.cat([v[1] for v in vals])
    return (plan.lsrc, plan.ldst, plan.weight, plan.out_degree), val, plan.num_out


def check_pagerank_num_vertices(prog: VertexProgram, num_vertices: int) -> None:
    """pagerank-apply programs renormalize by the GLOBAL vertex count."""
    if prog.apply == "pagerank" and num_vertices <= 0:
        raise ValueError(
            f"program {prog.name!r} renormalizes by the global vertex count: "
            "pass num_vertices= (GraphPipeline supplies graph.num_vertices)"
        )


def _check_staleness(prog: VertexProgram, exchange_period: int) -> None:
    if exchange_period < 1:
        raise ValueError(f"exchange_period must be >= 1, got {exchange_period}")
    if exchange_period > 1 and (prog.local != "fixpoint" or prog.convergence != "no_change"):
        raise ValueError(
            f"exchange_period>1 (bounded staleness) needs a fixpoint/no-change program; "
            f"{prog.name!r} is local={prog.local!r}, convergence={prog.convergence!r}"
        )


# ------------------------------------------------- the fused loop on the card


def _chunk_length(exchange_period: int) -> int:
    """Supersteps a chunk: FUSED_CHUNK raised to a multiple of the exchange
    period, so that every step's exchange is static within the chunk."""
    return -(-FUSED_CHUNK // exchange_period) * exchange_period


_GRAPH_POOLS: dict = {}


def _graph_pool(device: torch.device):
    """The memory pool the fused loops' CUDA graphs share on `device`. A
    loop's graph holds no live allocation between replays (its state lives
    outside the pool), so graphs replayed in any order may share it."""
    pool = _GRAPH_POOLS.get(device)
    if pool is None:
        pool = _GRAPH_POOLS[device] = torch.cuda.graph_pool_handle()
    return pool


class _FusedLoop:
    """The fused driver's loop for B queries of one exec program over one
    SubgraphSet: the value carry, the step counters, the per-step
    [max_supersteps + 1, B, p] message and inner-iteration buffers (row
    max_supersteps takes the masked steps' writes) and the done flags live
    on the device, and a chunk of K masked supersteps advances them in
    place (`_chunk`). Masking is the reference's batched driver's: a query
    that is done, or has run max_supersteps, keeps its values, counts no
    step and writes no stats row, so each query's stats are its own run's;
    the fixpoint kernel runs no pass over its rows (a masked step costs the
    launch and the exchange's tensor ops).

    On the card the chunk is captured once into a CUDA graph (after one
    eager chunk has built and loaded every kernel at these shapes) and
    replayed; on the CPU the same chunk runs eagerly. The host reads the
    stop flag once a chunk, and the stats once a run."""

    def __init__(self, prog: VertexProgram, sub: SubgraphSet, plan: _RunPlan, batch: int, *,
                 max_supersteps: int, inner_cap: int, exchange_period: int, tol: float,
                 num_vertices: int):
        # The set holds its loops (`_sub_cache`); a weak reference back
        # keeps that from being a cycle, so a loop and its graph go when
        # the set goes, never in a garbage collection during a capture.
        self.prog, self._sub, self.plan = prog, weakref.ref(sub), plan
        self.max_supersteps, self.inner_cap = int(max_supersteps), int(inner_cap)
        self.period, self.tol, self.num_vertices = int(exchange_period), float(tol), num_vertices
        self.chunk_steps = _chunk_length(self.period)
        # A tol program with tol=0 runs all max_supersteps: nothing to read.
        self.can_stop = not (prog.convergence == "tol" and not self.tol)
        dev, p, n = sub.device, sub.num_parts, sub.max_v + 1
        B = int(batch)
        self.val = torch.zeros((B, p, n), dtype=torch.float32, device=dev)
        self.last_ex = self.val.clone() if self.period > 1 else None
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.steps_q = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.k = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        rows = self.max_supersteps + 1
        self.msgs = torch.zeros((rows, B, p), dtype=torch.int32, device=dev)
        self.iters = torch.zeros((rows, B, p), dtype=torch.int32, device=dev)
        self.edges = sub.edge_mask.sum(dim=1)
        self.graph = None
        self.replay_launches = collections.Counter()

    def _chunk(self) -> None:
        """K masked supersteps on the loop's state, in place; no host sync."""
        prog, mx, sub = self.prog, self.max_supersteps, self._sub()
        for i in range(self.chunk_steps):
            do_ex = (i % self.period) == self.period - 1
            live = ~self.done & (self.steps_q < mx)
            v2, msgs, iters, delta = _superstep(
                prog, sub, self.plan, self.val, self.inner_cap, do_ex, self.last_ex,
                self.num_vertices, live,
            )
            if prog.convergence == "tol":
                newly = (l1_total(delta) < self.tol) if self.tol else None
            elif do_ex:
                # Converged only when an exchange round changed nothing.
                newly = ~(v2 != self.val).flatten(1).any(dim=1)
            else:
                newly = None
            self.val.copy_(torch.where(live[:, None, None], v2, self.val))
            if self.last_ex is not None and do_ex:
                self.last_ex.copy_(self.val)
            any_live = live.any()
            row = torch.where(any_live, self.k, mx)
            self.msgs.index_copy_(0, row, torch.where(live[:, None], msgs, 0)[None])
            self.iters.index_copy_(0, row, torch.where(live[:, None], iters, 0)[None])
            self.k += any_live
            self.steps_q += live
            if newly is not None:
                self.done |= live & newly
        self.stop.copy_(~(~self.done & (self.steps_q < mx)).any())

    def _advance(self) -> None:
        if self.val.device.type != "cuda":
            self._chunk()
            return
        if self.graph is None:
            self._chunk()  # the eager chunk that builds and loads every kernel
            self.capture()
            return
        self.graph.replay()
        dispatch.add_launches(self.replay_launches)

    def capture(self) -> None:
        """Capture one chunk into a CUDA graph (the state is left as it
        is: a capture runs nothing). A capture that fails raises. The
        garbage collector is off meanwhile: a collection that destroyed
        another graph or freed device memory mid-capture would invalidate
        it."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=_graph_pool(self.val.device)):
                launches = dispatch.captured_launches(self._chunk)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        self.graph, self.replay_launches = graph, launches
        CAPTURES["graphs"] += 1

    def run(self, init: torch.Tensor, driver: str, queries: Optional[int] = None):
        """One run from exec-domain values `init` [B, p, n]; with `queries`,
        only the first `queries` rows are real and the padding rows behind
        them start done (no step, no pass: their values stay the init's).
        Returns (the final exec values, a copy; steps per query; msgs
        [S, B, p]; iters [S, B, p]; edges [p]; converged per query) with
        everything but the values on the host. The converged flags tell a
        run that reached its fixpoint on its last step from one that ran
        out of steps: the segmented driver (`resilience.bsp`) stops on
        the first instead of running a superstep the uninterrupted run
        never ran."""
        self.val.copy_(init)
        if self.last_ex is not None:
            self.last_ex.copy_(init)
        for t in (self.done, self.steps_q, self.k, self.stop, self.msgs, self.iters,
                  self.plan.err):
            t.zero_()
        if queries is not None:
            self.done[queries:] = True
        chunks = -(-self.max_supersteps // self.chunk_steps)
        for c in range(chunks):
            self._advance()
            if self.can_stop and c + 1 < chunks:
                HOST_SYNCS[driver] += 1
                if bool(self.stop):  # the run's one host sync a chunk
                    break
        HOST_SYNCS[driver] += 1
        steps_q, msgs, iters, edges, bad, done = (t.cpu().numpy().astype(np.int64) for t in (
            self.steps_q, self.msgs, self.iters, self.edges, self.plan.err, self.done))
        check_flag(int(bad[0]), self.plan.lsrc, self.plan.ldst, self.plan.num_out)
        return self.val.clone(), steps_q, msgs, iters, edges, done.astype(bool)


def _fused_loop(prog: VertexProgram, sub: SubgraphSet, batch: int, *, max_supersteps: int,
                inner_cap: int, exchange_period: int, tol: float, num_vertices: int,
                block_e: int) -> _FusedLoop:
    """The cached loop of (SubgraphSet, exec program, knobs, batch): a warm
    run reuses it, and on the card its captured graph."""
    key = ("loop", prog, int(batch), int(max_supersteps), int(inner_cap), int(exchange_period),
           float(tol), int(num_vertices), int(block_e))
    cache = _sub_cache(sub)
    loop = cache.get(key)
    if loop is None:
        loop = cache[key] = _FusedLoop(
            prog, sub, _plan_for(prog, sub, block_e), batch, max_supersteps=max_supersteps,
            inner_cap=inner_cap, exchange_period=exchange_period, tol=tol,
            num_vertices=num_vertices,
        )
        CAPTURES["loops"] += 1
    return loop


# ----------------------------------------------------- single-query drivers


def run_bsp(
    sub: SubgraphSet,
    program,
    init_val: Optional[torch.Tensor] = None,
    *,
    max_supersteps: Optional[int] = None,
    inner_cap: int = 10_000,
    exchange_period: int = 1,
    tol: float = 0.0,
    num_vertices: int = 0,
    source=None,
    driver: str = "fused",
    block_e: int = 512,
    device=None,
    checkpoint_every: Optional[int] = None,
    ckpt_dir=None,
    fault_plan=None,
) -> tuple[torch.Tensor, BSPStats]:
    """THE simulation-mode driver: runs any `VertexProgram` (instance or
    registered name) on the device of `sub` (or moves `sub` to `device`).

    init_val defaults to the program's own `init_fn` (pass `source=` /
    `num_vertices=` as the program needs). max_supersteps=None takes the
    program's `default_steps` budget (PR: 20), else 200. exchange_period>1
    is bounded staleness (fixpoint programs only): workers run k local
    supersteps between exchanges. `tol` is the L1 step-delta threshold of
    convergence='tol' programs (0 = run all max_supersteps). `block_e` pads
    the edge stream as the reference's kernel wrapper does (values are
    identical for every block_e).

    driver="fused" keeps the carry, the counters, the stats and the
    convergence flag on the device and runs chunks of K masked supersteps
    (a CUDA graph on the card), reading the flag once a chunk;
    driver="host" runs one superstep per Python iteration and syncs once a
    superstep for the flag. Both return the same values and stats, bit for
    bit. The kernels' id flag comes to the host with the syncs the run
    makes anyway; an id outside [0, num_out) raises ValueError.
    Returns (values [p, max_v+1] in the program's dtype, BSPStats); the
    values and every stat match the reference's fused and host drivers.

    Fault tolerance: `checkpoint_every=k` with `ckpt_dir=` snapshots the
    value carry and the per-step stats every k supersteps through
    `repro_torch.checkpoint.ckpt`, and `fault_plan=` (a
    `repro_torch.resilience.FaultPlan`) injects a worker crash at a
    superstep; `repro_torch.resilience.resume_bsp` continues from the last
    snapshot to the uninterrupted run's values and stats, bit for bit. Any
    of the three routes the run through the segmented driver of
    `repro_torch.resilience.bsp` (the same values and stats).
    """
    if device is not None:
        sub = sub.to(device)
    if checkpoint_every is not None or ckpt_dir is not None or fault_plan is not None:
        # Deferred import: resilience builds on this module.
        from repro_torch.resilience.bsp import run_bsp_resilient

        return run_bsp_resilient(
            sub, program, init_val, max_supersteps=max_supersteps, inner_cap=inner_cap,
            exchange_period=exchange_period, tol=tol, num_vertices=num_vertices,
            source=source, driver=driver, block_e=block_e,
            checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir, fault_plan=fault_plan,
        )
    prog = get_program(program)
    check_int32_kernel_labels(prog, sub)
    check_pagerank_num_vertices(prog, num_vertices)
    check_driver(driver)
    if max_supersteps is None:
        max_supersteps = prog.default_steps or 200
    _check_staleness(prog, exchange_period)
    exec_prog, val, negate, codec = _exec_values(prog, sub, init_val, num_vertices, source)

    out, msgs, iters, edges, steps, _ = _run_segment(
        driver, exec_prog, sub, val, start=0, count=max_supersteps, inner_cap=inner_cap,
        exchange_period=exchange_period, tol=tol, num_vertices=num_vertices, block_e=block_e,
    )
    return _from_exec(prog, out, negate, codec), _assemble_stats(steps, msgs, iters, edges)


def _run_segment(driver, exec_prog, sub, val, *, start, count, inner_cap, exchange_period, tol,
                 num_vertices, block_e):
    """Supersteps start .. start+count-1 (fewer once converged) of either
    driver from exec values `val` [p, n]; `start` sits on an exchange
    boundary. A whole run is one segment from 0; the segmented driver
    (`resilience.bsp`) runs several. The fused driver runs the cached loop
    (on the card a replay of its graph); the host driver syncs once a
    superstep. Returns (values [p, n], msgs [steps, p], iters [steps, p],
    edges [p] as int64 numpy, steps run, converged?)."""
    if driver == "fused":
        loop = _fused_loop(exec_prog, sub, 1, max_supersteps=count, inner_cap=inner_cap,
                           exchange_period=exchange_period, tol=tol, num_vertices=num_vertices,
                           block_e=block_e)
        out, steps_q, msgs, iters, edges, done = loop.run(val[None], "fused")
        DISPATCH_COUNTS["fused"] += 1
        steps = int(steps_q[0])
        return out[0], msgs[:steps, 0], iters[:steps, 0], edges, steps, bool(done[0])
    plan = _plan_for(exec_prog, sub, block_e)
    plan.err.zero_()
    out, msgs, iters, steps, converged = _host_steps(
        exec_prog, sub, plan, val[None], start=start, count=count, inner_cap=inner_cap,
        exchange_period=exchange_period, tol=tol, num_vertices=num_vertices,
    )
    HOST_SYNCS["host"] += 1
    msgs, iters, edges, bad = (t.cpu().numpy().astype(np.int64) for t in (
        msgs, iters, sub.edge_mask.sum(dim=1), plan.err))
    check_flag(int(bad[0]), plan.lsrc, plan.ldst, plan.num_out)
    return out[0], msgs, iters, edges, steps, converged


def _host_steps(exec_prog, sub, plan, val, *, start, count, inner_cap, exchange_period, tol,
                num_vertices):
    """Supersteps start .. start+count-1 of the host driver on exec values
    `val` [1, p, n], one host sync each for the convergence flag; `start`
    sits on an exchange boundary (the value is the last exchanged one).
    Returns (values, msgs [steps, p], iters [steps, p] on the device, steps
    run, converged?)."""
    p, dev = sub.num_parts, sub.device
    msgs_buf = torch.zeros((count, p), dtype=torch.int32, device=dev)
    iters_buf = torch.zeros((count, p), dtype=torch.int32, device=dev)
    steps, converged = 0, False
    last_ex = val
    for k in range(start, start + count):
        do_ex = (k % exchange_period) == exchange_period - 1
        v2, msgs, iters, delta = _superstep(
            exec_prog, sub, plan, val, inner_cap, do_ex, last_ex, num_vertices,
        )
        DISPATCH_COUNTS["host"] += 1
        msgs_buf[steps] = msgs[0]
        iters_buf[steps] = iters[0]
        steps += 1
        if exec_prog.convergence == "tol":
            if tol:
                HOST_SYNCS["host"] += 1
                converged = bool(l1_total(delta)[0] < tol)
        elif do_ex:
            # Converged only when an exchange round produced no change; the
            # id flag comes in the same transfer.
            HOST_SYNCS["host"] += 1
            changed, bad = torch.stack([torch.any(v2 != val).to(torch.int32),
                                        plan.err[0]]).tolist()
            check_flag(bad, plan.lsrc, plan.ldst, plan.num_out)
            converged = not changed
        if do_ex:
            last_ex = v2
        val = v2
        if converged:
            break
    return val, msgs_buf[:steps], iters_buf[:steps], steps, converged


# ------------------------------------------------------------ batched driver
#
# The serving tier runs a [B] batch of point queries over SHARED subgraph
# structure in one fused loop: the generic superstep takes the batch axis
# (the kernels run B·p value rows on the p streams) and a per-query
# convergence mask freezes finished queries while stragglers run, so each
# query's BSPStats report the supersteps IT paid and are bit-identical to
# B separate single-source `run_bsp` runs.


def batch_init(prog, sub: SubgraphSet, sources=None, *, batch: Optional[int] = None,
               num_vertices: int = 0) -> torch.Tensor:
    """[B, p, max_v+1] initial values for a batch of point queries.

    Source-rooted programs take `sources` (a [B] sequence of vertex ids),
    each validated BEFORE any init is built — one bad source fails fast
    with the offending id named. Source-free programs (CC/PR/reach:
    whole-graph queries) take `batch` (or infer it from len(sources)) and
    tile one init B times.
    """
    prog = get_program(prog)
    if prog.needs_source:
        if sources is None:
            raise ValueError(
                f"program {prog.name!r} is source-rooted: pass sources= (a [B] "
                "sequence of vertex ids)"
            )
        for s in sources:
            check_source(sub, s, num_vertices)
        return torch.stack(
            [prog.init(sub, num_vertices=num_vertices, source=s) for s in sources]
        )
    if batch is None:
        batch = len(sources) if sources is not None else 0
    if batch < 1:
        raise ValueError(
            f"program {prog.name!r} is source-free: pass batch= (or sources= "
            "to size the batch)"
        )
    one = prog.init(sub, num_vertices=num_vertices)
    return one[None].repeat(int(batch), 1, 1)


def _assemble_batch_stats(steps_q, msgs_sbw, iters_sbw, edges) -> list:
    """Per-query BSPStats from the batched [S, B, p] buffers: query b's
    series is truncated to the supersteps IT paid under masking."""
    return [
        _assemble_stats(int(steps_q[b]), msgs_sbw[: int(steps_q[b]), b],
                        iters_sbw[: int(steps_q[b]), b], edges)
        for b in range(msgs_sbw.shape[1])
    ]


def _resolve_batch_args(sub, program, *, max_supersteps, num_vertices, exchange_period=1):
    prog = get_program(program)
    check_int32_kernel_labels(prog, sub)
    check_pagerank_num_vertices(prog, num_vertices)
    if exchange_period != 1:
        raise ValueError(
            "the batched driver always exchanges every superstep; "
            f"exchange_period={exchange_period} is not supported — run staleness "
            "experiments through single-query run_bsp"
        )
    if max_supersteps is None:
        max_supersteps = prog.default_steps or 200
    return prog, max_supersteps


def _run_batch_loop(loop: _FusedLoop, prog: VertexProgram, sub: SubgraphSet,
                    init_vals: torch.Tensor, queries: Optional[int] = None):
    exec_prog, vals, negate, codec = _to_exec(prog, sub, init_vals.to(sub.device))
    out, steps_q, msgs, iters, edges, _ = loop.run(vals, "batch", queries)
    DISPATCH_COUNTS["batch"] += 1
    return _from_exec(prog, out, negate, codec), _assemble_batch_stats(steps_q, msgs, iters, edges)


def run_bsp_batch(
    sub: SubgraphSet,
    program,
    sources=None,
    init_vals: Optional[torch.Tensor] = None,
    *,
    batch: Optional[int] = None,
    max_supersteps: Optional[int] = None,
    inner_cap: int = 10_000,
    exchange_period: int = 1,
    tol: float = 0.0,
    num_vertices: int = 0,
    block_e: int = 512,
) -> tuple[torch.Tensor, list]:
    """Batched multi-source BSP: B queries of one program in ONE fused loop
    over shared subgraph structure.

    Returns (values [B, p, max_v+1], per-query BSPStats list) — each query's
    values AND stats are bit-identical to a single-source `run_bsp` call.
    """
    prog, max_supersteps = _resolve_batch_args(
        sub, program, max_supersteps=max_supersteps, num_vertices=num_vertices,
        exchange_period=exchange_period,
    )
    if init_vals is None:
        init_vals = batch_init(prog, sub, sources, batch=batch, num_vertices=num_vertices)
    exec_prog, _ = _exec_view(prog)
    loop = _fused_loop(exec_prog, sub, init_vals.shape[0], max_supersteps=max_supersteps,
                       inner_cap=inner_cap, exchange_period=1, tol=tol,
                       num_vertices=num_vertices, block_e=block_e)
    return _run_batch_loop(loop, prog, sub, init_vals)


@dataclasses.dataclass
class BatchExecutable:
    """The batched loop captured for one (program, padded batch size): the
    serving tier's executable-cache value, the counterpart of the
    reference's AOT-compiled executable. On the card it holds the loop's
    CUDA graph, captured and instantiated by `compile_batch_executable`
    (`compile_s`); `run` copies the init into the graph's static input and
    replays, capturing nothing. Negation (max-combine programs), the
    codec and per-query stats assembly live in the wrapper, outside the
    graph."""

    program: VertexProgram
    sub: SubgraphSet
    batch: int
    loop: _FusedLoop
    compile_s: float

    def run(self, init_vals: torch.Tensor, queries: Optional[int] = None
            ) -> tuple[torch.Tensor, list]:
        """Same contract as `run_bsp_batch`. `queries` (≤ batch): how many
        leading rows are real queries; the padding rows behind them run no
        step and come back as their init with 0 supersteps (the reference
        runs them as copies of a real query and discards them, as the
        server does)."""
        if init_vals.shape[0] != self.batch:
            raise ValueError(
                f"executable compiled for batch {self.batch}, got {init_vals.shape[0]} "
                "— pad the batch to its bucket first"
            )
        if queries is not None and not 1 <= queries <= self.batch:
            raise ValueError(f"queries must be in [1, {self.batch}], got {queries}")
        return _run_batch_loop(self.loop, self.program, self.sub, init_vals, queries)


def compile_batch_executable(
    sub: SubgraphSet,
    program,
    batch: int,
    *,
    max_supersteps: Optional[int] = None,
    inner_cap: int = 10_000,
    tol: float = 0.0,
    num_vertices: int = 0,
    block_e: int = 512,
) -> BatchExecutable:
    """Build the batched loop for a fixed padded batch size and, on the
    card, capture its CUDA graph (after one eager chunk on placeholder
    values that builds and loads every kernel at these shapes): the warm
    path behind `repro_torch.serve`'s executable cache."""
    prog, max_supersteps = _resolve_batch_args(
        sub, program, max_supersteps=max_supersteps, num_vertices=num_vertices,
    )
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    exec_prog, _ = _exec_view(prog)
    t0 = time.perf_counter()
    loop = _fused_loop(exec_prog, sub, batch, max_supersteps=max_supersteps,
                       inner_cap=inner_cap, exchange_period=1, tol=tol,
                       num_vertices=num_vertices, block_e=block_e)
    if loop.graph is None and sub.device.type == "cuda":
        loop._chunk()  # on the zeros it was built with; `run` resets every buffer
        loop.capture()
    return BatchExecutable(program=prog, sub=sub, batch=int(batch), loop=loop,
                           compile_s=time.perf_counter() - t0)


# ------------------------------------------- distributed (torch.distributed)
#
# The paper's deployment: the p subgraphs sharded over the w ranks of a
# device mesh, rank r holding the contiguous parts [r·p/w, (r+1)·p/w) (as
# the reference's `P(axis)` lays them out under shard_map), and each
# superstep's exchange an all_to_all over the mesh group. On the card the
# group runs over NCCL, in the tests over gloo.

_ARRAY_FIELDS = [
    "lsrc", "ldst", "weight", "edge_mask",
    "lsrc_s", "ldst_s", "weight_s", "edge_mask_s",
    "gid", "vmask", "is_master", "out_degree",
    "send_idx", "recv_idx", "msg_mask", "recv_mask",
]
_STATIC_FIELDS = ["num_parts", "max_v", "max_e", "max_msg", "addressing"]


def subgraphs_to_arrays(sub: SubgraphSet) -> tuple[dict, dict]:
    arrays = {k: getattr(sub, k) for k in _ARRAY_FIELDS}
    statics = {k: getattr(sub, k) for k in _STATIC_FIELDS}
    return arrays, statics


def _a2a_exchange(group, w: int):
    """The exchange across the w ranks of `group`, each holding nloc of the
    p workers: [B, nloc, p, m] rowed by this rank's workers and columned by
    all p → the same shape columned by the other end, whose index is
    `src_rank·nloc + i` (the transpose of `_sim_exchange`, across ranks).
    Regrouped by destination rank into one contiguous [w, B, nloc, nloc, m]
    buffer, exchanged with one all_to_all_single (which concatenates by
    source rank), and permuted back."""

    def exchange(S: torch.Tensor) -> torch.Tensor:
        B, nloc, p, m = S.shape
        send = S.reshape(B, nloc, w, nloc, m).permute(2, 0, 1, 3, 4).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        # recv[s, b, i, j, m]: from worker i of rank s to local worker j.
        return recv.permute(1, 3, 0, 2, 4).reshape(B, nloc, p, m)

    return exchange


def make_distributed_stepper(
    mesh,
    axes,
    prog,
    statics: dict,
    *,
    num_supersteps: int,
    inner_cap: int,
    tol: float = 0.0,
    num_vertices: int = 0,
    block_e: int = 512,
    fault_plan=None,
):
    """A BSP runner for ANY `VertexProgram` with the subgraphs sharded over
    the ranks of the mesh dimensions `axes` (one name, or a tuple naming
    every dimension of a mesh over the whole world, in order): w ranks,
    w dividing p, rank r holding the contiguous parts [r·p/w, (r+1)·p/w)
    (`runner.rows`).

    The returned `runner(arrays, val)` is called on every rank with this
    rank's rows of the arrays (`subgraphs_to_arrays`, cut by `runner.rows`,
    on any device) and of the initial values [p/w, max_v+1] in the
    program's own domain; it copies them to its mesh device (the arrays'
    copy cached for the next call with the same arrays) and returns this
    rank's rows of what the reference's runner returns, as its shard_map
    does: (values [p/w, max_v+1], msgs_total [p/w], steps, msgs_per_step
    [num_supersteps, p/w], iters_per_step [num_supersteps, p/w]), on the
    mesh device, the buffers zero past `steps`. `runner.gather(out)`
    assembles the whole set's on every rank and on the host (one
    all_gather): what `GraphPipeline.run(mode="dist")` returns.

    Each superstep is the simulation's `_superstep` on the local rows with
    the exchange an all_to_all_single over the mesh group (only the f32
    values travel), then one collective of the convergence signal: an
    all_reduce(SUM) of the int32 changed flags (no-change programs), or an
    all_gather of every subgraph's f32 L1 delta (p floats), added in the
    simulation's order (`l1_total`) against `tol` (tol programs), so every
    rank takes the same trip count as the simulation would. The host
    reads that flag once a superstep (none for a tol program with tol=0),
    and one all_reduce(MAX) at the end hands every rank the kernels' id
    flag, so that all raise together. The kernels run as everywhere: CUDA
    on the card, the plain versions on the CPU. Max-combine programs are
    negated in and out here, and int32 programs remapped to f32 once a
    run, after the 2^24 guard: each rank bounds its own rows (flat
    addressing: the global ids; two-level: the carry's value bound, plus
    the covered vertices for unit weights), and one all_reduce(MAX) ahead
    of the loop hands every rank the world's bound (the largest, and each
    rank's covered count in a slot of its own, summed), so every rank
    raises before any other collective.

    `fault_plan=` (a `repro_torch.resilience.FaultPlan` with
    `crash_at_superstep=s`) caps the loop at s supersteps and raises
    `WorkerCrashError(superstep=s)` if it was still running then.
    `runner.shard(arrays)` is the `SubgraphSet` of this rank's rows that
    the runner copies (and caches) from those arrays.
    """
    prog = get_program(prog)
    check_pagerank_num_vertices(prog, num_vertices)
    crash_at = None
    if fault_plan is not None and fault_plan.crash_at_superstep is not None:
        crash_at = int(fault_plan.crash_at_superstep)
        num_supersteps = min(num_supersteps, crash_at)  # the doomed superstep never completes
    exec_prog, negate = _exec_view(prog)
    group, rank, w = axes_group(mesh, axes)
    p = int(statics["num_parts"])
    if p % w:
        raise ValueError(f"num_parts={p} must divide evenly over the {w} ranks of mesh axes "
                         f"{axes!r}")
    nloc = p // w
    rows = slice(rank * nloc, (rank + 1) * nloc)
    dev = mesh_device(mesh)
    exchange = _a2a_exchange(group, w)
    addressing = statics.get("addressing", "two_level")
    n = int(statics["max_v"]) + 1
    shard_cache: list = []  # [(the arrays it was copied from, the shard)]

    def shard(arrays: dict) -> SubgraphSet:
        held = tuple(arrays[k] for k in _ARRAY_FIELDS)
        if not (shard_cache and all(a is b for a, b in zip(shard_cache[0][0], held))):
            bad = [(k, a.shape[0]) for k, a in zip(_ARRAY_FIELDS, held) if a.shape[0] != nloc]
            if bad:
                raise ValueError(f"the runner takes this rank's {nloc} rows of each array "
                                 f"(runner.rows = {rows}); {bad[0][0]} has {bad[0][1]}")
            cut = {k: torch.as_tensor(a).to(dev).contiguous()
                   for k, a in zip(_ARRAY_FIELDS, held)}
            shard_cache[:] = [(held, SubgraphSet(**cut, **statics))]
        return shard_cache[0][1]

    def guard(arrays: dict, val: torch.Tensor) -> None:
        """The 2^24 guard over the world, before any other collective."""
        if prog.dtype != "int32":
            return
        word = torch.zeros((w + 1,), dtype=torch.int64)
        if addressing == "flat":
            gid = torch.as_tensor(arrays["gid"])
            word[0] = int(gid.max()) if gid.numel() else 0
        else:
            mag = val.abs()
            word[0] = int(torch.where(mag != INF_I32, mag, 0).max()) if val.numel() else 0
            if prog.weight == "unit":
                word[1 + rank] = int(torch.as_tensor(arrays["is_master"]).sum())
        word = word.to(dev)
        dist.all_reduce(word, op=dist.ReduceOp.MAX, group=group)
        HOST_SYNCS["dist"] += 1
        word = word.tolist()
        if addressing == "flat":
            check_int32_kernel_gid(prog, torch.tensor(word[0]))
        else:
            check_int32_kernel_values(prog, word[0] + sum(word[1:]))

    def runner(arrays: dict, val):
        val = torch.as_tensor(val)
        if val.shape[0] != nloc:
            raise ValueError(f"the runner takes this rank's {nloc} rows of the values "
                             f"(runner.rows = {rows}); got {val.shape[0]}")
        guard(arrays, val)
        sub = shard(arrays)
        v = val.to(dev)
        v = -v if negate else v
        if prog.dtype == "int32":
            v = _to_f32(v)
        out, steps, msgs, iters, bad = _dist_steps(
            exec_prog, sub, v[None].contiguous(), group, exchange, num_supersteps=num_supersteps,
            inner_cap=inner_cap, tol=tol, num_vertices=num_vertices, block_e=block_e,
        )
        if prog.dtype == "int32":
            out = _to_i32(out)
        # Every rank learns whether any rank's kernels flagged an id.
        bad = bad.clone()
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
        HOST_SYNCS["dist"] += 1
        plan = _plan_for(exec_prog, sub, block_e)
        check_flag(bad, plan.lsrc, plan.ldst, plan.num_out)
        if crash_at is not None and steps >= crash_at:
            # The loop was still running when the doomed superstep came due.
            from repro_torch.resilience.faults import WorkerCrashError

            raise WorkerCrashError(superstep=crash_at)
        return (-out if negate else out), msgs.sum(dim=0), steps, msgs, iters

    def gather(out) -> tuple:
        """The whole set's (values [p, n], msgs_total [p], steps,
        msgs_per_step [S, p], iters_per_step [S, p]) on the host, from
        every rank's `runner` output (one all_gather)."""
        vals, _, steps, msgs, iters = out
        words = vals.view(torch.int32) if vals.dtype == torch.float32 else vals
        pack = torch.cat([words.reshape(-1), msgs.reshape(-1), iters.reshape(-1)])
        gathered = [torch.empty_like(pack) for _ in range(w)]
        dist.all_gather(gathered, pack, group=group)
        allp = torch.stack(gathered).cpu()
        nv, ns = nloc * n, num_supersteps * nloc
        whole = allp[:, :nv].contiguous().view(vals.dtype).reshape(p, n)

        def per_step(a):  # [w, S·nloc] → [S, p]
            return a.reshape(w, num_supersteps, nloc).permute(1, 0, 2).reshape(num_supersteps, p)

        msgs_sp, iters_sp = per_step(allp[:, nv:nv + ns]), per_step(allp[:, nv + ns:])
        return whole, msgs_sp.sum(dim=0), steps, msgs_sp, iters_sp

    runner.shard = shard
    runner.rows = rows
    runner.gather = gather
    return runner


def _dist_steps(exec_prog, sub, val, group, exchange, *, num_supersteps, inner_cap, tol,
                num_vertices, block_e):
    """The distributed stepper's loop on this rank's rows: exec values
    `val` [1, nloc, n] → (values [nloc, n], steps, msgs [S, nloc], iters
    [S, nloc], the kernels' id flag [1]) on the device."""
    plan = _plan_for(exec_prog, sub, block_e)
    plan.err.zero_()
    nloc, dev = val.shape[1], val.device
    msgs_buf = torch.zeros((num_supersteps, nloc), dtype=torch.int32, device=dev)
    iters_buf = torch.zeros((num_supersteps, nloc), dtype=torch.int32, device=dev)
    steps = 0
    while steps < num_supersteps:
        v2, msgs, iters, delta = _superstep(exec_prog, sub, plan, val, inner_cap,
                                            num_vertices=num_vertices, exchange=exchange)
        DISPATCH_COUNTS["dist"] += 1
        msgs_buf[steps] = msgs[0]
        iters_buf[steps] = iters[0]
        steps += 1
        # Convergence is global, so every rank takes the same trip count
        # (and makes the same collectives): a tol program gathers every
        # subgraph's delta and adds them as the simulation does; a no-change
        # program adds the ranks' changed flags.
        if exec_prog.convergence == "tol":
            rows_w = [torch.empty_like(delta[0]) for _ in range(dist.get_world_size(group))]
            dist.all_gather(rows_w, delta[0].contiguous(), group=group)
            signal = l1_total(torch.cat(rows_w)[None])
        else:
            signal = torch.any(v2 != val).to(torch.int32).reshape(1)
            dist.all_reduce(signal, op=dist.ReduceOp.SUM, group=group)
        val = v2
        if exec_prog.convergence == "tol" and not tol:
            continue  # tol=0 runs every superstep: no flag to read
        HOST_SYNCS["dist"] += 1
        if bool(signal[0] < tol) if exec_prog.convergence == "tol" else not bool(signal[0]):
            break
    return val[0], steps, msgs_buf, iters_buf, plan.err
