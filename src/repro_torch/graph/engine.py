"""Subgraph-centric bulk-synchronous-parallel engine (paper §IV-B; port of
`repro.graph.engine`, simulation mode).

One subgraph == one worker. A superstep is
  1. compute:   local work over the subgraph's own edges — a min-plus
                fixpoint relaxation iterated to local convergence
                (min/max-semiring programs) or one push-sum sweep
                (PageRank), both through the `bsp_superstep` kernel;
  2. exchange:  mirror→master reduction then master→mirror broadcast over
                fixed padded tables (in simulation all p workers live on one
                device as a leading batch axis, so the exchange is a
                transpose);
  3. barrier:   the end of the step.

Every algorithm is a `VertexProgram`; ONE generic superstep body and ONE
driver loop run any of them. CC, SSSP, PageRank, BFS and max-label
reachability are the stock instances in `PROGRAMS`.

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

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.metrics import max_mean_ratio
from repro_torch.graph.build import SubgraphSet, check_addressing
from repro_torch.kernels import ops
from repro_torch.kernels.bsp_superstep import check_flag

INF_F32 = 3.0e38  # the f32 "unreached" value (the kernels' min identity)
INF_I32 = 2**31 - 1  # the int32 "unreached" value


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
    """The semiring actually executed: max-combine programs run as min over
    negated values; everything else runs as-is. Returns (program, negate?)."""
    if prog.combine != "max":
        return prog, False
    return dataclasses.replace(prog, combine="min"), True


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
    """Append the dump slot column (index max_v) holding `fill`."""
    dump = torch.full((val.shape[0], 1), fill, dtype=val.dtype, device=val.device)
    return torch.cat([val, dump], dim=1)


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
    """val: [p, max_v+1]; idx: [p, p*m] int64 → out[i, j, m] = val[i, idx[i, j*m]]."""
    return torch.gather(val, 1, idx).reshape(shape)


def _scatter(val: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor, reduce: str) -> torch.Tensor:
    """out[i, idx[i,k]] combined with upd[i, k] ("amin" | "sum" | "set");
    idx: [p, p*m] int64, upd: [p, p, m]."""
    upd = upd.reshape(idx.shape)
    if reduce == "set":
        return val.scatter(1, idx, upd)
    return val.scatter_reduce(1, idx, upd, reduce, include_self=True)


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
    """The run-invariant inputs of a superstep, made once per run: the local
    stage's edge stream (padded to `block_e` at the dump slot) and, for
    sweeps, the out-degree with the dump slot's 1 appended; and the exchange
    tables as the int64 indices that gather/scatter take; and the device
    flag that the run's superstep launches OR their id guard's bits into,
    read with the syncs the run makes anyway (`run_bsp`)."""

    lsrc: torch.Tensor
    ldst: torch.Tensor
    weight: torch.Tensor
    out_degree: Optional[torch.Tensor]
    num_out: int
    block_e: int
    send_idx: torch.Tensor  # [p, p*max_msg] int64
    recv_idx: torch.Tensor  # [p, p*max_msg] int64
    bcast_idx: torch.Tensor  # [p, p*max_msg] int64: send_idx, dump slot where unmasked
    err: torch.Tensor  # [1] int32, zeroed once a run


def _run_plan(prog: VertexProgram, sub: SubgraphSet, block_e: int) -> _RunPlan:
    num_out = sub.max_v + 1
    if prog.local == "fixpoint":
        lsrc, ldst, w = _relax_stream(prog, sub)
        outdeg = None
        identity = INF_F32
    else:
        # Pads carry weight 0: the sum identity and the kernel's pad mask.
        lsrc, ldst, w = sub.lsrc, sub.ldst, sub.edge_mask.to(torch.float32)
        ones = torch.ones((sub.num_parts, 1), dtype=torch.float32, device=sub.device)
        outdeg = torch.cat([sub.out_degree, ones], dim=1)
        identity = 0.0
    lsrc, ldst, w = ops.pad_stream(lsrc, ldst, w, num_out=num_out, block_e=block_e,
                                   identity=identity)
    p = sub.num_parts
    return _RunPlan(
        lsrc, ldst, w, outdeg, num_out, block_e,
        send_idx=sub.send_idx.reshape(p, -1).long(),
        recv_idx=sub.recv_idx.reshape(p, -1).long(),
        bcast_idx=torch.where(sub.msg_mask, sub.send_idx, sub.max_v).reshape(p, -1).long(),
        err=torch.zeros((1,), dtype=torch.int32, device=lsrc.device),
    )


def _local_fixpoint(plan: _RunPlan, val: torch.Tensor, inner_cap: int):
    """Batched local fixpoint on the f32 exec values [p, max_v+1] (last slot
    = dump): every relaxation pass and the per-worker convergence flag in
    one kernel launch (its ids' flag left in plan.err). Returns (values,
    per-worker inner iterations)."""
    return ops.bsp_superstep(
        plan.lsrc, plan.ldst, plan.weight, val, num_out=plan.num_out, combine="min",
        inner_cap=inner_cap, block_e=plan.block_e, err=plan.err,
    )


def _local_sweep(plan: _RunPlan, val: torch.Tensor) -> torch.Tensor:
    """One out-degree-normalized push-sum pass (PageRank's local compute):
    each vertex pushes val/outdeg along its out-edges, summed at dst."""
    new, _ = ops.bsp_superstep(
        plan.lsrc, plan.ldst, plan.weight, val, num_out=plan.num_out, combine="sum",
        out_degree=plan.out_degree, block_e=plan.block_e, err=plan.err,
    )
    return new


# --------------------------------------------------- THE generic superstep


def _apply_step(prog: VertexProgram, sub: SubgraphSet, combined: torch.Tensor, num_vertices: int):
    """Master-side post-combine step. "none" passes the combined value
    through; "pagerank" turns summed partials into damped, renormalized
    ranks at masters (mirrors zeroed until the broadcast)."""
    if prog.apply == "none":
        return combined
    base = (1.0 - prog.damping) / num_vertices
    new = torch.where(sub.is_master, base + prog.damping * combined[:, : sub.max_v], 0.0)
    return _with_dump(new.to(torch.float32), 0.0)


def _sim_exchange(S: torch.Tensor) -> torch.Tensor:
    return S.transpose(0, 1)


def _superstep(prog: VertexProgram, sub: SubgraphSet, plan: _RunPlan, val: torch.Tensor,
               inner_cap: int, do_exchange: bool = True, count_ref=None, num_vertices: int = 0):
    """ONE BSP superstep for ANY program (exec view: f32 values, combine
    "min" or "sum"). Returns (new_val, per-worker msg count, per-worker
    inner iters, L1 delta or None).

    Stages: local compute → mirror→master exchange + combine → apply →
    master→mirror broadcast. `count_ref` is the value snapshot of the LAST
    exchange — delta messages are counted against it (matters under bounded
    staleness). The L1 delta is only computed for convergence='tol'.
    """
    p = val.shape[0]
    start = val if count_ref is None else count_ref

    # 1. local compute. Sweep programs carry the per-vertex partial
    # aggregate (one sweep = one inner iteration of comp work per worker).
    if prog.local == "fixpoint":
        state, iters = _local_fixpoint(plan, val, inner_cap)
    else:
        state = _local_sweep(plan, val)
        iters = torch.ones((p,), dtype=torch.int32, device=val.device)
    if not do_exchange:  # bounded-staleness local step
        return state, torch.zeros((p,), dtype=torch.int32, device=val.device), iters, None

    # 2. mirror → master (forward): send current state of mirror slots.
    shape = sub.send_idx.shape
    S = _gather_rows(state, plan.send_idx, shape)  # [i, j, m]
    if prog.message_policy == "delta":
        ch_send = _gather_rows(state != start, plan.send_idx, shape)
        msgs_fwd = (ch_send & sub.msg_mask).sum(dim=(1, 2))
    else:
        msgs_fwd = sub.msg_mask.sum(dim=(1, 2))
    R = _sim_exchange(S)  # receiver-rowed [j, i, m]
    upd = torch.where(sub.recv_mask, R, prog.identity)
    combined = _scatter(state, plan.recv_idx, upd, "sum" if prog.combine == "sum" else "amin")

    # 3. apply at masters, then master → mirror (broadcast).
    new_val = _apply_step(prog, sub, combined, num_vertices)
    B = _gather_rows(new_val, plan.recv_idx, shape)  # [j, i, m] master values
    if prog.message_policy == "delta":
        ch_b = _gather_rows(new_val != start, plan.recv_idx, shape)
        msgs_bwd = (ch_b & sub.recv_mask).sum(dim=(1, 2))
    else:
        msgs_bwd = sub.recv_mask.sum(dim=(1, 2))
    Rb = _sim_exchange(B)  # sender-rowed view at mirrors: [i, j, m]
    out = _scatter(new_val, plan.bcast_idx, Rb, "set")

    delta = None
    if prog.convergence == "tol":
        delta = (out[:, : sub.max_v] - val[:, : sub.max_v]).abs().sum()
    return out, (msgs_fwd + msgs_bwd).to(torch.int32), iters, delta


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


def _exec_values(prog: VertexProgram, sub: SubgraphSet, init_val, num_vertices, source):
    """The run's entry into the exec domain: (exec program, f32 values,
    negate?, codec-or-None). The driver undoes each step on exit."""
    if init_val is None:
        init_val = prog.init(sub, num_vertices=num_vertices, source=source)
    init_val = init_val.to(sub.device)
    # Max-combine runs as min over negated values; delta message counts and
    # no-change convergence are negation-invariant.
    exec_prog, negate = _exec_view(prog)
    val = -init_val if negate else init_val
    # Two-level runs rank-compress label-domain values so the kernels only
    # ever see ranks < 2^24; codec=None means values pass raw.
    val, codec = _kernel_value_boundary(prog, sub, val)
    # The kernels compute in f32: int32 programs run on an f32 view of their
    # values for the whole run (the remap is a bijection on every value
    # that occurs, so values, counts and convergence are unchanged).
    if prog.dtype == "int32":
        val = _to_f32(val)
        exec_prog = dataclasses.replace(exec_prog, dtype="float32")
    return exec_prog, val, negate, codec


def kernel_inputs(sub: SubgraphSet, program, *, num_vertices: int = 0, source=None,
                  block_e: int = 512):
    """The local stage's kernel inputs at the start of a run of `program`:
    ((lsrc, ldst, weight, out_degree-or-None), f32 values, num_out) — what
    the first superstep hands `ops.bsp_superstep`. For holding the kernel
    against its plain version at the shapes a real run gives it."""
    prog = get_program(program)
    exec_prog, val, _, _ = _exec_values(prog, sub, None, num_vertices, source)
    plan = _run_plan(exec_prog, sub, block_e)
    return (plan.lsrc, plan.ldst, plan.weight, plan.out_degree), val, plan.num_out


def check_pagerank_num_vertices(prog: VertexProgram, num_vertices: int) -> None:
    """pagerank-apply programs renormalize by the GLOBAL vertex count."""
    if prog.apply == "pagerank" and num_vertices <= 0:
        raise ValueError(
            f"program {prog.name!r} renormalizes by the global vertex count: "
            "pass num_vertices= (GraphPipeline supplies graph.num_vertices)"
        )


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
    block_e: int = 512,
    device=None,
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

    The loop keeps the value carry and the per-step stats in device buffers
    and syncs with the host once per superstep, for the convergence flag.
    The kernels' id flag comes to the host with the syncs the run makes
    anyway: with no-change convergence in one transfer with that flag, and
    at the end with the stats; an id outside [0, num_out) raises ValueError.
    Returns (values [p, max_v+1] in the program's dtype, BSPStats); the
    values and every stat match the reference's fused and host drivers.
    """
    if device is not None:
        sub = sub.to(device)
    prog = get_program(program)
    check_int32_kernel_labels(prog, sub)
    check_pagerank_num_vertices(prog, num_vertices)
    if max_supersteps is None:
        max_supersteps = prog.default_steps or 200
    if exchange_period < 1:
        raise ValueError(f"exchange_period must be >= 1, got {exchange_period}")
    if exchange_period > 1 and (prog.local != "fixpoint" or prog.convergence != "no_change"):
        raise ValueError(
            f"exchange_period>1 (bounded staleness) needs a fixpoint/no-change program; "
            f"{prog.name!r} is local={prog.local!r}, convergence={prog.convergence!r}"
        )
    exec_prog, val, negate, codec = _exec_values(prog, sub, init_val, num_vertices, source)
    plan = _run_plan(exec_prog, sub, block_e)

    p = val.shape[0]
    dev = sub.device
    msgs_buf = torch.zeros((max_supersteps, p), dtype=torch.int32, device=dev)
    iters_buf = torch.zeros((max_supersteps, p), dtype=torch.int32, device=dev)
    steps = 0
    last_ex = val
    for k in range(max_supersteps):
        do_ex = (k % exchange_period) == exchange_period - 1
        v2, msgs, iters, delta = _superstep(
            exec_prog, sub, plan, val, inner_cap, do_ex, last_ex, num_vertices,
        )
        msgs_buf[k] = msgs
        iters_buf[k] = iters
        steps += 1
        if exec_prog.convergence == "tol":
            converged = bool(tol) and bool(delta < tol)
        elif do_ex:
            # Converged only when an exchange round produced no change; the
            # id flag comes in the same transfer.
            changed, bad = torch.stack([torch.any(v2 != val).to(torch.int32),
                                        plan.err[0]]).tolist()
            check_flag(bad, plan.lsrc, plan.ldst, plan.num_out)
            converged = not changed
        else:
            converged = False
        if do_ex:
            last_ex = v2
        val = v2
        if converged:
            break

    if prog.dtype == "int32":
        val = _to_i32(val)
    if codec is not None:
        val = codec.decode(val)
    edges = sub.edge_mask.sum(dim=1)
    msgs_sw, iters_sw, edges, bad = (t.cpu().numpy().astype(np.int64) for t in (
        msgs_buf[:steps], iters_buf[:steps], edges, plan.err))
    check_flag(int(bad[0]), plan.lsrc, plan.ldst, plan.num_out)
    return (-val if negate else val), _assemble_stats(steps, msgs_sw, iters_sw, edges)
