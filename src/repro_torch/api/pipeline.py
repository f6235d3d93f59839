"""`GraphPipeline` — the end-to-end facade over the paper's stack (port of
`repro.api.pipeline`).

    run = GraphPipeline(graph).partition("ebg_chunked", parts=32).build().run("cc")
    run.stats.total_messages, run.metrics.replication_factor, run.to_global()

The pipeline runs on one device: the CUDA card unless the caller passes
`device="cpu"` (then every kernel runs its plain PyTorch version);
`run(mode="dist", mesh=...)` runs one subgraph a rank of a
`torch.distributed` mesh (`repro_torch.launch.mesh.make_host_mesh`). Stages
are lazy and cached on a shared partition-stage state, so fluent views are
cheap: `.partition(...)` starts a fresh stage; `.build(...)` and repeated
`.run(...)` calls on the same stage reuse the cached `PartitionResult`,
`PartitionMetrics` and per-(symmetrize, pad) `SubgraphSet`s. If `.build`
is never called, `.run` picks the build the program needs (bidirectional
programs symmetrize; the rest keep edge direction).

Distributed execution shares the facade: `GraphPipeline.from_spec(spec)`
makes an abstract (shape-only) pipeline, and `.lower(mesh=...)` builds one
rank's distributed BSP stepper for an abstract spec or a built subgraph
set, with its plan: this rank's argument bytes, one superstep's
collectives and one local pass's bytes and operations, reckoned from the
shapes and the mesh alone (the counterpart of the reference's compiled
memory and cost analyses). This is what the production dry-run drives
(`repro_torch.launch.graph_dryrun`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.config import PartitionerConfig
from repro_torch.api.registry import PartitionerSpec, check_num_parts, get_partitioner
from repro_torch.core.metrics import PartitionMetrics, partition_metrics
from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.graph import algorithms as alg
from repro_torch.graph.build import ARRAY_FIELDS, SubgraphSet, build_subgraphs
from repro_torch.graph.engine import (
    BSPStats,
    VertexProgram,
    _assemble_stats,
    _kernel_value_boundary,
    check_driver,
    check_int32_kernel_labels,
    get_program,
    make_distributed_stepper,
    run_bsp_batch,
    subgraphs_to_arrays,
)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import axes_group, axis_size
from repro_torch.launch.roofline import CollectiveSummary, summarize_collectives

ProgramLike = Union[str, VertexProgram]


def _resolve_program(program: ProgramLike) -> VertexProgram:
    """Normalize a program handle to a runnable `VertexProgram` (one that
    carries an `init_fn`: the facade needs initial values to run)."""
    prog = get_program(program)
    if prog.init_fn is None:
        raise ValueError(
            f"program {prog.name!r} has no init_fn: GraphPipeline cannot build its "
            "initial values — set VertexProgram.init_fn, or drive it through "
            "repro_torch.graph.engine.run_bsp with an explicit init_val"
        )
    return prog


def _translate_engine_kwargs(prog: VertexProgram, kw: dict) -> tuple[VertexProgram, dict]:
    """`num_iters` is the PageRank-speak alias of `max_supersteps`, and
    `damping` specializes the program instance."""
    kw = dict(kw)
    if "num_iters" in kw:
        kw["max_supersteps"] = kw.pop("num_iters")
    if "damping" in kw:
        prog = dataclasses.replace(prog, damping=float(kw.pop("damping")))
    return prog, kw


def _normalize_axes(mesh, axes) -> tuple:
    if axes is None:
        return tuple(mesh.mesh_dim_names)
    return (axes,) if isinstance(axes, str) else tuple(axes)


# --------------------------------------------------------------- dry-run spec

_DTYPES = {"int32": torch.int32, "float32": torch.float32, "bool": torch.bool}
# Each SubgraphSet array: its dtype and its shape class ("e": [p, max_e],
# "v": [p, max_v], "m": [p, p, max_msg]).
_ARRAY_LAYOUT = {
    "lsrc": ("int32", "e"), "ldst": ("int32", "e"), "weight": ("float32", "e"),
    "edge_mask": ("bool", "e"), "lsrc_s": ("int32", "e"), "ldst_s": ("int32", "e"),
    "weight_s": ("float32", "e"), "edge_mask_s": ("bool", "e"),
    "gid": ("int32", "v"), "vmask": ("bool", "v"), "is_master": ("bool", "v"),
    "out_degree": ("float32", "v"),
    "send_idx": ("int32", "m"), "recv_idx": ("int32", "m"), "msg_mask": ("bool", "m"),
    "recv_mask": ("bool", "m"),
}


@dataclasses.dataclass(frozen=True)
class SubgraphSpec:
    """Shape-only description of a padded SubgraphSet (for lowering)."""

    num_parts: int
    max_v: int
    max_e: int
    max_msg: int = 2048
    addressing: str = "two_level"

    @classmethod
    def of(cls, sub: SubgraphSet) -> "SubgraphSpec":
        return cls(sub.num_parts, sub.max_v, sub.max_e, sub.max_msg, sub.addressing)

    def array_shape(self, name: str, rows: Optional[int] = None) -> tuple:
        """The shape of array `name`, with `rows` leading rows (all p by default)."""
        p = self.num_parts
        rows = p if rows is None else rows
        kind = _ARRAY_LAYOUT[name][1]
        return {"e": (rows, self.max_e), "v": (rows, self.max_v),
                "m": (rows, p, self.max_msg)}[kind]

    def array_specs(self) -> tuple[dict, dict]:
        """Meta tensors (shapes and dtypes, no storage) + statics matching
        `subgraphs_to_arrays`: PyTorch's counterpart of the reference's
        ShapeDtypeStructs."""
        arrays = {k: torch.empty(self.array_shape(k), dtype=_DTYPES[_ARRAY_LAYOUT[k][0]],
                                 device="meta")
                  for k in ARRAY_FIELDS}
        statics = dict(num_parts=self.num_parts, max_v=self.max_v, max_e=self.max_e,
                       max_msg=self.max_msg, addressing=self.addressing)
        return arrays, statics

    def value_spec(self, prog: VertexProgram) -> torch.Tensor:
        dt = torch.int32 if prog.dtype == "int32" else torch.float32
        return torch.empty((self.num_parts, self.max_v + 1), dtype=dt, device="meta")


def superstep_reads(prog: VertexProgram) -> tuple:
    """The SubgraphSet arrays a superstep of `prog` reads (`engine._run_plan`
    and `_superstep`), in field order: the local stage's stream (the
    src-sorted copy too for bidirectional programs; the weights only for
    edge weights; the out-degree for sweeps), `is_master` for the
    pagerank apply, and the four exchange tables."""
    reads = {"lsrc", "ldst", "edge_mask", "send_idx", "recv_idx", "msg_mask", "recv_mask"}
    if prog.local == "fixpoint":
        if prog.weight == "edge":
            reads.add("weight")
        if prog.bidirectional:
            reads |= {"lsrc_s", "ldst_s", "edge_mask_s"}
            if prog.weight == "edge":
                reads.add("weight_s")
    else:
        reads.add("out_degree")
    if prog.apply == "pagerank":
        reads.add("is_master")
    return tuple(k for k in ARRAY_FIELDS if k in reads)


@dataclasses.dataclass(frozen=True)
class PlanMemory:
    """`LoweredBSP.memory_analysis()`: this rank's argument bytes, reckoned
    from shapes. `argument_size_in_bytes` counts every array the runner cuts
    to the device and the values; `read_argument_size_in_bytes` only the
    arrays a superstep reads (`superstep_reads`) and the values, as the
    reference's lowering keeps just those. Temporaries are not reckoned:
    the dry-run measures them (`launch.graph_dryrun`)."""

    argument_size_in_bytes: int
    read_argument_size_in_bytes: int
    temp_size_in_bytes: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class BSPPlan:
    """One rank's share of the distributed stepper, reckoned from the spec's
    shapes and the mesh alone (no tensor is made, so it runs at Friendster
    size on any host). Like the reference's compiled analyses, which count
    a while loop's body once, its figures are one superstep and one local
    pass.

    `arrays`: bytes of this rank's rows of each array; `values`: its values
    [rows, max_v + 1] (4 B each). `superstep`: one superstep's collectives,
    in order, as (kind, output bytes, group size): the forward and the
    broadcast all-to-all of `engine._a2a_exchange` (f32 values), then the
    convergence collective (an all-reduce of one int32 for no-change
    programs; an all-gather of the p f32 deltas for tol programs). `setup`:
    the 2^24 guard's all-reduce of the world's bound (int32 programs: one
    int64 for the largest value or id, one a rank for its covered
    vertices), ahead of the loop. `final`: the all-reduce of the kernels'
    id flag (one int32) after it. The runner returns its rank's rows, as
    the reference's does; their assembly (`runner.gather`) is the
    caller's. The set-up and the final collectives are kept out of the
    link bytes a superstep. `pass_bytes` / `pass_flops`: one local
    pass of the kernel over this rank's rows, each input read once and each
    output written once (the stream as `engine._run_plan` pads it, lsrc,
    ldst and an f32 weight, 12 B an edge; the values in and out; the
    out-degree for sweeps; the iteration counts), two operations an edge."""

    program: str
    ranks: int
    rows: int
    arrays: dict
    reads: tuple
    values: int
    setup: tuple
    superstep: tuple
    final: tuple
    stream_edges: int
    pass_bytes: int
    pass_flops: int

    @property
    def arg_bytes(self) -> int:
        return sum(self.arrays.values()) + self.values

    @property
    def read_arg_bytes(self) -> int:
        return sum(self.arrays[k] for k in self.reads) + self.values

    def records(self, supersteps: int) -> list:
        """The collectives of a run of `supersteps` supersteps, in order."""
        return list(self.setup) + list(self.superstep) * supersteps + list(self.final)

    def collectives(self, supersteps: int = 1, final: bool = False) -> CollectiveSummary:
        """`supersteps` supersteps' collectives; with `final`, the whole
        run's (the set-up and the final ones too)."""
        return summarize_collectives(self.records(supersteps) if final
                                     else list(self.superstep) * supersteps)

    @property
    def link_bytes_per_superstep(self) -> float:
        return self.collectives().total_link_bytes


def plan_bsp(spec: SubgraphSpec, prog: VertexProgram, ranks: int, *,
             block_e: int = 512) -> BSPPlan:
    """The `BSPPlan` of one rank of `ranks` holding p/ranks subgraphs of
    `spec` under the distributed stepper of `prog` (a superstep's figures:
    a run's count enters through `BSPPlan.records(supersteps)`)."""
    prog = get_program(prog)
    p, m, n = spec.num_parts, spec.max_msg, spec.max_v + 1
    if p % ranks:
        raise ValueError(f"num_parts={p} must divide evenly over {ranks} ranks")
    nloc = p // ranks
    arrays = {k: math.prod(spec.array_shape(k, nloc))
              * torch.empty((), dtype=_DTYPES[_ARRAY_LAYOUT[k][0]]).element_size()
              for k in ARRAY_FIELDS}
    exchange = ("all-to-all", 4 * p * nloc * m, ranks)
    converge = (("all-gather", 4 * p, ranks) if prog.convergence == "tol"
                else ("all-reduce", 4, ranks))
    setup = (("all-reduce", 8 * (ranks + 1), ranks),) if prog.dtype == "int32" else ()
    final = (("all-reduce", 4, ranks),)
    E = spec.max_e * (2 if prog.local == "fixpoint" and prog.bidirectional else 1)
    blk = max(min(block_e, E), 1)
    E += (-E) % blk  # ops.pad_stream
    per_row = 12 * E + 8 * n + 4 + (4 * n if prog.local == "sweep" else 0)
    return BSPPlan(
        program=prog.name, ranks=ranks, rows=nloc, arrays=arrays, reads=superstep_reads(prog),
        values=4 * nloc * n, setup=setup, superstep=(exchange, exchange, converge), final=final,
        stream_edges=E, pass_bytes=nloc * per_row, pass_flops=2 * nloc * E,
    )


@dataclasses.dataclass
class LoweredBSP:
    """One rank's distributed BSP stepper and its plan (`GraphPipeline.lower`).

    `stepper` is the runner of `engine.make_distributed_stepper`, called
    with this rank's rows of the arrays and initial values (`rows`, the
    slice of subgraphs this rank holds) and returning its rows; `compile_s`
    lower's wall. PyTorch compiles nothing here: the CUDA kernels are built
    by `kernels.dispatch`, and the runner copies its rows and plans their
    stream at its first call."""

    spec: SubgraphSpec
    program: str
    mesh: object
    axes: tuple
    stepper: object
    rows: slice
    compile_s: float
    plan: BSPPlan

    def memory_analysis(self) -> PlanMemory:
        return PlanMemory(self.plan.arg_bytes, self.plan.read_arg_bytes)

    def cost_analysis(self) -> dict:
        """One local pass's operations and bytes (the reference's XLA keys)."""
        return {"flops": float(self.plan.pass_flops),
                "bytes accessed": float(self.plan.pass_bytes)}


# ------------------------------------------------------------------ pipeline


class GraphPipeline:
    """Fluent partition → build → engine → metrics session on one device
    (see the module docstring); `from_spec` makes an abstract one."""

    def __init__(self, graph: Optional[Graph], *, weights: Optional[np.ndarray] = None,
                 device=None):
        self.graph = graph
        # An abstract pipeline runs nothing here: its stepper runs on the
        # mesh's device.
        self.device = None if graph is None else resolve_device(device)
        self._spec: Optional[SubgraphSpec] = None
        self._weights = weights
        self._state: Optional[dict] = None  # partition-stage caches, shared by views
        self._build_params: Optional[dict] = None
        self._source: Optional[int] = None

    @classmethod
    def from_spec(cls, spec: SubgraphSpec) -> "GraphPipeline":
        """Abstract pipeline (shapes only): supports `.lower`, not `.run`."""
        pipe = cls(None)
        pipe._spec = spec
        return pipe

    def _clone(self, *, state=None, build_params=None) -> "GraphPipeline":
        pipe = GraphPipeline(self.graph, weights=self._weights, device=self.device)
        pipe._spec = self._spec
        pipe._state = self._state if state is None else state
        pipe._build_params = self._build_params if build_params is None else build_params
        pipe._source = self._source
        return pipe

    # ----------------------------------------------------------- partition

    def partition(
        self,
        partitioner: Union[str, PartitionerSpec] = "ebg",
        parts: int = 8,
        *,
        config: Optional[PartitionerConfig] = None,
        **overrides,
    ) -> "GraphPipeline":
        """Select a registered partitioner; returns a new pipeline view whose
        downstream stages are computed lazily and cached."""
        if self.graph is None:
            raise RuntimeError("abstract (from_spec) pipelines cannot partition a graph")
        spec = partitioner if isinstance(partitioner, PartitionerSpec) else get_partitioner(partitioner)
        check_num_parts(parts)
        cfg = spec.make_config(config, **overrides)
        spec.check_overrides(overrides)
        state = dict(spec=spec, config=cfg, parts=parts, result=None, metrics=None, builds={})
        return self._clone(state=state, build_params={})

    def _stage(self) -> dict:
        if self.graph is None:
            raise RuntimeError("abstract (from_spec) pipelines have no graph to partition, "
                               "build or run: they only .lower")
        if self._state is None:
            raise RuntimeError("no partition stage: call .partition(name, parts=...) first")
        return self._state

    @property
    def partitioner(self) -> PartitionerSpec:
        return self._stage()["spec"]

    @property
    def config(self) -> PartitionerConfig:
        return self._stage()["config"]

    @property
    def num_parts(self) -> int:
        return self._stage()["parts"]

    @property
    def result(self) -> PartitionResult:
        st = self._stage()
        if st["result"] is None:
            st["result"] = st["spec"].partition(
                self.graph, st["parts"], config=st["config"], device=self.device
            )
        return st["result"]

    @property
    def metrics(self) -> PartitionMetrics:
        st = self._stage()
        if st["metrics"] is None:
            st["metrics"] = partition_metrics(self.graph, self.result)
        return st["metrics"]

    # --------------------------------------------------------------- build

    def build(self, *, symmetrize: bool = False, pad_multiple: int = 8) -> "GraphPipeline":
        """Pin build parameters for subsequent `.run`/`.subgraphs` access."""
        self._stage()
        return self._clone(build_params=dict(symmetrize=symmetrize, pad_multiple=pad_multiple))

    def subgraphs_for(self, *, symmetrize: bool, pad_multiple: int = 8) -> SubgraphSet:
        st = self._stage()
        key = (bool(symmetrize), int(pad_multiple))
        if key not in st["builds"]:
            st["builds"][key] = build_subgraphs(
                self.graph, self.result, weights=self._weights, symmetrize=symmetrize,
                pad_multiple=pad_multiple, device=self.device,
            )
        return st["builds"][key]

    @property
    def subgraphs(self) -> SubgraphSet:
        bp = self._build_params or {}
        return self.subgraphs_for(
            symmetrize=bp.get("symmetrize", False), pad_multiple=bp.get("pad_multiple", 8)
        )

    def clear_builds(self) -> None:
        """Drop cached SubgraphSets (the partition result and metrics stay)."""
        if self._state is not None:
            self._state["builds"].clear()

    # ----------------------------------------------------------------- run

    def default_source(self) -> int:
        """SSSP/BFS source: the highest-degree covered vertex."""
        if self._source is None:
            cov = self.graph.covered_vertices()
            self._source = int(cov[np.argmax(self.graph.degrees()[cov])])
        return self._source

    def _build_params_for(self, prog: VertexProgram, symmetrize, pad_multiple) -> dict:
        # Explicit per-call arguments win over params pinned by `.build`,
        # which win over program defaults (bidirectional ones symmetrize).
        bp = dict(self._build_params or {})
        if symmetrize is not None:
            bp["symmetrize"] = symmetrize
        if pad_multiple is not None:
            bp["pad_multiple"] = pad_multiple
        bp.setdefault("symmetrize", bool(prog.bidirectional))
        bp.setdefault("pad_multiple", 8)
        return bp

    def _source_for(self, prog: VertexProgram, source) -> Optional[int]:
        if source is not None:
            return int(source)
        return self.default_source() if prog.needs_source else None

    def prepare(self, program: ProgramLike = "cc", *, symmetrize=None,
                pad_multiple: Optional[int] = None) -> "GraphPipeline":
        """Force partition + build (+ default source) caches, so a subsequent
        `.run` timing measures only the engine."""
        prog = _resolve_program(program)
        self.subgraphs_for(**self._build_params_for(prog, symmetrize, pad_multiple))
        if prog.needs_source:
            self.default_source()
        return self

    def run(
        self,
        program: ProgramLike = "cc",
        *,
        mode: str = "sim",
        symmetrize: Optional[bool] = None,
        pad_multiple: Optional[int] = None,
        source: Optional[int] = None,
        driver: Optional[str] = None,
        **kw,
    ) -> "PipelineRun":
        """Execute any registered program over the partitioned graph and
        collect stats. mode="sim" batches all workers on the pipeline's
        device; mode="dist" runs one subgraph a rank of a `torch.distributed`
        mesh (pass mesh=, and optionally axes=; the mesh's size must equal
        the number of parts), called on every rank — both through the same
        generic superstep, with the same values and stats. `driver` selects
        the sim step loop ("fused", the default, or "host"; identical values
        and stats). Extra kwargs flow to `run_bsp` (max_supersteps,
        inner_cap, exchange_period, tol, block_e, num_iters — the PageRank
        alias of max_supersteps — and damping), the fault-tolerance knobs
        among them: `checkpoint_every=k` with `ckpt_dir=` snapshots every k
        supersteps and `fault_plan=` injects a crash
        (`repro_torch.resilience.resume_bsp` continues the run); mode="dist"
        takes num_supersteps= (or max_supersteps= / num_iters=), inner_cap,
        tol and block_e."""
        if driver is not None:
            check_driver(driver)
            if mode != "sim":
                raise ValueError(
                    "driver= applies to mode='sim' only; mode='dist' always runs "
                    "the distributed stepper"
                )
            kw["driver"] = driver
        if mode not in ("sim", "dist"):
            raise ValueError(f"unknown mode {mode!r}; expected 'sim' or 'dist'")
        prog = _resolve_program(program)
        prog, kw = _translate_engine_kwargs(prog, kw)
        sub = self.subgraphs_for(**self._build_params_for(prog, symmetrize, pad_multiple))
        src = self._source_for(prog, source)
        if mode == "sim":
            values, stats = alg.run_program(
                sub, prog, num_vertices=self.graph.num_vertices, source=src, **kw
            )
        else:
            values, stats = self._run_distributed(prog, sub, source=src, **kw)
        return PipelineRun(pipeline=self, program=prog.name, values=values, stats=stats,
                           subgraphs=sub)

    def _run_distributed(
        self,
        prog: VertexProgram,
        sub: SubgraphSet,
        *,
        mesh,
        axes=None,
        num_supersteps: Optional[int] = None,
        max_supersteps: Optional[int] = None,
        inner_cap: int = 10_000,
        tol: float = 0.0,
        source: Optional[int] = None,
        block_e: int = 512,
    ) -> tuple[np.ndarray, BSPStats]:
        """mode="dist": the distributed stepper over `mesh`, one subgraph a
        rank; label-domain programs cross the kernels' value boundary as
        ranks (decoded on the way out)."""
        check_int32_kernel_labels(prog, sub)
        if max_supersteps is not None:  # sim-speak (and the num_iters alias)
            num_supersteps = max_supersteps
        if num_supersteps is None:
            num_supersteps = prog.default_steps or 30
        axes = _normalize_axes(mesh, axes)
        ndev = math.prod(axis_size(mesh, a) for a in axes)
        if ndev != sub.num_parts:
            raise ValueError(f"mesh axes {axes} span {ndev} devices but partition has "
                             f"{sub.num_parts} parts")
        arrays, statics = subgraphs_to_arrays(sub)
        stepper = make_distributed_stepper(
            mesh, axes, prog, statics,
            num_supersteps=num_supersteps, inner_cap=inner_cap, tol=tol,
            num_vertices=self.graph.num_vertices, block_e=block_e,
        )
        init = prog.init(sub, num_vertices=self.graph.num_vertices, source=source)
        # Rank compression is order-preserving, so it commutes with the
        # stepper's max→min negation; the output decodes below.
        init, codec = _kernel_value_boundary(prog, sub, init)
        # The stepper runs on this rank's rows; the whole set is assembled here.
        r = stepper.rows
        out = stepper({k: a[r] for k, a in arrays.items()}, init[r])
        val, _, steps, msgs_steps, iters_steps = stepper.gather(out)
        if codec is not None:
            val = codec.decode(val.to(sub.device))
        edges = as_numpy(sub.edge_mask.sum(dim=1)).astype(np.int64)
        stats = _assemble_stats(steps, as_numpy(msgs_steps[:steps]).astype(np.int64),
                                as_numpy(iters_steps[:steps]).astype(np.int64), edges)
        return as_numpy(val[:, :-1]), stats

    def run_batch(
        self,
        program: ProgramLike = "cc",
        sources=None,
        *,
        batch: Optional[int] = None,
        symmetrize: Optional[bool] = None,
        pad_multiple: Optional[int] = None,
        **kw,
    ) -> "BatchRun":
        """Run a [B] batch of point queries of ONE program in a single
        fused loop over the shared subgraph structure.

        Source-rooted programs (SSSP/BFS) take `sources` — a [B] sequence
        of vertex ids, each validated before anything runs; source-free
        programs take `batch` (B identical whole-graph queries). Each
        query's values and `BSPStats` are bit-identical to a one-source
        `.run` call: convergence masking freezes finished queries while
        stragglers run, and per-query stats report the supersteps that
        query actually paid. For a persistent admission-queue/cache
        serving loop over the same machinery, use `.serve()`.
        """
        prog = _resolve_program(program)
        prog, kw = _translate_engine_kwargs(prog, kw)
        sub = self.subgraphs_for(**self._build_params_for(prog, symmetrize, pad_multiple))
        vals, stats = run_bsp_batch(
            sub, prog, sources, batch=batch, num_vertices=self.graph.num_vertices, **kw
        )
        return BatchRun(
            pipeline=self,
            program=prog.name,
            values=as_numpy(vals[:, :, :-1]),
            stats=stats,
            subgraphs=sub,
            sources=tuple(int(s) for s in sources) if sources is not None else None,
        )

    # --------------------------------------------------------------- lower

    def lower(
        self,
        *,
        mesh,
        axes=None,
        program: ProgramLike = "cc",
        num_supersteps: int = 4,
        inner_cap: int = 64,
        tol: float = 0.0,
        symmetrize: Optional[bool] = None,
        pad_multiple: Optional[int] = None,
        num_vertices: Optional[int] = None,
        block_e: int = 512,
    ) -> LoweredBSP:
        """Build this rank's distributed BSP stepper over `mesh` (abstract
        or concrete pipeline) for ANY registered program, with its plan.

        The kernels run int32 programs (CC/BFS/REACH) through f32, exact
        only for labels below 2^24. Concrete pipelines are checked here
        (flat addressing; the runner checks the values it is given); an
        abstract (from_spec) pipeline has no labels to check, so the CALLER
        must keep the arrays and values it feeds the stepper below 2^24.
        Programs whose apply step renormalizes (PageRank) need
        `num_vertices=` when lowering from an abstract spec.
        """
        t0 = time.perf_counter()
        prog = get_program(program)
        axes = _normalize_axes(mesh, axes)
        nv = self.graph.num_vertices if self.graph is not None else int(num_vertices or 0)
        if prog.apply == "pagerank" and nv <= 0:
            raise ValueError(
                "lowering a pagerank-apply program from an abstract spec needs num_vertices="
            )
        if self._spec is not None:
            spec = self._spec
        else:
            sub = self.subgraphs_for(**self._build_params_for(prog, symmetrize, pad_multiple))
            check_int32_kernel_labels(prog, sub)
            spec = SubgraphSpec.of(sub)
        _, statics = spec.array_specs()
        stepper = make_distributed_stepper(
            mesh, axes, prog, statics, num_supersteps=num_supersteps, inner_cap=inner_cap,
            tol=tol, num_vertices=nv, block_e=block_e,
        )
        _, rank, w = axes_group(mesh, axes)
        plan = plan_bsp(spec, prog, w, block_e=block_e)
        return LoweredBSP(
            spec=spec, program=prog.name, mesh=mesh, axes=axes, stepper=stepper,
            rows=slice(rank * plan.rows, (rank + 1) * plan.rows),
            compile_s=time.perf_counter() - t0, plan=plan,
        )

    def serve(self, **server_kwargs) -> "GraphQueryServer":
        """Open a persistent query server over this pipeline's
        partitioned graph (admission queue, micro-batching, warm captured
        executables — see `repro_torch.serve.GraphQueryServer`)."""
        from repro_torch.serve import GraphQueryServer

        return GraphQueryServer(self, **server_kwargs)


@dataclasses.dataclass
class PipelineRun:
    """Result of one `GraphPipeline.run`: values + BSP stats + context."""

    pipeline: GraphPipeline
    program: str
    values: np.ndarray  # [p, max_v] per-(part, local-vertex) values
    stats: BSPStats
    subgraphs: SubgraphSet

    @property
    def metrics(self) -> PartitionMetrics:
        return self.pipeline.metrics

    @property
    def edges_per_worker(self) -> np.ndarray:
        return as_numpy(self.subgraphs.edge_mask.sum(dim=1))

    def to_global(self, reduce: str = "min") -> np.ndarray:
        """Per-vertex values collected from master replicas."""
        return alg.scatter_to_global(
            self.subgraphs, self.values, self.pipeline.graph.num_vertices, reduce=reduce
        )

    def num_components(self) -> int:
        """Distinct CC labels over covered vertices."""
        cov = self.pipeline.graph.covered_vertices()
        return int(np.unique(self.to_global()[cov]).shape[0])


@dataclasses.dataclass
class BatchRun:
    """Result of one `GraphPipeline.run_batch`: [B] queries of one program
    answered in one fused loop. `query(i)` views query i as a normal
    `PipelineRun` (same `.to_global()`, `.stats`, ... surface)."""

    pipeline: GraphPipeline
    program: str
    values: np.ndarray  # [B, p, max_v]
    stats: list  # [B] per-query BSPStats (each query's OWN supersteps)
    subgraphs: SubgraphSet
    sources: Optional[tuple]

    def __len__(self) -> int:
        return self.values.shape[0]

    def query(self, i: int) -> PipelineRun:
        return PipelineRun(
            pipeline=self.pipeline, program=self.program,
            values=self.values[i], stats=self.stats[i], subgraphs=self.subgraphs,
        )

    @property
    def supersteps_per_query(self) -> np.ndarray:
        """Supersteps each query actually paid under convergence masking
        (NOT B copies of the batch max)."""
        return np.asarray([s.supersteps for s in self.stats])
