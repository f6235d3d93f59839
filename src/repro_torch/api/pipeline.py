"""`GraphPipeline` — the end-to-end facade over the paper's stack (port of
`repro.api.pipeline`; its AOT half, `SubgraphSpec` and `.lower`, is not
ported).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np

from repro_torch.api.config import PartitionerConfig
from repro_torch.api.registry import PartitionerSpec, check_num_parts, get_partitioner
from repro_torch.core.metrics import PartitionMetrics, partition_metrics
from repro_torch.core.types import Graph, PartitionResult, as_numpy
from repro_torch.graph import algorithms as alg
from repro_torch.graph.build import SubgraphSet, build_subgraphs
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
from repro_torch.launch.mesh import axis_size

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


class GraphPipeline:
    """Fluent partition → build → engine → metrics session on one device."""

    def __init__(self, graph: Graph, *, weights: Optional[np.ndarray] = None, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._weights = weights
        self._state: Optional[dict] = None  # partition-stage caches, shared by views
        self._build_params: Optional[dict] = None
        self._source: Optional[int] = None

    def _clone(self, *, state=None, build_params=None) -> "GraphPipeline":
        pipe = GraphPipeline(self.graph, weights=self._weights, device=self.device)
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
        spec = partitioner if isinstance(partitioner, PartitionerSpec) else get_partitioner(partitioner)
        check_num_parts(parts)
        cfg = spec.make_config(config, **overrides)
        spec.check_overrides(overrides)
        state = dict(spec=spec, config=cfg, parts=parts, result=None, metrics=None, builds={})
        return self._clone(state=state, build_params={})

    def _stage(self) -> dict:
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
        val, _, steps, msgs_steps, iters_steps = stepper(arrays, init)
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
