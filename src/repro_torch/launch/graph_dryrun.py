"""Dry-run of the paper's subgraph-centric BSP engine at production scale
(port of `repro.launch.graph_dryrun`).

The reference AOT-lowers the shard_map'd stepper for p = 256 or 512
subgraphs (one a chip of one or two 16 × 16 pods) at Friendster-scale
padded sizes: |E| ≈ 3.6 B directed edges → ~8 M edges a subgraph, ~1 M
local vertices, 2,048-slot pairwise message buffers, and reads XLA's
estimates. The EBG balance guarantees (Theorems 1/2) are what make these
fixed paddings safe.

PyTorch has no compiled per-device cost analysis, and one card cannot hold
a 512-rank mesh. So the port runs rank 0 of the production world for real:
inside a fake world (`launch.mesh.fake_world`) it lays the production
mesh, lowers an abstract `GraphPipeline.from_spec(friendster_spec(p))`
(the plan reckons the arguments, one superstep's collectives and one local
pass from the shapes), then runs the stepper once on a synthetic shard at
the spec's full per-rank shapes, with every collective recorded
(`launch.roofline.record_collectives`) and none run. The record carries
the plan's figures beside what the run measured: the collectives, the
allocator's peak, the wall a superstep and the kernel launches.

The shard's labels are synthetic and below 2^24: the port runs CC, BFS
and REACH through the f32 kernels, exact only below 2^24, while Friendster
has 65,608,366 vertices. A real Friendster run would need its labels
rank-compressed under that bound, or the dense path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from repro_torch.api import GraphPipeline, SubgraphSpec, get_partitioner
from repro_torch.api.pipeline import ARRAY_FIELDS
from repro_torch.graph import engine
from repro_torch.graph.build import SubgraphSet
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import PRODUCTION_MESHES, fake_world, make_production_mesh
from repro_torch.launch.roofline import record_collectives, roofline_terms, summarize_collectives

# Friendster |V| — an abstract (shape-only) lowering has no graph to read it
# from, and renormalizing programs (PageRank) need it.
FRIENDSTER_NUM_VERTICES = 65_608_366
LABEL_LIMIT = 1 << 24  # the f32 kernels' exact label range
NOTE = ("one process ran rank 0 of a fake world of {p} ranks: the collectives were counted, "
        "not run (each all-to-all handed back this rank's send buffer); the shard is "
        "synthetic, its labels below 2^24")


def friendster_spec(p: int, max_v: int = 1 << 20, max_e: int = 8 << 20,
                    max_msg: int = 2048) -> SubgraphSpec:
    return SubgraphSpec(num_parts=p, max_v=max_v, max_e=max_e, max_msg=max_msg)


def synthetic_shard(spec: SubgraphSpec, prog, *, device, seed: int = 0):
    """One subgraph at the spec's full shapes, made on `device` from `seed`
    (an explicit `torch.Generator`), and the initial values of `prog` on
    it. Every edge slot is live, its local ids uniform in [0, max_v), with
    an f32 weight in [0, 1); the dst-sorted and src-sorted copies are sorted
    stably, as `graph/build.py` sorts them; local vertex v has global id v
    (labels below 2^24); the message tables are full: the mirrors a row
    sends are p·max_msg distinct vertices (so the broadcast writes each
    once), the masters they reach uniform ids, the vertices that send
    nothing its masters. Returns (arrays, init): the whole set's arrays and
    values as stride-0 `expand`ed views of the one subgraph, [p, ...]."""
    p, V, E, m = spec.num_parts, spec.max_v, spec.max_e, spec.max_msg
    if V > LABEL_LIMIT:
        raise ValueError(f"max_v={V}: the synthetic labels must stay below 2^24")
    if p * m > V:
        raise ValueError(f"full message tables need p·max_msg = {p * m} distinct mirrors, "
                         f"more than max_v={V}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    i32 = dict(dtype=torch.int32, device=device)
    src = torch.randint(0, V, (E,), generator=gen, **i32)
    dst = torch.randint(0, V, (E,), generator=gen, **i32)
    w = torch.rand((E,), generator=gen, device=device)
    by_dst = torch.sort(dst, stable=True).indices
    by_src = torch.sort(src, stable=True).indices
    mirrors = torch.randperm(V, generator=gen, device=device)[:p * m].to(torch.int32)
    is_master = torch.ones((V,), dtype=torch.bool, device=device)
    is_master[mirrors.long()] = False
    live_e = torch.ones((E,), dtype=torch.bool, device=device)
    full = torch.ones((p, m), dtype=torch.bool, device=device)
    one = dict(
        lsrc=src[by_dst], ldst=dst[by_dst], weight=w[by_dst], edge_mask=live_e,
        lsrc_s=src[by_src], ldst_s=dst[by_src], weight_s=w[by_src], edge_mask_s=live_e,
        gid=torch.arange(V, **i32), vmask=torch.ones((V,), dtype=torch.bool, device=device),
        is_master=is_master,
        out_degree=torch.bincount(src, minlength=V).to(torch.float32),
        send_idx=mirrors.reshape(p, m),
        recv_idx=torch.randint(0, V, (p, m), generator=gen, **i32),
        msg_mask=full, recv_mask=full,
    )
    row = {k: one[k][None] for k in ARRAY_FIELDS}
    sub = SubgraphSet(**row, num_parts=1, max_v=V, max_e=E, max_msg=m,
                      addressing=spec.addressing)
    init = engine.get_program(prog).init(sub, num_vertices=FRIENDSTER_NUM_VERTICES,
                                         source=0)
    arrays = {k: a.expand(p, *a.shape[1:]) for k, a in row.items()}
    return arrays, init.expand(p, init.shape[1])


@contextlib.contextmanager
def lowered_dryrun(*, multi_pod: bool = False, num_supersteps: int = 4, inner_cap: int = 64,
                   program: str = "cc", device=None, seed: int = 0, spec=None):
    """Inside a fake world of the production mesh's size: the mesh, the
    abstract pipeline lowered over all its axes (one subgraph a rank), and
    the synthetic shard. Yields (lowered, arrays, init); the world is
    destroyed on exit."""
    dev = dispatch.resolve_device(device)
    shape, _ = PRODUCTION_MESHES[bool(multi_pod)]
    p = math.prod(shape)
    spec = friendster_spec(p) if spec is None else spec
    if spec.num_parts != p:
        raise ValueError(f"the production mesh {shape} holds one subgraph a rank: "
                         f"num_parts must be {p}, got {spec.num_parts}")
    with fake_world(p):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
        low = GraphPipeline.from_spec(spec).lower(
            mesh=mesh, axes=tuple(mesh.mesh_dim_names), program=program,
            num_supersteps=num_supersteps, inner_cap=inner_cap,
            num_vertices=FRIENDSTER_NUM_VERTICES,
        )
        arrays, init = synthetic_shard(spec, program, device=dev, seed=seed)
        yield low, arrays, init


@dataclasses.dataclass
class DryRun:
    """What one run of a lowered stepper on its arrays gave: its outputs
    (this rank's rows),
    the collectives it recorded, its wall a superstep (CUDA events on the
    card, the host clock on the CPU), the launches, the device bytes of this
    rank's arguments and the allocator's peak."""

    values: torch.Tensor
    steps: int
    iters: torch.Tensor
    records: list
    superstep_ms: list
    clock: str
    launches: dict
    device_arg_bytes: int
    peak_bytes: object


def run_lowered(low, arrays, init) -> DryRun:
    """Run `low.stepper` once on this rank's rows (`low.rows`) of the whole
    set's (arrays, init) under `record_collectives`."""
    dev = arrays["lsrc"].device
    cuda = dev.type == "cuda"
    before = dict(dispatch.LAUNCHES)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    mine = {k: a[low.rows] for k, a in arrays.items()}
    with record_collectives() as rec:
        val, _, steps, _, iters = low.stepper(mine, init[low.rows])
    if cuda:
        torch.cuda.synchronize(dev)
    # Each superstep ends with its convergence collective (the third).
    first = len(low.plan.setup)
    ends = [r for i, r in enumerate(rec.records[first:first + 3 * steps]) if i % 3 == 2]
    if cuda:
        marks = [start] + [r.event for r in ends]
        superstep_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [t0] + [r.host_s for r in ends]
        superstep_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    sub = low.stepper.shard(mine)
    rows = low.rows.stop - low.rows.start
    held = sum(getattr(sub, k).numel() * getattr(sub, k).element_size() for k in ARRAY_FIELDS)
    launches = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()
                if v != before.get(k, 0)}
    return DryRun(
        values=val, steps=steps, iters=iters, records=rec.records, superstep_ms=superstep_ms,
        clock="cuda events" if cuda else "host", launches=launches,
        device_arg_bytes=held + 4 * rows * init.shape[1],
        peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
    )


def run_graph_dryrun(
    *,
    multi_pod: bool = False,
    num_supersteps: int = 4,
    inner_cap: int = 64,
    program: str = "cc",
    partitioner: str = "ebg_chunked",
    device=None,
    seed: int = 0,
    spec=None,
):
    """Lower the distributed stepper for any registered `VertexProgram`
    (`program="cc" | "sssp" | "pr" | "bfs" | "reach"`) at production scale,
    p = 256 (`multi_pod=False`) or 512, and run rank 0 of it once in a
    fake world on a synthetic shard (`spec`: `friendster_spec(p)` by
    default). On the card by default; `device="cpu"` runs the kernels'
    plain versions.

    `partitioner` names the registered streaming partitioner whose balance
    behaviour the fixed paddings assume (any EdgeScorer instance: EBV
    guarantees them through Theorems 1/2; hdrf/greedy bound edge balance
    through their range term); it is validated against the registry and
    recorded. The record has the reference's keys (no
    `compute_backend`): `arg_bytes`, `flops_per_device` and
    `hbm_bytes_per_device` from the plan (shapes: one local pass),
    `link_bytes_per_device` (a superstep) and `collectives` (the whole run,
    the guard's and the id flag's all-reduces included) from the recorded
    run, `temp_bytes` from the
    allocator's peak less `arg_bytes` (None on the CPU); and what the run
    measured beside them."""
    spec_p = get_partitioner(partitioner)
    if spec_p.scorer is None:
        raise ValueError(
            f"partitioner {partitioner!r} is not a streaming EdgeScorer instance; "
            "the dry-run paddings assume a balance-bounded streaming partitioner"
        )
    t0 = time.perf_counter()
    with lowered_dryrun(multi_pod=multi_pod, num_supersteps=num_supersteps,
                        inner_cap=inner_cap, program=program, device=device, seed=seed,
                        spec=spec) as (low, arrays, init):
        run = run_lowered(low, arrays, init)
        dev = arrays["lsrc"].device
    plan, p = low.plan, low.spec.num_parts
    recorded = summarize_collectives(run.records)
    first = len(plan.setup)
    per_step = summarize_collectives(run.records[first:first + 3 * run.steps])
    link = per_step.total_link_bytes / max(run.steps, 1)
    flops, hbm = float(plan.pass_flops), float(plan.pass_bytes)
    friendster = low.spec == friendster_spec(p)
    return dict(
        arch=f"graph_bsp_{low.program}",
        partitioner=spec_p.name,
        scorer=spec_p.scorer,
        shape=(f"p{p}_friendster_scale" if friendster else
               f"p{p}_v{low.spec.max_v}_e{low.spec.max_e}_m{low.spec.max_msg}"),
        mesh="2x16x16" if multi_pod else "16x16",
        chips=p,
        compile_s=low.compile_s,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        link_bytes_per_device=link,
        collectives=recorded.per_op,
        arg_bytes=plan.arg_bytes,
        temp_bytes=None if run.peak_bytes is None else run.peak_bytes - plan.arg_bytes,
        per_device_hbm_total=run.peak_bytes,
        **roofline_terms(flops, hbm, link),
        world="fake",
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        plan_link_bytes_per_superstep=plan.link_bytes_per_superstep,
        plan_collectives=plan.collectives(run.steps, final=True).per_op,
        collectives_count=len(run.records),
        device_arg_bytes=run.device_arg_bytes,
        read_arg_bytes=plan.read_arg_bytes,
        supersteps=run.steps,
        superstep_ms=run.superstep_ms,
        # The first superstep also pays the runner's set-up: the 2^24 guard
        # over this rank's values and its all-reduce, the shard's run plan,
        # the allocator's first blocks.
        first_superstep_ms=run.superstep_ms[0] if run.superstep_ms else None,
        ms_per_superstep=(sum(run.superstep_ms[1:]) / (len(run.superstep_ms) - 1)
                          if len(run.superstep_ms) > 1 else None),
        clock=run.clock,
        inner_iters_per_superstep=run.iters[:run.steps, 0].tolist(),
        bsp_superstep_launches=run.launches.get(
            "bsp_superstep.sum" if engine.get_program(program).local == "sweep"
            else "bsp_superstep.min", 0),
        launches=run.launches,
        stream_edges=plan.stream_edges,
        run_s=time.perf_counter() - t0,
        note=NOTE.format(p=p),
    )
