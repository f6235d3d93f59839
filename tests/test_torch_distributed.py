"""Port parity, the distributed engine on the CPU over gloo: the stepper
(`engine.make_distributed_stepper`), `GraphPipeline.run(mode="dist")` and
the out-of-core `partition_store(state_layout="sharded")`.

A world of 1 runs in this process; worlds of 2 and 4 are spawned ranks
(`python -c CHILD` with RANK and WORLD_SIZE set, a `file://` rendezvous
under the test's temporary directory, a 60 s collective timeout and a
120 s process timeout), started when the module starts and run beside
the in-process tests: every rank runs every case, writes what it got to
an .npz, and the tests here compare.
The ranks import only torch, numpy and repro_torch; this process runs the
JAX reference and carries its sets across (`interop`).

Exact: CC/SSSP/BFS/REACH values, steps and every stats buffer against the
reference's sim driver on the same `SubgraphSet`; the port's dist run
against its sim run, PageRank included (the exchange delivers the senders
in the sim's order, so the one-sender-at-a-time sums are the same); every
rank's result equal. Tolerance: PageRank values against the reference,
rtol 1e-5 / atol 1e-8 (f32 sums in another order). PageRank with tol:
each subgraph's L1 delta, gathered across the ranks and added in the
simulation's order (`engine.l1_total`), so dist stops where sim does
even at a tol equal to a superstep's delta (worlds 2 and 4); against the
reference, tol=1e-4, which this graph's deltas do not come near.
Out-of-core: assignments and both counters, sharded against replicated
and against the reference's replicated layout, bitwise.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compat import make_mesh_compat
from repro.core import PARTITIONERS
from repro.core import outofcore as ref_oc
from repro.data import edgeshards as ref_es
from repro.graph import algorithms as ref_alg
from repro.graph import engine as ref_eng
from repro.graph.build import build_subgraphs as ref_build
from repro.graph.generate import rmat as ref_rmat
from repro_torch import interop
from repro_torch.core import outofcore as oc
from repro_torch.data import edgeshards as es
from repro_torch.graph import engine as eng
from repro_torch.launch import mesh as pt_mesh
from repro_torch.resilience import FaultPlan, WorkerCrashError

SRC = str(Path(__file__).resolve().parents[1] / "src")
RTOL, ATOL = 1e-5, 1e-8
PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
# (name, program, stepper knobs) — each run by the stepper and by run_bsp.
CASES = {
    "cc": ("cc", dict(num_supersteps=30, inner_cap=100)),
    "sssp": ("sssp", dict(num_supersteps=30, inner_cap=100)),
    "bfs": ("bfs", dict(num_supersteps=30, inner_cap=3)),
    "reach": ("reach", dict(num_supersteps=30, inner_cap=100)),
    "pr": ("pr", dict(num_supersteps=20, inner_cap=1)),
    "pr_tol": ("pr", dict(num_supersteps=50, inner_cap=1, tol=1e-4)),
}
PARTS = 8  # the spawned worlds' stepper: nloc 4 at w=2, 2 at w=4
OOC = dict(V=1 << 10, E=1 << 12, P=4, block=128)
OOC_CASES = [(s, c) for s in ("ebv", "hdrf") for c in ("frozen", "window")]
WORLDS = (2, 4)
TIE_STEPS = range(2, 16)  # the supersteps whose sim L1 delta the tie test takes as tol

CHILD = r"""
import datetime, json, os, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
work = Path(os.environ["DIST_WORK"])
dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.core import outofcore as oc
from repro_torch.data import edgeshards as es
from repro_torch.graph import engine as eng
from repro_torch.launch.mesh import make_host_mesh

job = json.loads((work.parent / "job.json").read_text())
inputs = np.load(work.parent / "inputs.npz")
mesh = make_host_mesh(device_type="cpu")
out, errors = {}, {}


def catch(name, fn):
    try:
        fn()
    except ValueError as e:
        errors[name] = str(e)


subs = {}
for kind in ("sym", "dir"):
    arrays = {k: inputs[f"{kind}_{k}"] for k in interop.ARRAY_FIELDS}
    subs[kind] = interop.subgraphs_from_numpy(arrays, **job["statics"][kind], device="cpu")
for case, (prog, kw) in job["cases"].items():
    sub = subs["sym" if prog in ("cc", "reach") else "dir"]
    arrays, statics = eng.subgraphs_to_arrays(sub)
    init = eng.get_program(prog).init(sub, num_vertices=job["V"], source=job["source"])
    runner = eng.make_distributed_stepper(mesh, "workers", prog, statics,
                                          num_vertices=job["V"], **kw)
    r = runner.rows  # this rank's rows in, the whole set gathered out
    val, msgs, steps, ms, its = runner.gather(runner({k: a[r] for k, a in arrays.items()},
                                                     init[r]))
    out.update({f"step_{case}_val": val.numpy(), f"step_{case}_msgs": msgs.numpy(),
                f"step_{case}_steps": np.int64(steps), f"step_{case}_ms": ms.numpy(),
                f"step_{case}_its": its.numpy()})

g = interop.graph_from_numpy(inputs["pipe_src"], inputs["pipe_dst"], job["pipe_V"])
pipe = GraphPipeline(g, device="cpu").partition("ebg_chunked", parts=world, block=64)
for prog in job["programs"]:
    kw = dict(num_iters=10) if prog == "pr" else {}
    sim = pipe.run(prog, **kw)
    dst = pipe.run(prog, mode="dist", mesh=mesh, **(kw or dict(num_supersteps=30)))
    for mode, r in (("sim", sim), ("dist", dst)):
        out[f"pipe_{prog}_{mode}_values"] = r.values
        out[f"pipe_{prog}_{mode}_steps"] = np.int64(r.stats.supersteps)
        for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
                  "inner_iters_per_step", "comp_work_per_worker"):
            out[f"pipe_{prog}_{mode}_{f}"] = getattr(r.stats, f)
# PageRank's tol stop at a tie: tol equal to the sim run's L1 delta at
# superstep k (as the engine adds it), and the next float above it.
ties, prev = [], torch.from_numpy(pipe.run("pr", num_iters=job["tie_steps"][0] - 1).values)
for k in job["tie_steps"]:
    at = torch.from_numpy(pipe.run("pr", num_iters=k).values)
    tie = eng.l1_total(eng.l1_rows(at[None], prev[None], at.shape[1])).numpy()[0]
    ties += [(f"exact{k}", tie), (f"above{k}", np.nextafter(tie, np.float32(np.inf)))]
    prev = at
for name, t in ties:
    out[f"tie_{name}_tol"] = np.float32(t)
    for mode in ("sim", "dist"):
        r = pipe.run("pr", num_iters=50, tol=float(t),
                     **(dict(mode="dist", mesh=mesh) if mode == "dist" else {}))
        out[f"tie_{name}_{mode}_values"] = r.values
        out[f"tie_{name}_{mode}_steps"] = np.int64(r.stats.supersteps)
        for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
                  "inner_iters_per_step", "comp_work_per_worker"):
            out[f"tie_{name}_{mode}_{f}"] = getattr(r.stats, f)
catch("driver", lambda: pipe.run("cc", mode="dist", mesh=mesh, driver="host"))
catch("mode", lambda: pipe.run("cc", mode="bogus", mesh=mesh))
wider = GraphPipeline(g, device="cpu").partition("ebg_chunked", parts=2 * world, block=64)
catch("parts", lambda: wider.run("cc", mode="dist", mesh=mesh))

if job["ooc"] and world == 2:
    store = es.EdgeShardStore.open(work.parent / "store")
    for scorer, commit in job["ooc_cases"]:
        for layout in ("sharded", "replicated"):
            r = oc.partition_store(store, job["ooc_P"], scorer, block=job["ooc_block"],
                                   commit=commit, state_layout=layout, mesh=mesh,
                                   order_workdir=work / f"order_{scorer}_{commit}_{layout}",
                                   device="cpu")
            key = f"ooc_{scorer}_{commit}_{layout}"
            out.update({f"{key}_part": r.result.part.numpy(), f"{key}_e": r.e_count,
                        f"{key}_v": r.v_count})
    catch("ooc_parts", lambda: oc.partition_store(store, 3, "ebv", state_layout="sharded",
                                                  mesh=mesh, device="cpu"))
errors["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
np.savez(work / f"rank{rank}.npz", **out)
(work / f"rank{rank}_errors.json").write_text(json.dumps(errors))
dist.destroy_process_group()
"""


def assert_stats_equal(a, b):
    assert a.supersteps == b.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _source(g):
    cov = g.covered_vertices()
    return int(cov[np.argmax(g.degrees()[cov])])


def _carried(g, parts):
    """{symmetrize: (reference SubgraphSet, port SubgraphSet)} of the
    reference's EBG partition of `g` into `parts`."""
    res = PARTITIONERS["ebg"](g, parts)
    out = {}
    for sym in (True, False):
        ref = ref_build(g, res, symmetrize=sym)
        out[sym] = (ref, interop.to_port(ref, device="cpu"))
    return out


def _ref_sim(g, ref_sub, prog, kw):
    kw = dict(kw)
    return ref_alg.run_program(
        ref_sub, prog, compute_backend="xla", num_vertices=g.num_vertices,
        source=_source(g) if prog in ("sssp", "bfs") else None,
        max_supersteps=kw.pop("num_supersteps"), **kw)


def _port_sim(g, sub, prog, kw):
    kw = dict(kw)
    val, st = eng.run_bsp(sub, prog, num_vertices=g.num_vertices,
                          source=_source(g) if prog in ("sssp", "bfs") else None,
                          max_supersteps=kw.pop("num_supersteps"), **kw)
    return val.numpy(), st


def _stepper_stats(steps, ms, its, sub):
    edges = sub.edge_mask.sum(dim=1).numpy().astype(np.int64)
    return eng._assemble_stats(int(steps), np.asarray(ms)[:steps].astype(np.int64),
                               np.asarray(its)[:steps].astype(np.int64), edges)


def _check_against_sims(g, pair, prog, kw, val, msgs, steps, ms, its):
    """The stepper's output against the reference's and the port's sim runs
    on the same set."""
    ref_sub, sub = pair
    val = np.asarray(val)
    r_val, r_st = _ref_sim(g, ref_sub, prog, kw)
    p_val, p_st = _port_sim(g, sub, prog, kw)
    st = _stepper_stats(steps, ms, its, sub)
    assert steps == r_st.supersteps
    assert_stats_equal(st, r_st)
    np.testing.assert_array_equal(np.asarray(msgs), r_st.messages_per_worker)
    assert not np.asarray(ms)[steps:].any() and not np.asarray(its)[steps:].any()
    np.testing.assert_array_equal(val, p_val)  # bitwise, PageRank too
    assert_stats_equal(st, p_st)
    if prog == "pr":
        np.testing.assert_allclose(val[:, :-1], np.asarray(r_val), rtol=RTOL, atol=ATOL)
    else:
        assert val.dtype == np.asarray(r_val).dtype
        np.testing.assert_array_equal(val[:, :-1], np.asarray(r_val))


# ------------------------------------------------------------ world of 1


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of 1 in this process, and its mesh."""
    path = tmp_path_factory.mktemp("world1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield pt_mesh.make_host_mesh(device_type="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def carried4(small_powerlaw):
    return _carried(small_powerlaw, 4)


def _run_stepper(mesh, pair, g, prog, kw, **extra):
    _, sub = pair
    arrays, statics = eng.subgraphs_to_arrays(sub)
    init = eng.get_program(prog).init(sub, num_vertices=g.num_vertices,
                                      source=_source(g) if prog in ("sssp", "bfs") else None)
    runner = eng.make_distributed_stepper(mesh, "workers", prog, statics,
                                          num_vertices=g.num_vertices, **kw, **extra)
    return runner(arrays, init)


@pytest.mark.parametrize("case", CASES)
def test_stepper_world1_matches_sim(world1, carried4, small_powerlaw, case):
    """p = 4 on one rank (nloc 4): the exchange is an all_to_all of the
    rank with itself."""
    prog, kw = CASES[case]
    pair = carried4[prog in ("cc", "reach")]
    out = _run_stepper(world1, pair, small_powerlaw, prog, kw)
    _check_against_sims(small_powerlaw, pair, prog, kw, *out)
    if case == "pr_tol":
        assert out[2] < kw["num_supersteps"]  # tol fired


@pytest.mark.parametrize("prog", PROGRAMS)
def test_stepper_world1_matches_reference_stepper(world1, small_powerlaw, prog):
    """Against the reference's own distributed stepper on a 1-device mesh
    (its untiled all_to_all takes one subgraph a device, so p = 1)."""
    pair = _carried(small_powerlaw, 1)[prog in ("cc", "reach")]
    ref_sub, sub = pair
    kw = CASES[prog][1]
    mesh = make_mesh_compat((1,), ("workers",))
    arrays, statics = ref_eng.subgraphs_to_arrays(ref_sub)
    ref_runner = ref_eng.make_distributed_stepper(
        mesh, "workers", prog, statics, num_vertices=small_powerlaw.num_vertices, **kw)
    init = ref_eng.get_program(prog).init(
        ref_sub, num_vertices=small_powerlaw.num_vertices,
        source=_source(small_powerlaw) if prog in ("sssp", "bfs") else None)
    with mesh:
        r_val, r_msgs, r_steps, r_ms, r_its = ref_runner(arrays, init)
    val, msgs, steps, ms, its = _run_stepper(world1, pair, small_powerlaw, prog, kw)
    assert steps == int(r_steps)
    for got, want in ((msgs, r_msgs), (ms, r_ms), (its, r_its)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if prog == "pr":
        np.testing.assert_allclose(val.numpy(), np.asarray(r_val), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(val.numpy(), np.asarray(r_val))


def test_stepper_counts_host_syncs(world1, carried4, small_powerlaw):
    """"dist" counts a superstep a dispatch, and a host sync a superstep
    whose flag can stop the run, plus one for the 2^24 guard's bound
    (int32 programs) and one for the id flag at the end."""
    d0, h0 = eng.DISPATCH_COUNTS["dist"], eng.HOST_SYNCS["dist"]
    out = _run_stepper(world1, carried4[True], small_powerlaw, *CASES["cc"])
    steps = out[2]
    assert eng.DISPATCH_COUNTS["dist"] - d0 == steps
    assert eng.HOST_SYNCS["dist"] - h0 == steps + 2
    h0 = eng.HOST_SYNCS["dist"]
    out = _run_stepper(world1, carried4[False], small_powerlaw, *CASES["pr"])
    assert out[2] == 20 and eng.HOST_SYNCS["dist"] - h0 == 1  # tol 0: no flag to read


def test_stepper_crash_hook(world1, small_powerlaw):
    """fault_plan caps the superstep budget at the crash point and raises;
    the same stepper without a plan completes past it."""
    pair = _carried(small_powerlaw, 1)[True]
    kw = dict(num_supersteps=10, inner_cap=100)
    with pytest.raises(WorkerCrashError, match="superstep 1"):
        _run_stepper(world1, pair, small_powerlaw, "cc", kw,
                     fault_plan=FaultPlan(crash_at_superstep=1))
    assert _run_stepper(world1, pair, small_powerlaw, "cc", kw)[2] > 1


def test_stepper_rejects_huge_vertex_ids_before_any_collective(world1, carried4, monkeypatch):
    """Flat ids >= 2^24 raise the named ValueError before any remap or
    collective but the guard's own all_reduce of the world's bound (every
    other collective is made to fail here)."""
    _, sub = carried4[True]
    big = dataclasses.replace(sub, gid=torch.where(sub.vmask, sub.gid + (1 << 24), sub.gid),
                              addressing="flat")
    arrays, statics = eng.subgraphs_to_arrays(big)
    runner = eng.make_distributed_stepper(world1, "workers", "cc", statics, num_supersteps=4,
                                          inner_cap=100)

    def no_collective(*a, **k):
        raise AssertionError("a collective ran before the guard")

    real_all_reduce, guards = eng.dist.all_reduce, []

    def guard_only(t, *a, **k):
        if guards:
            no_collective()
        guards.append(t.dtype)
        return real_all_reduce(t, *a, **k)

    for name in ("all_to_all_single", "all_gather"):
        monkeypatch.setattr(eng.dist, name, no_collective)
    monkeypatch.setattr(eng.dist, "all_reduce", guard_only)
    with pytest.raises(ValueError, match="vertex ids"):
        runner(arrays, eng.init_cc(big))
    assert guards == [torch.int64]


@pytest.mark.parametrize("prog", ["cc", "pr"])
def test_run_plan_of_a_shard_is_its_rows(carried4, prog):
    """A shard of nloc < p rows plans the matching rows of the whole set's
    plan (the tables' rows come from the tensors, not num_parts)."""
    _, sub = carried4[prog == "cc"]
    exec_prog, _ = eng._exec_view(eng.get_program(prog))
    whole = eng._run_plan(exec_prog, sub, 64)
    rows = slice(1, 3)
    shard = dataclasses.replace(sub, **{k: getattr(sub, k)[rows] for k in eng._ARRAY_FIELDS})
    part = eng._run_plan(exec_prog, shard, 64)
    for f in ("send_idx", "recv_idx", "bcast_idx", "out_degree"):
        a, b = getattr(part, f), getattr(whole, f)
        if a is None:
            assert b is None
            continue
        assert torch.equal(a, b[rows]), f
    n = part.lsrc.shape[1]
    for f in ("lsrc", "ldst", "weight"):
        assert torch.equal(getattr(part, f), getattr(whole, f)[rows, :n]), f


def test_make_host_mesh_rules(monkeypatch):
    """No fallback: without a card the default raises; without a default
    process group any mesh raises, naming init_process_group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_mesh.make_host_mesh()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        pt_mesh.make_host_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        pt_mesh.make_host_mesh(device_type="tpu")


def test_mesh_axes_rules(world1):
    assert pt_mesh.axis_size(world1, "workers") == 1 and pt_mesh.mesh_size(world1) == 1
    assert pt_mesh.dp_axes(world1) == ("workers",)
    group, rank, w = pt_mesh.axes_group(world1, ("workers",))
    assert (rank, w) == (0, 1) and dist.get_world_size(group) == 1
    with pytest.raises(ValueError, match="no dimension"):
        pt_mesh.axes_group(world1, "model")
    with pytest.raises(ValueError, match="world size"):
        pt_mesh.make_host_mesh(2, device_type="cpu")
    # Several axes: every dimension of a mesh over the world, in order.
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("pod", "data"))
    group, rank, w = pt_mesh.axes_group(grid, ("pod", "data"))
    assert group is dist.group.WORLD and (rank, w) == (0, 1)
    assert pt_mesh.dp_axes(grid) == ("pod", "data")
    with pytest.raises(ValueError, match="every dimension"):
        pt_mesh.axes_group(grid, ("data", "pod"))


def test_stepper_over_several_axes(world1, carried4, small_powerlaw):
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("pod", "data"))
    pair = carried4[True]
    _, sub = pair
    arrays, statics = eng.subgraphs_to_arrays(sub)
    runner = eng.make_distributed_stepper(grid, ("pod", "data"), "cc", statics,
                                          **CASES["cc"][1])
    _check_against_sims(small_powerlaw, pair, "cc", CASES["cc"][1],
                        *runner(arrays, eng.init_cc(sub)))


# ------------------------------------------------ out-of-core, world of 1


@pytest.fixture(scope="module")
def ooc_graph():
    return ref_rmat(OOC["V"], OOC["E"], seed=3)


@pytest.fixture(scope="module")
def ooc_stores(ooc_graph, tmp_path_factory):
    """(port store, reference store) of the same graph, shards of 500."""
    base = tmp_path_factory.mktemp("ooc")
    g = interop.graph_from_numpy(ooc_graph.src, ooc_graph.dst, ooc_graph.num_vertices)
    return (es.write_graph(g, base / "store", shard_edges=500),
            ref_es.write_graph(ooc_graph, base / "ref_store", shard_edges=500))


@pytest.fixture(scope="module")
def ooc_reference(ooc_stores, tmp_path_factory):
    """The reference's replicated bitset layout for every OOC case."""
    base = tmp_path_factory.mktemp("ooc_ref")
    out = {}
    for scorer, commit in OOC_CASES:
        r = ref_oc.partition_store(ooc_stores[1], OOC["P"], scorer, block=OOC["block"],
                                   compute_backend="ref", commit=commit,
                                   order_workdir=base / f"{scorer}_{commit}")
        out[scorer, commit] = (np.asarray(r.result.part), np.asarray(r.e_count),
                               np.asarray(r.v_count))
    return out


def _assert_ooc_equal(got, want):
    for a, b, what in zip(got, want, ("parts", "e_count", "v_count")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("scorer,commit", OOC_CASES)
def test_sharded_outofcore_world1(world1, ooc_stores, ooc_reference, tmp_path, scorer, commit):
    kw = dict(block=OOC["block"], commit=commit, device="cpu")
    sh = oc.partition_store(ooc_stores[0], OOC["P"], scorer, state_layout="sharded",
                            mesh=world1, order_workdir=tmp_path / "s", **kw)
    rep = oc.partition_store(ooc_stores[0], OOC["P"], scorer, order_workdir=tmp_path / "r", **kw)
    got = (sh.result.part.numpy(), sh.e_count, sh.v_count)
    _assert_ooc_equal(got, (rep.result.part.numpy(), rep.e_count, rep.v_count))
    _assert_ooc_equal(got, ooc_reference[scorer, commit])
    assert sh.num_blocks == rep.num_blocks


@pytest.mark.parametrize("layout", ["sharded", "replicated"])
def test_outofcore_order_dir_a_rank(world1, ooc_stores, tmp_path, layout):
    """Under torch.distributed every rank sorts the stream itself, into a
    directory of its own under the shared order_workdir (the spawned world
    of 2 above shares one workdir between its ranks)."""
    oc.partition_store(ooc_stores[0], OOC["P"], "ebv", block=OOC["block"], device="cpu",
                       state_layout=layout, mesh=world1, order_workdir=tmp_path / "o")
    assert list((tmp_path / "o" / "rank0").glob("bucket-*.bin"))
    assert not list((tmp_path / "o").glob("bucket-*.bin"))


def test_sharded_outofcore_checks_its_mesh(world1, ooc_stores):
    """num_parts must divide over the mesh (checked before any collective:
    a 3-wide stand-in mesh), and the mesh must be on the state's device."""
    three = types.SimpleNamespace(shape=(3,), mesh_dim_names=("workers",), device_type="cpu")
    with pytest.raises(ValueError, match="divide evenly over 3"):
        oc.partition_store(ooc_stores[0], 4, "ebv", state_layout="sharded", mesh=three,
                           device="cpu")
    card = types.SimpleNamespace(shape=(1,), mesh_dim_names=("workers",), device_type="cuda")
    with pytest.raises(ValueError, match="partition state"):
        oc.partition_store(ooc_stores[0], 4, "ebv", state_layout="sharded", mesh=card,
                           device="cpu")


# -------------------------------------------------- spawned worlds of 2, 4


@pytest.fixture(scope="module", autouse=True)
def spawning(tmp_path_factory, small_powerlaw, tiny_powerlaw, ooc_graph):
    """Starts the worlds of 2 and 4 when the module starts, so that they
    run beside the in-process tests; `spawned` waits for them."""
    base = tmp_path_factory.mktemp("spawned")
    carried = _carried(small_powerlaw, PARTS)
    inputs, statics = {}, {}
    for sym, kind in ((True, "sym"), (False, "dir")):
        arrays, st = interop.subgraph_fields(carried[sym][0])
        inputs.update({f"{kind}_{k}": a for k, a in arrays.items()})
        statics[kind] = st
    inputs.update(pipe_src=tiny_powerlaw.src, pipe_dst=tiny_powerlaw.dst)
    np.savez(base / "inputs.npz", **inputs)
    g = interop.graph_from_numpy(ooc_graph.src, ooc_graph.dst, ooc_graph.num_vertices)
    es.write_graph(g, base / "store", shard_edges=500)
    (base / "job.json").write_text(json.dumps(dict(
        statics=statics, cases=CASES, V=small_powerlaw.num_vertices,
        source=_source(small_powerlaw), programs=PROGRAMS, pipe_V=tiny_powerlaw.num_vertices,
        ooc=True, ooc_cases=OOC_CASES, ooc_P=OOC["P"], ooc_block=OOC["block"],
        tie_steps=list(TIE_STEPS))))
    procs = []
    for w in WORLDS:
        work = base / f"w{w}"
        work.mkdir()
        for r in range(w):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(w), DIST_WORK=str(work),
                       PYTHONPATH=SRC, OMP_NUM_THREADS="1")
            procs.append((w, r, subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                                 stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    yield base, procs, carried
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def spawned(spawning):
    """{w: ([per-rank outputs], [per-rank errors], the carried p = 8
    sets)}, once every rank has exited (each within 120 s of the wait)."""
    base, procs, carried = spawning
    failed = []
    for w, r, proc in procs:
        try:
            log, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for _, _, other in procs:
                other.kill()
            log, _ = proc.communicate()
            failed.append(f"world {w} rank {r} timed out:\n{log}")
            continue
        if proc.returncode:
            failed.append(f"world {w} rank {r} exited {proc.returncode}:\n{log}")
    assert not failed, "\n".join(failed)
    out = {}
    for w in WORLDS:
        work = base / f"w{w}"
        out[w] = ([dict(np.load(work / f"rank{r}.npz")) for r in range(w)],
                  [json.loads((work / f"rank{r}_errors.json").read_text()) for r in range(w)],
                  carried)
    return out


def _ranks_agree(outs, prefix):
    """Every rank returned the same arrays under `prefix`; rank 0's."""
    keys = [k for k in outs[0] if k.startswith(prefix)]
    assert keys, prefix
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return {k[len(prefix):]: outs[0][k] for k in keys}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_stepper_spawned_matches_sim(spawned, small_powerlaw, w, case):
    """p = 8 over w ranks (nloc 8/w): every rank's result, and against the
    reference's and the port's sim runs on the same set."""
    outs, _, carried = spawned[w]
    prog, kw = CASES[case]
    got = _ranks_agree(outs, f"step_{case}_")
    _check_against_sims(small_powerlaw, carried[prog in ("cc", "reach")], prog, kw,
                        got["val"], got["msgs"], int(got["steps"]), got["ms"], got["its"])


@pytest.mark.parametrize("prog", PROGRAMS)
@pytest.mark.parametrize("w", WORLDS)
def test_pipeline_dist_matches_sim_spawned(spawned, w, prog):
    """GraphPipeline.run(mode="dist") on a mesh of w ranks, p = w: values
    and every BSPStats field equal to mode="sim"."""
    outs, _, _ = spawned[w]
    got = _ranks_agree(outs, f"pipe_{prog}_")
    for k in [k for k in got if k.startswith("sim_")]:
        np.testing.assert_array_equal(got["dist_" + k[4:]], got[k], err_msg=k[4:])
    assert got["dist_comp_work_per_worker"].sum() > 0
    assert got["dist_messages_per_worker"].shape == (w,)


@pytest.mark.parametrize("step", TIE_STEPS)
@pytest.mark.parametrize("tie", ["exact", "above"])
@pytest.mark.parametrize("w", WORLDS)
def test_pipeline_dist_tol_tie_spawned(spawned, w, tie, step):
    """PageRank with tol equal to the sim run's L1 delta at superstep
    `step` ("exact": that delta is not below it, so the run goes past it)
    and the next float above it ("above": the run stops there at the
    latest). mode="dist" stops where mode="sim" does, with the same values
    and every BSPStats field equal: both add the subgraphs' deltas in one
    order. (Summed rank by rank, as before, some of these stop a superstep
    apart.)"""
    outs, _, _ = spawned[w]
    got = _ranks_agree(outs, f"tie_{tie}{step}_")
    if tie == "above":
        assert got["sim_steps"] <= step
    else:
        assert got["sim_steps"] > step
    for k in [k for k in got if k.startswith("sim_")]:
        np.testing.assert_array_equal(got["dist_" + k[4:]], got[k], err_msg=k[4:])


@pytest.mark.parametrize("w", WORLDS)
def test_pipeline_dist_errors_spawned(spawned, w):
    _, errors, _ = spawned[w]
    for e in errors:
        assert "parts" in e["parts"]
        assert "driver=" in e["driver"]
        assert "unknown mode" in e["mode"]


@pytest.mark.parametrize("scorer,commit", OOC_CASES)
def test_sharded_outofcore_world2(spawned, ooc_reference, scorer, commit):
    outs, errors, _ = spawned[2]
    got = _ranks_agree(outs, f"ooc_{scorer}_{commit}_")
    sharded = (got["sharded_part"], got["sharded_e"], got["sharded_v"])
    _assert_ooc_equal(sharded, (got["replicated_part"], got["replicated_e"],
                                got["replicated_v"]))
    _assert_ooc_equal(sharded, ooc_reference[scorer, commit])
    assert all("divide evenly over 2" in e["ooc_parts"] for e in errors)


@pytest.mark.parametrize("w", WORLDS)
def test_spawned_ranks_import_neither_jax_nor_the_reference(spawned, w):
    _, errors, _ = spawned[w]
    assert all(e["imported"] == [] for e in errors)
