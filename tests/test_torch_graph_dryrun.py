"""Port parity, the graph engine's AOT half on the CPU: `SubgraphSpec`,
`GraphPipeline.from_spec` / `.lower` and its plan, `launch.roofline`,
`launch.mesh.make_production_mesh` / `fake_world` and
`launch.graph_dryrun`, against the reference's `repro.api.pipeline`,
`repro.launch.roofline` and its XLA lowering.

Exact: the specs' keys, shapes, dtypes and statics; `summarize_collectives`
against `parse_collectives` on the same numbers; `model_flops`; the plan's
byte counts at Friendster size; a lowered stepper's values and every stat
against `mode="sim"` and the reference's sim (PageRank against the
reference to rtol 1e-5 / atol 1e-8: f32 sums in another order); every
recorded collective against the plan. `roofline_terms` to rtol 1e-12 (the
constants differ, so the inputs are rescaled by their ratio).

Every fake or gloo world is started inside a test or a function-scoped
fixture and destroyed before it ends: other files may run in the same
worker afterwards.
"""
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api.pipeline import GraphPipeline as RefPipeline
from repro.api.pipeline import SubgraphSpec as RefSpec
from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.graph import engine as ref_eng
from repro.launch import roofline as ref_roof
from repro_torch import interop
from repro_torch.api import GraphPipeline, LoweredBSP, SubgraphSpec
from repro_torch.api.pipeline import plan_bsp, superstep_reads
from repro_torch.configs import get_config
from repro_torch.graph import engine as eng
from repro_torch.launch import graph_dryrun as gd
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import roofline as roof

SRC = str(Path(__file__).resolve().parents[1] / "src")
RTOL, ATOL = 1e-5, 1e-8
PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
SPECS = (RefSpec(4, 16, 32, 8), RefSpec(8, 100, 300, 7, "flat"), RefSpec(3, 5, 9),
         RefSpec(256, 1 << 20, 8 << 20))
SMALL = SubgraphSpec(256, 4096, 2048, 8)  # the production world, small ranks
HLO_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
TIMING_KEYS = ("compile_s", "superstep_ms", "first_superstep_ms", "ms_per_superstep", "run_s")


def _port_spec(s):
    return SubgraphSpec(s.num_parts, s.max_v, s.max_e, s.max_msg, s.addressing)


def _port(g):
    return interop.graph_from_numpy(g.src, g.dst, g.num_vertices)


@pytest.fixture
def world1(tmp_path):
    """A gloo world of 1 in this process, and its mesh; destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield pt_mesh.make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------- specs


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"p{s.num_parts}_{s.addressing}")
def test_array_specs_match_reference(spec):
    ref_arrays, ref_statics = spec.array_specs()
    arrays, statics = _port_spec(spec).array_specs()
    assert list(arrays) == list(ref_arrays)
    for k, a in arrays.items():
        assert a.device.type == "meta", k
        assert tuple(a.shape) == tuple(ref_arrays[k].shape), k
        assert str(a.dtype).removeprefix("torch.") == str(ref_arrays[k].dtype), k
    assert statics == ref_statics
    for prog in PROGRAMS:
        v = _port_spec(spec).value_spec(eng.get_program(prog))
        r = spec.value_spec(ref_eng.get_program(prog))
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(r.shape)
        assert str(v.dtype).removeprefix("torch.") == str(r.dtype)


def test_spec_of_matches_reference(tiny_powerlaw):
    ref = RefPipeline(tiny_powerlaw).partition("ebg", parts=4).build(symmetrize=True)
    port = GraphPipeline(_port(tiny_powerlaw), device="cpu").partition("ebg", parts=4)
    got = SubgraphSpec.of(port.build(symmetrize=True).subgraphs)
    want = RefSpec.of(ref.subgraphs)
    for f in ("num_parts", "max_v", "max_e", "max_msg", "addressing"):
        assert getattr(got, f) == getattr(want, f), f


def test_abstract_pipelines_refuse(world1):
    from jax.sharding import Mesh
    import jax

    spec = SubgraphSpec(4, 16, 32, 8)
    for pipe, mesh in ((GraphPipeline.from_spec(spec), world1),
                       (RefPipeline.from_spec(RefSpec(4, 16, 32, 8)),
                        Mesh(np.array(jax.devices()[:1]), ("workers",)))):
        with pytest.raises(RuntimeError):
            pipe.run("cc")
        with pytest.raises(RuntimeError, match="abstract"):
            pipe.partition("ebg", parts=4)
        with pytest.raises(RuntimeError, match="abstract \\(from_spec\\) pipelines cannot "
                                               "serve queries"):
            pipe.serve()
        with pytest.raises(ValueError, match="num_vertices="):
            pipe.lower(mesh=mesh, program="pr")
    port = GraphPipeline.from_spec(spec)
    for call in (port.prepare, lambda: port.subgraphs):
        with pytest.raises(RuntimeError, match="abstract"):
            call()
    assert port.device is None


# --------------------------------------------------------------- roofline


def _hlo_line(kind, g, shape):
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    return (f"  %x.1 = f32[{','.join(map(str, shape))}]{{1,0}} {kind}(f32[4,4]{{1,0}} %p.0), "
            f"channel_id=1, replica_groups={groups}, dimensions={{0}}")


@pytest.mark.parametrize("g", (1, 2, 4, 16, 512))
@pytest.mark.parametrize("kind", HLO_KINDS)
def test_summarize_collectives_matches_parse_collectives(kind, g):
    shape = (g * 3, 40)
    want = ref_roof.parse_collectives(_hlo_line(kind, g, shape) + "\n"
                                      + _hlo_line(kind, g, (7,)))
    got = roof.summarize_collectives([(kind, 4 * shape[0] * shape[1], g), (kind, 28, g)])
    assert got.per_op == want.per_op
    assert got.total_link_bytes == want.total_link_bytes
    assert got.row() == want.row()


def test_roofline_terms_match_reference():
    rng = np.random.default_rng(0)
    scale = (ref_roof.PEAK_FLOPS / roof.PEAK_FLOPS, ref_roof.HBM_BW / roof.HBM_BW,
             ref_roof.LINK_BW / roof.LINK_BW)
    for _ in range(50):
        f, h, l = 10.0 ** rng.uniform(3, 15, size=3)
        got = roof.roofline_terms(f, h, l)
        want = ref_roof.roofline_terms(f * scale[0], h * scale[1], l * scale[2])
        assert got["bottleneck"] == want["bottleneck"]
        for k in ("compute_s", "memory_s", "collective_s", "bound_s"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference(arch):
    for kind in ("train", "prefill", "decode"):
        got = roof.model_flops(get_config(arch), kind, 4096, 256, chips=256)
        want = ref_roof.model_flops(ref_config(arch), kind, 4096, 256, chips=256)
        assert got == want, kind


def test_record_collectives_gloo(world1):
    """The recorder sees the collectives the port makes, by kind, with
    their output bytes and group size; outside its block it records
    nothing."""
    with roof.record_collectives() as rec:
        x = torch.ones(5, dtype=torch.int32)
        dist.all_reduce(x)
        out = [torch.empty(3)]
        dist.all_gather(out, torch.ones(3))
        recv = torch.empty(8)
        dist.all_to_all_single(recv, torch.ones(8))
        dist.barrier()
    dist.all_reduce(torch.ones(2))
    got = [(r.kind, r.out_bytes, r.group_size, r.op) for r in rec.records]
    assert got == [("all-reduce", 20, 1, "allreduce_"), ("all-gather", 12, 1, "allgather_"),
                   ("all-to-all", 32, 1, "alltoall_base_")]
    assert all(r.event is None for r in rec.records)
    assert rec.summary().per_op == {}  # a world of 1 moves nothing


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_in_fake_world(multi_pod):
    n = 512 if multi_pod else 256
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    with pytest.raises(RuntimeError, match="no default process group"):
        pt_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    with pt_mesh.fake_world(n):
        assert dist.get_backend() == "fake" and dist.get_world_size() == n
        with pytest.raises(RuntimeError, match="already exists"):
            with pt_mesh.fake_world(8):
                pass
        with pytest.raises(ValueError, match="backend"):
            pt_mesh.make_host_mesh(device_type="cpu")  # nothing else takes the fake world
        with pytest.raises(ValueError, match=f"{2 * n if not multi_pod else 256} ranks"):
            pt_mesh.make_production_mesh(multi_pod=not multi_pod, device_type="cpu")
        mesh = pt_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape and tuple(mesh.mesh_dim_names) == names
        assert pt_mesh.mesh_size(mesh) == n and pt_mesh.dp_axes(mesh) == names[:-1]
        group, rank, w = pt_mesh.axes_group(mesh, names)
        assert (rank, w) == (0, n) and dist.get_world_size(group) == n
        for a, s in zip(names, shape):
            assert pt_mesh.axes_group(mesh, a)[2] == s
    assert not dist.is_initialized()


def test_fake_world_exchange_is_the_send_buffer():
    """The fake all-to-all hands back this rank's send buffer on every
    PyTorch; all-gather fills each slot with the input; all-reduce leaves
    the tensor as it was."""
    with pt_mesh.fake_world(4):
        send = torch.arange(12, dtype=torch.float32)
        recv = torch.full_like(send, float("nan"))
        dist.all_to_all_single(recv, send)
        assert torch.equal(recv, send)
        outs = [torch.full((3,), -1.0) for _ in range(4)]
        dist.all_gather(outs, torch.tensor([1.0, 2.0, 3.0]))
        assert all(torch.equal(o, torch.tensor([1.0, 2.0, 3.0])) for o in outs)
        x = torch.tensor([7], dtype=torch.int32)
        dist.all_reduce(x)
        assert int(x) == 7


# ------------------------------------------------------------------- plan


@pytest.mark.parametrize("p", (256, 512))
def test_plan_at_friendster_size(p):
    """The Friendster spec's byte counts, reckoned from shapes alone."""
    plan = plan_bsp(gd.friendster_spec(p), eng.get_program("cc"), p)
    a = plan.arrays
    edges = sum(a[k] for k in ("lsrc", "ldst", "weight", "edge_mask", "lsrc_s", "ldst_s",
                               "weight_s", "edge_mask_s"))
    assert edges == 8_388_608 * 26 == 218_103_808
    assert sum(a[k] for k in ("gid", "vmask", "is_master", "out_degree")) == 10_485_760
    tables = sum(a[k] for k in ("send_idx", "recv_idx", "msg_mask", "recv_mask"))
    assert tables == p * 2048 * 10 == {256: 5_242_880, 512: 10_485_760}[p]
    assert plan.values == 4_194_308 and plan.rows == 1
    assert plan.arg_bytes == {256: 238_026_756, 512: 243_269_636}[p]
    a2a = p * 2048 * 4
    assert a2a == {256: 2_097_152, 512: 4_194_304}[p]
    assert plan.superstep == (("all-to-all", a2a, p), ("all-to-all", a2a, p),
                              ("all-reduce", 4, p))
    link = roof.ring_link_bytes("all-to-all", a2a, p)
    assert link == {256: 2_088_960, 512: 4_186_112}[p]
    assert plan.link_bytes_per_superstep == 2 * link + 2 * 4 * (p - 1) / p
    # One local pass: CC's stream is both directions (2 x 8,388,608 edges,
    # no pad at block 512), 12 B an edge as the kernel reads it, the values
    # in and out, the iteration count; two operations an edge.
    assert plan.stream_edges == 16_777_216
    assert plan.pass_bytes == 16_777_216 * 12 + 8 * 1_048_577 + 4
    assert plan.pass_flops == 2 * 16_777_216
    # The 2^24 guard's bound ahead of the loop (the largest value, and a
    # covered count a rank), the kernels' id flag after it: the runner
    # returns its rank's rows, with no gather of the whole set.
    assert plan.setup == (("all-reduce", 8 * (p + 1), p),)
    assert plan.final == (("all-reduce", 4, p),)
    pr = plan_bsp(gd.friendster_spec(p), eng.get_program("pr"), p)
    assert pr.superstep[2] == ("all-gather", 4 * p, p)
    assert pr.setup == () and pr.final == (("all-reduce", 4, p),)
    assert pr.stream_edges == 8_388_608
    with pt_mesh.fake_world(p):
        mesh = pt_mesh.make_production_mesh(multi_pod=p == 512, device_type="cpu")
        low = GraphPipeline.from_spec(gd.friendster_spec(p)).lower(mesh=mesh, program="cc")
    assert isinstance(low, LoweredBSP) and low.plan == plan and low.rows == slice(0, 1)
    assert low.axes == tuple(mesh.mesh_dim_names) and low.program == "cc"
    mem = low.memory_analysis()
    assert mem.argument_size_in_bytes == plan.arg_bytes
    assert mem.read_argument_size_in_bytes == plan.read_arg_bytes
    assert low.cost_analysis() == {"flops": float(plan.pass_flops),
                                   "bytes accessed": float(plan.pass_bytes)}


# ------------------------------------------------- lowered stepper, world 1


@pytest.mark.parametrize("prog", PROGRAMS)
def test_lowered_stepper_world1_matches_sims(world1, small_powerlaw, prog):
    """lower(...).stepper at p = 4 on one rank against mode="sim" and the
    reference's sim; its collectives against the plan."""
    S, C = 30, 100
    port = GraphPipeline(_port(small_powerlaw), device="cpu").partition("ebg", parts=4)
    ref = RefPipeline(small_powerlaw).partition("ebg", parts=4)
    low = port.lower(mesh=world1, program=prog, num_supersteps=S, inner_cap=C)
    assert low.rows == slice(0, 4) and low.plan.rows == 4
    P = eng.get_program(prog)
    sub = port.subgraphs_for(symmetrize=P.bidirectional)
    arrays, _ = eng.subgraphs_to_arrays(sub)
    source = port.default_source() if P.needs_source else None
    init = P.init(sub, num_vertices=small_powerlaw.num_vertices, source=source)
    with roof.record_collectives() as rec:
        val, msgs, steps, ms, its = low.stepper(arrays, init)
    edges = sub.edge_mask.sum(dim=1).numpy().astype(np.int64)
    stats = eng._assemble_stats(steps, ms[:steps].numpy().astype(np.int64),
                                its[:steps].numpy().astype(np.int64), edges)
    sim = port.run(prog, max_supersteps=S, inner_cap=C)
    want = ref.run(prog, max_supersteps=S, inner_cap=C, compute_backend="xla")
    np.testing.assert_array_equal(val[:, :-1].numpy(), sim.values)
    if prog == "pr":
        np.testing.assert_allclose(val[:, :-1].numpy(), np.asarray(want.values), rtol=RTOL,
                                   atol=ATOL)
    else:
        np.testing.assert_array_equal(val[:, :-1].numpy(), np.asarray(want.values))
    for run in (sim.stats, want.stats):
        assert stats.supersteps == run.supersteps
        for f in ("messages_per_worker", "messages_per_step_worker", "inner_iters_per_step",
                  "comp_work_per_worker"):
            np.testing.assert_array_equal(getattr(stats, f), getattr(run, f), err_msg=f)
    got = [(r.kind, r.out_bytes, r.group_size) for r in rec.records]
    assert got == low.plan.records(steps)


# ------------------------------------------------------------ the dry-run


def _run_small(prog):
    with gd.lowered_dryrun(program=prog, device="cpu", spec=SMALL) as (low, arrays, init):
        assert arrays["lsrc"].stride() == (0, 1) and init.stride()[0] == 0
        run = gd.run_lowered(low, arrays, init)
    return low, run


@pytest.mark.parametrize("prog", ("cc", "pr"))
def test_graph_dryrun_small_matches_plan(prog):
    """run_graph_dryrun on the CPU in the production world of 256 with
    small ranks: recorded against the plan (count and bytes, exact), the
    rank's argument bytes against the plan's; two runs equal."""
    rec = gd.run_graph_dryrun(device="cpu", spec=SMALL, program=prog)
    again = gd.run_graph_dryrun(device="cpu", spec=SMALL, program=prog)
    plan = plan_bsp(SMALL, eng.get_program(prog), 256)
    assert rec["collectives"] == plan.collectives(rec["supersteps"], final=True).per_op
    assert rec["collectives"] == rec["plan_collectives"]
    assert rec["collectives_count"] == 3 * rec["supersteps"] + (2 if prog == "cc" else 1)
    assert rec["link_bytes_per_device"] == plan.link_bytes_per_superstep
    assert rec["device_arg_bytes"] == rec["arg_bytes"] == plan.arg_bytes
    assert rec["world"] == "fake" and rec["device"] == "cpu" and rec["temp_bytes"] is None
    assert rec["arch"] == f"graph_bsp_{prog}" and rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] == plan.pass_flops
    assert rec["hbm_bytes_per_device"] == plan.pass_bytes
    assert len(rec["superstep_ms"]) == rec["supersteps"] > 0
    assert {k: v for k, v in rec.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in again.items() if k not in TIMING_KEYS}
    low, run = _run_small(prog)
    low2, run2 = _run_small(prog)
    assert torch.equal(run.values, run2.values) and run.steps == run2.steps
    assert [(r.kind, r.out_bytes, r.group_size) for r in run.records] == \
        low.plan.records(run.steps)


def test_graph_dryrun_multi_pod_and_refusals():
    rec = gd.run_graph_dryrun(multi_pod=True, device="cpu",
                              spec=SubgraphSpec(512, 8192, 1024, 8), num_supersteps=2)
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16" and rec["supersteps"] <= 2
    assert rec["collectives"] == rec["plan_collectives"]
    with pytest.raises(ValueError, match="EdgeScorer"):
        gd.run_graph_dryrun(device="cpu", spec=SMALL, partitioner="hash")
    with pytest.raises(ValueError, match="num_parts must be 256"):
        gd.run_graph_dryrun(device="cpu", spec=SubgraphSpec(8, 4096, 2048, 8))
    with pytest.raises(ValueError, match="distinct mirrors"):
        gd.run_graph_dryrun(device="cpu", spec=SubgraphSpec(256, 1024, 2048, 8))
    assert not dist.is_initialized()


def test_synthetic_shard_layout():
    spec = SubgraphSpec(8, 512, 1000, 16)
    arrays, init = gd.synthetic_shard(spec, "cc", device="cpu", seed=3)
    a = {k: v[0] for k, v in arrays.items()}
    assert all(v.shape[0] == 8 and v.stride()[0] == 0 for v in arrays.values())
    for k in ("ldst", "lsrc_s"):
        assert bool((a[k][1:] >= a[k][:-1]).all()), k  # sorted
    assert sorted(zip(a["lsrc"].tolist(), a["ldst"].tolist())) == \
        sorted(zip(a["lsrc_s"].tolist(), a["ldst_s"].tolist()))
    assert bool(a["edge_mask"].all()) and bool(a["msg_mask"].all())
    sent = a["send_idx"].reshape(-1)
    assert sent.unique().numel() == sent.numel() == 8 * 16
    assert not bool(a["is_master"][sent.long()].any())
    assert int(a["is_master"].sum()) == 512 - 128
    assert int(init[:, :-1].max()) == 511 and init.shape == (8, 513)
    again, _ = gd.synthetic_shard(spec, "cc", device="cpu", seed=3)
    assert all(torch.equal(arrays[k], again[k]) for k in arrays)


def test_fake_world_8_lowered_stepper():
    """A flat mesh over a fake world of 8 (torch's own mesh: the port's
    meshes take the fake world only at the production sizes)."""
    from torch.distributed.device_mesh import init_device_mesh

    spec = SubgraphSpec(8, 256, 512, 4)
    with pt_mesh.fake_world(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("workers",))
        low = GraphPipeline.from_spec(spec).lower(mesh=mesh, program="sssp", num_supersteps=3)
        arrays, init = gd.synthetic_shard(spec, "sssp", device="cpu")
        run = gd.run_lowered(low, arrays, init)
    assert [(r.kind, r.out_bytes, r.group_size) for r in run.records] == \
        low.plan.records(run.steps)
    assert run.device_arg_bytes == low.plan.arg_bytes


# ------------------------------------------- against the reference's XLA


CHILD = r"""
import json
from repro.api import GraphPipeline, SubgraphSpec
from repro.launch.mesh import make_production_mesh
from repro.launch.roofline import _group_size, _shape_bytes, parse_collectives

out = {}
for prog in ("cc", "pr"):
    low = GraphPipeline.from_spec(SubgraphSpec(256, 64, 256, 16)).lower(
        mesh=make_production_mesh(), program=prog, num_supersteps=2, inner_cap=8,
        num_vertices=1000)
    text = low.compiled.as_text()
    a2a = [(_shape_bytes(line.split(" all-to-all(")[0].split("=", 1)[1]), _group_size(line))
           for line in text.splitlines() if " all-to-all(" in line]
    out[prog] = dict(per_op=parse_collectives(text).per_op, a2a=a2a,
                     args=low.compiled.memory_analysis().argument_size_in_bytes)
print("RESULT", json.dumps(out))
"""


def test_plan_against_reference_lowering():
    """The reference lowered for SubgraphSpec(256, 64, 256, 16) over 256 XLA
    host devices (XLA locks the device count at first init: a subprocess)
    against the port's plan. Pinned differences: (1) `parse_collectives`
    finds no all-to-all: XLA prints it with a tuple of 256 shapes whose
    `/*index=5*/` comments hold an `=`, which its type pattern excludes; the
    same lines summed with the reference's own `_shape_bytes` and
    `_group_size` give the plan's bytes. (2) jit drops the arguments a
    program never reads, so XLA's argument size is the plan's
    `read_arg_bytes`; the plan's `arg_bytes` adds the arrays the runner cuts
    anyway. (3) At tol = 0 XLA drops PageRank's unused psum; the port's
    stepper all-gathers the p deltas every superstep."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.split("RESULT", 1)[1])
    spec = SubgraphSpec(256, 64, 256, 16)
    for prog in ("cc", "pr"):
        P = eng.get_program(prog)
        plan = plan_bsp(spec, P, 256)
        got = res[prog]
        assert "all-to-all" not in got["per_op"]  # (1)
        xla_a2a = roof.summarize_collectives([("all-to-all", b, g) for b, g in got["a2a"]])
        assert xla_a2a.per_op["all-to-all"] == plan.collectives().per_op["all-to-all"]
        assert got["args"] == plan.read_arg_bytes  # (2)
        unread = sum(v for k, v in plan.arrays.items() if k not in superstep_reads(P))
        assert plan.arg_bytes - got["args"] == unread > 0
        if prog == "cc":
            assert got["per_op"] == {"all-reduce": plan.collectives().per_op["all-reduce"]}
        else:  # (3)
            assert got["per_op"] == {}
            assert plan.collectives().per_op["all-gather"] == {
                "count": 1, "bytes": roof.ring_link_bytes("all-gather", 4 * 256, 256)}
