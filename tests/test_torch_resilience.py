"""Port parity, superstep checkpoint/resume (`repro_torch.resilience.bsp`)
and the checkpoint store (`repro_torch.checkpoint.ckpt`), on the CPU.

Each test is the counterpart of one in tests/test_resilience.py,
tests/test_scale.py or tests/test_substrate.py, on the same inputs: the
`built_small` builds of the reference (EBG, p = 4, on rmat(256, 1024,
seed=3)) carried across with `interop.to_port`. A crash at superstep s
followed by `resume_bsp` must give the uninterrupted run's values and
every `BSPStats` field bit for bit, on both drivers and across them; and
a checkpoint written by either package must resume in the other.

Exact: every value of the port's runs against the port's, every
`BSPStats` field everywhere, CC/SSSP values against the reference.
Tolerance: PageRank values against the reference, rtol 1e-5 / atol 1e-8
(f32 sums in another order), as in tests/test_torch_drivers.py.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.graph import engine as ref_eng
from repro.resilience import FaultPlan as RefFaultPlan
from repro.resilience import WorkerCrashError as RefWorkerCrashError
from repro.resilience import resume_bsp as ref_resume_bsp
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.graph import engine as eng
from repro_torch.graph.generate import rmat
from repro_torch.resilience import (
    FaultPlan,
    WorkerCrashError,
    resume_bsp,
    run_bsp_resilient,
)
from repro_torch.resilience import bsp as pt_bsp

RTOL, ATOL = 1e-5, 1e-8
CASES = (
    ("cc", dict()),
    ("sssp", dict(source=0)),
    ("pr", dict(max_supersteps=8)),
)
IDS = [c[0] for c in CASES]


def assert_stats_equal(a, b):
    assert a.supersteps == b.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.total_messages == b.total_messages


def assert_values_match_reference(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if name == "pr":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def carried(built_small):
    """(graph, {symmetrize: (reference SubgraphSet, port SubgraphSet)})."""
    g, sub_sym, sub_dir = built_small
    return g, {True: (sub_sym, interop.to_port(sub_sym, device="cpu")),
               False: (sub_dir, interop.to_port(sub_dir, device="cpu"))}


def _subs(carried, name):
    return carried[1][name in ("cc", "reach")]


def _kw(graph, name, kw):
    out = dict(kw)
    if name == "pr":
        out["num_vertices"] = graph.num_vertices
    return out


# ----------------------------------------------------- checkpoint/resume


@pytest.mark.parametrize("driver", ("fused", "host"))
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_crash_resume_bit_parity(carried, tmp_path, name, kw, driver):
    """Crash at mid-run superstep s, resume from the checkpoint dir: the
    port's uninterrupted run bit for bit, and the reference's run_bsp."""
    graph = carried[0]
    ref_sub, sub = _subs(carried, name)
    kw = _kw(graph, name, kw)
    base_val, base_stats = eng.run_bsp(sub, name, driver=driver, **kw)
    crash_at = max(1, base_stats.supersteps // 2)
    ckpt_dir = tmp_path / f"{name}_{driver}"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub, name, driver=driver, checkpoint_every=1, ckpt_dir=ckpt_dir,
                    fault_plan=FaultPlan(seed=3, crash_at_superstep=crash_at), **kw)
    val, stats = resume_bsp(sub, ckpt_dir=ckpt_dir)
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)
    ref_val, ref_stats = ref_eng.run_bsp(ref_sub, name, driver=driver, **kw)
    assert_values_match_reference(name, val.numpy(), ref_val)
    assert_stats_equal(stats, ref_stats)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_crash_on_fused_resume_on_host(carried, tmp_path, name, kw):
    """A fused-driver crash resumed by the host driver (the drivers are bit
    for bit equal, so the answer is the uninterrupted run's)."""
    graph = carried[0]
    _, sub = _subs(carried, name)
    kw = _kw(graph, name, kw)
    base_val, base_stats = eng.run_bsp(sub, name, **kw)
    ckpt_dir = tmp_path / "x"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub, name, checkpoint_every=1, ckpt_dir=ckpt_dir,
                    fault_plan=FaultPlan(crash_at_superstep=max(1, base_stats.supersteps // 2)),
                    **kw)
    calls = eng.DISPATCH_COUNTS["host"]
    val, stats = resume_bsp(sub, ckpt_dir=ckpt_dir, driver="host")
    assert eng.DISPATCH_COUNTS["host"] > calls  # the host driver ran the rest
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_checkpointed_run_matches_plain(carried, tmp_path, name, kw):
    """Checkpointing alone (no crash) must not perturb values or stats."""
    graph = carried[0]
    _, sub = _subs(carried, name)
    kw = _kw(graph, name, kw)
    base_val, base_stats = eng.run_bsp(sub, name, **kw)
    val, stats = eng.run_bsp(sub, name, checkpoint_every=2, ckpt_dir=tmp_path / name, **kw)
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)
    # Snapshots at 0 and at every second superstep, in the reference's layout.
    steps = sorted(int(d.name.split("_")[1]) for d in (tmp_path / name).glob("step_*"))
    assert steps == list(range(0, stats.supersteps + 1, 2))


def test_resume_crash_resume_chain(carried, tmp_path):
    """Two successive crashes, two resumes — still bit-identical. PageRank
    runs a fixed 6 supersteps, so both crash points are live."""
    graph, subs = carried
    sub = subs[False][1]
    kw = dict(max_supersteps=6, num_vertices=graph.num_vertices)
    base_val, base_stats = eng.run_bsp(sub, "pr", **kw)
    assert base_stats.supersteps == 6
    ckpt = tmp_path / "chain"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub, "pr", checkpoint_every=1, ckpt_dir=ckpt,
                    fault_plan=FaultPlan(crash_at_superstep=2), **kw)
    with pytest.raises(WorkerCrashError, match="superstep 4"):
        resume_bsp(sub, ckpt_dir=ckpt, fault_plan=FaultPlan(crash_at_superstep=4))
    val, stats = resume_bsp(sub, ckpt_dir=ckpt)
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)


@pytest.mark.parametrize("driver", ("fused", "host"))
def test_crash_resume_with_bounded_staleness(carried, tmp_path, driver):
    """exchange_period 2 with checkpoints every 2 supersteps: segments start
    on exchange boundaries, so the resumed run is the uninterrupted one."""
    _, sub = _subs(carried, "cc")
    kw = dict(exchange_period=2, inner_cap=2, driver=driver)
    base_val, base_stats = eng.run_bsp(sub, "cc", **kw)
    assert base_stats.supersteps >= 4
    ckpt = tmp_path / "stale"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub, "cc", checkpoint_every=2, ckpt_dir=ckpt,
                    fault_plan=FaultPlan(crash_at_superstep=3), **kw)
    val, stats = resume_bsp(sub, ckpt_dir=ckpt)
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)


def test_pipeline_run_passes_fault_tolerance_knobs(tmp_path):
    """GraphPipeline.run hands checkpoint_every/ckpt_dir/fault_plan to run_bsp."""
    pipe = GraphPipeline(rmat(256, 1024, seed=3), device="cpu").partition("ebg", parts=4)
    base = pipe.run("cc")
    with pytest.raises(WorkerCrashError):
        pipe.run("cc", checkpoint_every=1, ckpt_dir=tmp_path / "p",
                 fault_plan=FaultPlan(crash_at_superstep=1))
    val, stats = resume_bsp(pipe.subgraphs_for(symmetrize=True), ckpt_dir=tmp_path / "p")
    np.testing.assert_array_equal(val[:, :-1].numpy(), base.values)
    assert_stats_equal(stats, base.stats)


def test_resume_without_checkpoint_raises(carried, tmp_path):
    _, sub = _subs(carried, "cc")
    with pytest.raises(FileNotFoundError):
        resume_bsp(sub, ckpt_dir=tmp_path / "nothing_here")


def test_resume_rejects_mismatched_subgraphs(carried, tmp_path):
    """Resuming against a different partition is an error, not garbage."""
    graph, subs = carried
    sub_sym = subs[True][1]
    ckpt = tmp_path / "mismatch"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub_sym, "cc", checkpoint_every=1, ckpt_dir=ckpt,
                    fault_plan=FaultPlan(crash_at_superstep=1))
    other = GraphPipeline(interop.graph_from_numpy(graph.src, graph.dst, graph.num_vertices),
                          device="cpu").partition("ebg", parts=2).subgraphs_for(symmetrize=True)
    with pytest.raises(ValueError, match="checkpoint"):
        resume_bsp(other, ckpt_dir=ckpt)


def test_checkpoint_args_validated(carried, tmp_path):
    _, sub = _subs(carried, "cc")
    with pytest.raises(ValueError, match="checkpoint_every"):
        eng.run_bsp(sub, "cc", checkpoint_every=0, ckpt_dir=tmp_path / "x")
    with pytest.raises(ValueError, match="ckpt_dir"):
        eng.run_bsp(sub, "cc", checkpoint_every=2)
    with pytest.raises(ValueError, match="checkpoint_every"):
        eng.run_bsp(sub, "cc", ckpt_dir=tmp_path / "z")
    with pytest.raises(ValueError, match="exchange_period"):
        run_bsp_resilient(sub, "cc", checkpoint_every=3, ckpt_dir=tmp_path / "y",
                          exchange_period=2)


# ------------------------------------------------- across the two packages


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_reference_checkpoint_resumes_in_port(carried, tmp_path, name, kw):
    """The reference's run_bsp_resilient (compute_backend="xla", CPU) crashes;
    the port's resume_bsp finishes it: the reference's uninterrupted values
    and every stat."""
    graph = carried[0]
    ref_sub, sub = _subs(carried, name)
    kw = _kw(graph, name, kw)
    base_val, base_stats = ref_eng.run_bsp(ref_sub, name, **kw)
    ckpt_dir = tmp_path / "ref"
    with pytest.raises(RefWorkerCrashError):
        ref_eng.run_bsp(ref_sub, name, compute_backend="xla", checkpoint_every=1,
                        ckpt_dir=ckpt_dir,
                        fault_plan=RefFaultPlan(crash_at_superstep=max(1, base_stats.supersteps
                                                                      // 2)), **kw)
    assert json.loads((ckpt_dir / pt_bsp.RESUME_META).read_text())["compute_backend"] == "xla"
    val, stats = resume_bsp(sub, ckpt_dir=ckpt_dir)
    assert_values_match_reference(name, val.numpy(), base_val)
    assert_stats_equal(stats, base_stats)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_port_checkpoint_resumes_in_reference(carried, tmp_path, name, kw):
    """The port crashes; the reference's resume_bsp finishes it (on the
    backend the port's resume.json names): the port's uninterrupted stats,
    and its values."""
    graph = carried[0]
    ref_sub, sub = _subs(carried, name)
    kw = _kw(graph, name, kw)
    base_val, base_stats = eng.run_bsp(sub, name, **kw)
    ckpt_dir = tmp_path / "port"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(sub, name, checkpoint_every=1, ckpt_dir=ckpt_dir,
                    fault_plan=FaultPlan(crash_at_superstep=max(1, base_stats.supersteps // 2)),
                    **kw)
    assert json.loads((ckpt_dir / pt_bsp.RESUME_META).read_text())["compute_backend"] == "ref"
    val, stats = ref_resume_bsp(ref_sub, ckpt_dir=ckpt_dir)
    assert_values_match_reference(name, base_val.numpy(), val)
    assert_stats_equal(stats, base_stats)


# ------------------------------------------- codec through checkpoints


@pytest.fixture(scope="module")
def boundary_sub():
    """A two-level CC build with its gids shifted so max(gid) is exactly
    2^24 (tests/test_scale.py's `boundary_subs["at"]`), carried across."""
    from repro.core.streaming import streaming_chunked_partition
    from repro.graph.build import build_subgraphs
    from repro.graph.generate import rmat as ref_rmat

    g = ref_rmat(256, 1024, seed=3)
    sub = build_subgraphs(g, streaming_chunked_partition(g, 4, "ebv"), symmetrize=True)
    shift = (1 << 24) - int(jnp.max(sub.gid))
    at = dataclasses.replace(sub, gid=jnp.where(sub.vmask, sub.gid + shift, sub.gid))
    return at, interop.to_port(at, device="cpu")


def test_resilient_resume_restores_value_codec(boundary_sub, tmp_path):
    """Crash/resume on a 2^24-id two-level run: the rank codec rides in the
    checkpoint (as `codec_uniq`), so the resumed run decodes to the
    uninterrupted labels — which are the reference's."""
    ref_at, at = boundary_sub
    base_val, base_stats = eng.run_bsp(at, "cc")
    crash_at = max(1, base_stats.supersteps // 2)
    ckpt = tmp_path / "ckpt"
    with pytest.raises(WorkerCrashError):
        eng.run_bsp(at, "cc", checkpoint_every=1, ckpt_dir=ckpt,
                    fault_plan=FaultPlan(seed=3, crash_at_superstep=crash_at))
    tree = CKPT.restore(ckpt, crash_at, {"codec_uniq": np.zeros(0, np.int32)})
    assert tree["codec_uniq"].size > 0 and int(tree["codec_uniq"].max()) >= 1 << 24
    val, stats = resume_bsp(at, ckpt_dir=ckpt)
    torch.testing.assert_close(val, base_val, rtol=0, atol=0)
    assert_stats_equal(stats, base_stats)
    ref_val, _ = ref_eng.run_bsp(ref_at, "cc", compute_backend="ref")
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))
    # The reference resumes the port's encoded carry with the same codec.
    ref_val2, ref_stats2 = ref_resume_bsp(ref_at, ckpt_dir=ckpt)
    np.testing.assert_array_equal(np.asarray(ref_val2), base_val.numpy())
    assert_stats_equal(ref_stats2, base_stats)


# --------------------------------------------------------- checkpoint store


def test_checkpoint_roundtrip(tmp_path):
    tree = dict(a=torch.arange(12, dtype=torch.float32).reshape(3, 4),
                b=dict(c=torch.ones((5,), dtype=torch.int32), step=np.int32(7)),
                d=[np.arange(3, dtype=np.int64), (np.float32(2.5),)])
    CKPT.save(tmp_path, 3, tree)
    assert CKPT.latest_step(tmp_path) == 3
    got = CKPT.restore(tmp_path, 3, tree)
    assert got["a"].dtype == torch.float32 and got["b"]["c"].dtype == torch.int32
    torch.testing.assert_close(got["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(got["b"]["c"], tree["b"]["c"], rtol=0, atol=0)
    assert int(got["b"]["step"]) == 7 and got["b"]["step"].dtype == np.int32
    np.testing.assert_array_equal(got["d"][0], tree["d"][0])
    assert isinstance(got["d"][1], tuple) and float(got["d"][1][0]) == 2.5
    keys = [m["path"] for m in json.loads(
        (tmp_path / "step_00000003" / "manifest.json").read_text())["leaves"]]
    assert keys == ["a", "b|c", "b|step", "d|0", "d|1|0"]


def test_partial_checkpoint_ignored(tmp_path):
    """A dir without manifest.json (killed mid-write) must be invisible."""
    (tmp_path / "step_00000009").mkdir(parents=True)
    assert CKPT.latest_step(tmp_path) is None
    CKPT.save(tmp_path, 5, dict(x=torch.ones(3)))
    assert CKPT.latest_step(tmp_path) == 5


def test_checkpoint_files_move_between_packages(tmp_path):
    """The same tree saved by each package: the same manifest and bytes,
    and each restores the other's."""
    arrays = dict(v=np.arange(10, dtype=np.float32).reshape(2, 5),
                  m=dict(k=np.arange(6, dtype=np.int64), z=np.int32(1)))
    ref_ckpt.save(tmp_path / "ref", 1, {k: (jnp.asarray(v) if k == "v" else v)
                                        for k, v in arrays.items()})
    CKPT.save(tmp_path / "port", 1, dict(v=torch.from_numpy(arrays["v"]), m=arrays["m"]))
    mr = json.loads((tmp_path / "ref" / "step_00000001" / "manifest.json").read_text())
    mp = json.loads((tmp_path / "port" / "step_00000001" / "manifest.json").read_text())
    assert mr == mp
    for m in mp["leaves"]:
        assert ((tmp_path / "ref" / "step_00000001" / m["file"]).read_bytes()
                == (tmp_path / "port" / "step_00000001" / m["file"]).read_bytes())
    got = CKPT.restore(tmp_path / "ref", 1, dict(v=torch.zeros(0), m=arrays["m"]))
    np.testing.assert_array_equal(got["v"].numpy(), arrays["v"])
    np.testing.assert_array_equal(got["m"]["k"], arrays["m"]["k"])
    back = ref_ckpt.restore(tmp_path / "port", 1, arrays)
    np.testing.assert_array_equal(np.asarray(back["v"]), arrays["v"])


def test_async_checkpointer_surfaces_thread_errors(tmp_path):
    """A failed async save must raise on wait()/next save(), never be
    silently treated as durable."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the checkpoint dir should be")
    ckpt = CKPT.AsyncCheckpointer(blocker)
    ckpt.save(0, {"x": torch.zeros((4,))})
    with pytest.raises(RuntimeError, match="checkpoint save"):
        ckpt.wait()
    # The error is consumed once surfaced; a save to a good dir recovers.
    ok = CKPT.AsyncCheckpointer(tmp_path / "good")
    x = torch.zeros((4,))
    ok.save(0, {"x": x})
    x += 1  # the snapshot was taken before the thread started
    ok.save(1, {"x": x})
    ok.wait()
    assert float(CKPT.restore(tmp_path / "good", 0, {"x": x})["x"].sum()) == 0.0
    assert float(CKPT.restore(tmp_path / "good", 1, {"x": x})["x"].sum()) == 4.0


def test_async_checkpointer_raises_on_next_save(tmp_path):
    blocker = tmp_path / "still_a_file"
    blocker.write_text("x")
    ckpt = CKPT.AsyncCheckpointer(blocker)
    ckpt.save(0, {"x": np.zeros((2,), np.float32)})
    with pytest.raises(RuntimeError, match="checkpoint save"):
        ckpt.save(1, {"x": np.zeros((2,), np.float32)})
