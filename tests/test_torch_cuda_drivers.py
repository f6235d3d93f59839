"""The engine's drivers on the card: the superstep kernel's batched launch
(B·p value rows on p shared streams) against its plain version and against
the same rows launched alone; the fused driver's CUDA graph against the
host driver, bitwise; the launch counts a graph replay adds; the id guard
through a captured run; and the batched driver against single runs
(marked `cuda`; they skip without a card). This file imports neither jax
nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_drivers.py

Exact: min values and iteration counts, every BSPStats field, all values
but PageRank's across drivers and batches (PageRank too: the same
launches in the same order). Tolerance: the batched sum against its plain
version, rtol 1e-5 / atol 1e-6 (both add in f64, the plain version's
atomics in another order); the batch's rows against the rows launched
alone are bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api.pipeline import GraphPipeline
from repro_torch.graph import engine as eng
from repro_torch.graph.generate import rmat
from repro_torch.kernels import bsp_superstep as pt_bsp
from repro_torch.kernels import dispatch

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.fixture
def card_pipe(cuda_device):
    g = rmat(256, 1024, seed=3)
    return GraphPipeline(g, device=cuda_device).partition("ebg", parts=4)


def _sub(pipe, prog):
    return pipe.subgraphs_for(symmetrize=prog in ("cc", "reach"))


def _kw(pipe, prog, **kw):
    kw = dict(kw, num_vertices=pipe.graph.num_vertices)
    if prog in ("sssp", "bfs"):
        kw.setdefault("source", pipe.default_source())
    return kw


def assert_stats_equal(a, b):
    assert a.supersteps == b.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _streams(dev, p, E, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lsrc = torch.randint(0, n, (p, E), generator=gen, device=dev, dtype=torch.int32)
    ldst = torch.randint(0, n - 1, (p, E), generator=gen, device=dev).sort(dim=1).values
    w = torch.rand((p, E), generator=gen, device=dev) + 0.1
    return lsrc, ldst.to(torch.int32), w, gen


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("E", [1001, 4096])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_cuda_batched_superstep_matches_plain_and_rows(cuda_device, B, E, combine):
    """A launch over B·p value rows reads stream row r % p: against the
    plain version on the same inputs, and each query's p rows against the
    same rows launched alone (bitwise, min and sum); for min also with a
    live mask. E=1001 is ragged (the scalar loads), 4096 takes the vector
    loads."""
    p, n = 3, 97
    lsrc, ldst, w, gen = _streams(cuda_device, p, E, n, seed=B * E)
    if combine == "min":
        w[:, -7:] = 3.0e38  # pads: the INF identity
        deg = None
    else:
        w[:, -7:] = 0.0
        deg = torch.randint(0, 5, (p, n), generator=gen, device=cuda_device).float()
    val = torch.rand((B * p, n), generator=gen, device=cuda_device) * 10
    kw = dict(num_out=n, combine=combine, inner_cap=10_000, out_degree=deg)
    got, it = pt_bsp.bsp_superstep(lsrc, ldst, w, val, **kw)
    want, want_it = pt_bsp.bsp_superstep_plain(lsrc, ldst, w, val, **kw)
    assert torch.equal(it, want_it)
    if combine == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=SUM_ATOL)
    for b in range(B):
        alone, alone_it = pt_bsp.bsp_superstep(lsrc, ldst, w, val[b * p:(b + 1) * p].clone(),
                                               **kw)
        assert torch.equal(got[b * p:(b + 1) * p], alone), f"query {b}"
        assert torch.equal(it[b * p:(b + 1) * p], alone_it), f"query {b}"
    if combine == "min":
        # The live mask: a query that is not live keeps its rows (0
        # iterations); the others are the unmasked launch's, bitwise.
        live = torch.arange(B, device=cuda_device) % 2 == 1
        masked, masked_it = pt_bsp.bsp_superstep(lsrc, ldst, w, val, live=live, **kw)
        plain, plain_it = pt_bsp.bsp_superstep_plain(lsrc, ldst, w, val, live=live, **kw)
        assert torch.equal(masked, plain) and torch.equal(masked_it, plain_it)
        rows = live.repeat_interleave(p)
        assert torch.equal(masked[rows], got[rows]) and torch.equal(masked_it[rows], it[rows])
        assert torch.equal(masked[~rows], val[~rows]) and not masked_it[~rows].any()


@pytest.mark.cuda
@pytest.mark.parametrize("prog,kw", [
    *[(p, {}) for p in PROGRAMS],
    ("cc", dict(exchange_period=2)),
    ("sssp", dict(exchange_period=3, inner_cap=2)),
    ("pr", dict(max_supersteps=50, tol=1e-4)),
])
def test_cuda_fused_graph_matches_host(card_pipe, prog, kw):
    """The captured fused loop, cold (eager chunk + capture + replays) and
    warm (replays only), against the host driver: values and stats bitwise."""
    sub = _sub(card_pipe, prog)
    kw = _kw(card_pipe, prog, **kw)
    h, sh = eng.run_bsp(sub, prog, driver="host", **kw)
    for _ in range(2):
        f, sf = eng.run_bsp(sub, prog, driver="fused", **kw)
        assert torch.equal(f, h)
        assert_stats_equal(sf, sh)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", ["cc", "bfs", "pr"])
def test_cuda_replay_launches_equal_host_plus_masked(card_pipe, prog):
    """A warm fused run captures nothing, and its replays add to LAUNCHES
    the launches the host driver makes for the same run plus the masked
    steps of the last chunk; the host syncs are one a chunk plus one."""
    sub = _sub(card_pipe, prog)
    kw = _kw(card_pipe, prog)
    combine = "sum" if prog == "pr" else "min"
    key = f"bsp_superstep.{combine}"
    dispatch.reset_launches()
    _, sh = eng.run_bsp(sub, prog, driver="host", **kw)
    host = dispatch.LAUNCHES[key]
    assert host == sh.supersteps
    eng.run_bsp(sub, prog, driver="fused", **kw)  # cold: captures
    captures = dict(eng.CAPTURES)
    dispatch.reset_launches()
    syncs = eng.HOST_SYNCS["fused"]
    _, sf = eng.run_bsp(sub, prog, driver="fused", **kw)
    assert dict(eng.CAPTURES) == captures
    K = eng._chunk_length(1)
    chunks = -(-sf.supersteps // K)
    masked = chunks * K - sf.supersteps
    assert dispatch.LAUNCHES[key] == host + masked
    budget = -(-(kw.get("max_supersteps") or eng.get_program(prog).default_steps or 200) // K)
    can_stop = prog != "pr"
    assert eng.HOST_SYNCS["fused"] - syncs == (min(chunks, budget - 1) if can_stop else 0) + 1


@pytest.mark.cuda
def test_cuda_id_guard_raises_through_captured_run(card_pipe):
    """A stream with an out-of-range id: the fused run raises the id
    guard's ValueError cold (eager chunk, then capture) and warm (replays
    only), and a good set's run right after succeeds."""
    sub = _sub(card_pipe, "cc")
    bad = sub.lsrc.clone()
    bad[1, 0] = sub.max_v + 1
    broken = dataclasses.replace(sub, lsrc=bad)
    for _ in range(2):
        with pytest.raises(ValueError, match="has ids"):
            eng.run_bsp(broken, "cc", driver="fused")
    h, _ = eng.run_bsp(sub, "cc", driver="host")
    f, _ = eng.run_bsp(sub, "cc", driver="fused")
    assert torch.equal(f, h)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", ["bfs", "sssp", "cc", "pr"])
def test_cuda_batch_matches_singles(card_pipe, prog):
    """run_bsp_batch and a captured BatchExecutable on the card against
    single runs, bitwise; queries from a hub to a leaf converge apart."""
    sub = _sub(card_pipe, prog)
    g = card_pipe.graph
    nv = g.num_vertices
    kw = dict(max_supersteps=10) if prog == "pr" else {}
    if prog in ("bfs", "sssp"):
        cov = g.covered_vertices()
        order = cov[np.argsort(-g.degrees()[cov])]
        srcs = [int(v) for v in order[np.linspace(0, len(order) - 1, 3).astype(int)]]
        singles = [eng.run_bsp(sub, prog, source=s, num_vertices=nv, **kw) for s in srcs]
    else:
        srcs = None
        singles = [eng.run_bsp(sub, prog, num_vertices=nv, **kw) for _ in range(3)]
    vals, stats = eng.run_bsp_batch(sub, prog, srcs, batch=3, num_vertices=nv, **kw)
    exe = eng.compile_batch_executable(sub, prog, 3, num_vertices=nv, **kw)
    assert exe.loop.graph is not None and exe.compile_s > 0
    init = eng.batch_init(prog, sub, srcs, batch=3, num_vertices=nv)
    vals2, stats2 = exe.run(init)
    for b, (v1, s1) in enumerate(singles):
        assert torch.equal(vals[b], v1) and torch.equal(vals2[b], v1), f"query {b}"
        assert_stats_equal(stats[b], s1)
        assert_stats_equal(stats2[b], s1)


# ------------------------------------------- checkpoint/resume on the card


@pytest.mark.cuda
@pytest.mark.parametrize("prog,every,crash", [("cc", 1, 2), ("sssp", 2, 2), ("pr", 5, 12)])
def test_cuda_fused_segment_resume_matches_captured_run(card_pipe, tmp_path, prog, every,
                                                        crash):
    """A fused run checkpointed every `every` supersteps crashes at `crash`;
    resume_bsp finishes it on the card: the uninterrupted captured run's
    values and every stat, bitwise. Each new segment length captures its
    own graph once: a second crash/resume of the same run captures nothing
    and launches the superstep kernel only by replays."""
    from repro_torch.resilience import FaultPlan, WorkerCrashError, resume_bsp

    sub = _sub(card_pipe, prog)
    kw = _kw(card_pipe, prog, **({"max_supersteps": 20} if prog == "pr" else {}))
    base, base_stats = eng.run_bsp(sub, prog, driver="fused", **kw)
    crash = min(crash, base_stats.supersteps - 1)
    for attempt in range(2):
        captures = dict(eng.CAPTURES)
        ckpt = tmp_path / f"run{attempt}"
        with pytest.raises(WorkerCrashError):
            eng.run_bsp(sub, prog, checkpoint_every=every, ckpt_dir=ckpt,
                        fault_plan=FaultPlan(crash_at_superstep=crash), **kw)
        dispatch.reset_launches()
        val, stats = resume_bsp(sub, ckpt_dir=ckpt)
        kernel = "bsp_superstep.sum" if prog == "pr" else "bsp_superstep.min"
        assert dispatch.LAUNCHES[kernel] > 0
        assert torch.equal(val, base), f"attempt {attempt}"
        assert_stats_equal(stats, base_stats)
        if attempt:
            assert dict(eng.CAPTURES) == captures  # every segment loop was warm
        else:
            assert eng.CAPTURES["graphs"] > captures.get("graphs", 0)
        # The same crash resumed by the host driver.
        host_val, host_stats = resume_bsp(sub, ckpt_dir=ckpt, driver="host")
        assert torch.equal(host_val, base)
        assert_stats_equal(host_stats, base_stats)


# -------------------------------------- the out-of-core partition on the card


@pytest.fixture(scope="module")
def card_store(tmp_path_factory):
    from repro_torch.data import edgeshards as es

    g = rmat(1 << 12, 1 << 14, seed=5)
    return es.write_graph(g, tmp_path_factory.mktemp("card_store") / "s", shard_edges=5000)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 4096])
@pytest.mark.parametrize("parts", [32, 64])
def test_cuda_partition_store_matches_cpu(cuda_device, card_store, tmp_path, parts, block):
    """partition_store with its state on the card (the CUDA commit) against
    the same call on the CPU (the plain commit): assignments in stream and
    input order and both counters, bitwise; the kernel launched once a
    group of blocks."""
    from repro_torch.core import outofcore as oc

    dispatch.reset_launches()
    card = oc.partition_store(card_store, parts, "ebv", block=block, device=cuda_device,
                              order_workdir=tmp_path / "o")
    launches = dispatch.LAUNCHES["ebg_commit"]
    assert launches == -(-card_store.num_edges // (block * max(1, oc.GROUP_EDGES // block)))
    assert card.result.part.device.type == "cuda"
    cpu = oc.partition_store(card_store, parts, "ebv", block=block, device="cpu",
                             order_workdir=tmp_path / "o2")
    assert torch.equal(card.result.part.cpu(), cpu.result.part)
    np.testing.assert_array_equal(card.result.part_in_input_order(),
                                  cpu.result.part_in_input_order())
    np.testing.assert_array_equal(card.e_count, cpu.e_count)
    np.testing.assert_array_equal(card.v_count, cpu.v_count)
    assert card.num_blocks == cpu.num_blocks
