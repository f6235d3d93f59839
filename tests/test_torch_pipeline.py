"""Port parity, the slice as a whole: `GraphPipeline` on the CPU against the
reference's `GraphPipeline` (its "xla" paths) — partition metrics, every
program's values and `BSPStats`, and the run's views — plus the device
rule, and the CUDA kernels against their plain versions where a card is
present (marked `cuda`; they skip without one).
"""
import types

import numpy as np
import pytest
import torch

from repro.api.pipeline import GraphPipeline as RefPipeline
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.kernels import dispatch

PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
RTOL, ATOL = 1e-5, 1e-8  # PageRank: f32 sums taken in another order


def _port(g):
    return interop.graph_from_numpy(g.src, g.dst, g.num_vertices)


@pytest.fixture(scope="module")
def pipes(tiny_powerlaw):
    ref = RefPipeline(tiny_powerlaw).partition("ebg_chunked", parts=4, block=64)
    port = GraphPipeline(_port(tiny_powerlaw), device="cpu").partition(
        "ebg_chunked", parts=4, block=64)
    return ref, port


def test_partition_stage_matches(pipes):
    ref, port = pipes
    np.testing.assert_array_equal(port.result.part_in_input_order(),
                                  ref.result.part_in_input_order())
    assert port.metrics.row() == ref.metrics.row()
    assert port.metrics.replication_factor == ref.metrics.replication_factor
    assert port.default_source() == ref.default_source()
    assert port.num_parts == 4 and port.config.block == 64
    assert port.partitioner.name == "ebg_chunked"


@pytest.mark.parametrize("prog", PROGRAMS)
def test_pipeline_runs_match(pipes, prog):
    ref, port = pipes
    r = ref.run(prog, compute_backend="xla")
    p = port.run(prog)
    assert p.program == r.program
    if prog == "pr":
        np.testing.assert_allclose(p.values, np.asarray(r.values), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(p.to_global(), r.to_global(), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(p.values, np.asarray(r.values))
        np.testing.assert_array_equal(p.to_global(), r.to_global())
    for f in ("messages_per_worker", "messages_per_step_worker", "inner_iters_per_step",
              "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(p.stats, f), getattr(r.stats, f), err_msg=f)
    assert p.stats.supersteps == r.stats.supersteps
    np.testing.assert_array_equal(p.edges_per_worker, r.edges_per_worker)
    if prog == "cc":
        assert p.num_components() == r.num_components()


def test_build_params_and_kwargs_flow_like_the_reference(pipes):
    ref, port = pipes
    r = ref.build(symmetrize=True, pad_multiple=16).run("pr", num_iters=5, damping=0.8)
    p = port.build(symmetrize=True, pad_multiple=16).run("pr", num_iters=5, damping=0.8)
    assert p.stats.supersteps == r.stats.supersteps == 5
    assert p.subgraphs.max_v == r.subgraphs.max_v and p.subgraphs.max_v % 16 == 0
    np.testing.assert_allclose(p.values, np.asarray(r.values), rtol=RTOL, atol=ATOL)
    p_src = port.run("bfs", source=3, symmetrize=True)
    r_src = ref.run("bfs", source=3, symmetrize=True)
    np.testing.assert_array_equal(p_src.values, np.asarray(r_src.values))
    assert port.prepare("sssp") is port
    port.clear_builds()


def test_pipeline_rejects_what_is_not_ported(pipes, tiny_powerlaw):
    _, port = pipes
    # mode="dist" is ported (tests/test_torch_distributed.py runs it); its
    # argument errors come before any collective, so a stand-in mesh of 2
    # ranks serves: a 4-part partition does not fit it, driver= is sim-only.
    two = types.SimpleNamespace(shape=(2,), mesh_dim_names=("workers",), device_type="cpu")
    with pytest.raises(ValueError, match="parts"):
        port.run("cc", mode="dist", mesh=two)
    with pytest.raises(ValueError, match="driver="):
        port.run("cc", mode="dist", mesh=two, driver="fused")
    with pytest.raises(ValueError, match="unknown mode"):
        port.run("cc", mode="shard_map")
    with pytest.raises(RuntimeError, match="no partition stage"):
        GraphPipeline(_port(tiny_powerlaw), device="cpu").run("cc")
    with pytest.raises(ValueError, match="does not use"):
        GraphPipeline(_port(tiny_powerlaw), device="cpu").partition("ebg", parts=2, block=8)


def test_pipeline_defaults_to_the_card(monkeypatch, tiny_powerlaw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphPipeline(_port(tiny_powerlaw))


def test_paper_example(paper_example):
    ref = RefPipeline(paper_example).partition("ebg", parts=2)
    port = GraphPipeline(_port(paper_example), device="cpu").partition("ebg", parts=2)
    np.testing.assert_array_equal(port.result.part.numpy(), np.asarray(ref.result.part))
    assert port.run("cc").num_components() == ref.run("cc").num_components() == 1


# ------------------------------------------------- on the card (skip here)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device, tiny_powerlaw):
    """Both kernels against their plain versions on the card, on the
    states a real partition and a real run give them."""
    from repro_torch.kernels import bsp_superstep as bsp, ebg_commit as ebg, ops

    g = _port(tiny_powerlaw)
    p, V, B = 8, g.num_vertices, 256
    src = g.src[:B].to(torch.int32)
    dst = g.dst[:B].to(torch.int32)
    keep = torch.randint(-2**31, 2**31 - 1, (p, (V + 31) // 32), dtype=torch.int32)
    keep &= torch.randint(-2**31, 2**31 - 1, keep.shape, dtype=torch.int32)
    e = torch.randint(0, 50, (p,)).float()
    v = torch.randint(0, 90, (p,)).float()
    valid = torch.ones(B, dtype=torch.bool)
    valid[-7:] = False
    coef = ops.commit_coefficients(alpha=1.0, beta=1.0, inv_e=np.float32(p) / np.float32(9000),
                                   inv_v=np.float32(p) / np.float32(V), eps=1.0, device="cpu")
    for window in (False, True):
        for balance in ("static", "range"):
            args = (keep, e, v, src, dst, valid, coef)
            want = ebg.ebg_commit_block_plain(*args, balance=balance, window=window)
            got = ebg.ebg_commit_block(*(a.to(cuda_device) for a in args), balance=balance,
                                       window=window)
            torch.cuda.synchronize()
            for w_, g_ in zip(want, got):
                assert torch.equal(g_.cpu(), w_)
    from repro_torch.graph.engine import kernel_inputs

    pipe = GraphPipeline(g, device="cpu").partition("ebg_chunked", parts=p)
    for prog, sym in (("cc", True), ("reach", True), ("sssp", False), ("pr", False)):
        (lsrc, ldst, w, deg), val, n = kernel_inputs(
            pipe.subgraphs_for(symmetrize=sym), prog, num_vertices=V, source=0)
        kw = dict(num_out=n, combine="sum" if deg is not None else "min", inner_cap=10_000)
        want = bsp.bsp_superstep_plain(lsrc, ldst, w, val, out_degree=deg, **kw)
        dev = [None if t is None else t.to(cuda_device) for t in (lsrc, ldst, w, val, deg)]
        got = bsp.bsp_superstep(*dev[:4], out_degree=dev[4], **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[1].cpu(), want[1])
        if deg is None:
            assert torch.equal(got[0].cpu(), want[0])
        else:
            torch.testing.assert_close(got[0].cpu(), want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu(cuda_device, tiny_powerlaw):
    g = _port(tiny_powerlaw)
    cpu = GraphPipeline(g, device="cpu").partition("ebg_chunked", parts=8)
    gpu = GraphPipeline(g, device=cuda_device).partition("ebg_chunked", parts=8)
    np.testing.assert_array_equal(gpu.result.part_in_input_order(),
                                  cpu.result.part_in_input_order())
    for prog in PROGRAMS:
        a, b = cpu.run(prog), gpu.run(prog)
        assert a.stats.total_messages == b.stats.total_messages
        np.testing.assert_array_equal(a.stats.inner_iters_per_step, b.stats.inner_iters_per_step)
        if prog == "pr":
            np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(b.values, a.values)
    for kernel in ("ebg_commit", "bsp_superstep.min", "bsp_superstep.sum"):
        assert dispatch.LAUNCHES[kernel] > 0, kernel
