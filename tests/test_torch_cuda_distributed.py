"""The distributed engine on the card: a NCCL world of 1 in this process
(marked `cuda`; they skip without a card). The stepper with all p
subgraphs on rank 0 (the all_to_all goes through NCCL to the rank itself)
against `run_bsp(driver="fused")`, `GraphPipeline.run(mode="dist")` at
p = 1 against mode="sim", and the out-of-core sharded layout against the
replicated one, all bitwise, with the kernels' launches on each path.
This file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_distributed.py
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.api.pipeline import GraphPipeline
from repro_torch.core import outofcore as oc
from repro_torch.data import edgeshards as es
from repro_torch.graph import engine as eng
from repro_torch.graph.generate import rmat
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh

PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels run only on the card")
    path = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    yield make_host_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def card_pipe(nccl_mesh):
    return GraphPipeline(rmat(1 << 12, 1 << 15, seed=3), device="cuda").partition("ebg", parts=8)


@pytest.mark.parametrize("prog", PROGRAMS)
def test_stepper_on_nccl_matches_fused(nccl_mesh, card_pipe, prog):
    pipe = card_pipe
    sub = pipe.subgraphs_for(symmetrize=prog in ("cc", "reach"))
    source = pipe.default_source() if prog in ("sssp", "bfs") else None
    V = pipe.graph.num_vertices
    steps_budget = 20 if prog == "pr" else 30
    want, st = eng.run_bsp(sub, prog, num_vertices=V, source=source, driver="fused",
                           max_supersteps=steps_budget)
    arrays, statics = eng.subgraphs_to_arrays(sub)
    runner = eng.make_distributed_stepper(nccl_mesh, "workers", prog, statics,
                                          num_supersteps=steps_budget, inner_cap=10_000,
                                          num_vertices=V)
    init = eng.get_program(prog).init(sub, num_vertices=V, source=source)
    dispatch.reset_launches()
    val, msgs, steps, ms, its = runner(arrays, init)
    kernel = "bsp_superstep.sum" if prog == "pr" else "bsp_superstep.min"
    assert dispatch.LAUNCHES[kernel] == steps
    assert torch.equal(val, want.cpu())
    assert steps == st.supersteps
    np.testing.assert_array_equal(ms[:steps].numpy(), st.messages_per_step_worker)
    np.testing.assert_array_equal(its[:steps].numpy(), st.inner_iters_per_step)
    np.testing.assert_array_equal(msgs.numpy(), st.messages_per_worker)


def test_pipeline_dist_at_one_part(nccl_mesh):
    pipe = GraphPipeline(rmat(1 << 10, 1 << 13, seed=5), device="cuda").partition(
        "ebg_chunked", parts=1)
    for prog in PROGRAMS:
        sim = pipe.run(prog)
        d = pipe.run(prog, mode="dist", mesh=nccl_mesh)
        np.testing.assert_array_equal(d.values, sim.values)
        assert d.stats.supersteps == sim.stats.supersteps
        for f in ("messages_per_worker", "messages_per_step_worker", "inner_iters_per_step",
                  "comp_work_per_worker"):
            np.testing.assert_array_equal(getattr(d.stats, f), getattr(sim.stats, f))


@pytest.mark.parametrize("scorer,commit", [("ebv", "frozen"), ("ebv", "window"),
                                           ("hdrf", "frozen")])
@pytest.mark.parametrize("block", [1, 37, 256])
def test_sharded_outofcore_on_the_card(nccl_mesh, tmp_path, scorer, commit, block):
    """Any block (any word count k of the block-local bitset, down to one
    edge) gives the replicated layout's parts and counters."""
    g = rmat(1 << 10, 1 << 12, seed=3)
    store = es.write_graph(g, tmp_path / "store", shard_edges=1000)
    kw = dict(block=block, commit=commit, device="cuda")
    dispatch.reset_launches()
    sh = oc.partition_store(store, 8, scorer, state_layout="sharded", mesh=nccl_mesh,
                            order_workdir=tmp_path / "s", **kw)
    assert dispatch.LAUNCHES["ebg_commit"] == sh.num_blocks
    assert dispatch.LAUNCHES["ebg_commit.keep_to_memb"] == sh.num_blocks
    rep = oc.partition_store(store, 8, scorer, order_workdir=tmp_path / "r", **kw)
    assert torch.equal(sh.result.part, rep.result.part)
    np.testing.assert_array_equal(sh.e_count, rep.e_count)
    np.testing.assert_array_equal(sh.v_count, rep.v_count)
