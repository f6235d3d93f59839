"""The plain reference against the program's CPU path (its plain PyTorch
kernels) on small Graph500 graphs, through the facade the cells drive."""
import numpy as np
import pytest
import torch

from bench import compare, gen, reference

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def graph():
    el = gen.kronecker(10, 16, 0.57, 0.19, 0.19, seed=SEED, device="cpu")
    keys = gen.search_keys(el.num_vertices, 8, seed=SEED, device="cpu").tolist()
    ref = reference.SymGraph.from_edges(el.src, el.dst, el.weight, el.num_vertices, "cpu")
    return el, keys, ref


@pytest.fixture(scope="module", params=["ebg_chunked", "dbh"])
def pipeline(request, graph):
    from repro_torch.api import GraphPipeline
    from repro_torch.core.types import Graph

    el, _, _ = graph
    pipe = GraphPipeline(Graph(src=el.src, dst=el.dst, num_vertices=el.num_vertices),
                         weights=el.weight.numpy(), device="cpu")
    return pipe.partition(request.param, parts=4).build(symmetrize=True)


def test_csr_holds_both_arcs(graph):
    el, _, g = graph
    assert g.num_arcs == 2 * el.num_edges
    assert int(g.off[-1]) == g.num_arcs and bool((g.deg > 0).all())
    assert bool((g.src[1:] >= g.src[:-1]).all())


def test_wcc(graph, pipeline):
    _, _, g = graph
    assert compare.labels_wrong(pipeline.run("cc", driver="fused").to_global(),
                                reference.wcc(g)) == 0


def test_bfs(graph, pipeline):
    _, keys, g = graph
    for s in keys[:4]:
        got = pipeline.run("bfs", driver="fused", source=s).to_global()
        assert compare.hops_wrong(got, reference.bfs(g, s)) == 0


def test_sssp(graph, pipeline):
    _, keys, g = graph
    for s in keys[:4]:
        got = pipeline.run("sssp", driver="fused", source=s).to_global()
        ref = reference.sssp(g, s)
        assert compare.reach_wrong(got, ref) == 0
        # Both reach the least fixpoint of the same float32 sums.
        assert compare.dist_gap(got, ref) == 0.0


def test_pagerank(graph, pipeline):
    _, _, g = graph
    got = pipeline.run("pr", driver="fused", damping=0.85, num_iters=10).to_global()
    ref = reference.pagerank(g, 10, 0.85, g.num_vertices)
    assert compare.rank_gap(got, ref) < 1e-5


def test_bfs_matches_unit_sssp(graph):
    _, keys, g = graph
    unit = reference.SymGraph(off=g.off, nbr=g.nbr, w=torch.ones_like(g.w), src=g.src,
                              deg=g.deg, num_vertices=g.num_vertices)
    hops = reference.bfs(g, keys[0]).double()
    dist = reference.sssp(unit, keys[0]).double()
    hops[hops >= reference.UNREACHED_HOPS] = float("inf")
    assert torch.equal(hops, dist)


def test_job_bytes(graph):
    _, keys, g = graph
    comps = reference.Components.of(g, reference.wcc(g))
    assert int(comps.verts.sum()) == g.num_vertices and int(comps.arcs.sum()) == g.num_arcs
    full = reference.job_bytes("cc", g, comps)
    assert full == 8 * g.num_arcs + 8 * g.num_vertices
    assert reference.job_bytes("bfs", g, comps, keys[0]) <= full
    assert reference.job_bytes("sssp", g, comps, keys[0]) > reference.job_bytes(
        "bfs", g, comps, keys[0])
    assert reference.job_bytes("pr", g, comps, iters=10) == 10 * (
        8 * g.num_arcs + 20 * g.num_vertices)


def test_compare_counts_what_differs():
    a = np.array([0.0, 1.0, 2.0**31 - 1, 3.0])
    assert compare.hops_wrong(a, np.array([0, 1, 2**31 - 1, 3])) == 0
    assert compare.hops_wrong(a, np.array([0, 1, 2, 3])) == 1
    d = np.array([0.0, 0.5, 3e38])
    assert compare.reach_wrong(d, np.array([0.0, 0.5, np.inf])) == 0
    assert compare.dist_gap(d, np.array([0.0, 0.5 * (1 + 1e-3), np.inf])) == pytest.approx(
        1e-3 / (1 + 1e-3))
    assert compare.rank_gap(np.array([1.0, np.nan]), np.array([1.0, 1.0])) == np.inf
    checks = compare.Checks({"x": 0, "y": 1e-3})
    checks.add("x", 0)
    checks.worst("y", 5e-4)
    checks.worst("y", 2e-4)
    assert checks.correct and checks.values["y"] == 5e-4
    checks.worst("y", float("nan"))
    assert not checks.correct
    with pytest.raises(KeyError):
        checks.add("z", 0)
