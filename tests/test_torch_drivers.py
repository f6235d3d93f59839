"""Port parity, the engine's drivers: `run_bsp(driver="fused"|"host")`
against each other and against the JAX reference's fused driver
(`compute_backend="xla"`) on a `SubgraphSet` built by the reference and
carried across, for every program, with bounded staleness
(exchange_period 2 and 3), with `tol` early exit and with a step budget
that cuts the run; the dispatch and host-sync counts of each driver; and
the fused loop's cache (on the CPU the chunk runs eagerly: a warm run
reuses the loop the first run built, as on the card it replays the
captured graph).

Exact: CC/SSSP/BFS/REACH values and every `BSPStats` field against the
reference; every value, PageRank's included, across the port's two
drivers. Tolerance: PageRank values against the reference, rtol 1e-5 /
atol 1e-8 (f32 sums in another order), as in tests/test_torch_engine.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import algorithms as ref_alg
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.graph import algorithms as pt_alg
from repro_torch.graph import engine as eng
from repro_torch.graph.generate import rmat
from repro_torch.kernels import bsp_superstep as pt_bsp
from repro_torch.kernels import ops as pt_ops

RTOL, ATOL = 1e-5, 1e-8
PROGRAMS = ("cc", "sssp", "bfs", "reach", "pr")
CASES = [
    *[(p, {}) for p in PROGRAMS],
    ("cc", dict(exchange_period=2)),
    ("cc", dict(exchange_period=3, inner_cap=2)),
    ("sssp", dict(exchange_period=2)),
    ("sssp", dict(exchange_period=3, inner_cap=2)),
    ("bfs", dict(exchange_period=3)),
    ("reach", dict(exchange_period=2, inner_cap=1)),
    ("bfs", dict(max_supersteps=2)),
    ("pr", dict(max_supersteps=50, tol=1e-4)),
    ("pr", dict(max_supersteps=7)),
]


def assert_stats_equal(a, b):
    assert a.supersteps == b.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.total_messages == b.total_messages
    assert a.max_mean == b.max_mean


@pytest.fixture(scope="module")
def carried(built_small):
    """(graph, {symmetrize: (reference SubgraphSet, port SubgraphSet)})."""
    g, sub_sym, sub_dir = built_small
    return g, {True: (sub_sym, interop.to_port(sub_sym, device="cpu")),
               False: (sub_dir, interop.to_port(sub_dir, device="cpu"))}


def _source(g):
    cov = g.covered_vertices()
    return int(cov[np.argmax(g.degrees()[cov])])


def _args(g, prog, kw):
    kw = dict(kw, num_vertices=g.num_vertices)
    if prog in ("sssp", "bfs"):
        kw["source"] = _source(g)
    return kw


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("B", [1, 2, 5])
def test_batched_superstep_matches_reference_per_query(B, combine):
    """The superstep over B·p value rows on p shared streams (the port's
    batch axis) against the reference oracle run query by query (the
    reference's batched driver vmaps the kernel): min and max bitwise, sum
    to rtol 1e-5 / atol 1e-8; and each query's rows bitwise against the
    same rows launched alone."""
    rng = np.random.default_rng(B)
    p, V, E = 3, 29, 61
    lsrc = rng.integers(0, V, (p, E)).astype(np.int32)
    ldst = np.sort(rng.integers(0, V - 1, (p, E)), axis=1).astype(np.int32)
    w = (rng.random((p, E)) + 0.1).astype(np.float32)
    w[:, -4:] = 0.0 if combine == "sum" else np.float32(3.0e38)
    if combine == "max":
        w[:, :-4] = 0.0
    val = (rng.random((B * p, V)) * 10 - 3).astype(np.float32)
    deg = rng.integers(0, 4, (p, V)).astype(np.float32) if combine == "sum" else None
    kw = dict(num_out=V, combine=combine, inner_cap=50)
    t = torch.from_numpy
    got, it = pt_ops.bsp_superstep(t(lsrc), t(ldst), t(w), t(val),
                                   out_degree=None if deg is None else t(deg), **kw)
    assert got.shape == (B * p, V) and it.shape == (B * p,)
    for b in range(B):
        rows = slice(b * p, (b + 1) * p)
        r_val, r_it = ref_ops.bsp_superstep(
            jnp.asarray(lsrc), jnp.asarray(ldst), jnp.asarray(w), jnp.asarray(val[rows]),
            impl="ref", out_degree=None if deg is None else jnp.asarray(deg), **kw)
        np.testing.assert_array_equal(it[rows].numpy(), np.asarray(r_it))
        if combine == "sum":
            np.testing.assert_allclose(got[rows].numpy(), np.asarray(r_val), rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(got[rows].numpy(), np.asarray(r_val))
        alone, alone_it = pt_ops.bsp_superstep(t(lsrc), t(ldst), t(w), t(val[rows].copy()),
                                               out_degree=None if deg is None else t(deg), **kw)
        assert torch.equal(got[rows], alone) and torch.equal(it[rows], alone_it)
    with pytest.raises(ValueError, match="val must have shape"):
        pt_bsp.bsp_superstep(t(lsrc), t(ldst), t(w), torch.zeros((p + 1, V)), num_out=V)
    if combine == "sum":
        return
    # The live mask: the rows of a query that is not live stay as they are,
    # with 0 iterations; the live ones are the unmasked launch's.
    live = torch.from_numpy(np.arange(B) % 2 == 0)
    masked, masked_it = pt_ops.bsp_superstep(t(lsrc), t(ldst), t(w), t(val), live=live, **kw)
    for b in range(B):
        rows = slice(b * p, (b + 1) * p)
        if live[b]:
            assert torch.equal(masked[rows], got[rows]) and torch.equal(masked_it[rows], it[rows])
        else:
            assert torch.equal(masked[rows], t(val[rows])) and not masked_it[rows].any()


@pytest.mark.parametrize("prog,kw", CASES, ids=[f"{p}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                                                for p, kw in CASES])
def test_fused_matches_host_and_reference(carried, prog, kw):
    g, subs = carried
    ref_sub, sub = subs[prog in ("cc", "reach")]
    kw = _args(g, prog, kw)
    r_val, r_st = ref_alg.run_program(ref_sub, prog, compute_backend="xla", driver="fused", **kw)
    f_val, f_st = pt_alg.run_program(sub, prog, driver="fused", **kw)
    h_val, h_st = pt_alg.run_program(sub, prog, driver="host", **kw)
    np.testing.assert_array_equal(f_val, h_val)  # bitwise, PageRank too
    assert_stats_equal(f_st, h_st)
    assert_stats_equal(f_st, r_st)
    if prog == "pr":
        np.testing.assert_allclose(f_val, np.asarray(r_val), rtol=RTOL, atol=ATOL)
        if "tol" in kw:
            assert f_st.supersteps < kw["max_supersteps"]  # tol fired
    else:
        assert f_val.dtype == np.asarray(r_val).dtype
        np.testing.assert_array_equal(f_val, np.asarray(r_val))


def test_dispatch_counts_per_run(carried):
    """fused and batch add one a run; host adds one a superstep."""
    g, subs = carried
    _, sub = subs[True]
    base = dict(eng.DISPATCH_COUNTS)
    _, st = eng.run_bsp(sub, "cc", driver="fused")
    assert eng.DISPATCH_COUNTS["fused"] == base.get("fused", 0) + 1
    assert eng.DISPATCH_COUNTS["host"] == base.get("host", 0)
    _, sh = eng.run_bsp(sub, "cc", driver="host")
    assert eng.DISPATCH_COUNTS["host"] == base.get("host", 0) + sh.supersteps
    assert eng.DISPATCH_COUNTS["fused"] == base.get("fused", 0) + 1
    assert eng.DISPATCH_COUNTS["batch"] == base.get("batch", 0)
    _, dirn = subs[False]
    before = eng.DISPATCH_COUNTS["fused"]
    eng.run_bsp(dirn, "pr", num_vertices=g.num_vertices, max_supersteps=5)
    assert eng.DISPATCH_COUNTS["fused"] == before + 1


@pytest.mark.parametrize("prog,kw", [("cc", {}), ("sssp", dict(exchange_period=3)),
                                     ("pr", {}), ("pr", dict(max_supersteps=30, tol=1e-4))])
def test_host_syncs_per_run(carried, prog, kw):
    """The fused driver reads its stop flag once a chunk (none when the
    run cannot stop early: PageRank with tol 0) and the stats once; the
    host driver once an exchange step (tol programs: once a step when tol
    is set) and the stats once."""
    g, subs = carried
    _, sub = subs[prog in ("cc", "reach")]
    kw = _args(g, prog, kw)
    base = eng.HOST_SYNCS["fused"]
    _, st = eng.run_bsp(sub, prog, driver="fused", **kw)
    K = eng._chunk_length(kw.get("exchange_period", 1))
    budget = -(-(kw.get("max_supersteps") or eng.get_program(prog).default_steps or 200) // K)
    chunks = -(-st.supersteps // K)
    can_stop = not (prog == "pr" and not kw.get("tol"))
    assert eng.HOST_SYNCS["fused"] - base == (min(chunks, budget - 1) if can_stop else 0) + 1
    base = eng.HOST_SYNCS["host"]
    _, sh = eng.run_bsp(sub, prog, driver="host", **kw)
    period = kw.get("exchange_period", 1)
    per_step = sh.supersteps // period if prog != "pr" else (sh.supersteps if kw.get("tol") else 0)
    assert eng.HOST_SYNCS["host"] - base == per_step + 1


def test_warm_fused_run_reuses_the_loop(carried):
    """The second run of the same (SubgraphSet, program, knobs) builds no
    loop (on the card: captures no graph) and gives the same answer; other
    knobs build their own."""
    g, subs = carried
    _, sub = subs[False]
    kw = dict(source=_source(g), num_vertices=g.num_vertices)
    v1, s1 = eng.run_bsp(sub, "bfs", **kw)
    built = dict(eng.CAPTURES)
    v2, s2 = eng.run_bsp(sub, "bfs", **kw)
    assert dict(eng.CAPTURES) == built
    assert torch.equal(v1, v2)
    assert_stats_equal(s1, s2)
    eng.run_bsp(sub, "bfs", max_supersteps=3, **kw)
    assert eng.CAPTURES["loops"] == built.get("loops", 0) + 1
    assert eng.CAPTURES["graphs"] == built.get("graphs", 0)  # no card here


def test_masked_steps_leave_the_stats_untouched(carried):
    """Steps past convergence run masked: the values stay, the step count
    stops, and the rows past the run's steps stay zero (the masked steps
    write the spare row max_supersteps)."""
    g, subs = carried
    _, sub = subs[False]
    v, st = eng.run_bsp(sub, "sssp", driver="fused", max_supersteps=9, source=_source(g))
    loop = next(x for k, x in eng._sub_cache(sub).items()
                if k[0] == "loop" and k[3] == 9)
    K = loop.chunk_steps
    assert st.supersteps % K != 0  # the last chunk has masked steps
    steps = int(loop.steps_q[0])
    assert steps == st.supersteps and int(loop.k[0]) == steps
    assert not loop.msgs[steps:9].any() and not loop.iters[steps:9].any()
    assert bool(loop.stop)


@pytest.mark.parametrize("period,K", [(1, 2), (2, 2), (3, 3), (4, 4)])
def test_chunk_length_is_a_multiple_of_the_exchange_period(period, K):
    assert eng._chunk_length(period) == K
    assert K % period == 0 and K >= eng.FUSED_CHUNK


def test_messages_per_step_worker_consistent(carried):
    _, subs = carried
    _, sub = subs[True]
    for driver in eng.DRIVERS:
        _, stats = eng.run_bsp(sub, "cc", driver=driver)
        m = stats.messages_per_step_worker
        assert m.shape == (stats.supersteps, sub.num_parts)
        np.testing.assert_array_equal(m.sum(axis=0), stats.messages_per_worker)
        np.testing.assert_array_equal(m.sum(axis=1), stats.messages_per_step)


def test_driver_validation(carried):
    _, subs = carried
    _, sub = subs[True]
    with pytest.raises(ValueError, match="driver"):
        pt_alg.connected_components(sub, driver="turbo")
    assert eng.check_driver("host") == "host"
    assert eng.DRIVERS == ("fused", "host")


def test_pipeline_surfaces_driver():
    pipe = GraphPipeline(rmat(256, 1024, seed=3), device="cpu").partition("ebg", parts=4)
    f = pipe.run("cc")  # fused is the default
    h = pipe.run("cc", driver="host")
    np.testing.assert_array_equal(f.values, h.values)
    assert_stats_equal(f.stats, h.stats)
    with pytest.raises(ValueError, match="driver"):
        pipe.run("cc", driver="turbo")
