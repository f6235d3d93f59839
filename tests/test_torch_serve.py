"""Port parity, the batched driver and the serving tier: `run_bsp_batch`,
`BatchExecutable`, `GraphQueryServer` (its admission queue, bucket
padding, executable cache and every resilience path), `FaultPlan`'s draws
and `run_graph_serve`, against single runs of the port and against the
JAX reference (`compute_backend="xla"`).

Exact: every query's values and `BSPStats` against the port's single runs
(PageRank's too: the same launches in the same order); CC/SSSP/BFS/REACH
values and every stat against the reference's batched driver; fault
draws, retry and breaker counters, and `run_graph_serve`'s counts and
supersteps against the reference's. Tolerance: PageRank values against the
reference, rtol 1e-5 / atol 1e-8 (f32 sums in another order).
"""
import doctest

import numpy as np
import pytest
import torch

import repro.graph.engine as ref_eng
import repro_torch.serve.padding as padding
from repro.api import GraphPipeline as RefPipeline
from repro.launch.graph_serve import run_graph_serve as ref_run_graph_serve
from repro.resilience import FaultPlan as RefFaultPlan
from repro.resilience import RetryPolicy as RefRetryPolicy
from repro.serve.trace import synthetic_trace as ref_synthetic_trace
from repro_torch import interop
from repro_torch.api.pipeline import GraphPipeline
from repro_torch.graph import engine as eng
from repro_torch.launch.graph_serve import run_graph_serve
from repro_torch.resilience import (
    CircuitBreaker,
    FaultPlan,
    LoadShedError,
    RetryPolicy,
)
from repro_torch.serve import QueryFailure
from repro_torch.serve.cache import ExecutableCache
from repro_torch.serve.padding import bucket_size, pad_batch_rows, pad_items, padding_waste
from repro_torch.serve.queue import AdmissionQueue, Query
from repro_torch.serve.trace import synthetic_trace

RTOL, ATOL = 1e-5, 1e-8
SOURCE_PROGRAMS = ("sssp", "bfs")
FREE_PROGRAMS = ("cc", "reach")


def assert_stats_equal(a, b):
    assert a.supersteps == b.supersteps
    for f in ("messages_per_worker", "messages_per_step", "messages_per_step_worker",
              "inner_iters_per_step", "comp_work_per_worker"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _sources(graph, n: int) -> list:
    """n covered vertices spanning the degree range (hub first, leaf last)
    so batched queries converge at different supersteps."""
    cov = graph.covered_vertices()
    order = cov[np.argsort(-graph.degrees()[cov])]
    idx = np.linspace(0, len(order) - 1, n).astype(int)
    return [int(v) for v in order[idx]]


@pytest.fixture(scope="module")
def carried(built_small):
    g, sub_sym, sub_dir = built_small
    return g, {True: (sub_sym, interop.to_port(sub_sym, device="cpu")),
               False: (sub_dir, interop.to_port(sub_dir, device="cpu"))}


def _subs(carried, prog):
    """(graph, (reference SubgraphSet, port SubgraphSet)) of the build the
    program runs on: symmetric for CC/REACH, directed otherwise."""
    g, subs = carried
    return g, subs[prog in FREE_PROGRAMS]


def _singles(sub, prog, sources=None, batch=None, driver="fused", **kw):
    if sources is not None:
        return [eng.run_bsp(sub, prog, source=s, driver=driver, **kw) for s in sources]
    return [eng.run_bsp(sub, prog, driver=driver, **kw) for _ in range(batch)]


def assert_batch_matches_singles(vals, stats, singles):
    assert vals.shape[0] == len(singles)
    for b, (v1, s1) in enumerate(singles):
        assert torch.equal(vals[b], v1), f"query {b}"
        assert_stats_equal(stats[b], s1)


# ------------------------------------------------------------- padding


def test_padding_doctests():
    """The bucket-boundary examples in the docstrings are executable."""
    failures, tried = doctest.testmod(padding)
    assert failures == 0 and tried > 0


def test_bucket_size_boundaries():
    assert [bucket_size(n) for n in (1, 2, 3, 4, 5, 8, 9, 64)] == [1, 2, 4, 4, 8, 8, 16, 64]
    with pytest.raises(ValueError, match="64"):
        bucket_size(65)
    with pytest.raises(ValueError):
        bucket_size(0)
    assert bucket_size(3, buckets=(2, 6)) == 6


def test_padding_waste_and_items():
    assert padding_waste(8, 8) == 0.0
    assert padding_waste(3, 4) == pytest.approx(0.25)
    assert padding_waste(5, 8) == pytest.approx(3 / 8)
    assert pad_items([7, 9], 4) == [7, 9, 9, 9]
    with pytest.raises(ValueError):
        pad_items([], 4)
    x = np.arange(6).reshape(3, 2)
    y = pad_batch_rows(x, 4)
    np.testing.assert_array_equal(y[:3], x)
    np.testing.assert_array_equal(y[3], x[2])
    np.testing.assert_array_equal(pad_batch_rows(x, 3), x)


# ---------------------------------------------------- source validation


def test_batched_bad_source_fails_fast(carried):
    """One bad source fails BEFORE any init is built or any loop runs."""
    g, (_, sub) = _subs(carried, "bfs")
    before = eng.DISPATCH_COUNTS["batch"]
    with pytest.raises(ValueError, match=f"source={g.num_vertices}"):
        eng.run_bsp_batch(sub, "bfs", _sources(g, 2) + [g.num_vertices],
                          num_vertices=g.num_vertices)
    assert eng.DISPATCH_COUNTS["batch"] == before
    for bad in (-1, g.num_vertices):
        with pytest.raises(ValueError, match="source"):
            eng.batch_init("sssp", sub, [0, bad], num_vertices=g.num_vertices)


def test_batch_init_matches_reference(carried):
    g, (ref_sub, sub) = _subs(carried, "bfs")
    with pytest.raises(ValueError, match="sources"):
        eng.batch_init("sssp", sub)
    with pytest.raises(ValueError, match="batch"):
        eng.batch_init("cc", sub)
    assert eng.batch_init("cc", sub, batch=3).shape[0] == 3
    srcs = _sources(g, 3)
    for prog in ("bfs", "sssp"):
        got = eng.batch_init(prog, sub, srcs, num_vertices=g.num_vertices)
        want = ref_eng.batch_init(prog, ref_sub, srcs, num_vertices=g.num_vertices)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(eng.batch_init("cc", sub, batch=2).numpy(),
                                  np.asarray(ref_eng.batch_init("cc", ref_sub, batch=2)))


def test_batched_driver_rejects_staleness(carried):
    _, (_, sub) = _subs(carried, "cc")
    with pytest.raises(ValueError, match="exchange_period"):
        eng.run_bsp_batch(sub, "cc", batch=2, exchange_period=3)


# ------------------------------------------------------- batched parity


@pytest.mark.parametrize("B", (1, 3, 8))
@pytest.mark.parametrize("prog", SOURCE_PROGRAMS + FREE_PROGRAMS)
def test_batch_matches_singles_and_reference(carried, prog, B):
    """Values and per-query stats bit-identical to B single runs under both
    drivers, and to the reference's batched driver."""
    g, (ref_sub, sub) = _subs(carried, prog)
    srcs = _sources(g, B) if prog in SOURCE_PROGRAMS else None
    vals, stats = eng.run_bsp_batch(sub, prog, srcs, batch=B, num_vertices=g.num_vertices)
    for driver in eng.DRIVERS:
        singles = _singles(sub, prog, srcs, batch=B, driver=driver, num_vertices=g.num_vertices)
        assert_batch_matches_singles(vals, stats, singles)
    r_vals, r_stats = ref_eng.run_bsp_batch(ref_sub, prog, srcs, batch=B,
                                            num_vertices=g.num_vertices)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))
    for a, b in zip(stats, r_stats):
        assert_stats_equal(a, b)


def test_batch_pagerank_fixed_iters(carried):
    """f32 whole-graph program: batched lanes bitwise-match single runs, and
    the reference's within tolerance."""
    g, (ref_sub, sub) = _subs(carried, "pr")
    kw = dict(batch=3, max_supersteps=10, num_vertices=g.num_vertices)
    vals, stats = eng.run_bsp_batch(sub, "pr", **kw)
    singles = _singles(sub, "pr", batch=3, max_supersteps=10, num_vertices=g.num_vertices)
    assert_batch_matches_singles(vals, stats, singles)
    r_vals, r_stats = ref_eng.run_bsp_batch(ref_sub, "pr", **kw)
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), rtol=RTOL, atol=ATOL)
    for a, b in zip(stats, r_stats):
        assert_stats_equal(a, b)


def test_masking_lets_stragglers_run(carried):
    """Queries that converge at DIFFERENT supersteps: each reports the steps
    IT paid, equal to its single run's, and finished queries stop sending."""
    g, (_, sub) = _subs(carried, "bfs")
    srcs = _sources(g, 4)
    singles = _singles(sub, "bfs", srcs, num_vertices=g.num_vertices)
    step_counts = [s.supersteps for _, s in singles]
    assert len(set(step_counts)) > 1, step_counts  # precondition: a real straggler
    vals, stats = eng.run_bsp_batch(sub, "bfs", srcs, num_vertices=g.num_vertices)
    assert [s.supersteps for s in stats] == step_counts
    assert_batch_matches_singles(vals, stats, singles)
    fastest = int(np.argmin(step_counts))
    np.testing.assert_array_equal(stats[fastest].messages_per_step,
                                  singles[fastest][1].messages_per_step)


def test_batch_single_dispatch(carried):
    g, (_, sub) = _subs(carried, "bfs")
    srcs = _sources(g, 3)
    eng.run_bsp_batch(sub, "bfs", srcs, num_vertices=g.num_vertices)  # warm
    base = dict(eng.DISPATCH_COUNTS)
    loops = eng.CAPTURES["loops"]
    eng.run_bsp_batch(sub, "bfs", srcs, num_vertices=g.num_vertices)
    assert eng.DISPATCH_COUNTS["batch"] == base["batch"] + 1
    assert eng.DISPATCH_COUNTS["fused"] == base.get("fused", 0)
    assert eng.DISPATCH_COUNTS["host"] == base.get("host", 0)
    assert eng.CAPTURES["loops"] == loops  # the warm batch reuses its loop


# ------------------------------------------------------ executables


def test_executable_matches_run_bsp_batch(carried):
    g, (_, sub) = _subs(carried, "bfs")
    srcs = _sources(g, 4)
    exe = eng.compile_batch_executable(sub, "bfs", 4, num_vertices=g.num_vertices)
    assert exe.compile_s > 0 and exe.batch == 4
    init = eng.batch_init("bfs", sub, srcs, num_vertices=g.num_vertices)
    vals, stats = exe.run(init)
    want_vals, want_stats = eng.run_bsp_batch(sub, "bfs", srcs, num_vertices=g.num_vertices)
    assert torch.equal(vals, want_vals)
    for a, b in zip(stats, want_stats):
        assert_stats_equal(a, b)
    assert_batch_matches_singles(vals, stats, _singles(sub, "bfs", srcs,
                                                       num_vertices=g.num_vertices))


def test_executable_padding_rows_run_no_step(carried):
    """With queries=n the rows behind the first n start done: the real
    queries are their single runs, bitwise, and the padding rows come back
    as their init with 0 supersteps."""
    g, (_, sub) = _subs(carried, "bfs")
    srcs = _sources(g, 2)
    exe = eng.compile_batch_executable(sub, "bfs", 4, num_vertices=g.num_vertices)
    init = eng.batch_init("bfs", sub, srcs + [srcs[-1]] * 2, num_vertices=g.num_vertices)
    vals, stats = exe.run(init, queries=2)
    assert_batch_matches_singles(vals[:2], stats[:2],
                                 _singles(sub, "bfs", srcs, num_vertices=g.num_vertices))
    assert torch.equal(vals[2:], init[2:]) and [s.supersteps for s in stats[2:]] == [0, 0]
    with pytest.raises(ValueError, match="queries"):
        exe.run(init, queries=5)


def test_executable_rejects_wrong_batch(carried):
    g, (_, sub) = _subs(carried, "bfs")
    exe = eng.compile_batch_executable(sub, "bfs", 4, num_vertices=g.num_vertices)
    init = eng.batch_init("bfs", sub, _sources(g, 2), num_vertices=g.num_vertices)
    with pytest.raises(ValueError, match="pad the batch"):
        exe.run(init)
    with pytest.raises(ValueError, match="batch must be"):
        eng.compile_batch_executable(sub, "bfs", 0, num_vertices=g.num_vertices)


# ------------------------------------------------- queue / cache units


def _q(qid, t, program="bfs", source=0):
    return Query(qid=qid, program=program, source=source, t_arrival=t)


def test_admission_queue_full_flush():
    q = AdmissionQueue(max_batch=2, max_delay_s=1.0)
    q.push(_q(0, 0.0))
    assert q.pop_full() == []
    q.push(_q(1, 0.1))
    (batch,) = q.pop_full()
    assert [x.qid for x in batch] == [0, 1]
    assert len(q) == 0


def test_admission_queue_deadline_flush():
    q = AdmissionQueue(max_batch=8, max_delay_s=0.5)
    q.push(_q(0, 0.0))
    q.push(_q(1, 0.2, program="cc", source=None))
    assert q.next_deadline() == pytest.approx(0.5)
    assert q.pop_due(0.4) == []
    due = q.pop_due(0.5)
    assert [[x.qid for x in b] for b in due] == [[0]]
    assert len(q) == 1
    assert q.next_deadline() == pytest.approx(0.7)


def test_admission_queue_pop_all_and_program_lanes():
    q = AdmissionQueue(max_batch=8, max_delay_s=1.0)
    for qid, prog in ((0, "bfs"), (1, "sssp"), (2, "bfs")):
        q.push(_q(qid, 0.0, program=prog))
    batches = q.pop_all()
    assert sorted(sorted(x.qid for x in b) for b in batches) == [[0, 2], [1]]
    assert q.next_deadline() is None and len(q) == 0


def test_queue_push_raises_load_shed():
    q = AdmissionQueue(max_batch=4, max_queue=1)
    q.push(Query(qid=0, program="cc", source=None, t_arrival=0.0))
    with pytest.raises(LoadShedError, match="reject-newest"):
        q.push(Query(qid=1, program="cc", source=None, t_arrival=0.0))


def test_executable_cache_builds_once():
    cache = ExecutableCache()
    built = []
    for _ in range(5):
        cache.get(("bfs", 4), lambda: built.append(1) or object())
    assert len(built) == 1
    assert cache.misses == 1 and cache.hits == 4
    assert cache.hit_rate == pytest.approx(0.8)
    assert cache.stats()["keys"] == 1 and cache.stats()["compiles_per_key_max"] == 1
    cache.get(("bfs", 8), lambda: object())
    assert cache.stats()["keys"] == 2


def test_synthetic_trace_matches_reference(small_powerlaw):
    g = interop.graph_from_numpy(small_powerlaw.src, small_powerlaw.dst,
                                 small_powerlaw.num_vertices)
    mix = (("bfs", 0.7), ("cc", 0.3))
    got = synthetic_trace(g, 24, rate_qps=2000.0, mix=mix, seed=1)
    want = ref_synthetic_trace(small_powerlaw, 24, rate_qps=2000.0, mix=mix, seed=1)
    assert got == want


# --------------------------------------------------------------- server


@pytest.fixture(scope="module")
def serve_pipe(small_powerlaw):
    g = interop.graph_from_numpy(small_powerlaw.src, small_powerlaw.dst,
                                 small_powerlaw.num_vertices)
    return GraphPipeline(g, device="cpu").partition("ebg", parts=4)


@pytest.fixture(scope="module")
def ref_serve_pipe(small_powerlaw):
    return RefPipeline(small_powerlaw).partition("ebg", parts=4)


def test_server_answers_match_single_runs(serve_pipe):
    g = serve_pipe.graph
    srcs = _sources(g, 3)
    server = serve_pipe.serve(max_batch=4, max_delay_s=0.01)
    qids = [server.submit("bfs", s, at=0.0) for s in srcs]
    qid_cc = server.submit("cc", at=0.001)
    assert server.pump(now=1.0) == 4
    for qid, s in zip(qids, srcs):
        r = server.result(qid)
        for driver in eng.DRIVERS:
            single = serve_pipe.run("bfs", source=s, driver=driver)
            np.testing.assert_array_equal(r.values, single.values)
            assert_stats_equal(r.stats, single.stats)
        assert r.batch == 3 and r.bucket == 4 and r.latency_s > 0
    np.testing.assert_array_equal(server.result(qid_cc).values, serve_pipe.run("cc").values)


def test_server_admission_validation(serve_pipe):
    server = serve_pipe.serve()
    with pytest.raises(ValueError, match="source"):
        server.submit("bfs", serve_pipe.graph.num_vertices)
    with pytest.raises(ValueError, match="whole-graph"):
        server.submit("cc", 5)
    assert len(server.queue) == 0
    with pytest.raises(KeyError, match="still queued"):
        server.result(server.submit("bfs", _sources(serve_pipe.graph, 1)[0]))


def test_server_full_batch_flushes_immediately(serve_pipe):
    server = serve_pipe.serve(max_batch=2, max_delay_s=1e9)
    for s in _sources(serve_pipe.graph, 2):
        server.submit("bfs", s, at=0.0)
    assert server.pump(now=0.0) == 2
    assert server.drain() == 0


def test_server_bucket_ladder_and_warm(serve_pipe):
    server = serve_pipe.serve(max_batch=8)
    assert server.buckets == (1, 2, 4, 8)
    assert server.levels == (("kernel", "batch"), ("kernel", "host"))
    assert server.warm(["bfs"]) > 0 and len(server.cache) == 4
    server.warm(["bfs"])
    assert server.cache.stats()["compiles_per_key_max"] == 1
    with pytest.raises(ValueError, match="bucket"):
        serve_pipe.serve(max_batch=8, buckets=(1, 2, 4))


def test_run_trace_report(serve_pipe, ref_serve_pipe):
    """The report's fields, and its counts equal the reference server's on
    the same trace (walls excluded: they are this host's)."""
    g = serve_pipe.graph
    trace = synthetic_trace(g, 24, rate_qps=2000.0, mix=(("bfs", 0.7), ("cc", 0.3)), seed=1)
    row = serve_pipe.serve(max_batch=4, max_delay_s=0.002).run_trace(trace).row()
    assert row["queries"] == 24 and row["throughput_qps"] > 0
    assert 0 <= row["latency_p50_s"] <= row["latency_p99_s"]
    assert 0 <= row["padding_waste"] < 1
    assert row["cache"]["compiles_per_key_max"] <= 1
    assert row["batches"] >= 24 / 4
    ref = ref_serve_pipe.serve(max_batch=4, max_delay_s=0.002).run_trace(trace).row()
    for k in ("queries", "batches", "mean_batch", "padding_waste", "supersteps_mean",
              "resilience"):
        assert row[k] == ref[k], k
    for k in ("keys", "hits", "misses", "hit_rate", "compiles_per_key_max"):
        assert row["cache"][k] == ref["cache"][k], k


def test_pipeline_run_batch_facade(serve_pipe):
    srcs = _sources(serve_pipe.graph, 3)
    batch = serve_pipe.run_batch("bfs", srcs)
    assert len(batch) == 3 and batch.sources == tuple(srcs)
    singles = [serve_pipe.run("bfs", source=s) for s in srcs]
    for i in range(3):
        np.testing.assert_array_equal(batch.values[i], singles[i].values)
        assert_stats_equal(batch.stats[i], singles[i].stats)
        np.testing.assert_array_equal(batch.query(i).to_global(), singles[i].to_global())
    np.testing.assert_array_equal(batch.supersteps_per_query,
                                  [s.stats.supersteps for s in singles])
    with pytest.raises(ValueError, match="source"):
        serve_pipe.run_batch("bfs", [0, -3])


# ------------------------------------------------------------ faults


@pytest.mark.parametrize("seed", [0, 7, 21, 12345])
def test_fault_plan_draws_match_reference(seed):
    kw = dict(seed=seed, transient_error_prob=0.4, max_transient_faults=5, straggler_prob=0.3,
              straggler_delay_s=0.01, malformed_batch_prob=0.2)
    plan, ref = FaultPlan(**kw), RefFaultPlan(**kw)
    for stream in ("transient", "malformed", "straggler", "backoff", "x"):
        assert [plan.draw(stream, i) for i in range(32)] == [ref.draw(stream, i)
                                                            for i in range(32)]
    assert [plan.transient_fault(i) for i in range(24)] == [ref.transient_fault(i)
                                                            for i in range(24)]
    assert [plan.malformed_batch(i) for i in range(24)] == [ref.malformed_batch(i)
                                                            for i in range(24)]
    assert [plan.straggler_delay(i) for i in range(24)] == [ref.straggler_delay(i)
                                                            for i in range(24)]
    assert [RetryPolicy().backoff_s(a, seed=seed, token=t) for a in range(3) for t in range(4)] \
        == [RefRetryPolicy().backoff_s(a, seed=seed, token=t) for a in range(3) for t in range(4)]


def test_fault_plan_ledger_targeting_validation():
    plan = FaultPlan(seed=1, transient_error_prob=1.0, max_transient_faults=3)
    assert [plan.transient_fault(i) for i in range(6)] == [True] * 3 + [False] * 3
    plan = FaultPlan(seed=2, transient_error_prob=1.0, transient_target_driver="batch")
    assert plan.transient_fault(0, backend="kernel", driver="batch")
    assert not plan.transient_fault(0, backend="kernel", driver="host")
    for bad in (dict(transient_error_prob=1.5), dict(crash_at_superstep=-1),
                dict(straggler_delay_s=-0.1), dict(max_transient_faults=-1)):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
    for bad in (dict(max_retries=-1), dict(multiplier=0.5), dict(jitter=2.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


# ------------------------------------------------------ resilient serving


def test_serving_retry_then_success_parity(serve_pipe):
    plain = serve_pipe.serve(max_batch=4, max_delay_s=0.001)
    chaos = serve_pipe.serve(
        max_batch=4, max_delay_s=0.001,
        fault_plan=FaultPlan(seed=5, transient_error_prob=1.0, max_transient_faults=2),
        retry=RetryPolicy(max_retries=3),
    )
    for srv in (plain, chaos):
        for s in (0, 3, 7):
            srv.submit("sssp", s)
        srv.drain()
    for qid in range(3):
        a, b = plain.result(qid), chaos.result(qid)
        assert b.ok
        np.testing.assert_array_equal(a.values, b.values)
        assert_stats_equal(a.stats, b.stats)
    c = chaos.resilience_counters()
    assert c["retries"] == 2 and c["faults_injected"] == 2
    assert c["terminated"] == c["answered"] == 3


def test_serving_retries_exhausted_named_failure(serve_pipe):
    srv = serve_pipe.serve(
        max_batch=2, max_delay_s=0.001,
        fault_plan=FaultPlan(seed=1, transient_error_prob=1.0),
        retry=RetryPolicy(max_retries=1), breaker=CircuitBreaker(threshold=100),
    )
    qid = srv.submit("cc")
    srv.drain()
    r = srv.result(qid)
    assert not r.ok and r.error == "retries_exhausted" and r.retries == 1
    assert srv.resilience_counters()["terminated"] == 1


def test_serving_deadline_expiry_named_timeout(serve_pipe):
    srv = serve_pipe.serve(
        max_batch=4, max_delay_s=0.001, deadline_s=0.002,
        fault_plan=FaultPlan(seed=9, straggler_prob=1.0, straggler_delay_s=0.05),
    )
    qid = srv.submit("cc", at=0.0)
    srv.drain()
    r = srv.result(qid)
    assert not r.ok and r.error == "deadline_exceeded" and r.latency_s <= 0.06


def test_serving_load_shed_bounded_queue(serve_pipe):
    srv = serve_pipe.serve(max_batch=8, max_delay_s=10.0, max_queue=2)
    qids = [srv.submit("cc") for _ in range(4)]
    for qid in qids[:2]:
        with pytest.raises(KeyError):
            srv.result(qid)
    for qid in qids[2:]:
        r = srv.result(qid)
        assert not r.ok and r.error == "load_shed"
    srv.drain()
    assert all(srv.result(q).ok for q in qids[:2])
    c = srv.resilience_counters()
    assert c["load_shed"] == 2 and c["terminated"] == 4


def test_serving_breaker_degrades_to_host_driver_with_parity(serve_pipe):
    """Faults that target the batched loop degrade to per-query host-driver
    runs on the same device — bit-identical answers."""
    plain = serve_pipe.serve(max_batch=2, max_delay_s=0.001)
    srv = serve_pipe.serve(
        max_batch=2, max_delay_s=0.001,
        fault_plan=FaultPlan(seed=6, transient_error_prob=1.0, transient_target_driver="batch"),
        retry=RetryPolicy(max_retries=4), breaker=CircuitBreaker(threshold=1, max_level=1),
    )
    base = eng.DISPATCH_COUNTS["host"]
    for s in (0, 5):
        plain.submit("bfs", s)
        srv.submit("bfs", s)
    plain.drain()
    srv.drain()
    for qid in range(2):
        a, b = plain.result(qid), srv.result(qid)
        assert b.ok
        np.testing.assert_array_equal(a.values, b.values)
        assert_stats_equal(a.stats, b.stats)
    assert srv.levels[srv.breaker.level] == ("kernel", "host")
    assert ("degrade", 0, 1) in srv.breaker.transitions
    assert srv.resilience_counters()["degraded_batches"] >= 1
    assert eng.DISPATCH_COUNTS["host"] > base  # the host driver answered


def test_serving_breaker_probe_recovery(serve_pipe):
    srv = serve_pipe.serve(
        max_batch=2, max_delay_s=0.001,
        fault_plan=FaultPlan(seed=8, transient_error_prob=1.0, max_transient_faults=3),
        retry=RetryPolicy(max_retries=10),
        breaker=CircuitBreaker(threshold=2, probe_after=1, max_level=1),
    )
    for s in range(6):
        srv.submit("sssp", s)
        srv.drain()
    assert srv.breaker.level == 0
    assert ("degrade", 0, 1) in srv.breaker.transitions
    assert ("recover", 1, 0) in srv.breaker.transitions
    assert all(srv.result(q).ok for q in range(6))


def test_serving_malformed_batch_retries(serve_pipe):
    srv = serve_pipe.serve(
        max_batch=2, max_delay_s=0.001, fault_plan=FaultPlan(seed=12, malformed_batch_prob=1.0),
        retry=RetryPolicy(max_retries=0), breaker=CircuitBreaker(threshold=100),
    )
    qid = srv.submit("cc")
    srv.drain()
    r = srv.result(qid)
    assert not r.ok and r.error == "retries_exhausted"
    assert srv.resilience_counters()["malformed_batches"] == 1


def test_serving_chaos_trace_every_query_terminates(serve_pipe):
    trace = synthetic_trace(serve_pipe.graph, 48, rate_qps=4000.0,
                            mix=(("cc", 0.3), ("sssp", 0.7)), seed=7)
    srv = serve_pipe.serve(
        max_batch=4, max_delay_s=0.002,
        fault_plan=FaultPlan(seed=11, transient_error_prob=0.3, straggler_prob=0.2,
                             straggler_delay_s=0.005),
        retry=RetryPolicy(max_retries=4), max_queue=64, deadline_s=10.0,
    )
    report = srv.run_trace(trace)
    c = report.resilience
    assert c["terminated"] == 48 and c["answered"] + c["failed"] == 48
    for qid in range(48):
        r = srv.result(qid)
        if not r.ok:
            assert r.error in ("deadline_exceeded", "retries_exhausted", "load_shed")
            assert r.retries <= 4


def _drain_each(pipe, plan_cls, retry_cls, breaker_cls, plan_kw, programs_sources):
    srv = pipe.serve(max_batch=2, max_delay_s=0.001, fault_plan=plan_cls(**plan_kw),
                     retry=retry_cls(max_retries=6), breaker=breaker_cls(threshold=3))
    for prog, s in programs_sources:
        srv.submit(prog, s)
        srv.drain()
    c = srv.resilience_counters()
    return c, srv.breaker.transitions, [srv.result(q).ok for q in range(len(programs_sources))]


@pytest.mark.parametrize("plan_kw", [
    dict(seed=21, transient_error_prob=0.5),
    dict(seed=3, transient_error_prob=0.9, transient_target_driver="batch"),
    dict(seed=4, transient_error_prob=0.4, malformed_batch_prob=0.3),
], ids=["untargeted", "target-batch", "malformed"])
def test_serving_chaos_matches_reference(serve_pipe, ref_serve_pipe, plan_kw):
    """A chaos scenario that drains after each submit: the reference's
    compute_backend="xla" ladder has two rungs, batch then host, like the
    port's, so faults, retries and breaker transitions must be equal; and
    the same seed replays the same schedule."""
    import repro.resilience as ref_res
    from repro_torch import resilience as res

    queries = [("sssp", s) for s in (0, 1, 2, 3)] + [("cc", None), ("bfs", 5)]
    got = _drain_each(serve_pipe, res.FaultPlan, res.RetryPolicy, res.CircuitBreaker, plan_kw,
                      queries)
    assert got == _drain_each(serve_pipe, res.FaultPlan, res.RetryPolicy, res.CircuitBreaker,
                              plan_kw, queries)
    want = _drain_each(ref_serve_pipe, ref_res.FaultPlan, ref_res.RetryPolicy,
                       ref_res.CircuitBreaker, plan_kw, queries)
    assert got == want


def test_pipeline_serve_exposes_failure_type():
    f = QueryFailure(qid=0, program="cc", source=None, error="load_shed",
                     t_arrival=0.0, t_done=0.0)
    assert not f.ok and f.latency_s == 0.0


# ------------------------------------------------------------ the CLI


def test_run_graph_serve_matches_reference():
    """`run_graph_serve` at its defaults against the reference's row: the
    same graph, trace, answered/failed counts, batches and supersteps
    (walls excluded: they are each host's own)."""
    got = run_graph_serve(device="cpu")
    want = ref_run_graph_serve()
    assert got["device"] == {"platform": "cpu", "kind": "cpu"}
    for k in ("graph", "trace", "faults", "queries", "batches", "mean_batch", "padding_waste",
              "supersteps_mean", "resilience"):
        assert got[k] == want[k], k
    assert got["resilience"]["answered"] == 200 and got["resilience"]["failed"] == 0
