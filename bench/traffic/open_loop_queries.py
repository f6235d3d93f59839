"""Open-loop point queries through the program's query server.

Independent users send BFS and SSSP queries from Graph500 search keys.
Arrivals are Poisson-like at `rate_per_s`: every seed offers the same
round(rate * seconds) queries with the same set of exponential gaps and
the same share of each program, in orders drawn from the seed, so seeds
differ in order and not in amount of work. The harness submits each query at its
due time (`GraphQueryServer.submit(program, source, at=due)`) and pumps
the server on its own clock; a query's latency runs from its due time to
the moment the pump that answered it returns.

A traced run profiles the whole window: the profiler starts before the
window's clock does and stops after the last answer, so its start-up
(seconds, the first time) and its stop delay no query.

Workload keys: `programs`, `mix` (shares, summing to 1), `rate_per_s`,
`server` (keywords of `GraphPipeline.serve`), `warm_buckets` and `check`
({"answers": queries compared, split evenly over the programs}).
"""
from __future__ import annotations

import time

import numpy as np

from bench.gen import stream_seed


def plan(workload: dict, seconds: float, keys: np.ndarray, seed: int) -> list:
    """[(due_s, program, source)] of the window, sorted by due time: the
    same n = round(rate * seconds) exponential gaps for every seed (the
    quantiles of the exponential distribution, scaled to the window), in
    an order drawn from the seed, and the mix's programs in an order drawn
    from the seed."""
    rng = np.random.default_rng(stream_seed(seed, "arrivals"))
    n = int(round(workload["rate_per_s"] * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)[rng.permutation(n)]
    due = (np.cumsum(gaps) - gaps[0]) * seconds / gaps.sum()
    counts = np.floor(np.asarray(workload["mix"]) * n).astype(int)
    counts[0] += n - counts.sum()
    programs = np.repeat(np.asarray(workload["programs"]), counts)
    rng.shuffle(programs)
    sources = keys[np.arange(n) % keys.shape[0]]
    return [(float(t), str(p), int(s)) for t, p, s in zip(due, programs, sources)]


def checked(workload: dict, queries: list, seed: int) -> list:
    """Indices into `queries` (the window's plan) of the queries a run
    compares: an even share of each program, drawn from the seed."""
    rng = np.random.default_rng(stream_seed(seed, "check_sample"))
    share = workload["check"]["answers"] // len(workload["programs"])
    out = []
    for program in workload["programs"]:
        idx = [i for i, q in enumerate(queries) if q[1] == program]
        out += [int(i) for i in rng.permutation(idx)[:share]]
    return out


def checked_pairs(workload: dict, keys: np.ndarray, seed: int, seconds: float) -> list:
    """The (program, source) pairs a run of `seconds` compares."""
    queries = plan(workload, seconds, keys, seed)
    return [queries[i][1:] for i in checked(workload, queries, seed)]


def setup(cell, rec) -> dict:
    """Open the server and warm every (program, bucket) the traffic uses:
    a capture each, then one batch each through submit and pump."""
    wl = cell.workload
    server = cell.pipe.serve(**wl["server"])
    server.warm(wl["programs"], buckets=wl["warm_buckets"])
    for program in wl["programs"]:
        for bucket in wl["warm_buckets"]:
            for i in range(bucket):
                server.submit(program, int(cell.keys[-1 - i]), at=time.perf_counter())
            server.drain()
    return {"server": server, "log_start": len(server._batch_log), "qids": [], "answered": {},
            "done_at": {}}


def window(cell, state, seconds: float, tracer, rec) -> None:
    server = state["server"]
    wl = cell.workload
    queries = state["plan"] = plan(wl, seconds, cell.keys, cell.seed)
    qids, answered, done_at = state["qids"], state["answered"], state["done_at"]
    pending = []
    tracer.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        while i < len(queries) and queries[i][0] <= now:
            due, program, source = queries[i]
            qid = server.submit(program, source, at=t0 + due)
            qids.append(qid)
            pending.append(qid)
            i += 1
        if server.pump(t0 + now):
            t_done = time.perf_counter() - t0
            still = []
            for qid in pending:
                try:
                    res = server.result(qid)
                except KeyError:
                    still.append(qid)
                    continue
                answered[qid] = (res.program, res.source)
                done_at[qid] = t_done
            pending = still
        if i >= len(queries) and not pending:
            break
        if i >= len(queries) and now > seconds + 60.0:
            break  # a minute past the close: what is still pending never came
        nxt = [queries[i][0]] if i < len(queries) else []
        deadline = server.queue.next_deadline()
        if deadline is not None:
            nxt.append(deadline - t0)
        wait = min(nxt) - (time.perf_counter() - t0) if nxt else 0.0005
        if wait > 0:
            time.sleep(min(wait, 0.05))
    if tracer.active:
        tracer.stop()
        rec.traced_work = list(answered.values())
    dues = {qid: q[0] for qid, q in zip(qids, queries)}
    ok = [qid for qid in qids if qid in done_at and server.result(qid).ok]
    rec.offered = len(queries)
    rec.answered = len(ok)
    rec.latencies_s = [done_at[qid] - dues[qid] for qid in ok]
    rec.span_s = max([seconds] + [done_at[qid] for qid in ok])
    rec.batch_log = list(server._batch_log[state["log_start"]:])


def outcome(cell, state, rec) -> tuple:
    """(queries offered, queries never answered)."""
    return rec.offered, rec.offered - rec.answered


def answers(cell, state) -> list:
    """The answers of the queries `checked` draws, in global vertex order;
    a drawn query that was never answered is missing (it also counts as
    unanswered)."""
    from bench.harness import Answer
    from repro_torch.graph.algorithms import scatter_to_global

    server, done_at, qids = state["server"], state["done_at"], state["qids"]
    sub, nv = cell.pipe.subgraphs, cell.pipe.graph.num_vertices
    out = []
    for i in checked(cell.workload, state["plan"], cell.seed):
        qid = qids[i] if i < len(qids) else None
        if qid in done_at and server.result(qid).ok:
            res = server.result(qid)
            out.append(Answer(res.program, res.source, scatter_to_global(sub, res.values, nv)))
    return out
