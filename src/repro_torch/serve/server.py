"""`GraphQueryServer` — the persistent graph-query serving loop (port of
`repro.serve.server`).

One server wraps one partitioned `GraphPipeline` and answers point
queries over its shared subgraph structure, on the pipeline's device:

  submit → admission queue (per-program lanes, full/deadline flush) →
  pad to bucket → warm `BatchExecutable` (its CUDA graph captured once per
  (program, bucket) key on the card) → one fused batched BSP loop →
  per-query results + `BSPStats`.

Per-query answers are bit-identical to single-source `run_bsp` calls:
padding lanes repeat a real query, start done (they run no step: the
kernels spend nothing on them) and are discarded after execution, and
convergence masking means each query's stats report the supersteps IT
paid, not the batch max.

Time is explicit rather than wall-clock-implicit so the server is
drivable both live (`submit()` + `pump()` with real timestamps) and in
simulation (`run_trace` replays a synthetic trace on a virtual clock,
charging real execution walls against it) — the same single-server
queueing discipline either way.

The resilient path: per-query deadlines drop expired work with a named
timeout failure; a bounded admission queue sheds the newest query under
overload (`LoadShedError` → `QueryFailure("load_shed")`); transient
backend failures (injected by a seeded `FaultPlan`, replayable
bit-for-bit) are retried with bounded exponential backoff + deterministic
jitter, the waits charged to the virtual clock; and a `CircuitBreaker`
walks the degradation ladder after consecutive failures. The port has no
compute backend to degrade (its local stage always runs the kernel, the
CUDA kernel on the card), so the reference's three rungs

    (compute_backend, "batch") → ("xla", "batch") → ("xla", "host")

become two, both on the pipeline's device:

    ("kernel", "batch") → ("kernel", "host")

the batched fused loop, then per-query runs of the host driver. A
`FaultPlan` targets a rung as in the reference: the server passes
backend="kernel" and the rung's driver ("batch" or "host"). Every rung
computes bit-identical answers (the parity suites pin fused≡host and
batch≡singles), so degradation trades latency, never correctness. Every
admitted query terminates as either a `QueryResult` or a named
`QueryFailure`; no injected fault escapes the pump.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Union

import numpy as np

from repro_torch.core.types import as_numpy
from repro_torch.graph.engine import (
    BSPStats,
    batch_init,
    check_source,
    compile_batch_executable,
    get_program,
    run_bsp,
)
from repro_torch.resilience.faults import (
    FaultPlan,
    LoadShedError,
    MalformedBatchError,
    TransientBackendError,
)
from repro_torch.resilience.retry import CircuitBreaker, RetryPolicy
from repro_torch.serve.cache import ExecutableCache
from repro_torch.serve.padding import DEFAULT_BUCKETS, bucket_size, pad_items, padding_waste
from repro_torch.serve.queue import AdmissionQueue, Query

log = logging.getLogger("repro_torch.resilience")

# The degradation ladder: (backend, path) rungs, every one on the
# pipeline's device and every one bit-identical in its answers.
LEVELS = (("kernel", "batch"), ("kernel", "host"))

# The retryable fault vocabulary: anything else raised by execution is a
# real bug and propagates (chaos tests assert ZERO unhandled exceptions
# from the injected kinds, not a blanket except).
_RETRYABLE = (TransientBackendError, MalformedBatchError)


@dataclasses.dataclass
class QueryResult:
    """One answered query: values are [p, max_v] (dump slot stripped),
    stats are THIS query's BSPStats under masking (its own superstep
    count). `batch`/`bucket` record the micro-batch it rode in."""

    qid: int
    program: str
    source: Optional[int]
    values: np.ndarray
    stats: BSPStats
    t_arrival: float
    t_done: float
    batch: int
    bucket: int

    ok = True

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def supersteps(self) -> int:
        return self.stats.supersteps


@dataclasses.dataclass
class QueryFailure:
    """One terminated-without-answer query. `error` is the named reason:
    "load_shed" (bounded queue rejected admission), "deadline_exceeded"
    (the deadline passed before execution), or "retries_exhausted" (every
    retry hit a fault). `retries` counts the backoff rounds paid."""

    qid: int
    program: str
    source: Optional[int]
    error: str
    t_arrival: float
    t_done: float
    retries: int = 0

    ok = False

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival


@dataclasses.dataclass
class ServerReport:
    """Aggregate serving metrics over everything the server answered.
    `resilience` carries the fault-path counters (retries, sheds,
    timeouts, injected faults, degraded batches, breaker state) — all
    zero on a fault-free run."""

    queries: int
    wall_s: float
    throughput_qps: float
    latency_p50_s: float
    latency_p99_s: float
    batches: int
    mean_batch: float
    padding_waste: float
    supersteps_mean: float
    cache: dict
    resilience: dict = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        return {
            "queries": self.queries,
            "wall_s": round(self.wall_s, 4),
            "throughput_qps": round(self.throughput_qps, 1),
            "latency_p50_s": round(self.latency_p50_s, 5),
            "latency_p99_s": round(self.latency_p99_s, 5),
            "batches": self.batches,
            "mean_batch": round(self.mean_batch, 2),
            "padding_waste": round(self.padding_waste, 4),
            "supersteps_mean": round(self.supersteps_mean, 2),
            "cache": self.cache,
            "resilience": self.resilience,
        }


class GraphQueryServer:
    """See module docstring. Knobs:

    max_batch / max_delay_s — the admission queue's flush policy (full
    batch fires immediately; a lone query waits at most max_delay_s).
    buckets — padded-batch ladder; defaults to the shared power-of-two
    ladder truncated at max_batch's bucket.
    max_supersteps / inner_cap / tol — engine knobs baked into every
    captured executable (part of the cache key).

    Resilience knobs: max_queue bounds the backlog (overflow load-sheds
    the arriving query); deadline_s is the default per-query deadline
    from arrival (submit can override); retry is the bounded-backoff
    policy for transient faults; breaker drives degradation (default: 3
    consecutive failures drop one rung of `LEVELS`, ["kernel" batch] ->
    ["kernel" host]); fault_plan injects deterministic chaos (tests/CI).
    """

    def __init__(
        self,
        pipeline,
        *,
        max_batch: int = 8,
        max_delay_s: float = 0.005,
        buckets=None,
        max_supersteps: Optional[int] = None,
        inner_cap: int = 10_000,
        tol: float = 0.0,
        max_queue: Optional[int] = None,
        deadline_s: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        fault_plan: Optional[FaultPlan] = None,
    ):
        pipeline._stage()  # require a partition stage up front
        top = bucket_size(max_batch, DEFAULT_BUCKETS if buckets is None else buckets)
        self.buckets = (
            tuple(b for b in DEFAULT_BUCKETS if b <= top) if buckets is None else tuple(buckets)
        )
        if bucket_size(max_batch, self.buckets) > max_batch:
            raise ValueError(
                f"buckets {self.buckets} cannot hold a full batch of {max_batch} "
                "without padding — include max_batch's bucket"
            )
        self.pipeline = pipeline
        self.max_supersteps = max_supersteps
        self.inner_cap = inner_cap
        self.tol = tol
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.retry = RetryPolicy() if retry is None else retry
        self.fault_plan = fault_plan
        # Degradation ladder: every rung computes bit-identical answers.
        self.levels: tuple = LEVELS
        self.breaker = (
            CircuitBreaker(threshold=3, max_level=len(self.levels) - 1)
            if breaker is None else breaker
        )
        self.queue = AdmissionQueue(
            max_batch=max_batch, max_delay_s=max_delay_s, max_queue=max_queue
        )
        self.cache = ExecutableCache()
        self._results: dict[int, QueryResult] = {}
        self._failures: dict[int, QueryFailure] = {}
        self._batch_log: list[tuple] = []  # (program, n_real, bucket, exec_wall_s)
        self._next_qid = 0
        self._clock = 0.0
        self._attempt = 0  # global execution-attempt counter (fault draws)
        self._batch_seq = 0  # global batch counter (straggler draws)
        self._counters = {
            "load_shed": 0, "deadline_exceeded": 0, "retries": 0,
            "retries_exhausted": 0, "faults_injected": 0, "malformed_batches": 0,
            "stragglers": 0, "degraded_batches": 0,
        }

    # ------------------------------------------------------------ admission

    def submit(
        self,
        program,
        source: Optional[int] = None,
        *,
        at: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Admit one query; returns its qid. Source-rooted programs
        validate `source` HERE — a bad source rejects this query alone,
        before it can join (and poison) a micro-batch. A full bounded
        queue sheds the query (reject-newest): the qid still resolves,
        to a `QueryFailure` named "load_shed"."""
        prog = get_program(program)
        sub = self._sub_for(prog)
        if prog.needs_source:
            source = check_source(sub, source, self.pipeline.graph.num_vertices)
        elif source is not None:
            raise ValueError(
                f"program {prog.name!r} is a whole-graph query; source= does not apply"
            )
        at = self._clock if at is None else float(at)
        self._clock = max(self._clock, at)
        qid = self._next_qid
        self._next_qid += 1
        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        query = Query(
            qid=qid, program=prog.name, source=source, t_arrival=at,
            deadline=None if budget is None else at + budget,
        )
        try:
            self.queue.push(query)
        except LoadShedError:
            self._counters["load_shed"] += 1
            self._fail(query, "load_shed", at)
        return qid

    def pump(self, now: Optional[float] = None) -> int:
        """Execute every micro-batch due at `now` (full lanes plus lanes
        past their deadline). Returns the number of queries terminated
        (answered or failed with a named reason)."""
        now = self._clock if now is None else float(now)
        self._clock = max(self._clock, now)
        done = 0
        for batch in self.queue.pop_due(self._clock):
            self._clock = self._execute(batch, self._clock)
            done += len(batch)
        return done

    def drain(self) -> int:
        """Force-flush everything still queued."""
        done = 0
        for batch in self.queue.pop_all():
            self._clock = self._execute(batch, self._clock)
            done += len(batch)
        return done

    def result(self, qid: int) -> Union[QueryResult, QueryFailure]:
        """The query's terminal outcome: a `QueryResult` answer or a
        named `QueryFailure` (check `.ok`)."""
        if qid in self._results:
            return self._results[qid]
        if qid in self._failures:
            return self._failures[qid]
        raise KeyError(f"query {qid} has no result yet (still queued? call pump/drain)")

    # ------------------------------------------------------------ execution

    def _sub_for(self, prog):
        """The program's build of the shared partition (bidirectional
        programs run the symmetrized build), cached by the pipeline."""
        return self.pipeline.subgraphs_for(**self.pipeline._build_params_for(prog, None, None))

    def _key_for(self, prog, sub, bucket: int) -> tuple:
        return (
            prog.name, int(bucket), sub.num_parts, sub.max_v, sub.max_e, sub.max_msg,
            prog.dtype, self.max_supersteps, self.inner_cap, self.tol,
        )

    def _executable(self, prog, sub, bucket: int):
        return self.cache.get(
            self._key_for(prog, sub, bucket),
            lambda: compile_batch_executable(
                sub, prog, bucket,
                max_supersteps=self.max_supersteps, inner_cap=self.inner_cap, tol=self.tol,
                num_vertices=self.pipeline.graph.num_vertices,
            ),
        )

    def warm(self, programs, buckets=None) -> float:
        """Build (on the card: capture) the executables for `programs` ×
        `buckets` (default: the server's whole ladder) so live traffic
        never pays a capture. Returns the seconds it took."""
        t0 = time.perf_counter()
        for program in programs:
            prog = get_program(program)
            sub = self._sub_for(prog)
            for b in (self.buckets if buckets is None else buckets):
                self._executable(prog, sub, int(b))
        return time.perf_counter() - t0

    def _fail(self, query, error: str, now: float, retries: int = 0) -> None:
        self._failures[query.qid] = QueryFailure(
            qid=query.qid, program=query.program, source=query.source, error=error,
            t_arrival=query.t_arrival, t_done=now, retries=retries,
        )

    def _drop_expired(self, queries: list, now: float, retries: int = 0) -> list:
        live = []
        for q in queries:
            if q.deadline is not None and now >= q.deadline:
                self._counters["deadline_exceeded"] += 1
                self._fail(q, "deadline_exceeded", now, retries)
            else:
                live.append(q)
        return live

    def _run_batch(self, prog, sub, queries: list, path: str):
        """One execution attempt at a degradation rung. Returns
        (per-query values, per-query stats, wall_s, bucket)."""
        nv = self.pipeline.graph.num_vertices
        if path == "host":
            # Deepest rung: per-query host-driver runs — one superstep and
            # one host sync per iteration, no batching. Slowest, simplest,
            # bit-identical (driver-parity suites).
            t0 = time.perf_counter()
            vals, stats = [], []
            for q in queries:
                v, s = run_bsp(
                    sub, prog, driver="host",
                    max_supersteps=self.max_supersteps, inner_cap=self.inner_cap,
                    tol=self.tol, num_vertices=nv, source=q.source,
                )
                vals.append(as_numpy(v)[:, :-1])  # strip the dump slot
                stats.append(s)
            return vals, stats, time.perf_counter() - t0, len(queries)
        bucket = bucket_size(len(queries), self.buckets)
        exe = self._executable(prog, sub, bucket)
        t0 = time.perf_counter()
        if prog.needs_source:
            init = batch_init(
                prog, sub, pad_items([q.source for q in queries], bucket), num_vertices=nv
            )
        else:
            init = batch_init(prog, sub, batch=bucket, num_vertices=nv)
        vals, stats = exe.run(init, queries=len(queries))  # padding lanes run no step
        vals = as_numpy(vals[:, :, :-1])  # strip the dump slot; padding lanes dropped
        wall = time.perf_counter() - t0
        return [vals[i] for i in range(len(queries))], stats, wall, bucket

    def _execute(self, queries: list, t_start: float) -> float:
        """Run one micro-batch through the resilient path; returns its
        completion time (t_start plus injected straggler delay, backoff
        waits, and the real execution wall — the virtual clock is charged
        what the hardware actually took). Every query in the batch
        terminates: answered, or failed with a named reason."""
        prog = get_program(queries[0].program)
        sub = self._sub_for(prog)
        now = t_start
        batch_seq = self._batch_seq
        self._batch_seq += 1
        if self.fault_plan is not None:
            delay = self.fault_plan.straggler_delay(batch_seq)
            if delay:
                self._counters["stragglers"] += 1
                now += delay
        live = self._drop_expired(queries, now)
        if not live:
            return now
        retries = 0
        while True:
            probing = self.breaker.should_probe()
            level = self.breaker.level - 1 if probing else self.breaker.level
            backend, path = self.levels[min(max(level, 0), len(self.levels) - 1)]
            attempt = self._attempt
            self._attempt += 1
            try:
                if self.fault_plan is not None:
                    if self.fault_plan.malformed_batch(attempt):
                        self._counters["malformed_batches"] += 1
                        raise MalformedBatchError(
                            f"injected malformed batch (attempt {attempt})"
                        )
                    if self.fault_plan.transient_fault(attempt, backend=backend, driver=path):
                        self._counters["faults_injected"] += 1
                        raise TransientBackendError(
                            f"injected transient {backend}/{path} fault (attempt {attempt})"
                        )
                vals, stats, wall, bucket = self._run_batch(prog, sub, live, path)
            except _RETRYABLE as e:
                self.breaker.record_failure(probe=probing)
                if retries >= self.retry.max_retries:
                    log.warning("batch %d: %s; retry budget exhausted", batch_seq, e)
                    self._counters["retries_exhausted"] += len(live)
                    for q in live:
                        self._fail(q, "retries_exhausted", now, retries)
                    return now
                backoff = self.retry.backoff_s(
                    retries,
                    seed=0 if self.fault_plan is None else self.fault_plan.seed,
                    token=attempt,
                )
                log.info("batch %d: %s; retry %d in %.4fs", batch_seq, e, retries + 1, backoff)
                now += backoff
                retries += 1
                self._counters["retries"] += 1
                live = self._drop_expired(live, now, retries)
                if not live:
                    return now
            else:
                self.breaker.record_success(probe=probing)
                if level > 0:
                    self._counters["degraded_batches"] += 1
                break
        t_done = now + wall
        for i, q in enumerate(live):
            self._results[q.qid] = QueryResult(
                qid=q.qid, program=prog.name, source=q.source, values=vals[i],
                stats=stats[i], t_arrival=q.t_arrival, t_done=t_done,
                batch=len(live), bucket=bucket,
            )
        self._batch_log.append((prog.name, len(live), bucket, wall))
        return t_done

    # ------------------------------------------------------------- replay

    def run_trace(self, trace, *, warm: bool = True) -> ServerReport:
        """Replay [(t, program, source)] through the queueing discipline
        on a virtual clock: arrivals are admitted in time order, a full
        lane flushes on the admission that fills it, a partial lane
        flushes when its deadline passes, and each batch's REAL execution
        wall advances the clock (so queue latency includes waiting behind
        earlier batches). `warm=True` captures every (program, bucket)
        first — steady-state behaviour, no capture in the latency path."""
        events = sorted(trace, key=lambda e: e[0])
        if not events:
            raise ValueError("empty trace")
        if warm:
            self.warm({program for _, program, _ in events})
        t_first = float(events[0][0])
        self._clock = max(self._clock, t_first)
        i = 0
        while i < len(events) or len(self.queue):
            deadline = self.queue.next_deadline()
            if i < len(events) and (deadline is None or events[i][0] <= deadline):
                t, program, source = events[i]
                i += 1
                self._clock = max(self._clock, float(t))
                self.submit(program, source, at=float(t))
                for batch in self.queue.pop_full():
                    self._clock = self._execute(batch, self._clock)
            else:
                self._clock = max(self._clock, deadline)
                for batch in self.queue.pop_due(self._clock):
                    self._clock = self._execute(batch, self._clock)
        return self.report(wall_s=self._clock - t_first)

    def resilience_counters(self) -> dict:
        """Fault-path accounting: counters, breaker state, and the
        answered/failed split. `terminated` == answered + failed is the
        every-query-accounted-for invariant chaos CI asserts."""
        return {
            **self._counters,
            "breaker_level": self.breaker.level,
            "breaker_transitions": len(self.breaker.transitions),
            "answered": len(self._results),
            "failed": len(self._failures),
            "terminated": len(self._results) + len(self._failures),
        }

    def report(self, wall_s: Optional[float] = None) -> ServerReport:
        results = list(self._results.values())
        if not results and not self._failures:
            raise RuntimeError("no answered queries to report on")
        lat = np.asarray([r.latency_s for r in results]) if results else np.zeros((1,))
        if wall_s is None:
            done = [r.t_done for r in results] or [f.t_done for f in self._failures.values()]
            arr = [r.t_arrival for r in results] or [f.t_arrival for f in self._failures.values()]
            wall_s = float(max(done) - min(arr))
        reals = sum(n for _, n, _, _ in self._batch_log)
        pads = sum(b for _, _, b, _ in self._batch_log)
        nbatches = max(len(self._batch_log), 1)
        return ServerReport(
            queries=len(results),
            wall_s=float(wall_s),
            throughput_qps=len(results) / wall_s if wall_s > 0 else float("inf"),
            latency_p50_s=float(np.percentile(lat, 50)),
            latency_p99_s=float(np.percentile(lat, 99)),
            batches=len(self._batch_log),
            mean_batch=reals / nbatches,
            padding_waste=padding_waste(reals, pads) if pads else 0.0,
            supersteps_mean=float(np.mean([r.supersteps for r in results])) if results else 0.0,
            cache=self.cache.stats(),
            resilience=self.resilience_counters(),
        )
