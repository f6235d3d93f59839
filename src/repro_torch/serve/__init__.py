"""repro_torch.serve — the graph-query serving tier (port of `repro.serve`).

Turns the one-shot partition → build → run pipeline into a persistent
query server over a shared partitioned graph: an admission queue
micro-batches point queries per program (`queue`), batches are padded to
a small set of bucket sizes (`padding`), and each (program, bucket)
executes through a warm `BatchExecutable` (`cache` +
`repro_torch.graph.engine.compile_batch_executable`: on the card a CUDA
graph of the batched loop, captured once) so steady-state traffic never
captures. Per-query results and `BSPStats` are bit-identical to
single-source `run_bsp` calls — convergence masking means a query pays
only its own supersteps, not the batch max.

The serving path is resilient (`repro_torch.resilience`): per-query
deadlines, a bounded admission queue with reject-newest load shedding,
bounded retry with deterministic backoff for transient faults, and a
circuit breaker that degrades the batched fused loop to per-query host
driver runs under consecutive failures — bit-identical answers at every
rung, on the pipeline's device. Every admitted query terminates as a
`QueryResult` or a named `QueryFailure`.

Entry points: `GraphPipeline.serve()` returns a `GraphQueryServer`;
`GraphPipeline.run_batch()` is the one-shot batched call; the
`repro_torch.launch.graph_serve` CLI replays a synthetic power-law trace.
"""
from repro_torch.serve.cache import ExecutableCache
from repro_torch.serve.padding import DEFAULT_BUCKETS, bucket_size, pad_batch_rows, padding_waste
from repro_torch.serve.queue import AdmissionQueue, Query
from repro_torch.serve.server import GraphQueryServer, QueryFailure, QueryResult, ServerReport
from repro_torch.serve.trace import synthetic_trace

__all__ = [
    "AdmissionQueue",
    "DEFAULT_BUCKETS",
    "ExecutableCache",
    "GraphQueryServer",
    "Query",
    "QueryFailure",
    "QueryResult",
    "ServerReport",
    "bucket_size",
    "pad_batch_rows",
    "padding_waste",
    "synthetic_trace",
]
