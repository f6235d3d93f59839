"""Graph-query serving driver (port of `repro.launch.graph_serve`): replay
a synthetic power-law query trace through the persistent
`GraphQueryServer` and report serving metrics (throughput, p50/p99 queue
latency, padding waste, executable-cache hit rate) as one JSON line. It
runs on the CUDA card unless `--device cpu` asks for the CPU (the
kernels' plain versions); the row names the device.

  PYTHONPATH=src python -m repro_torch.launch.graph_serve --queries 200 --rate 2000
  PYTHONPATH=src python -m repro_torch.launch.graph_serve --device cpu

Chaos mode: `--transient-prob`/`--straggler-prob`/`--malformed-prob` (with
`--fault-seed`) inject a deterministic `FaultPlan` into the serving path;
`--max-retries`, `--deadline-ms`, and `--max-queue` exercise the retry/
timeout/load-shed machinery. The output row then carries the resilience
counters, and the driver asserts the every-query-accounted-for invariant:
answered + failed == submitted, zero unhandled exceptions.

  PYTHONPATH=src python -m repro_torch.launch.graph_serve --queries 120 \
      --transient-prob 0.2 --fault-seed 7 --max-retries 4

The flags and the row are the reference's, except that the port has no
`--backend` (its local stage always runs the kernel) and takes
`--device`.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.api.pipeline import GraphPipeline
from repro_torch.graph.generate import rmat
from repro_torch.resilience import FaultPlan, RetryPolicy
from repro_torch.serve.trace import synthetic_trace


def run_graph_serve(
    *,
    num_vertices: int = 1 << 12,
    num_edges: int = 40_000,
    parts: int = 8,
    partitioner: str = "ebg_chunked",
    queries: int = 200,
    rate_qps: float = 2000.0,
    max_batch: int = 8,
    max_delay_s: float = 0.005,
    programs: tuple = ("bfs", "sssp"),
    device=None,
    seed: int = 0,
    fault_seed: int = 0,
    transient_prob: float = 0.0,
    straggler_prob: float = 0.0,
    straggler_delay_s: float = 0.0,
    malformed_prob: float = 0.0,
    max_retries: int = 3,
    deadline_s=None,
    max_queue=None,
) -> dict:
    """Build graph → partition → serve a trace on `device` (the card when
    None); returns the report row plus the setup facts. Non-zero fault
    probabilities arm the deterministic chaos plan; the run must still
    terminate every query."""
    graph = rmat(num_vertices, num_edges, seed=seed, a=0.65, b=0.15, c=0.15)
    pipe = GraphPipeline(graph, device=device).partition(partitioner, parts=parts)
    chaos = transient_prob > 0 or straggler_prob > 0 or malformed_prob > 0
    fault_plan = FaultPlan(
        seed=fault_seed,
        transient_error_prob=transient_prob,
        straggler_prob=straggler_prob,
        straggler_delay_s=straggler_delay_s,
        malformed_batch_prob=malformed_prob,
    ) if chaos else None
    server = pipe.serve(
        max_batch=max_batch, max_delay_s=max_delay_s,
        fault_plan=fault_plan, retry=RetryPolicy(max_retries=max_retries),
        deadline_s=deadline_s, max_queue=max_queue,
    )
    trace = synthetic_trace(
        graph, queries, rate_qps=rate_qps,
        mix=tuple((p, 1.0) for p in programs), seed=seed,
    )
    report = server.run_trace(trace)
    counters = server.resilience_counters()
    # The resilience invariant: every admitted query terminated, answered
    # or failed with a named reason — nothing lost, nothing unhandled.
    if counters["terminated"] != queries:
        raise AssertionError(
            f"serving trace lost queries: {counters['terminated']} terminated "
            f"of {queries} submitted ({counters})"
        )
    dev = pipe.device
    return {
        "device": {"platform": dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"},
        "graph": {"num_vertices": graph.num_vertices, "num_edges": graph.num_edges,
                  "p": parts, "partitioner": partitioner},
        "trace": {"queries": queries, "rate_qps": rate_qps,
                  "programs": list(programs), "max_batch": max_batch,
                  "max_delay_s": max_delay_s},
        "faults": {"enabled": chaos, "seed": fault_seed,
                   "transient_prob": transient_prob, "straggler_prob": straggler_prob,
                   "malformed_prob": malformed_prob, "max_retries": max_retries},
        **report.row(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vertices", type=int, default=1 << 12)
    ap.add_argument("--edges", type=int, default=40_000)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--partitioner", default="ebg_chunked")
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--rate", type=float, default=2000.0, help="arrival rate (queries/s)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--programs", default="bfs,sssp", help="comma-separated program mix")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the current card) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0, help="FaultPlan seed (chaos replay)")
    ap.add_argument("--transient-prob", type=float, default=0.0,
                    help="per-attempt injected transient backend error probability")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-batch injected straggler probability")
    ap.add_argument("--straggler-delay-ms", type=float, default=10.0,
                    help="virtual delay charged per injected straggler")
    ap.add_argument("--malformed-prob", type=float, default=0.0,
                    help="per-attempt injected malformed-batch probability")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="bounded retry budget per micro-batch")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query deadline from arrival (default: none)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission queue bound (overflow load-sheds)")
    args = ap.parse_args(argv)
    out = run_graph_serve(
        num_vertices=args.vertices, num_edges=args.edges, parts=args.parts,
        partitioner=args.partitioner, queries=args.queries, rate_qps=args.rate,
        max_batch=args.max_batch, max_delay_s=args.max_delay_ms / 1000.0,
        programs=tuple(p.strip() for p in args.programs.split(",") if p.strip()),
        device=args.device, seed=args.seed,
        fault_seed=args.fault_seed, transient_prob=args.transient_prob,
        straggler_prob=args.straggler_prob,
        straggler_delay_s=args.straggler_delay_ms / 1000.0,
        malformed_prob=args.malformed_prob, max_retries=args.max_retries,
        deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1000.0,
        max_queue=args.max_queue,
    )
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
