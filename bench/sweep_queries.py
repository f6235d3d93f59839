"""The knee of an open-loop query cell: one process sets the cell up once,
then offers its traffic at rising rates, one window each, until the
server falls behind.

    python3 bench/sweep_queries.py --workload g500-22.ebv32.queries --seed 7 \
        --seconds 15 --rates 8,12,16,20,24,28,32,40 [--out chiprun_out/sweep.jsonl]

A rate is kept up when the queries answered a second (over the seconds
from the window's start to its last answer) are within 1% of the offered
rate and the last answer came less than a quarter second (about one SSSP
batch) after the window closed: no backlog is left.
The knee is the highest rate kept up below the first that is not. Prints
one JSON line a rate and a last line with the knee.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def kept_up(row: dict) -> bool:
    return row["queries_per_s"] >= 0.99 * row["rate_per_s"] and row["lag_s"] < 0.25


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="g500-22.ebv32.queries")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", default="8,12,16,20,24,28,32,40")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from bench import harness
    from bench.trace import Tracer

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 3
    _, _, cfg, wl = harness.cell_files(ROOT, args.workload)
    cell = harness.Cell(args.workload, cfg, wl, args.seed, "cuda")
    rec = harness.Record(cell=args.workload, seconds=args.seconds, trace=False)
    harness.generate(cell, rec)
    harness.deploy(cell, rec)
    traffic = harness.traffic_module(wl["kind"])
    state = traffic.setup(cell, rec)
    print(json.dumps({"setup_s": time.perf_counter() - T_START, "spans": rec.spans}), flush=True)
    out = open(args.out, "a") if args.out else None
    rows, knee = [], None
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.workload = copy.deepcopy(wl)
        cell.workload["rate_per_s"] = rate
        r = harness.Record(cell=args.workload, seconds=args.seconds, trace=False)
        state["server"]._results.clear()  # each window's answers: ~30 MB a query on the host
        state.update(qids=[], answered={}, done_at={})
        state["log_start"] = len(state["server"]._batch_log)
        traffic.window(cell, state, args.seconds, Tracer(enabled=False), r)
        lat = np.asarray(r.latencies_s) * 1e3
        real = sum(n for _, n, _, _ in r.batch_log)
        row = {"rate_per_s": rate, "offered": r.offered, "answered": r.answered,
               "queries_per_s": r.answered / r.span_s, "lag_s": r.span_s - args.seconds,
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "batches": len(r.batch_log), "mean_batch": real / max(len(r.batch_log), 1),
               "batch_ms_median": float(np.median([w for *_, w in r.batch_log]) * 1e3)}
        row["kept_up"] = kept_up(row)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        if not row["kept_up"]:
            break
        knee = rate
    summary = {"knee_per_s": knee, "rate_0.8_knee": None if knee is None else 0.8 * knee,
               "device": torch.cuda.get_device_name(0), "seed": args.seed,
               "seconds": args.seconds}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
