"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one cell is data: its configuration
(`bench/configs/<config>.json`, named in BENCHMARK.json), its traffic
(`bench/workloads/<cell>.json`, whose `kind` names the generator module
`bench/traffic/<kind>.py`) and its metrics (one reader each,
`bench/metrics/<metric>.py`, or `<metric before its first dot>.py`, whose
`read(rec)` returns the number or None where the run has nothing to read).

The program under test is `repro_torch`: the harness hands it the
generated graph and reads back its answers, spans around its calls and
its counters. The reference (`bench/reference.py`) recomputes every
checked answer from the generated graph alone, after the window, once the
program's state is freed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bench import compare, gen, reference
from bench.trace import Tracer

BENCH_DIR = Path(__file__).resolve().parent
# Deployment modes the traffic can drive: "sim" runs every worker's
# subgraph on one card (the query server serves that mode only).
DRIVEN_MODES = ("sim",)


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: str
    seconds: float
    trace: bool
    num_vertices: int = 0
    num_edges: int = 0
    spans: dict = dataclasses.field(default_factory=dict)  # seconds by span name
    setup_s: float = 0.0
    # Open-loop traffic: every query due in the window.
    offered: int = 0
    answered: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    span_s: float = 0.0  # from the window's start to its last answer, at least `seconds`
    batch_log: list = dataclasses.field(default_factory=list)  # (program, real, bucket, wall_s)
    # Closed-loop jobs.
    jobs: int = 0
    window_s: float = 0.0
    host_syncs: int = 0
    messages: int = 0
    # The partition and the trace.
    replication_factor: Optional[float] = None
    traced_work: list = dataclasses.field(default_factory=list)  # (program, source) run traced
    traced_bytes: Optional[int] = None
    device_trace: Optional[dict] = None
    peaks: dict = dataclasses.field(default_factory=dict)  # bench/peaks.json
    device_kind: Optional[str] = None

    @property
    def ev_per_job(self) -> int:
        return self.num_vertices + self.num_edges


@dataclasses.dataclass
class Answer:
    """One answer to check: a program's per-vertex values in global order."""

    program: str
    source: Optional[int]
    values: np.ndarray


class Cell:
    """A cell's set-up and state, shared by the harness and its traffic."""

    def __init__(self, name: str, config: dict, workload: dict, seed: int, device):
        self.name, self.config, self.workload, self.seed = name, config, workload, int(seed)
        self.device = torch.device(device)
        self.mode = config["deployment"]["mode"]
        self.pipe = None
        self.edges = None  # host copies of the generated graph (the reference's inputs)
        self.keys: Optional[np.ndarray] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, cell: str) -> tuple:
    """(BENCHMARK.json's entry of `cell`, its configuration, its workload)."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        names = [w["name"] for w in bench["workloads"]]
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has {names}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return bench, entry, load_json(root / conf["file"]), load_json(BENCH_DIR / "workloads" / f"{cell}.json")


def traffic_module(kind: str):
    return importlib.import_module(f"bench.traffic.{kind}")


def metric_reader(name: str):
    """The `read` function of metric `name`'s reader module."""
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "bench_metric_" + stem.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH_DIR / 'metrics'}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: the end-to-end ones with
    --trace 0, the per-layer ones with --trace 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


# ------------------------------------------------------------------ set-up


def generate(cell: Cell, rec: Record) -> None:
    """The graph, its weights and the search keys, made on the device from
    the seed; the program and the reference get host copies."""
    gcfg = cell.config["graph"]
    t0 = time.perf_counter()
    el = gen.kronecker(gcfg["scale"], gcfg["edge_factor"], gcfg["a"], gcfg["b"], gcfg["c"],
                       seed=cell.seed, device=cell.device)
    keys = gen.search_keys(el.num_vertices, cell.workload["search_keys"], seed=cell.seed,
                           device=cell.device)
    cell.edges = (el.src.cpu(), el.dst.cpu(), el.weight.cpu(), el.num_vertices)
    cell.keys = keys.cpu().numpy()
    rec.num_vertices, rec.num_edges = el.num_vertices, el.num_edges
    del el, keys
    cell.sync()
    rec.spans["generate"] = time.perf_counter() - t0


def deploy(cell: Cell, rec: Record) -> None:
    """Partition and build, as the configuration's deployment states."""
    from repro_torch.api import GraphPipeline
    from repro_torch.core.types import Graph

    dep = cell.config["deployment"]
    if dep["mode"] not in DRIVEN_MODES:
        raise SystemExit(f"deployment mode {dep['mode']!r}: the harness drives {DRIVEN_MODES} only")
    src, dst, weight, nv = cell.edges
    pipe = GraphPipeline(Graph(src=src, dst=dst, num_vertices=nv), weights=weight.numpy(),
                         device=cell.device)
    t0 = time.perf_counter()
    pipe = pipe.partition(dep["partitioner"], parts=dep["parts"], **dep.get("options", {}))
    pipe.result
    cell.sync()
    rec.spans["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = pipe.build(**dep["build"])
    pipe.subgraphs
    cell.sync()
    rec.spans["build"] = time.perf_counter() - t0
    cell.pipe = pipe


# ------------------------------------------------------------ after window


def partition_check(cell: Cell) -> tuple:
    """(bad edges, the assignment in input order): an input edge is bad
    unless it sits in exactly one part in [0, parts)."""
    res = cell.pipe.result
    p, E = res.num_parts, int(cell.edges[0].shape[0])
    part = res.part.detach().to("cpu", torch.int64)
    bad = abs(int(part.shape[0]) - E)
    part = part[:E]
    bad += int(((part < 0) | (part >= p)).sum())
    if res.order is None:
        placed = part
    else:
        order = res.order.detach().to("cpu", torch.int64)[:E]
        hits = torch.bincount(order.clamp(0, E - 1), minlength=E)
        bad += int((hits != 1).sum())
        placed = torch.full((E,), -1, dtype=torch.int64)
        placed[order.clamp(0, E - 1)] = part
    return bad, placed


def replication_factor(src, dst, part, parts: int, device) -> float:
    """Replicas a vertex: distinct (vertex, part) pairs over the edges'
    endpoints, over the vertices with an edge."""
    s = src.to(device, torch.int64)
    d = dst.to(device, torch.int64)
    pt = part.to(device, torch.int64)
    pairs = torch.unique(torch.cat([s * parts + pt, d * parts + pt])).numel()
    covered = torch.unique(torch.cat([s, d])).numel()
    return pairs / covered


def check_answers(cell: Cell, answers: list, g: reference.SymGraph,
                  checks: compare.Checks) -> None:
    """Hold each answer against the reference's, computed once a program
    and source."""
    pr = cell.workload.get("pr", {})
    cache = {}

    def ref(program, source):
        key = (program, source)
        if key not in cache:
            if program == "cc":
                cache[key] = reference.wcc(g)
            elif program == "bfs":
                cache[key] = reference.bfs(g, source)
            elif program == "sssp":
                cache[key] = reference.sssp(g, source)
            elif program == "pr":
                cache[key] = reference.pagerank(g, pr["num_iters"], pr["damping"],
                                                g.num_vertices)
            else:
                raise ValueError(f"no reference for program {program!r}")
        return cache[key]

    for ans in answers:
        r = ref(ans.program, ans.source)
        if ans.program == "cc":
            checks.add("cc_wrong_vertices", compare.labels_wrong(ans.values, r))
        elif ans.program == "bfs":
            checks.add("bfs_wrong_vertices", compare.hops_wrong(ans.values, r))
        elif ans.program == "sssp":
            checks.add("sssp_wrong_reach", compare.reach_wrong(ans.values, r))
            checks.worst("sssp_rel_gap", compare.dist_gap(ans.values, r))
        elif ans.program == "pr":
            checks.worst("pr_rel_gap", compare.rank_gap(ans.values, r))


def run_cell(root: Path, cell_name: str, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, faults=None, config=None, workload=None) -> tuple:
    """One run: returns (result dict, compare.Checks). `config` and
    `workload` override the files (the CPU tests run tiny copies);
    `faults(cell)` may break the timed path once it is set up."""
    bench, entry, cfg, wl = cell_files(root, cell_name)
    cfg = cfg if config is None else config
    wl = wl if workload is None else workload
    cell = Cell(cell_name, cfg, wl, seed, device)
    rec = Record(cell=cell_name, seconds=float(seconds), trace=bool(trace))
    rec.peaks = load_json(BENCH_DIR / "peaks.json")
    on_card = cell.device.type == "cuda"
    rec.device_kind = torch.cuda.get_device_name(cell.device) if on_card else None
    traffic = traffic_module(wl["kind"])

    generate(cell, rec)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    deploy(cell, rec)
    state = traffic.setup(cell, rec)
    if faults is not None:
        faults(cell)
    cell.sync()
    rec.setup_s = time.perf_counter() - t_start

    tracer = Tracer(enabled=bool(trace) and on_card)
    traffic.window(cell, state, float(seconds), tracer, rec)
    tracer.stop()
    cell.sync()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    answers = traffic.answers(cell, state)
    bad_edges, placed = partition_check(cell)
    parts = cell.pipe.result.num_parts
    attempted, failed = traffic.outcome(cell, state, rec)
    cell.pipe = state = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tracer.reduce()
    rec.device_trace = tracer.summary

    src, dst, weight, nv = cell.edges
    rec.replication_factor = replication_factor(src, dst, placed, parts, cell.device)
    del placed
    g = reference.SymGraph.from_edges(src, dst, weight, nv, cell.device)
    checks = compare.Checks(wl["limits"])
    checks.add("partition_bad_edges", bad_edges)
    checks.add("unanswered", failed)
    short = wl["check"]["answers"] - len(answers)
    checks.add("answers_short", max(short, 0))
    check_answers(cell, answers, g, checks)
    if rec.traced_work:
        comps = reference.Components.of(g, reference.wcc(g))
        iters = wl.get("pr", {}).get("num_iters", 0)
        rec.traced_bytes = sum(reference.job_bytes(p, g, comps, s, iters=iters)
                               for p, s in rec.traced_work)
    del g

    metrics = {}
    for m in metrics_of(bench, cell_name, trace):
        value = metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": rec.device_kind or "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": checks.correct, "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and rec.device_trace is not None:
        dev["busy_s"] = rec.device_trace["busy_s"]
        dev["window_s"] = rec.device_trace["window_s"]
        result["breakdown"] = {"device_ops": rec.device_trace["device_ops"],
                               "idle_gaps": rec.device_trace["idle_gaps"]}
    result["checks"] = checks.table()
    info = {"cell": cell_name, "seed": seed, "spans": rec.spans, "setup_s": rec.setup_s,
            "num_vertices": rec.num_vertices, "num_edges": rec.num_edges,
            "replication_factor": rec.replication_factor}
    print(json.dumps({"info": info}), file=sys.stdout)
    return result, checks
