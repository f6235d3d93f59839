"""BENCHMARK.json and the harness's files keep to the benchmark's
contract: keys, names, units, bounds, metric readers, configurations and
workload files, found by name."""
import json
import re
from pathlib import Path

import pytest

from bench import harness, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["name"] in used and c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and 1 <= len(c["source"]) <= 200
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    wl = json.loads((ROOT / "bench" / "workloads" / f"{w['name']}.json").read_text())
    harness.traffic_module(wl["kind"])
    e2e = harness.metrics_of(BENCH, w["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(BENCH, w["name"], True)
    assert set(wl["limits"]) >= {"partition_bad_edges", "unanswered", "answers_short"}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    assert callable(harness.metric_reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_summarize_a_trace():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "pump", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "bsp_min_kernel", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "bsp_min_kernel", "ts": 70, "dur": 10},
    ]
    s = trace.summarize(events, 1e-4)
    assert s["busy_s"] == pytest.approx(35e-6) and s["kernel_s"] == pytest.approx(30e-6)
    assert s["device_ops"][0] == ["bsp_min_kernel", pytest.approx(30e-6)]
    idle = dict(s["idle_gaps"])
    # A gap goes whole to the innermost host span at its midpoint.
    assert idle["pump"] == pytest.approx(10e-6 + 20e-6)
    assert idle["aten::copy_"] == pytest.approx(35e-6)
