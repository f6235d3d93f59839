"""A cell's run on the CPU at a tiny size: the harness's path without the
look for a card, for the tests."""
import copy
import time
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 31337


def tiny_files(cell: str) -> tuple:
    _, _, cfg, wl = harness.cell_files(ROOT, cell)
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg["graph"]["scale"] = 9
    cfg["deployment"]["parts"] = 4
    wl["search_keys"] = 64
    if wl["kind"] == "open_loop_queries":
        wl["rate_per_s"] = 24.0
        wl["check"]["answers"] = 24  # every query of the 1 s window
    else:
        wl["check"]["answers"] = 8
        wl["check"]["within"] = 3
    return cfg, wl


def run(cell: str, faults=None, seed: int = SEED) -> tuple:
    cfg, wl = tiny_files(cell)
    return harness.run_cell(ROOT, cell, seed=seed, seconds=1.0, trace=False, device="cpu",
                            t_start=time.perf_counter(), faults=faults, config=cfg, workload=wl)
