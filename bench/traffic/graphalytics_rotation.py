"""LDBC Graphalytics jobs back to back: a closed loop of one client.

The client runs the jobs of `rotation` in turn (WCC as `cc`, PageRank as
`pr` with `pr`'s damping and iterations, BFS, SSSP), each through
`GraphPipeline.run(program, driver="fused", mode=...)` and `to_global()`;
BFS and SSSP start at the next Graph500 search key. The window runs whole
rotations until `seconds` have passed, so it always ends on a rotation's
last job and its length is the time those rotations took.

Workload keys: `rotation`, `pr` ({"damping", "num_iters"}), `check`
({"answers": jobs compared, split evenly over the programs, drawn from
the seed among the first `within` jobs of each program}) and `trace`
({"lead_s", "stretch_s"}).
"""
from __future__ import annotations

import time

import numpy as np

from bench.gen import stream_seed


def jobs(workload: dict, keys: np.ndarray):
    """The client's jobs in order, without end: (program, source), where
    BFS and SSSP take the next search key and the others none."""
    k = 0
    while True:
        for program in workload["rotation"]:
            if program in ("bfs", "sssp"):
                yield program, int(keys[k % keys.shape[0]])
                k += 1
            else:
                yield program, None


def checked(workload: dict, keys: np.ndarray, seed: int) -> dict:
    """{job index: (program, source)} of the jobs a run compares: for each
    program an even share of its first `within` jobs, drawn from the seed.
    A window that runs fewer of a program's jobs comes up short."""
    rng = np.random.default_rng(stream_seed(seed, "check_sample"))
    programs = list(dict.fromkeys(workload["rotation"]))
    share = workload["check"]["answers"] // len(programs)
    within = workload["check"]["within"]
    picks = {p: set(int(i) for i in rng.permutation(within)[:share]) for p in programs}
    seen = dict.fromkeys(programs, 0)
    out = {}
    for j, (program, source) in enumerate(jobs(workload, keys)):
        if seen[program] in picks[program]:
            out[j] = (program, source)
        seen[program] += 1
        if min(seen.values()) >= within:
            return out


def checked_pairs(workload: dict, keys: np.ndarray, seed: int, seconds: float) -> list:
    """The (program, source) pairs a run compares."""
    return list(checked(workload, keys, seed).values())


def _run(cell, program: str, key):
    """One job: the program's run and its answer in global vertex order."""
    pr = cell.workload["pr"]
    if program == "pr":
        run = cell.pipe.run("pr", driver="fused", mode=cell.mode, damping=pr["damping"],
                            num_iters=pr["num_iters"])
    elif program in ("bfs", "sssp"):
        run = cell.pipe.run(program, driver="fused", mode=cell.mode, source=key)
    else:
        run = cell.pipe.run(program, driver="fused", mode=cell.mode)
    return run, run.to_global()


def setup(cell, rec) -> dict:
    """One rotation before the window: it builds and captures each
    program's fused loop."""
    for j, program in enumerate(cell.workload["rotation"]):
        _run(cell, program, int(cell.keys[-1 - j]))
    return {"kept": []}


def window(cell, state, seconds: float, tracer, rec) -> None:
    from repro_torch.graph import engine

    wl = cell.workload
    lead, stretch = wl["trace"]["lead_s"], wl["trace"]["stretch_s"]
    per_rotation = len(wl["rotation"])
    check = checked(wl, cell.keys, cell.seed)
    kept = state["kept"]
    syncs0 = sum(engine.HOST_SYNCS.values())
    messages = j = 0
    t0 = time.perf_counter()
    for program, source in jobs(wl, cell.keys):
        if j % per_rotation == 0 and j and time.perf_counter() - t0 >= seconds:
            break
        now = time.perf_counter() - t0
        if tracer.enabled and not tracer.done:
            if not tracer.active and now >= lead:
                tracer.start()
            elif tracer.active and now >= lead + stretch:
                tracer.stop()
        run, values = _run(cell, program, source)
        if tracer.active:
            rec.traced_work.append((program, source))
        messages += run.stats.total_messages
        if j in check:
            kept.append((program, source, values))
        j += 1
    tracer.stop()
    rec.window_s = time.perf_counter() - t0
    rec.jobs = j
    rec.messages = messages
    rec.host_syncs = sum(engine.HOST_SYNCS.values()) - syncs0


def outcome(cell, state, rec) -> tuple:
    """(jobs run, jobs without an answer): a job that raises ends the run."""
    return rec.jobs, 0


def answers(cell, state) -> list:
    from bench.harness import Answer

    return [Answer(program, source, values) for program, source, values in state["kept"]]
