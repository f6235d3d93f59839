"""The harness's whole run on the CPU at a tiny size (the look for a card
skipped), sound and then with the timed path broken underneath: each
fault the cell can have must turn `correct` false."""
import pytest
import torch

from bench.tests import tinyrun

CELLS = ["g500-22.ebv32.queries", "g500-22.dbh32.analytics"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = tinyrun.run(cell)
    assert result["correct"], checks.lines()
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"] and "replication_factor" in result["metrics"]


def _state_unchanged(monkeypatch):
    from repro_torch.graph import engine

    def step(prog, sub, plan, val, *args, **kw):
        B, p, _ = val.shape
        zeros = torch.zeros((B, p), dtype=torch.int32, device=val.device)
        delta = torch.zeros((B, p), device=val.device) if prog.convergence == "tol" else None
        return val, zeros, zeros + 1, delta

    monkeypatch.setattr(engine, "_superstep", step)


def _no_exchange(monkeypatch):
    from repro_torch.graph import engine

    real = engine._superstep

    def step(prog, sub, plan, val, inner_cap, do_exchange=True, *args, **kw):
        return real(prog, sub, plan, val, inner_cap, False, *args, **kw)

    monkeypatch.setattr(engine, "_superstep", step)


def _alter(vals: torch.Tensor, sub) -> None:
    """Change one value of every query where it is produced: that of the
    first master replica of part 0 (to_global reads masters)."""
    local = int(torch.nonzero(sub.is_master[0]).flatten()[0])
    vals[:, 0, local] += 1


def _answer_altered(monkeypatch):
    from repro_torch.graph import algorithms, engine

    real_batch, real_single = engine._run_batch_loop, algorithms.run_bsp

    def batch(loop, prog, sub, *args, **kw):
        vals, stats = real_batch(loop, prog, sub, *args, **kw)
        _alter(vals, sub)
        return vals, stats

    def single(sub, *args, **kw):
        val, stats = real_single(sub, *args, **kw)
        _alter(val[None], sub)
        return val, stats

    monkeypatch.setattr(engine, "_run_batch_loop", batch)
    monkeypatch.setattr(algorithms, "run_bsp", single)


def _half_batch(monkeypatch):
    """Half of each batch left out: its queries get the other half's answers."""
    from repro_torch.graph import engine

    real = engine._run_batch_loop

    def batch(loop, prog, sub, init, queries=None):
        n = init.shape[0] if queries is None else queries
        keep = max(n // 2, 1)
        vals, stats = real(loop, prog, sub, init, queries)
        for i in range(keep, n):
            vals[i] = vals[i % keep]
        return vals, stats

    monkeypatch.setattr(engine, "_run_batch_loop", batch)


FAULTS = {
    "g500-22.ebv32.queries": [_state_unchanged, _no_exchange, _answer_altered, _half_batch],
    "g500-22.dbh32.analytics": [_state_unchanged, _no_exchange, _answer_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]],
                         ids=[f"{c}-{f.__name__.strip('_')}" for c in CELLS for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    result, checks = tinyrun.run(cell, faults=lambda _cell: fault(monkeypatch))
    assert not result["correct"], checks.lines()


@pytest.mark.parametrize("mode", ["dist", "unknown"])
def test_mode_the_harness_cannot_drive_is_refused(mode):
    """A configuration whose deployment mode the traffic cannot drive ends
    the run before the window, with no result."""
    import time

    from bench import harness

    cfg, wl = tinyrun.tiny_files(CELLS[1])
    cfg["deployment"]["mode"] = mode
    with pytest.raises(SystemExit, match="mode"):
        harness.run_cell(tinyrun.ROOT, CELLS[1], seed=tinyrun.SEED, seconds=1.0, trace=False,
                         device="cpu", t_start=time.perf_counter(), config=cfg, workload=wl)


def test_traced_query_window_is_profiled_whole(monkeypatch):
    """A traced query run starts the profiler before the first query of
    the window falls due and stops it after the last is answered, so the
    profiler's start-up and stop delay no query."""
    from bench import harness
    from repro_torch.serve.server import GraphQueryServer

    events = []

    class Recorder:
        def __init__(self, enabled):
            self.enabled, self.active, self.done, self.summary = True, False, False, None

        def start(self):
            events.append("start")
            self.active = True

        def stop(self):
            if self.active:
                events.append("stop")
                self.active, self.done = False, True

        def reduce(self):
            pass

    real = GraphQueryServer.submit

    def submit(self, *args, **kw):
        events.append("submit")
        return real(self, *args, **kw)

    monkeypatch.setattr(harness, "Tracer", Recorder)
    monkeypatch.setattr(GraphQueryServer, "submit", submit)
    result, checks = tinyrun.run(CELLS[0])
    assert result["correct"], checks.lines()
    assert events.count("start") == events.count("stop") == 1
    inside = events[events.index("start"):events.index("stop")]
    assert inside.count("submit") == result["attempted"]
    assert "submit" not in events[events.index("stop"):]
