"""The control of each cell's comparison: the reference put in the
program's place in bfloat16 (the precision below the configurations'
float32) must come out not correct; the float32 reference in the same
place must come out correct. At a size a test run holds; on the card the
same test runs at a larger one, and `bench/control.py` at the cells'."""
import pytest
import torch

from bench import compare, control, gen, harness, reference
from bench.tests import tinyrun

CELLS = ["g500-22.ebv32.queries", "g500-22.dbh32.analytics"]


def _checks(cell: str, scale: int, dtype, device) -> compare.Checks:
    cfg, wl = tinyrun.tiny_files(cell)
    seed = tinyrun.SEED
    el = gen.kronecker(scale, 16, 0.57, 0.19, 0.19, seed=seed, device=device)
    keys = gen.search_keys(el.num_vertices, wl["search_keys"], seed=seed,
                           device=device).cpu().numpy()
    g = reference.SymGraph.from_edges(el.src, el.dst, el.weight, el.num_vertices, device)
    pairs = control.sample(wl, keys, seed, 1.0)
    checks = compare.Checks(wl["limits"])
    c = harness.Cell(cell, cfg, wl, seed, device)
    harness.check_answers(c, control.control_answers(g, pairs, wl, dtype), g, checks)
    return checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    checks = _checks(cell, 10, torch.bfloat16, "cpu")
    assert not checks.correct, checks.lines()
    # Only the float answers can differ: the exact ones are the reference's.
    assert checks.values.get("bfs_wrong_vertices", 0) == 0
    assert checks.values.get("cc_wrong_vertices", 0) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_float32_reference_in_its_place_passes(cell):
    checks = _checks(cell, 10, torch.float32, "cpu")
    assert checks.correct, checks.lines()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks = _checks(cell, 16, torch.bfloat16, "cuda")
    assert not checks.correct, checks.lines()


@pytest.mark.parametrize("cell", CELLS)
def test_control_checks_what_a_run_checks(cell, monkeypatch):
    """The control and a run choose the compared (program, source) pairs
    through the same function of the traffic module."""
    seen = []
    real = harness.check_answers

    def spy(c, answers, g, checks):
        seen.extend((a.program, a.source) for a in answers)
        return real(c, answers, g, checks)

    monkeypatch.setattr(harness, "check_answers", spy)
    result, checks = tinyrun.run(cell)
    assert result["correct"], checks.lines()
    cfg, wl = tinyrun.tiny_files(cell)
    gcfg = cfg["graph"]
    el = gen.kronecker(gcfg["scale"], gcfg["edge_factor"], gcfg["a"], gcfg["b"], gcfg["c"],
                       seed=tinyrun.SEED, device="cpu")
    keys = gen.search_keys(el.num_vertices, wl["search_keys"], seed=tinyrun.SEED,
                           device="cpu").cpu().numpy()
    pairs = control.sample(wl, keys, tinyrun.SEED, 1.0)
    assert len(pairs) == wl["check"]["answers"]
    assert sorted(seen, key=repr) == sorted(pairs, key=repr)
