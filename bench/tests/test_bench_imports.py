"""Nothing under bench/ imports JAX or the JAX package, and the yardstick
(the generator, the reference and the comparison) imports nothing of the
program either. Top-level module names are compared whole."""
import ast
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "compare.py", "gen.py")


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported_tops(BENCH / name)


def test_the_walk_sees_every_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import x\nimport repro_torch\n"
                     "from . import sibling\nimportlib.import_module('flax.linen')\n")
    tops = imported_tops(probe)
    assert tops & FORBIDDEN == {"jax", "repro", "flax"}
    assert "repro_torch" in tops and "repro_torch" not in FORBIDDEN


def test_run_refuses_loaded_jax(monkeypatch):
    from bench import run

    assert "repro_torch" not in {n.split(".")[0] for n in run.forbidden_modules()}
    monkeypatch.setitem(sys.modules, "repro.fake_loaded", types.ModuleType("repro.fake_loaded"))
    monkeypatch.setitem(sys.modules, "repro_torch.fake_loaded",
                        types.ModuleType("repro_torch.fake_loaded"))
    assert "repro.fake_loaded" in run.forbidden_modules()
    assert "repro_torch.fake_loaded" not in run.forbidden_modules()
