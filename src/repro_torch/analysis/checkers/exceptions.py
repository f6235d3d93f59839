"""EH01 — swallowed broad exception handlers.

A bare ``except:`` / ``except Exception:`` / ``except BaseException:``
whose body does nothing (``pass`` / ``...``) silently discards failures —
exactly the bug class the AsyncCheckpointer in ``repro_torch.checkpoint``
guards against: a checkpoint save that fails on the writer thread must surface,
or a later crash "resumes" from a snapshot that does not exist. The
fault-tolerance machinery in ``repro_torch.resilience`` leans on this: every
failure is either retried, recorded as a named result, or raised —
never dropped on the floor.

Narrow handlers (``except FileNotFoundError: pass``) are fine —
they document exactly which condition is expected and ignorable. Broad
handlers that DO something (log, fall back, re-raise) are also fine.
Only the broad-and-silent combination is flagged.

Warning severity, plain ``# noqa`` honored (hygiene tier) — but policy
per the repo's lint bar: true findings get FIXED, not baselined.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Checker, register_checker

# Names that count as "broad": catching these says nothing about which
# failure you expected.
_BROAD = ("Exception", "BaseException")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare `except:`
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True  # e.g. builtins.Exception
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # `...` or a docstring-style constant — still silent
        return False
    return True


@register_checker
class SwallowedExceptionChecker(Checker):
    code = "EH01"
    name = "swallowed-broad-exception"
    description = "broad except handler silently discards the exception"
    severity = "warning"
    scope = "module"

    def check_module(self, module, report) -> None:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and _is_silent(node):
                caught = "except:" if node.type is None else (
                    f"except {ast.unparse(node.type)}:"
                )
                report(
                    module.path, node.lineno, node.col_offset,
                    f"`{caught}` with a pass-only body swallows every failure — "
                    "catch the specific exception, or handle it (log / fall back / "
                    "re-raise)",
                    anchor=caught,
                )
