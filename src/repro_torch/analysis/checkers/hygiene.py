"""UI01/DS01/MD01 — low-severity hygiene: unused imports, dead stores,
mutable default arguments.

These are warnings, not errors, and additionally honor plain ``# noqa``
pragmas (see repro_torch.analysis.core). Policy per the repo's lint bar: true
findings get FIXED, not baselined — the committed baseline ships empty.

  - UI01: a top-level import alias never referenced in the module. Skipped
    entirely in ``__init__.py`` (re-export surface) and for imports inside
    ``try`` blocks (the optional-dependency gating idiom) or named in a
    literal ``__all__``.
  - DS01: a local assigned through a plain single-name target that is
    never read anywhere in its function — the classic leftover from a
    refactor. Tuple unpacking and ``_``-prefixed names are exempt
    (discarding one of several results is idiomatic), as are closures
    referenced by nested functions.
  - MD01: ``def f(x=[])``-style mutable defaults (list/dict/set literals
    or constructor calls) — shared state across calls, and unhashable
    where configs must hash.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Checker, register_checker


@register_checker
class UnusedImportChecker(Checker):
    code = "UI01"
    name = "unused-import"
    description = "imported name is never used in the module"
    severity = "warning"
    scope = "module"

    def check_module(self, module, report) -> None:
        if module.path.endswith("__init__.py"):
            return
        in_try: set = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Try):
                for child in ast.walk(node):
                    in_try.add(id(child))

        used: set = set()
        exported: set = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                used.add(node.id)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        for elt in ast.walk(node.value):
                            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                                exported.add(elt.value)

        for node in ast.walk(module.tree):
            if id(node) in in_try:
                continue
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    if local not in used and local not in exported:
                        report(
                            module.path, node.lineno, node.col_offset,
                            f"`import {alias.name}` is unused",
                            anchor=local,
                        )
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    if local not in used and local not in exported:
                        report(
                            module.path, node.lineno, node.col_offset,
                            f"`from {'.' * node.level}{node.module or ''} import "
                            f"{alias.name}` is unused",
                            anchor=local,
                        )


@register_checker
class DeadStoreChecker(Checker):
    code = "DS01"
    name = "dead-store"
    description = "local variable is assigned but never read in its function"
    severity = "warning"
    scope = "module"

    def check_module(self, module, report) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(module, node, report)

    def _check_function(self, module, fn, report) -> None:
        loaded: set = set()
        declared: set = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loaded.add(node.id)
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                declared.update(node.names)
            elif isinstance(node, ast.Call):
                # locals()/eval/exec make static liveness unknowable.
                fname = getattr(node.func, "id", "")
                if fname in ("locals", "vars", "eval", "exec"):
                    return
        # Only this function's own statements: stores in nested defs belong
        # to the nested function's scope (and were walked above for loads —
        # a closure read keeps the outer store alive).
        for stmt in self._own_statements(fn):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            target = stmt.targets[0]
            if not isinstance(target, ast.Name):
                continue  # tuple unpacking / attribute / subscript: exempt
            name = target.id
            if name.startswith("_") or name in loaded or name in declared:
                continue
            report(
                module.path, stmt.lineno, stmt.col_offset,
                f"`{name}` is assigned but never read in `{fn.name}`",
                anchor=f"{fn.name}.{name}",
            )

    def _own_statements(self, fn):
        stack = list(fn.body)
        while stack:
            stmt = stack.pop()
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    stack.append(child)
                elif hasattr(child, "body") and not isinstance(child, ast.expr):
                    stack.append(child)


@register_checker
class MutableDefaultChecker(Checker):
    code = "MD01"
    name = "mutable-default-arg"
    description = "function parameter default is a mutable object"
    severity = "warning"
    scope = "module"

    MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)

    def check_module(self, module, report) -> None:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            for param, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
                self._check_default(module, node, param, default, report)
            for param, default in zip(a.kwonlyargs, a.kw_defaults):
                if default is not None:
                    self._check_default(module, node, param, default, report)

    def _check_default(self, module, fn, param, default, report) -> None:
        bad = isinstance(default, self.MUTABLE) or (
            isinstance(default, ast.Call)
            and getattr(default.func, "id", "") in ("list", "dict", "set", "bytearray")
            and not default.args
            and not default.keywords
        )
        if bad:
            fname = getattr(fn, "name", "<lambda>")
            report(
                module.path, default.lineno, default.col_offset,
                f"`{fname}` parameter `{param.arg}` defaults to a mutable object — "
                "use None and create it in the body (shared across calls otherwise)",
                anchor=f"{fname}.{param.arg}",
            )
