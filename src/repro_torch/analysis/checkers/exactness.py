"""XD01 — int→f32 exactness-domain remap reachable without a 2^24 guard.

The CUDA kernels run int32 semirings in f32 via the INF_I32↔INF_F32 remap
(`engine._to_f32`) — exact only for magnitudes below 2^24. Every public
entry point from which that remap is reachable must pass through a
dominating guard (compare against `1 << 24`, raise) BEFORE the remap can
run. The port has two such guards, and the structural detector below
recognizes both without naming them: `engine.check_int32_kernel_gid`
(flat addressing — the global-id space IS the kernel value domain, so
max(gid) is the bound) and `engine.check_int32_kernel_values` (two-level
addressing — enforcement moves to the kernel VALUE boundary, where
`engine._kernel_value_boundary` proves a per-worker bound: the rank-codec
size for label-domain programs, the covered-vertex count for unit-weight
hop counts). This is the static version of those runtime ValueErrors.

Detection is interprocedural over the analyzed module set:

  - **remap site**: a function whose body both references an `INF_I32`
    sentinel constant and casts to f32 with `.to(torch.float32)` (or
    `.to(dtype=torch.float32)`) or `.float()` — the port's canonical
    int-domain remap signature.
  - **guard**: a function containing a comparison against the constant
    2^24 (any literal spelling: `1 << 24`, `2 ** 24`, `16777216`)
    alongside a `raise` (or as an `assert`).
  - **call graph**: the project `CallGraph` (module-local defs, imports
    and module aliases, `self.method` within its class). Defining a
    closure counts as reaching whatever the closure reaches (the
    stepper/runner pattern).
  - **dominance** (approximation): a remap-reaching call in a top-level
    statement needs a guard-reaching call in an earlier-or-same top-level
    statement, unless the callee guards internally. A remap-reaching call
    inside a nested def needs a guard-reaching call anywhere in the
    enclosing function (closures run out of definition order).

Only public functions/methods (no leading underscore) are reported —
private helpers are expected to rely on their callers' guards.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import CallGraph, const_value, dotted_name, own_nodes, qualify
from repro_torch.analysis.core import Checker, register_checker

GUARD_CONST = 1 << 24
SENTINEL = "INF_I32"
F32_NAMES = {"torch.float32", "torch.float"}


def _is_f32_cast(node: ast.AST, imports: dict) -> bool:
    """``x.to(torch.float32)``, ``x.to(dtype=torch.float32)``, ``x.float()``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr == "float" and not node.args and not node.keywords:
        return True
    if node.func.attr != "to":
        return False
    targets = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]
    return any(qualify(dotted_name(t), imports) in F32_NAMES for t in targets)


def _is_remap(fn: ast.AST, imports: dict) -> bool:
    """INF_I32 reference + an f32 cast in the same function body."""
    has_sentinel = has_cast = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and SENTINEL in node.id:
            has_sentinel = True
        elif isinstance(node, ast.Attribute) and SENTINEL in node.attr:
            has_sentinel = True
        elif _is_f32_cast(node, imports):
            has_cast = True
        if has_sentinel and has_cast:
            return True
    return False


def _is_guard(fn: ast.AST) -> bool:
    """Contains a comparison against 2^24 plus a raise (or an assert)."""
    nodes = list(ast.walk(fn))
    has_raise = any(isinstance(n, ast.Raise) for n in nodes)
    if not has_raise and not any(isinstance(n, ast.Assert) for n in nodes):
        return False
    for node in nodes:
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if any(const_value(s) == GUARD_CONST for s in sides):
                in_assert = any(
                    isinstance(a, ast.Assert) and node in ast.walk(a) for a in ast.walk(fn)
                )
                if has_raise or in_assert:
                    return True
    return False


@register_checker
class ExactnessChecker(Checker):
    code = "XD01"
    name = "unguarded-exactness-remap"
    description = (
        "public entry point reaches the int->f32 exactness remap (INF_I32 + "
        ".to(torch.float32)) without a dominating 1 << 24 guard on the path"
    )
    severity = "error"
    scope = "project"

    def check_project(self, modules, report, resources=None) -> None:
        g = CallGraph.of(modules)
        remap = {k for k, (m, i) in g.funcs.items() if _is_remap(i.node, g.imports[m.path])}
        guard = {k for k, (_, i) in g.funcs.items() if _is_guard(i.node)}
        edges = {
            k: g.callees(k, ast.walk(info.node)) + g.nested(k)
            for k, (_, info) in g.funcs.items()
        }

        def reaches(key, targets, seen=None) -> bool:
            if seen is None:
                seen = set()
            if key in seen:
                return False
            seen.add(key)
            if key in targets:
                return True
            return any(reaches(c, targets, seen) for c in edges.get(key, ()))

        guarded_memo: dict = {}

        def guarded(key) -> bool:
            if key in guarded_memo:
                return guarded_memo[key]
            guarded_memo[key] = True  # cycle default: lenient
            guarded_memo[key] = self._guarded(key, g, remap, guard, reaches, guarded)
            return guarded_memo[key]

        for key in sorted(g.funcs, key=lambda k: (k[0], k[1])):
            module, info = g.funcs[key]
            if not info.is_public or ".<locals>." in info.qualname:
                continue
            if not reaches(key, remap):
                continue
            if guarded(key):
                continue
            report(
                module.path,
                info.node.lineno,
                info.node.col_offset,
                f"`{info.qualname}` reaches the int->f32 exactness remap without a "
                "dominating 1 << 24 guard; call a check_int32_kernel_gid- or "
                "check_int32_kernel_values-style guard before the remap on every path",
                anchor=info.qualname,
            )

    def _guarded(self, key, g, remap, guard, reaches, guarded) -> bool:
        if key in guard:
            return True
        module, info = g.funcs[key]
        imports = g.imports[module.path]
        body = getattr(info.node, "body", [])
        guard_anywhere = any(reaches(c, guard) for c in g.callees(key, ast.walk(info.node)))

        # Direct (non-nested) remap-reaching calls — and this function's own
        # remap casts, if it is itself a remap site — need a guard-reaching
        # call in an earlier-or-same top-level statement.
        guard_seen = False
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # closures are judged by the nested-def rule below
            own = [stmt] + list(own_nodes(stmt))
            callees = g.callees(key, own)
            if any(reaches(c, guard) for c in callees):
                guard_seen = True
            for c in callees:
                if reaches(c, remap) and not guarded(c) and not guard_seen:
                    return False
            if key in remap and not guard_seen and any(_is_f32_cast(n, imports) for n in own):
                return False

        # Remap work inside nested defs (closures returned/registered out of
        # order) needs a guard-reaching call anywhere in this function.
        for n in g.nested(key):
            if reaches(n, remap) and not guarded(n) and not guard_anywhere:
                return False
        return True
