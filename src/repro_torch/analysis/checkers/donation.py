"""DA01 — a captured CUDA graph's static buffers rebound or handed out.

PyTorch has no buffer donation; the hazard of the same kind is a CUDA
graph's static buffers. A graph replays on the exact tensors it captured:
rebinding ``self.val = new_tensor`` after the capture leaves the graph
writing the old one, and returning ``self.val`` hands the caller a tensor
the next replay overwrites. On the CPU there is no graph — the chunk runs
eagerly on whatever ``self.val`` is now — so both work there and fail
silently on the card. This checker makes the card's semantics the static
contract.

In a class with a method that opens a ``with torch.cuda.graph(...)``
block, the **captured attributes** are the ``self.<attr>`` the captured
body reads: in the block and, through ``self.method`` calls and bound
methods passed along (``captured_launches(self._chunk)``), in every method
of the class it reaches. Then:

  - a plain rebind ``self.<attr> = ...`` (or as one target of a tuple)
    of a captured attribute outside ``__init__`` is flagged — write into
    it with ``copy_``/``zero_``/slicing instead (``_FusedLoop.run``).
    An augmented ``self.<attr> += ...`` on a tensor is in place and is
    not flagged;
  - a public method that returns a captured attribute itself (or an
    element or slice of it, or inside a returned tuple/list/dict) is
    flagged — return ``.clone()`` / ``.copy()`` of it.

``capture()``'s ``self.graph, self.replay_launches = ...`` is not flagged:
the captured body reads neither.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import CallGraph, dotted_name, graph_capture_blocks
from repro_torch.analysis.core import Checker, register_checker


def _self_attr(node) -> str | None:
    if isinstance(node, ast.Attribute) and dotted_name(node.value) == "self":
        return node.attr
    return None


def _returned_attrs(value):
    """Captured-attribute candidates a return value hands out as they are."""
    if value is None:
        return
    if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
        for e in value.elts:
            yield from _returned_attrs(e)
    elif isinstance(value, ast.Dict):
        for e in value.values:
            yield from _returned_attrs(e)
    elif isinstance(value, ast.Subscript):
        yield from _returned_attrs(value.value)
    else:
        attr = _self_attr(value)
        if attr is not None:
            yield attr, value


@register_checker
class GraphBufferChecker(Checker):
    code = "DA01"
    name = "graph-static-buffer"
    description = (
        "an attribute a captured CUDA graph reads is rebound after __init__, or "
        "returned without .clone() (the graph replays on the captured tensor)"
    )
    severity = "error"
    scope = "project"

    def check_project(self, modules, report, resources=None) -> None:
        g = CallGraph.of(modules)
        for m in modules:
            for cap in graph_capture_blocks(m.tree, g.imports[m.path]):
                if not isinstance(cap, (ast.With, ast.AsyncWith)):
                    continue
                scope = g.scope_of(m, cap)
                cls = g.enclosing_class(scope) if scope is not None else None
                if cls is None:
                    continue
                self._check_class(m, g, cls, scope, cap, report)

    def _captured_attrs(self, g, cls, scope, cap) -> set:
        methods = g.classes.get(cls, {})
        method_keys = set(methods.values())
        attrs: set = set()
        todo = [(scope, list(cap.body))]
        seen = set()
        while todo:
            key, nodes = todo.pop()
            for stmt in nodes:
                for n in ast.walk(stmt):
                    attr = _self_attr(n)
                    if attr is None or not isinstance(n.ctx, ast.Load):
                        continue
                    if attr in methods:
                        target = methods[attr]
                        if target not in seen:
                            seen.add(target)
                            todo.append((target, list(g.info(target).node.body)))
                    else:
                        attrs.add(attr)
            # Methods reached through other calls in the class (not self.*).
            for target in g.callees(key, [n for s in nodes for n in ast.walk(s)]):
                if target in method_keys and target not in seen:
                    seen.add(target)
                    todo.append((target, list(g.info(target).node.body)))
        return attrs

    def _check_class(self, module, g, cls, scope, cap, report) -> None:
        captured = self._captured_attrs(g, cls, scope, cap)
        for name, key in sorted(g.classes.get(cls, {}).items()):
            info = g.info(key)
            if name == "__init__":
                continue
            for node in ast.walk(info.node):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                for t in targets:
                    for e in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                        attr = _self_attr(e)
                        if attr in captured:
                            report(
                                module.path, e.lineno, e.col_offset,
                                f"`self.{attr}` is rebound in `{info.qualname}`, but the CUDA "
                                f"graph captured in `{g.info(scope).qualname}` reads it and "
                                "replays on the tensor it captured — write into it in place "
                                "(copy_/zero_) instead",
                                anchor=f"{info.qualname}.{attr}",
                            )
                if isinstance(node, ast.Return) and not name.startswith("_"):
                    for attr, e in _returned_attrs(node.value):
                        if attr in captured:
                            report(
                                module.path, e.lineno, e.col_offset,
                                f"`{info.qualname}` returns `self.{attr}`, a static buffer of "
                                f"the CUDA graph captured in `{g.info(scope).qualname}`: the "
                                "next replay overwrites it — return a .clone()",
                                anchor=f"{info.qualname}.{attr}",
                            )
