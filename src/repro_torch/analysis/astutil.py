"""Shared AST plumbing for the static-analysis checkers.

Everything here is deliberately resolution-light: we canonicalize names
through each module's import table (``np.asarray`` -> ``numpy.asarray``,
``_bsp.launch_flagged`` -> ``repro_torch.kernels.bsp_superstep.launch_flagged``)
and resolve calls to project-local function definitions by name. No type
inference, no execution — the checkers are grep-with-structure, tuned for
zero false positives on this repo's idioms.

`CallGraph` is the project call graph the interprocedural checkers share
(HS01's captured closure, XD01's dominance, DA01, KP01): it resolves
module-level functions through imports and module aliases, ``self.method``
within the class that defines it, nested functions by their lexical
scope, and bound methods passed as arguments (``captured_launches(self._chunk)``).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def build_import_map(tree: ast.Module) -> dict:
    """alias -> fully-qualified dotted prefix, from the module's imports.

    ``import numpy as np``                               -> {"np": "numpy"}
    ``import torch.nn.functional as F``                  -> {"F": "torch.nn.functional"}
    ``from repro_torch.kernels import dispatch``         -> {"dispatch": "repro_torch.kernels.dispatch"}
    ``from repro_torch.kernels import ops as _ops``      -> {"_ops": "repro_torch.kernels.ops"}
    """
    imports: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                imports[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                if alias.name == "*":
                    continue
                imports[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return imports


def qualify(name: Optional[str], imports: dict) -> Optional[str]:
    """Canonicalize a dotted name through the module's import aliases."""
    if name is None:
        return None
    head, sep, rest = name.partition(".")
    if head in imports:
        return imports[head] + (sep + rest if rest else "")
    return name


def call_qualname(call: ast.Call, imports: dict) -> Optional[str]:
    return qualify(dotted_name(call.func), imports)


@dataclasses.dataclass(frozen=True)
class Symbol:
    """A folded reference to a named object, e.g. ``ctypes.c_int`` in an
    ``argtypes`` list (`const_value` with an import map)."""

    name: str


def const_value(node: ast.AST, imports: Optional[dict] = None):
    """Fold pure-literal arithmetic (1 << 24, 2**24, -1) to a Python value;
    returns None when the expression is not a literal computation.

    With `imports`, ``ctypes.*`` names fold to `Symbol`s and list/tuple
    arithmetic folds over them: ``[ctypes.c_void_p] * 2 + [ctypes.c_int]``
    -> ``[Symbol("ctypes.c_void_p")] * 2 + [Symbol("ctypes.c_int")]``."""
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        pass
    if imports is not None:
        qn = qualify(dotted_name(node), imports)
        if qn is not None and qn.startswith("ctypes."):
            return Symbol(qn)
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = [const_value(e, imports) for e in node.elts]
            if any(e is None for e in elts):
                return None
            return elts if isinstance(node, ast.List) else tuple(elts)
    if isinstance(node, ast.BinOp):
        left, right = const_value(node.left, imports), const_value(node.right, imports)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.Pow):
                return left**right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Add):
                return left + right
        except (TypeError, ValueError, OverflowError):
            return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = const_value(node.operand, imports)
        return None if inner is None else -inner
    return None


@dataclasses.dataclass
class FuncInfo:
    """One function/method definition with its lexical context."""

    qualname: str  # "Class.method" / "outer.<locals>.inner"
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    parent: Optional["FuncInfo"]  # enclosing function, if any
    in_class: bool  # direct child of a ClassDef
    cls: Optional[str] = None  # the enclosing class's qualname, for a method

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    @property
    def is_public(self) -> bool:
        """Module-level functions and class methods not starting with '_'."""
        return self.parent is None and not self.name.startswith("_")

    def params(self) -> list:
        a = self.node.args
        return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]

    def positional_params(self) -> list:
        a = self.node.args
        return [p.arg for p in (a.posonlyargs + a.args)]

    @property
    def is_method(self) -> bool:
        """A method taking its instance first (not a static method)."""
        if not self.in_class or not self.positional_params():
            return False
        return not any(dotted_name(d) == "staticmethod" for d in self.node.decorator_list)


def iter_functions(tree: ast.Module) -> Iterator[FuncInfo]:
    """All function definitions with qualnames and parent links."""

    def visit(node, prefix: str, parent: Optional[FuncInfo], cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}" if prefix else child.name
                info = FuncInfo(qualname=qn, node=child, parent=parent,
                                in_class=cls is not None, cls=cls)
                yield info
                yield from visit(child, qn + ".<locals>.", info, None)
            elif isinstance(child, ast.ClassDef):
                cq = f"{prefix}{child.name}" if prefix else child.name
                yield from visit(child, cq + ".", parent, cq)
            else:
                yield from visit(child, prefix, parent, cls)

    yield from visit(tree, "", None, None)


def iter_classes(tree: ast.Module) -> Iterator[tuple]:
    """(qualname, ClassDef) of every class, with `iter_functions`' naming."""

    def visit(node, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}" if prefix else child.name
                yield from visit(child, qn + ".<locals>.")
            elif isinstance(child, ast.ClassDef):
                cq = f"{prefix}{child.name}" if prefix else child.name
                yield cq, child
                yield from visit(child, cq + ".")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def local_function_table(tree: ast.Module) -> dict:
    """name -> module-level FunctionDef node (top level only)."""
    return {
        n.name: n
        for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def own_nodes(fn: ast.AST):
    """Walk a function's body, pruning nested function/lambda/class bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


GRAPH_CONTEXTS = ("torch.cuda.graph", "torch.cuda.graphs.graph")
GRAPHED_CALLABLES = ("torch.cuda.make_graphed_callables", "torch.cuda.graphs.make_graphed_callables")


def graph_capture_blocks(tree: ast.Module, imports: Optional[dict] = None) -> list:
    """The CUDA-graph captures of a module: each ``with torch.cuda.graph(...)``
    block (the With node: its body runs under capture) and each call of
    ``torch.cuda.make_graphed_callables`` (the Call node: its first argument
    is captured)."""
    imports = build_import_map(tree) if imports is None else imports
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and call_qualname(ctx, imports) in GRAPH_CONTEXTS:
                    out.append(node)
                    break
        elif isinstance(node, ast.Call) and call_qualname(node, imports) in GRAPHED_CALLABLES:
            out.append(node)
    return out


class CallGraph:
    """Name-resolved project call graph over the analyzed modules.

    Keys are (module path, qualname). `resolve` maps a Name/Attribute
    reference inside a function to the key of the definition it names:

      - a nested function of the scope or of an enclosing scope, by name;
      - a module-level function or class of the same module, or one
        reached through an import (``from a.b import f``, ``import a.b as m``
        then ``m.f``, ``from a import b as _b`` then ``_b.f``);
      - ``self.m`` / ``cls.m`` inside a method (or a closure in one) to the
        method ``m`` of the enclosing class; ``Class.m`` to that method;
      - a class to its ``__init__`` (a constructor call runs it).
    """

    _last: tuple = ((), None)  # (modules, graph) of the latest `of` call

    @classmethod
    def of(cls, modules) -> "CallGraph":
        """The graph of `modules`, shared by the checkers of one run."""
        mods, graph = cls._last
        if len(mods) != len(modules) or any(a is not b for a, b in zip(mods, modules)):
            graph = cls(modules)
            cls._last = (tuple(modules), graph)
        return graph

    def __init__(self, modules):
        self.modules = list(modules)
        self.funcs: dict = {}  # key -> (module, FuncInfo)
        self.by_dotted: dict = {}  # "repro_torch.graph.engine.run_bsp" -> key
        self.classes: dict = {}  # (path, class qualname) -> {method name: key}
        self.class_dotted: dict = {}  # "pkg.mod.Class" -> (path, class qualname)
        self.imports: dict = {}  # module.path -> import map
        self._scopes: Optional[dict] = None  # id(node) -> innermost function key
        self._resolved: dict = {}  # (path, dotted name, scope) -> key or None
        for m in self.modules:
            self.imports[m.path] = build_import_map(m.tree)
            for info in iter_functions(m.tree):
                key = (m.path, info.qualname)
                self.funcs[key] = (m, info)
                if ".<locals>." not in info.qualname:
                    self.by_dotted[f"{m.dotted}.{info.qualname}"] = key
                if info.cls is not None:
                    self.classes.setdefault((m.path, info.cls), {})[info.name] = key
            for cq, _ in iter_classes(m.tree):
                self.classes.setdefault((m.path, cq), {})
                if ".<locals>." not in cq:
                    self.class_dotted[f"{m.dotted}.{cq}"] = (m.path, cq)

    def info(self, key) -> FuncInfo:
        return self.funcs[key][1]

    def module_of(self, key):
        return self.funcs[key][0]

    def enclosing_class(self, key) -> Optional[tuple]:
        """(path, class qualname) of the method `key` is, or is nested in."""
        module, info = self.funcs[key]
        while info is not None:
            if info.cls is not None:
                return (module.path, info.cls)
            info = info.parent
        return None

    def _self_names(self, key) -> set:
        module, info = self.funcs[key]
        while info is not None:
            if info.cls is not None and info.is_method:
                return {"self", "cls", info.positional_params()[0]}
            info = info.parent
        return set()

    def resolve(self, module, node: ast.AST, scope=None):
        """The key of the definition `node` (Name/Attribute) names, or None.
        `scope` is the key of the function the reference sits in."""
        qn = dotted_name(node)
        if qn is None:
            return None
        memo = (module.path, qn, scope)
        if memo not in self._resolved:
            self._resolved[memo] = self._resolve(module, qn, scope)
        return self._resolved[memo]

    def _resolve(self, module, qn: str, scope):
        head, _, rest = qn.partition(".")
        if scope is not None:
            # Nested functions of this scope or of an enclosing one.
            if not rest:
                info = self.funcs[scope][1]
                while info is not None:
                    cand = (module.path, f"{info.qualname}.<locals>.{qn}")
                    if cand in self.funcs:
                        return cand
                    info = info.parent
            # self.method / cls.method within the defining class.
            if rest and "." not in rest and head in self._self_names(scope):
                cls = self.enclosing_class(scope)
                return self.classes.get(cls, {}).get(rest)
        for full in (qualify(qn, self.imports[module.path]), f"{module.dotted}.{qn}"):
            if full in self.by_dotted:
                return self.by_dotted[full]
            if full in self.class_dotted:
                return self.classes[self.class_dotted[full]].get("__init__")
        return None

    def callees(self, key, nodes) -> list:
        """Function keys referenced (called or passed) among `nodes`, which
        lie in function `key`."""
        module = self.funcs[key][0]
        out = []
        for node in nodes:
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                target = self.resolve(module, node, key)
                if target is not None and target != key:
                    out.append(target)
        return out

    def nested(self, key) -> list:
        """Keys of functions lexically nested directly under `key`."""
        module, info = self.funcs[key]
        prefix = info.qualname + ".<locals>."
        return [
            k
            for k, (m, i) in self.funcs.items()
            if m.path == module.path
            and i.qualname.startswith(prefix)
            and ".<locals>." not in i.qualname[len(prefix):]
        ]

    def scope_of(self, module, node: ast.AST):
        """The key of the innermost function whose body holds `node` (None
        at module level)."""
        if self._scopes is None:
            self._scopes = {}
            for key, (_, info) in self.funcs.items():
                stack = list(ast.iter_child_nodes(info.node))
                while stack:
                    n = stack.pop()
                    self._scopes[id(n)] = key
                    if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        stack.extend(ast.iter_child_nodes(n))
        return self._scopes.get(id(node))


def unparse(node: ast.AST, limit: int = 60) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        text = "<expr>"
    return text if len(text) <= limit else text[: limit - 3] + "..."
