"""HS01 — host sync inside a captured CUDA graph.

The fused and batched drivers capture a chunk of supersteps into a CUDA
graph (`engine._FusedLoop.capture`) and replay it; the host reads the stop
flag once a chunk, outside the graph. A host sync inside the captured body
fails the capture on the card (a `.item()`, a `.cpu()`, a
`torch.cuda.synchronize()` are illegal while a stream captures) — or,
worse, runs once at capture time and is baked into every replay: a read of
a kernel's pinned host flag reads it before anything ran, with no error.
On the CPU the chunk runs eagerly, so no CPU test can see either. This
checker holds the body sync-free statically.

It is project-scoped, since a captured body calls across modules:

  - **captured roots**: every function called or passed (a bound method
    too: ``captured_launches(self._chunk)``) inside a ``with
    torch.cuda.graph(...)`` block, the block's own statements, and the
    callables given to ``torch.cuda.make_graphed_callables``;
  - **the captured closure**: everything those reach over the project
    call graph (`astutil.CallGraph`), walked path by path. The walk knows
    what the call it followed passes: an optional argument the call spells
    out (anything but a bare unknown name or ``None``) is taken as given,
    one it leaves out as its default, so ``if err is None:`` branches of
    the callee are pruned accordingly (`_local_fixpoint`'s
    ``ops.bsp_superstep(..., err=plan.err)`` takes the flag path and is
    clean; the same call without ``err`` reaches the wrapper's host read
    and is flagged). A captured body runs on the card, so branches on
    ``<x>.device.type == "cpu"`` (or ``!= "cuda"``) are not taken.
  - **sync sites**: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")`` / ``.to(device="cpu")``; ``torch.cuda.synchronize``
    and any ``.synchronize()`` (streams, events); ``np.asarray`` /
    ``np.array`` of anything but a literal; ops whose output shape depends
    on the data (``torch.nonzero`` / ``.nonzero()``, ``torch.unique``,
    ``torch.masked_select``, ``torch.argwhere``, one-argument
    ``torch.where``, ``repeat_interleave`` of tensor repeats without
    ``output_size``); ``bool()`` / ``int()`` / ``float()`` of a dynamic
    expression; and the host-flag path: a ``host_flag(...)`` call (the C
    launch then spins on pinned host memory until the kernel writes it)
    and a read of the flag (``flag[2].value``).

`bool()`/`int()`/`float()` are flagged only when the argument is dynamic:
literals, UPPER_CASE constants, shape metadata (``.shape[...]``,
``.size(...)``, ``.numel()``, ``.dim()``, ``.ndim``, ``.dtype``,
``.device``), parameters annotated ``int``/``float``/``bool``/``str``,
names bound from such expressions and instance attributes only ever
assigned such values (``self.tol = float(tol)``) are static. Implicit
truthiness of a tensor (``if t:``) is not seen.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.astutil import (
    CallGraph,
    call_qualname,
    dotted_name,
    graph_capture_blocks,
    iter_classes,
    unparse,
)
from repro_torch.analysis.core import Checker, register_checker

NONE, GIVEN, STATIC, HOST_FLAG = "none", "given", "static", "host_flag"  # env states

SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
NUMPY_COPIES = {"numpy.asarray", "numpy.array", "numpy.asanyarray", "numpy.ascontiguousarray"}
DATA_SHAPED = {"nonzero", "unique", "unique_consecutive", "masked_select", "argwhere"}
CAST_BUILTINS = {"float", "bool", "int"}
SCALAR_TYPES = {"int", "float", "bool", "str"}
STATIC_ATTRS = {"ndim", "dtype", "device", "shape", "is_cuda", "type", "size"}
STATIC_METHODS = {"size", "numel", "dim", "element_size", "stride", "nelement",
                  "is_contiguous", "bit_length"}
STATIC_BUILTINS = {"len", "min", "max", "abs", "round", "divmod", "tuple", "int", "float",
                   "bool", "str", "range"}


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _scalar_annotation(arg: ast.arg) -> bool:
    return isinstance(arg.annotation, ast.Name) and arg.annotation.id in SCALAR_TYPES


def _own_expr_nodes(node: ast.AST):
    """`node` and its subtree, pruning nested def/class bodies."""
    stack = [node]
    while stack:
        n = stack.pop(0)
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                stack.append(child)


def _assigned_names(stmt: ast.AST) -> set:
    out = set()
    for n in ast.walk(stmt):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def _assignments(node):
    """(target, value) pairs of an assignment statement; value None where
    the target takes part of a value that is not spelled out."""
    if isinstance(node, ast.Assign):
        targets, value = node.targets, node.value
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
        targets, value = [node.target], node.value
    else:
        return []
    out = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(t.elts):
                out += list(zip(t.elts, value.elts))
            else:
                out += [(e, None) for e in t.elts]
        else:
            out.append((t, value))
    return out


def _static_attrs(modules) -> dict:
    """(path, class qualname) -> instance attributes only ever assigned a
    static value (a literal, or an int()/float()/bool()/str()/len() call)."""
    out = {}
    for m in modules:
        for cq, cls in iter_classes(m.tree):
            good, bad = set(), set()
            for node in ast.walk(cls):
                for target, value in _assignments(node):
                    if not (isinstance(target, ast.Attribute)
                            and dotted_name(target.value) == "self"):
                        continue
                    static = isinstance(value, ast.Constant) or (
                        isinstance(value, ast.Call)
                        and dotted_name(value.func) in ("int", "float", "bool", "str", "len"))
                    (good if static else bad).add(target.attr)
            out[(m.path, cq)] = good - bad
    return out


class _Captured:
    """The walk over one project's captured closure."""

    def __init__(self, modules, report=None):
        self.g = CallGraph.of(modules)
        self.report = report
        self.static_attrs = _static_attrs(modules)
        self.visited: set = set()
        self.reported: set = set()
        self.roots: list = []  # keys called or passed directly under a capture

    # ----------------------------------------------------------- states

    def _resolve_callable(self, node, env, ctx):
        """The function key `node` names in this scope, or None."""
        module, scope, params = ctx["module"], ctx["scope"], ctx["params"]
        if isinstance(node, ast.Name) and (node.id in env or node.id in params):
            state = env.get(node.id)
            return state[1] if isinstance(state, tuple) else None
        return self.g.resolve(module, node, scope)

    def is_static(self, node, env, ctx) -> bool:
        if isinstance(node, ast.Constant) or isinstance(node, ast.JoinedStr):
            return True
        if isinstance(node, ast.Name):
            return env.get(node.id) == STATIC or node.id.isupper()
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS or node.attr.isupper():
                return True
            if dotted_name(node.value) == "self" and ctx["cls"] is not None:
                return node.attr in self.static_attrs.get(ctx["cls"], set())
            return False
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value, env, ctx) and self.is_static(node.slice, env, ctx)
        if isinstance(node, ast.Slice):
            return all(p is None or self.is_static(p, env, ctx)
                       for p in (node.lower, node.upper, node.step))
        if isinstance(node, ast.Call):
            args = list(node.args) + [kw.value for kw in node.keywords]
            fn = node.func
            if isinstance(fn, ast.Name):
                return fn.id in STATIC_BUILTINS and all(self.is_static(a, env, ctx) for a in args)
            if isinstance(fn, ast.Attribute):
                if fn.attr in STATIC_METHODS:
                    return all(self.is_static(a, env, ctx) for a in args)
                return self.is_static(fn.value, env, ctx) and all(
                    self.is_static(a, env, ctx) for a in args)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left, env, ctx) and self.is_static(node.right, env, ctx)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand, env, ctx)
        if isinstance(node, ast.BoolOp):
            return all(self.is_static(v, env, ctx) for v in node.values)
        if isinstance(node, ast.Compare):
            return all(self.is_static(v, env, ctx) for v in (node.left, *node.comparators))
        if isinstance(node, ast.IfExp):
            return all(self.is_static(v, env, ctx) for v in (node.test, node.body, node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.is_static(e, env, ctx) for e in node.elts)
        return False

    def state(self, node, env, ctx, passed: bool = False):
        """What an expression bound here (or `passed` as an argument) is
        known to be: NONE, STATIC (a host scalar), HOST_FLAG, ("func",
        key), GIVEN (an argument spelled out as an expression other than a
        name: taken as given, not None), or None (unknown)."""
        if _is_none(node):
            return NONE
        if isinstance(node, ast.Name) and node.id in env:
            return env[node.id]
        if self.is_static(node, env, ctx):
            return STATIC
        if isinstance(node, (ast.Name, ast.Attribute)):
            key = self._resolve_callable(node, env, ctx)
            if key is not None:
                return ("func", key)
            if isinstance(node, ast.Name):
                return None
        if isinstance(node, ast.Call) and self._is_host_flag_call(node, ctx):
            return HOST_FLAG
        return GIVEN if passed else None

    def truth(self, test, env, ctx) -> Optional[bool]:
        """The value of an `if` test inside captured code, where known."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self.truth(test.operand, env, ctx)
            return None if inner is None else not inner
        if isinstance(test, ast.BoolOp):
            vals = [self.truth(v, env, ctx) for v in test.values]
            if isinstance(test.op, ast.And):
                return False if False in vals else (True if all(v is True for v in vals) else None)
            return True if True in vals else (False if all(v is False for v in vals) else None)
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            left, op, right = test.left, test.ops[0], test.comparators[0]
            if isinstance(op, (ast.Is, ast.IsNot)) and _is_none(right):
                st = self.state(left, env, ctx)
                if st is None:
                    return None
                is_none = st == NONE
                return is_none if isinstance(op, ast.Is) else not is_none
            # A captured body runs on the card: `<x>.type` is "cuda".
            if isinstance(left, ast.Attribute) and left.attr == "type":
                lit = right.value if isinstance(right, ast.Constant) else None
                if isinstance(right, (ast.Tuple, ast.List, ast.Set)):
                    lits = [e.value for e in right.elts if isinstance(e, ast.Constant)]
                    if isinstance(op, (ast.In, ast.NotIn)) and len(lits) == len(right.elts):
                        return ("cuda" in lits) == isinstance(op, ast.In)
                if isinstance(lit, str) and isinstance(op, (ast.Eq, ast.NotEq)):
                    return (lit == "cuda") == isinstance(op, ast.Eq)
        if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
            return True
        if isinstance(test, ast.Name) and env.get(test.id) == NONE:
            return False
        return None

    # ------------------------------------------------------------ walk

    def visit(self, key, env, chain) -> None:
        memo = (key, frozenset(env.items()))
        if memo in self.visited:
            return
        self.visited.add(memo)
        module, info = self.g.funcs[key]
        ctx = dict(module=module, scope=key, params=set(info.params()), info=info,
                   cls=self.g.enclosing_class(key), chain=chain + [info.qualname],
                   imports=self.g.imports[module.path])
        self.walk_block(info.node.body, dict(env), ctx)

    def walk_block(self, stmts, env, ctx):
        """Walk the live statements of a block; returns (env, terminated)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # a nested def runs when it is called or passed
            if isinstance(stmt, ast.If):
                self.scan(stmt.test, env, ctx)
                t = self.truth(stmt.test, env, ctx)
                if t is not None:
                    env, term = self.walk_block(stmt.body if t else stmt.orelse, env, ctx)
                else:
                    e1, t1 = self.walk_block(stmt.body, dict(env), ctx)
                    e2, t2 = self.walk_block(stmt.orelse, dict(env), ctx)
                    term = t1 and t2
                    env = e2 if t1 else e1 if t2 else {
                        k: v for k, v in e1.items() if e2.get(k) == v}
                if term:
                    return env, True
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While, ast.Try, ast.With,
                                 ast.AsyncWith)) or type(stmt).__name__ == "Match":
                env = self._walk_compound(stmt, env, ctx)
                continue
            self.scan(stmt, env, ctx)
            self._bind(stmt, env, ctx)
            if isinstance(stmt, (ast.Return, ast.Raise)):
                return env, True
        return env, False

    def _walk_compound(self, stmt, env, ctx) -> dict:
        """Loops, with, try, match: every part walked from the state before
        it, less the names any part rebinds."""
        assigned = _assigned_names(stmt)
        inner = {k: v for k, v in env.items() if k not in assigned}
        for field in ("iter", "test", "subject"):
            if getattr(stmt, field, None) is not None:
                self.scan(getattr(stmt, field), env, ctx)
        for item in getattr(stmt, "items", []):
            self.scan(item.context_expr, env, ctx)
        if isinstance(stmt, (ast.For, ast.AsyncFor)) and self.is_static(stmt.iter, env, ctx):
            inner.update({n: STATIC for n in _assigned_names(stmt.target)})
        bodies = [stmt.body, getattr(stmt, "orelse", []), getattr(stmt, "finalbody", [])]
        bodies += [h.body for h in getattr(stmt, "handlers", [])]
        bodies += [c.body for c in getattr(stmt, "cases", [])]
        for body in bodies:
            self.walk_block(body, dict(inner), ctx)
        return {k: v for k, v in env.items() if k not in assigned}

    def _bind(self, stmt, env, ctx) -> None:
        if isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name) and not (
                env.get(stmt.target.id) == STATIC and self.is_static(stmt.value, env, ctx)
            ):
                env.pop(stmt.target.id, None)
            return
        before = dict(env)
        for target, value in _assignments(stmt):
            if isinstance(target, ast.Name):
                st = None if value is None else self.state(value, before, ctx)
                if value is None and isinstance(stmt, ast.Assign) and self.is_static(
                        stmt.value, before, ctx):
                    st = STATIC  # `p, E = x.shape`
                if st is None:
                    env.pop(target.id, None)
                else:
                    env[target.id] = st
            else:
                for name in _assigned_names(target):
                    env.pop(name, None)

    # ------------------------------------------------------------ scan

    def _is_host_flag_call(self, call, ctx) -> bool:
        qn = call_qualname(call, ctx["imports"]) or ""
        if qn == "host_flag" or qn.endswith(".host_flag"):
            return True
        key = self._resolve_callable(call.func, {}, dict(ctx, params=set()))
        return key is not None and self.g.info(key).name == "host_flag"

    def scan(self, node, env, ctx) -> None:
        """Check every sync site in `node` and follow every call or
        reference into the project."""
        called = set()
        for n in _own_expr_nodes(node):
            if isinstance(n, ast.Call):
                called.add(id(n.func))
                what = self._sync(n, env, ctx)
                if what:
                    self._report(n, what, ctx)
                key = self._resolve_callable(n.func, env, ctx)
                if key is not None:
                    self.visit(key, self._callee_env(n, key, env, ctx), ctx["chain"])
            elif (isinstance(n, ast.Attribute) and n.attr == "value"
                  and isinstance(n.value, ast.Subscript) and isinstance(n.value.value, ast.Name)
                  and env.get(n.value.value.id) == HOST_FLAG):
                self._report(n, "reads the kernel's pinned host flag: under capture it is read "
                                "once, before anything ran", ctx)
            elif (isinstance(n, (ast.Name, ast.Attribute)) and isinstance(n.ctx, ast.Load)
                  and id(n) not in called):
                key = self._resolve_callable(n, env, ctx)
                if key is not None and key != ctx["scope"]:
                    self.visit(key, {}, ctx["chain"])  # passed: the callee may call it

    def _callee_env(self, call, key, env, ctx) -> dict:
        info = self.g.info(key)
        a = info.node.args
        positional = a.posonlyargs + a.args
        if info.is_method:
            positional = positional[1:]
        out = {}
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(positional):
                out[positional[i].arg] = self.state(arg, env, ctx, passed=True)
        for kw in call.keywords:
            if kw.arg is not None:
                out[kw.arg] = self.state(kw.value, env, ctx, passed=True)
        # *args / **kwargs may supply any parameter not spelled out: then
        # no default is assumed.
        starred = any(isinstance(a, ast.Starred) for a in call.args) or any(
            kw.arg is None for kw in call.keywords)
        defaults = list(zip(positional[len(positional) - len(a.defaults):], a.defaults))
        defaults += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
        callee_module = self.g.module_of(key)
        callee_ctx = dict(module=callee_module, scope=key, params=set(), cls=None,
                          imports=self.g.imports[callee_module.path])
        for p, d in defaults:
            if p.arg not in out and not starred:
                out[p.arg] = self.state(d, {}, callee_ctx)
        for p in positional + a.kwonlyargs:
            if _scalar_annotation(p) and out.get(p.arg) != NONE:
                out[p.arg] = STATIC
        return {k: v for k, v in out.items() if v is not None}

    def _sync(self, call, env, ctx) -> Optional[str]:
        imports = ctx["imports"]
        qn = call_qualname(call, imports) or ""
        fn = call.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        on_module = attr is not None and dotted_name(fn.value) in imports
        sync = "forces a device->host sync"
        if self._is_host_flag_call(call, ctx):
            return ("takes the kernel's host-flag path: the C launch spins on pinned host "
                    "memory that no kernel writes during a capture")
        if qn in NUMPY_COPIES and not (call.args and self.is_static(call.args[0], env, ctx)):
            return f"copies to the host and {sync}"
        if qn == "torch.cuda.synchronize" or attr == "synchronize":
            return "waits for the device (illegal while a stream captures)"
        if attr in SYNC_METHODS and not on_module and (attr in ("cpu", "numpy") or not call.args):
            return sync
        if attr == "to" and not on_module:
            targets = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "device"]
            for t in targets:
                if isinstance(t, ast.Constant) and t.value == "cpu" or (
                    isinstance(t, ast.Call) and call_qualname(t, imports) == "torch.device"
                    and t.args and isinstance(t.args[0], ast.Constant)
                    and t.args[0].value == "cpu"
                ):
                    return f"copies to the host and {sync}"
        shaped = "has a data-dependent output shape: the host waits for the device to size it"
        if qn in {f"torch.{n}" for n in DATA_SHAPED} or (attr in DATA_SHAPED and not on_module):
            return shaped
        if qn == "torch.where" and len(call.args) == 1 and not call.keywords:
            return shaped
        if qn == "torch.repeat_interleave" or (attr == "repeat_interleave" and not on_module):
            repeats = call.args[1] if qn == "torch.repeat_interleave" and len(call.args) > 1 else (
                call.args[0] if call.args and qn != "torch.repeat_interleave" else None)
            repeats = next((kw.value for kw in call.keywords if kw.arg == "repeats"), repeats)
            has_size = any(kw.arg == "output_size" for kw in call.keywords)
            if not has_size and (repeats is None or not self.is_static(repeats, env, ctx)):
                return shaped + " (pass output_size=)"
        if (isinstance(fn, ast.Name) and fn.id in CAST_BUILTINS and len(call.args) == 1
                and not self.is_static(call.args[0], env, ctx)):
            return f"converts a device value on the host and {sync}"
        return None

    def _report(self, node, what, ctx) -> None:
        module = ctx["module"]
        pos = (module.path, node.lineno, node.col_offset)
        if pos in self.reported or self.report is None:
            return
        self.reported.add(pos)
        scope = ctx["info"].qualname if ctx.get("info") else ctx["chain"][-1]
        self.report(
            module.path, node.lineno, node.col_offset,
            f"`{unparse(node)}` in `{scope}` {what}; it runs inside the CUDA graph captured "
            f"in `{ctx['chain'][0]}` (via {' -> '.join(ctx['chain'])})",
            anchor=scope,
        )

    # ------------------------------------------------------------ roots

    def run(self) -> None:
        for m in self.g.modules:
            imports = self.g.imports[m.path]
            for cap in graph_capture_blocks(m.tree, imports):
                scope = self.g.scope_of(m, cap)
                info = self.g.info(scope) if scope is not None else None
                ctx = dict(module=m, scope=scope, params=set(info.params()) if info else set(),
                           info=info, cls=self.g.enclosing_class(scope) if scope else None,
                           chain=[info.qualname if info else "<module>"], imports=imports)
                if isinstance(cap, ast.Call):  # make_graphed_callables(callables, ...)
                    first = cap.args[0] if cap.args else None
                    elts = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
                    for e in elts:
                        key = self._resolve_callable(e, {}, ctx) if e is not None else None
                        if key is not None:
                            self.roots.append(key)
                            self.visit(key, {}, ctx["chain"])
                    continue
                for stmt in cap.body:
                    for n in _own_expr_nodes(stmt):
                        if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                            n.ctx, ast.Load
                        ):
                            key = self._resolve_callable(n, {}, ctx)
                            if key is not None and key not in self.roots:
                                self.roots.append(key)
                self.walk_block(cap.body, {}, ctx)


def captured_roots(modules) -> list:
    """Dotted names of the functions called or passed directly under a
    CUDA-graph capture in `modules` (the roots of HS01's closure)."""
    walk = _Captured(modules)
    walk.run()
    return sorted(f"{walk.g.module_of(k).dotted}.{walk.g.info(k).qualname}" for k in walk.roots)


@register_checker
class HostSyncChecker(Checker):
    code = "HS01"
    name = "host-sync-in-capture"
    description = (
        ".item()/.tolist()/.cpu()/bool()/int()/synchronize/host-flag reads and "
        "data-shaped ops inside code a CUDA graph captures (fails the capture, or "
        "is baked into every replay)"
    )
    severity = "error"
    scope = "project"

    def check_project(self, modules, report, resources=None) -> None:
        _Captured(modules, report).run()

