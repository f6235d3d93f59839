"""KP01 — kernel wrapper parity: plain branch, CUDA branch, C bindings.

Every public entry of the kernels' ``ops`` module that calls into a kernel
wrapper module (one that binds C entries with ``c_function``) must keep
both implementations alive and honest:

  - a **plain branch**: the wrapper (or a helper of its module that it
    calls) branches on ``<x>.device.type == "cpu"`` and calls a
    ``*_plain`` function there, call-compatible with the plain function's
    actual signature (arity, unknown/missing keywords);
  - a **CUDA branch**: the wrapper's module functions that it reaches call
    ``c_function(...)``, pass the launch's return code to
    ``check_launch``, and count the launch in ``LAUNCHES[...] +=`` (the
    counter chip_smoke's launch columns read);
  - **no quiet fallback**: no launch sits in a ``try`` whose handler runs
    the plain version instead;
  - **block padding**: an entry taking a ``block_*`` parameter pads the
    stream itself (``pad_stream`` or a ``% block_*`` length), forwards the
    parameter, or says ``del block_*`` (the CUDA kernel takes any length).

Every C entry point a wrapper returns a ``cudaError_t`` from (default
``restype``: ``c_int``) must send that code to ``check_launch`` in the
function that launches it.

**The bindings.** Every ``c_function(lib, symbol, argtypes, restype)``
with a literal library and symbol is held against the ``extern "C"`` block
of ``csrc/<lib>.cu`` beside the calling module: the symbol exists, the
arity matches, each argument's kind matches (any pointer ↔ ``c_void_p``,
``int`` ↔ ``c_int``, ``long long`` ↔ ``c_longlong``, ``float`` ↔
``c_float``, ...) and so does the return type (``int`` is c_function's
default restype; ``long long`` ↔ ``c_longlong``). A binding whose library
and symbol come from the enclosing function's parameter
(``c_function(name, f"{name}_host_flag", ...)`` in ``dispatch.host_flag``)
is checked once for each call site that passes that parameter a literal
(``host_flag("segment_reduce")``). A binding that cannot be resolved —
a non-literal name, ``argtypes`` that do not fold — is a finding, never
skipped: a drifted binding is silent memory corruption on the card, and
no CPU test loads a library.
"""
from __future__ import annotations

import ast
import dataclasses
import posixpath
import re
from typing import Optional

from repro_torch.analysis.astutil import (
    CallGraph,
    Symbol,
    const_value,
    dotted_name,
    own_nodes,
    unparse,
)
from repro_torch.analysis.core import Checker, register_checker

PAD_HELPER = "pad_stream"
LAUNCH_COUNTER = "LAUNCHES"
CHECK_LAUNCH = "check_launch"
BINDER = "c_function"
DEFAULT_RESTYPE = "c_int"

# C parameter / return types (qualifiers dropped) -> the ctypes name that binds them.
C_TYPES = {
    "int": "c_int", "int32_t": "c_int", "signed int": "c_int",
    "unsigned": "c_uint", "unsigned int": "c_uint", "uint32_t": "c_uint",
    "long long": "c_longlong", "long long int": "c_longlong", "int64_t": "c_longlong",
    "unsigned long long": "c_ulonglong", "uint64_t": "c_ulonglong",
    "long": "c_long", "unsigned long": "c_ulong", "size_t": "c_size_t",
    "float": "c_float", "double": "c_double", "bool": "c_bool", "char": "c_char",
    "void": None,
}
# ctypes aliases -> the name C_TYPES uses (on LP64: int32 = int, int64 = long long).
CTYPES_ALIASES = {"c_int32": "c_int", "c_uint32": "c_uint", "c_int64": "c_longlong",
                  "c_uint64": "c_ulonglong", "c_char_p": "c_void_p"}
_QUALIFIERS = {"const", "volatile", "static", "inline", "extern", "__host__", "restrict",
               "__restrict__", "struct"}


@dataclasses.dataclass(frozen=True)
class CFunction:
    """One function of an ``extern "C"`` block."""

    name: str
    restype: Optional[str]  # ctypes name; None for void; "?" if unknown
    params: tuple  # (ctypes name or "?", declaration text) per parameter
    line: int


@dataclasses.dataclass(frozen=True)
class Binding:
    """One checked (library, symbol) binding."""

    lib: str
    symbol: str
    path: str  # the Python module that binds it
    line: int
    argtypes: tuple  # ctypes names
    c_arity: Optional[int]  # parameters of the C function (None: not found)


def _strip_comments(text: str) -> str:
    """Blank out // and /* */ comments, keeping newlines (line numbers)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _c_kind(decl: str, is_param: bool) -> str:
    decl = re.sub(r"\[[^\]]*\]", "*", decl)
    if "*" in decl or "&" in decl:
        return "c_void_p"
    words = [w for w in re.findall(r"[A-Za-z_]\w*", decl) if w not in _QUALIFIERS]
    if is_param and len(words) > 1:
        words = words[:-1]  # the parameter's name
    base = " ".join(words)
    if base in C_TYPES:
        return C_TYPES[base]
    return "?"


def _parse_header(header: str, line: int) -> Optional[CFunction]:
    m = re.match(r"^\s*(?P<ret>[\w\s\*&]+?)\s*\b(?P<name>[A-Za-z_]\w*)\s*\((?P<params>.*)\)\s*$",
                 header, flags=re.S)
    if m is None:
        return None
    raw = " ".join(m.group("params").split())
    params = [] if raw in ("", "void") else [p.strip() for p in raw.split(",")]
    ret = _c_kind(m.group("ret"), is_param=False)
    return CFunction(m.group("name"), ret, tuple((_c_kind(p, True), p) for p in params), line)


def extern_c_functions(text: str) -> dict:
    """{name: CFunction} of every function defined or declared in the
    ``extern "C"`` blocks (or after a one-line ``extern "C"``) of a C/CUDA
    source."""
    text = _strip_comments(text)
    out = {}
    for m in re.finditer(r'extern\s+"C"\s*', text):
        i = m.end()
        block = text[i] == "{"
        if block:
            i += 1
        depth, start = 0, i
        while i < len(text):
            ch = text[i]
            if depth == 0 and ch in "{;}":
                if ch == "}" and block:
                    break
                header = text[start:i]
                fn = _parse_header(header, text.count("\n", 0, start + len(header) - len(
                    header.lstrip())) + 1)
                if fn is not None:
                    out[fn.name] = fn
                if ch == "{":
                    depth = 1
                elif not block:
                    break
                start = i + 1
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    start = i + 1
                    if not block:
                        break
            i += 1
    return out


def _ctypes_name(value) -> Optional[str]:
    if isinstance(value, Symbol) and value.name.startswith("ctypes."):
        name = value.name.split(".", 1)[1]
        return CTYPES_ALIASES.get(name, name)
    return None


def _arg(call: ast.Call, index: int, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return call.args[index] if index < len(call.args) else None


def _is_binder(call: ast.Call) -> bool:
    return (dotted_name(call.func) or "").rsplit(".", 1)[-1] == BINDER


def _is_check_launch(call: ast.Call) -> bool:
    return (dotted_name(call.func) or "").rsplit(".", 1)[-1] == CHECK_LAUNCH


def _signature_issue(call: ast.Call, impl: ast.FunctionDef):
    """Call-compatibility of `call` against def `impl`; None when fine."""
    if any(isinstance(a, ast.Starred) for a in call.args) or any(
        kw.arg is None for kw in call.keywords
    ):
        return None  # *args/**kwargs forwarding: not statically checkable
    a = impl.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    kwonly = [p.arg for p in a.kwonlyargs]
    npos_given = len(call.args)
    if a.vararg is None and npos_given > len(pos):
        return f"passes {npos_given} positional args but `{impl.name}` takes {len(pos)}"
    given_kw = {kw.arg for kw in call.keywords}
    if a.kwarg is None:
        unknown = given_kw - set(pos) - set(kwonly)
        if unknown:
            return f"passes unknown keyword(s) {sorted(unknown)} to `{impl.name}`"
    n_defaults = len(a.defaults)
    required_pos = pos[: len(pos) - n_defaults]
    missing = [
        p for p in required_pos[npos_given:] if p not in given_kw
    ] + [
        p
        for p, d in zip(kwonly, a.kw_defaults)
        if d is None and p not in given_kw
    ]
    if missing:
        return f"misses required parameter(s) {missing} of `{impl.name}`"
    return None


def _is_cpu_test(test: ast.AST) -> bool:
    """``<x>.type == "cpu"`` (also ``<x>.device.type``)."""
    return (
        isinstance(test, ast.Compare) and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Eq)
        and isinstance(test.left, ast.Attribute) and test.left.attr == "type"
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value == "cpu"
    )


class _Bindings:
    """The c_function sites of the analysed set, resolved and checked."""

    def __init__(self, g: CallGraph, resources: dict, report):
        self.g, self.resources, self.report = g, resources, report
        self.c_cache: dict = {}
        self.checked: list = []
        self._sites = None

    def c_functions(self, path: str):
        if path not in self.c_cache:
            text = self.resources.get(path)
            self.c_cache[path] = None if text is None else extern_c_functions(text)
        return self.c_cache[path]

    def sites(self) -> list:
        """(module, scope key, call) of every c_function call."""
        if self._sites is None:
            self._sites = [(m, self.g.scope_of(m, node), node)
                           for m in self.g.modules for node in ast.walk(m.tree)
                           if isinstance(node, ast.Call) and _is_binder(node)]
        return self._sites

    def run(self) -> None:
        for module, scope, call in self.sites():
            for lib, symbol, where in self._instances(module, scope, call):
                self._check(module, call, lib, symbol, where)

    def _instances(self, module, scope, call):
        """(lib, symbol, where) for each concrete binding the site makes."""
        lib_node, sym_node = _arg(call, 0, "name"), _arg(call, 1, "symbol")
        lib, sym = const_value(lib_node) if lib_node else None, (
            const_value(sym_node) if sym_node else None)
        if isinstance(lib, str) and isinstance(sym, str):
            return [(lib, sym, "")]
        info = self.g.info(scope) if scope is not None else None
        param = lib_node.id if isinstance(lib_node, ast.Name) else None
        if info is not None and param in info.params() and isinstance(sym_node, ast.JoinedStr) \
                and all(isinstance(v, ast.Constant) or (
                    isinstance(v, ast.FormattedValue) and isinstance(v.value, ast.Name)
                    and v.value.id == param) for v in sym_node.values):
            out, bad = [], []
            positional = info.positional_params()
            index = positional.index(param) if param in positional else len(positional) + 1
            for caller, site in self._call_sites(scope):
                value = _arg(site, index - info.is_method, param)
                lit = const_value(value) if value is not None else None
                if not isinstance(lit, str):
                    bad.append((caller, site))
                    continue
                name = "".join(v.value if isinstance(v, ast.Constant) else lit
                               for v in sym_node.values)
                out.append((lit, name, f" (through `{caller.path}:{site.lineno}`)"))
            for caller, site in bad:
                self.report(
                    caller.path, site.lineno, site.col_offset,
                    f"`{unparse(site)}` passes `{info.name}` a non-literal `{param}`: the C "
                    f"entry it binds through `{BINDER}` cannot be checked",
                    anchor=info.qualname,
                )
            if not out and not bad:
                self._unresolved(module, call, f"no call of `{info.name}` passes `{param}` a "
                                                "literal library name")
            return out
        self._unresolved(module, call, "its library and symbol are not literals")
        return []

    def _call_sites(self, key):
        """(module, call) of every call that resolves to function `key`."""
        for m in self.g.modules:
            scopes = [None] + [k for k, (mm, _) in self.g.funcs.items() if mm.path == m.path]
            for scope in scopes:
                body = m.tree if scope is None else self.g.info(scope).node
                for node in own_nodes(body):
                    if isinstance(node, ast.Call) and self.g.resolve(m, node.func, scope) == key:
                        yield m, node

    def _unresolved(self, module, call, why) -> None:
        self.report(
            module.path, call.lineno, call.col_offset,
            f"`{unparse(call)}` cannot be held against its C entry: {why}",
            anchor=BINDER,
        )

    def _check(self, module, call, lib, symbol, where) -> None:
        imports = self.g.imports[module.path]
        pos = (module.path, call.lineno, call.col_offset)
        anchor = f"{lib}.{symbol}"
        cu = posixpath.join(posixpath.dirname(module.path), "csrc", f"{lib}.cu")
        funcs = self.c_functions(cu)
        if funcs is None:
            self.report(*pos, f"`{symbol}`{where}: library `{lib}` has no C source `{cu}` "
                              "in the analysed set", anchor=anchor)
            return
        fn = funcs.get(symbol)
        if fn is None:
            self.report(*pos, f"`{symbol}`{where} is not an extern \"C\" function of `{cu}` "
                              f"(it has: {sorted(funcs)})", anchor=anchor)
            self.checked.append(Binding(lib, symbol, module.path, call.lineno, (), None))
            return
        argtypes_node = _arg(call, 2, "argtypes")
        folded = const_value(argtypes_node, imports) if argtypes_node is not None else None
        names = [_ctypes_name(v) for v in folded] if isinstance(folded, (list, tuple)) else None
        if names is None or None in names:
            self.report(*pos, f"`{symbol}`{where}: argtypes `{unparse(argtypes_node)}` do not "
                              "fold to a list of ctypes types", anchor=anchor)
            return
        self.checked.append(Binding(lib, symbol, module.path, call.lineno, tuple(names),
                                    len(fn.params)))
        if len(names) != len(fn.params):
            self.report(*pos, f"`{symbol}`{where} binds {len(names)} argtypes, but the C "
                              f"function (`{cu}:{fn.line}`) takes {len(fn.params)}",
                        anchor=anchor)
        for i, (got, (want, decl)) in enumerate(zip(names, fn.params) if len(names) == len(
                fn.params) else ()):
            if want != got:
                self.report(*pos, f"`{symbol}`{where}: argument {i} (`{decl}`) is bound as "
                                  f"ctypes.{got}, the C type needs "
                                  f"{'ctypes.' + want if want != '?' else 'a type KP01 knows'}",
                            anchor=anchor)
        restype_node = _arg(call, 3, "restype")
        if restype_node is None:
            restype = DEFAULT_RESTYPE
        else:
            value = const_value(restype_node, imports)
            restype = None if value is None and isinstance(restype_node, ast.Constant) else (
                _ctypes_name(value) if value is not None else "?")
        if restype != fn.restype:
            self.report(*pos, f"`{symbol}`{where} returns `{fn.restype or 'void'}` in C "
                              f"(`{cu}:{fn.line}`) but is bound with restype "
                              f"{'ctypes.' + restype if restype else None}", anchor=anchor)


@register_checker
class KernelParityChecker(Checker):
    code = "KP01"
    name = "kernel-wrapper-parity"
    description = (
        "kernels.ops entries keep a *_plain CPU branch and a counted, checked CUDA "
        "branch; every c_function binding matches its extern \"C\" signature"
    )
    severity = "error"
    scope = "project"

    def check_project(self, modules, report, resources=None) -> None:
        g = CallGraph.of(modules)
        bindings = _Bindings(g, resources or {}, report)
        bindings.run()
        wrapper_paths = {m.path for m, _, _ in bindings.sites()}
        for m in modules:
            for key in [k for k, (mm, _) in g.funcs.items() if mm.path == m.path]:
                if m.path in wrapper_paths:
                    self._check_return_codes(g, key, report)
            if m.dotted.endswith("kernels.ops"):
                self._check_ops_module(g, m, wrapper_paths, report)

    # ------------------------------------------------------ launch codes

    def _check_return_codes(self, g, key, report) -> None:
        module, info = g.funcs[key]
        fn = info.node
        handles = {}  # local name -> restype node (None: default c_int)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and _is_binder(
                    node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        handles[t.id] = _arg(node.value, 3, "restype")
        checked_names, checked_calls = set(), set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_check_launch(node):
                for n in ast.walk(node):
                    if isinstance(n, ast.Name):
                        checked_names.add(n.id)
                    checked_calls.add(id(n))
        assigned = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                assigned[id(node.value)] = [t.id for t in node.targets if isinstance(t, ast.Name)]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id in handles:
                restype = handles[node.func.id]
            elif isinstance(node.func, ast.Call) and _is_binder(node.func):
                restype = _arg(node.func, 3, "restype")
            else:
                continue
            if restype is not None:
                continue  # a size query, not a launch
            if id(node) in checked_calls or set(assigned.get(id(node), ())) & checked_names:
                continue
            report(
                module.path, node.lineno, node.col_offset,
                f"the cudaError_t that `{unparse(node.func)}` returns in `{info.qualname}` "
                f"never reaches {CHECK_LAUNCH}: a failed launch would pass silently",
                anchor=info.qualname,
            )

    # ------------------------------------------------------ ops entries

    def _same_module_closure(self, g, key) -> list:
        module = g.module_of(key)
        out, todo = [], [key]
        while todo:
            k = todo.pop()
            if k in out:
                continue
            out.append(k)
            for c in g.callees(k, ast.walk(g.info(k).node)):
                if g.module_of(c).path == module.path:
                    todo.append(c)
        return out

    def _check_ops_module(self, g, module, wrapper_paths, report) -> None:
        for fn in module.tree.body:
            if not isinstance(fn, ast.FunctionDef) or fn.name.startswith("_"):
                continue
            key = (module.path, fn.name)
            wrappers = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    target = g.resolve(module, node.func, key)
                    if target is not None and target not in wrappers and g.module_of(
                            target).path in wrapper_paths and self._dispatches(g, target):
                        wrappers.append(target)
            if not wrappers:
                continue  # a helper or a delegator: parity owned by the delegate
            for w in wrappers:
                self._check_wrapper(g, module, fn, w, report)
            self._check_padding(module, fn, report)

    def _dispatches(self, g, key) -> bool:
        """A kernel wrapper: it (or a helper of its module it calls) tests
        the device for the CPU or binds a C entry."""
        return any(
            isinstance(n, ast.If) and _is_cpu_test(n.test)
            or isinstance(n, ast.Call) and _is_binder(n)
            for k in self._same_module_closure(g, key) for n in ast.walk(g.info(k).node)
        )

    def _check_wrapper(self, g, module, fn, wrapper, report) -> None:
        where = (module.path, fn.lineno, fn.col_offset)
        wname = g.info(wrapper).qualname
        closure = self._same_module_closure(g, wrapper)
        wmod = g.module_of(wrapper)
        plain_calls = []
        for k in closure:
            for node in ast.walk(g.info(k).node):
                if isinstance(node, ast.If) and _is_cpu_test(node.test):
                    for stmt in node.body:
                        for n in ast.walk(stmt):
                            if isinstance(n, ast.Call) and (dotted_name(n.func) or "").endswith(
                                    "_plain"):
                                plain_calls.append((k, n))
        if not plain_calls:
            report(*where, f"`{fn.name}` reaches `{wname}`, which has no CPU branch calling a "
                           "`*_plain` function (`if <t>.device.type == \"cpu\": ..._plain(...)`)",
                   anchor=fn.name)
        for k, call in plain_calls:
            target = g.resolve(g.module_of(k), call.func, k)
            if target is None:
                continue
            issue = _signature_issue(call, g.info(target).node)
            if issue:
                report(wmod.path, call.lineno, call.col_offset,
                       f"plain-branch signature drift in `{g.info(k).qualname}` (reached from "
                       f"ops `{fn.name}`): call {issue}", anchor=g.info(k).qualname)
        nodes = [n for k in closure for n in ast.walk(g.info(k).node)]
        binds = any(isinstance(n, ast.Call) and _is_binder(n) for n in nodes)
        checks = any(isinstance(n, ast.Call) and _is_check_launch(n) for n in nodes)
        counts = any(
            isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Subscript)
            and (dotted_name(n.target.value) or "").rsplit(".", 1)[-1] == LAUNCH_COUNTER
            for n in nodes
        )
        for ok, what in ((binds, f"calls no `{BINDER}(...)`: no CUDA branch"),
                         (checks, f"sends no launch's return code to `{CHECK_LAUNCH}`"),
                         (counts, f"counts no launch in `{LAUNCH_COUNTER}[...] +=`")):
            if not ok:
                report(*where, f"`{fn.name}` reaches `{wname}`, which {what}", anchor=fn.name)
        self._check_fallback(g, fn, closure, report)

    def _check_fallback(self, g, fn, closure, report) -> None:
        launching = {
            k for k in closure
            if any(isinstance(n, ast.Call) and _is_binder(n) for n in ast.walk(g.info(k).node))
        }
        for k in closure:
            module = g.module_of(k)
            for node in ast.walk(g.info(k).node):
                if not isinstance(node, ast.Try):
                    continue
                body = [n for s in node.body for n in ast.walk(s)]
                launches = any(isinstance(n, ast.Call) and _is_binder(n) for n in body) or any(
                    c in launching for c in g.callees(k, body))
                if not launches:
                    continue
                for h in node.handlers:
                    if any(isinstance(n, ast.Call) and (dotted_name(n.func) or "").endswith(
                            "_plain") for s in h.body for n in ast.walk(s)):
                        report(module.path, h.lineno, h.col_offset,
                               f"`{g.info(k).qualname}` (reached from ops `{fn.name}`) falls back "
                               "to the plain version when the CUDA launch raises: a card that "
                               "fails must fail loudly", anchor=g.info(k).qualname)

    def _check_padding(self, module, fn: ast.FunctionDef, report) -> None:
        a = fn.args
        block_params = [
            p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs) if p.arg.startswith("block_")
        ]
        for block in block_params:
            pads = any(
                isinstance(n, ast.Call) and (dotted_name(n.func) or "").endswith(PAD_HELPER)
                for n in ast.walk(fn)
            ) or any(
                isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
                and block in {dotted_name(n.right), dotted_name(n.left)}
                for n in ast.walk(fn)
            )
            forwarded = any(
                isinstance(n, ast.Call) and not (dotted_name(n.func) or "").endswith(PAD_HELPER)
                and any(kw.arg == block and isinstance(kw.value, ast.Name) and kw.value.id == block
                        for kw in n.keywords)
                for n in ast.walk(fn)
            )
            dropped = any(
                isinstance(n, ast.Delete) and any(
                    isinstance(t, ast.Name) and t.id == block for t in n.targets)
                for n in ast.walk(fn)
            )
            if not (pads or forwarded or dropped):
                report(
                    module.path, fn.lineno, fn.col_offset,
                    f"`{fn.name}` takes `{block}` but neither pads the stream "
                    f"({PAD_HELPER} / `% {block}`), forwards it, nor says `del {block}`",
                    anchor=fn.name,
                )


def c_bindings(modules, resources: dict) -> list:
    """The bindings KP01 checked in `modules` (with `resources`, the C
    sources), as `Binding`s: one per (site, library, symbol)."""
    g = CallGraph.of(modules)
    b = _Bindings(g, resources, lambda *a, **k: None)
    b.run()
    return b.checked
