"""RC01/RC02 — registry capability flags and frozen-config purity.

RC01 cross-checks declared capabilities against what the decorated /
registered code actually implements:

  - `@register_partitioner(...)` (`repro_torch.api.registry`): the port
    dispatches by device, so every registered partitioner must accept a
    `device` keyword (`PartitionerSpec.partition` passes one) and none may
    take a `compute_backend` or declare `compute_backends` (the
    reference's JAX-only knob, which the port's registry does not carry);
    `chunked=True` holds if and only if the function takes a `block`
    parameter; a literal `scorer=` name must be registered somewhere in
    the analyzed set via `EdgeScorer(name=...)`.
  - `register_program(VertexProgram(...))`: literal field values must be
    drawn from the engine's closed vocabularies (dtype/combine/local/
    weight/apply/message_policy/convergence), combine="sum" programs must
    run local="sweep" (there is no sum fixpoint kernel), apply="pagerank"
    requires combine="sum", and names/aliases must be project-unique.

RC02 keeps frozen config dataclasses pure: a `@dataclass(frozen=True)`
class must not carry mutable defaults (list/dict/set literals — breaks
hashability and shares state across instances) and must not mutate itself
after construction (`object.__setattr__(self, ...)` anywhere in the class
— the frozen contract exists so caches (the engine's run plans and fused
loops) can key on config identity).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.astutil import build_import_map, const_value, dotted_name, qualify
from repro_torch.analysis.core import Checker, register_checker

PROGRAM_VOCAB = {
    "dtype": ("int32", "float32"),
    "combine": ("min", "max", "sum"),
    "local": ("fixpoint", "sweep"),
    "weight": ("none", "edge", "unit"),
    "apply": ("none", "pagerank"),
    "message_policy": ("delta", "always"),
    "convergence": ("no_change", "tol"),
}
MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)


def _kw(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _literal(node):
    return None if node is None else const_value(node)


def _fn_params(fn: ast.FunctionDef) -> set:
    a = fn.args
    return {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}


@register_checker
class RegistryConsistencyChecker(Checker):
    code = "RC01"
    name = "registry-consistency"
    description = (
        "PartitionerSpec capability flags (device/chunked/scorer) and "
        "VertexProgram registry fields must match what the code implements"
    )
    severity = "error"
    scope = "project"

    def check_project(self, modules, report, resources=None) -> None:
        scorer_names = self._collect_scorer_names(modules)
        seen_programs: dict = {}
        for m in modules:
            imports = build_import_map(m.tree)
            for node in ast.walk(m.tree):
                if isinstance(node, ast.FunctionDef):
                    for dec in node.decorator_list:
                        if (
                            isinstance(dec, ast.Call)
                            and (qualify(dotted_name(dec.func), imports) or "").endswith(
                                "register_partitioner"
                            )
                        ):
                            self._check_partitioner(m, node, dec, scorer_names, report)
                elif isinstance(node, ast.Call):
                    qn = qualify(dotted_name(node.func), imports) or ""
                    if qn.endswith("register_program") and node.args:
                        inner = node.args[0]
                        if isinstance(inner, ast.Call) and (
                            dotted_name(inner.func) or ""
                        ).endswith("VertexProgram"):
                            self._check_program(m, inner, seen_programs, report)

    def _collect_scorer_names(self, modules) -> set:
        names = set()
        for m in modules:
            for node in ast.walk(m.tree):
                if isinstance(node, ast.Call) and (dotted_name(node.func) or "").endswith(
                    "EdgeScorer"
                ):
                    name = _literal(_kw(node, "name"))
                    if isinstance(name, str):
                        names.add(name)
        return names

    def _check_partitioner(self, module, fn, dec, scorer_names, report) -> None:
        where = (module.path, dec.lineno, dec.col_offset)
        params = _fn_params(fn)
        if "device" not in params and fn.args.kwarg is None:
            report(
                *where,
                f"partitioner `{fn.name}` takes no `device` keyword — the registry's "
                "partition() passes one, and every entry point runs on a caller-chosen device",
                anchor=fn.name,
            )
        if "compute_backend" in params or _kw(dec, "compute_backends") is not None:
            report(
                *where,
                f"partitioner `{fn.name}` carries the reference's compute_backend knob — "
                "the port dispatches by device and its registry has no compute_backends",
                anchor=fn.name,
            )
        chunked = _literal(_kw(dec, "chunked"))
        if chunked is True and "block" not in params:
            report(
                *where,
                f"partitioner `{fn.name}` declares chunked=True but takes no "
                "`block` parameter",
                anchor=fn.name,
            )
        if chunked in (False, None) and "block" in params:
            report(
                *where,
                f"partitioner `{fn.name}` accepts `block` but is not declared "
                "chunked=True",
                anchor=fn.name,
            )
        scorer = _literal(_kw(dec, "scorer"))
        if isinstance(scorer, str) and scorer_names and scorer not in scorer_names:
            report(
                *where,
                f"partitioner `{fn.name}` declares scorer={scorer!r} but no "
                f"EdgeScorer(name={scorer!r}) is registered (known: "
                f"{sorted(scorer_names)})",
                anchor=fn.name,
            )

    def _check_program(self, module, call: ast.Call, seen: dict, report) -> None:
        where = (module.path, call.lineno, call.col_offset)
        fields = {kw.arg: _literal(kw.value) for kw in call.keywords if kw.arg}
        name = fields.get("name")
        anchor = name if isinstance(name, str) else "VertexProgram"
        for field, vocab in PROGRAM_VOCAB.items():
            value = fields.get(field)
            if field in fields and isinstance(value, str) and value not in vocab:
                report(
                    *where,
                    f"program {anchor!r}: {field}={value!r} is not in {vocab}",
                    anchor=anchor,
                )
        combine = fields.get("combine", "min")
        local = fields.get("local", "fixpoint")
        if combine == "sum" and local != "sweep":
            report(
                *where,
                f"program {anchor!r}: combine='sum' requires local='sweep' "
                "(no sum-fixpoint kernel exists)",
                anchor=anchor,
            )
        if fields.get("apply") == "pagerank" and combine != "sum":
            report(
                *where,
                f"program {anchor!r}: apply='pagerank' requires combine='sum'",
                anchor=anchor,
            )
        claimed = [name] if isinstance(name, str) else []
        aliases = fields.get("aliases")
        if isinstance(aliases, (tuple, list)):
            claimed += [a for a in aliases if isinstance(a, str)]
        for n in claimed:
            if n in seen:
                report(
                    *where,
                    f"program name/alias {n!r} already registered at "
                    f"{seen[n][0]}:{seen[n][1]}",
                    anchor=anchor,
                )
            else:
                seen[n] = (module.path, call.lineno)


@register_checker
class FrozenConfigChecker(Checker):
    code = "RC02"
    name = "frozen-config-purity"
    description = (
        "frozen dataclasses must stay pure: no mutable defaults, no "
        "object.__setattr__ self-mutation after construction"
    )
    severity = "error"
    scope = "module"

    def check_module(self, module, report) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and self._is_frozen_dataclass(node):
                self._check_class(module, node, report)

    def _is_frozen_dataclass(self, cls: ast.ClassDef) -> bool:
        for dec in cls.decorator_list:
            if isinstance(dec, ast.Call) and (dotted_name(dec.func) or "").endswith("dataclass"):
                frozen = _kw(dec, "frozen")
                if frozen is not None and const_value(frozen) is True:
                    return True
        return False

    def _check_class(self, module, cls: ast.ClassDef, report) -> None:
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                default = stmt.value
                bad = isinstance(default, MUTABLE_LITERALS) or (
                    isinstance(default, ast.Call)
                    and (dotted_name(default.func) or "") in ("list", "dict", "set")
                )
                if bad:
                    field = dotted_name(stmt.target) or "<field>"
                    report(
                        module.path, stmt.lineno, stmt.col_offset,
                        f"frozen dataclass `{cls.name}` field `{field}` has a mutable "
                        "default — use dataclasses.field(default_factory=...) or a tuple",
                        anchor=f"{cls.name}.{field}",
                    )
        for node in ast.walk(cls):
            if (
                isinstance(node, ast.Call)
                and (dotted_name(node.func) or "") == "object.__setattr__"
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "self"
            ):
                report(
                    module.path, node.lineno, node.col_offset,
                    f"frozen dataclass `{cls.name}` mutates itself via "
                    "object.__setattr__ — frozen configs must be pure values "
                    "(derive in properties or validate without rewriting fields)",
                    anchor=cls.name,
                )
