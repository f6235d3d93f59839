"""Analyzer core: findings, modules, suppressions, baseline, registry.

The pass is two-phase: every target file is parsed once into a `Module`,
then each registered checker runs either per-module (``scope="module"``)
or once over the whole module set (``scope="project"`` — the
interprocedural checkers: call graphs, captured CUDA-graph bodies,
registry cross-references, the kernel wrappers and their C entries).
Findings are filtered through inline/file suppression comments and the
committed baseline before they reach the CLI.

Besides Python modules the pass reads the kernels' CUDA sources (`.cu`)
as plain text (`resources`): KP01 holds every ctypes binding against the
``extern "C"`` function it binds.

Suppression syntax (a suppression names its code and says why):

    x = t.tolist()             # repro_torch: ignore[HS01]     one line, one code
    x = t.tolist()             # repro_torch: ignore           one line, all codes
    # repro_torch: ignore-file[DS01]                           whole file, one code
    # repro_torch: ignore-file                                 whole file, all codes

``# noqa`` on a line additionally suppresses the hygiene codes (UI01/DS01/
MD01/EH01) so existing flake8-style pragmas keep working.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Callable, Iterable, Optional

SEVERITIES = ("error", "warning")
RESOURCE_SUFFIXES = (".cu",)  # read as text, not parsed

_SUPPRESS_RE = re.compile(
    r"#\s*repro_torch:\s*ignore(?P<file>-file)?(?:\[(?P<codes>[A-Za-z0-9_,\s]+)\])?"
)
_NOQA_RE = re.compile(r"#\s*noqa\b")
_NOQA_CODES = ("UI01", "DS01", "MD01", "EH01")  # hygiene codes honor plain `# noqa`


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit, anchored to a file position."""

    code: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    severity: str = "error"
    anchor: str = ""  # enclosing symbol (fingerprint stability across edits)

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline file."""
        digest = hashlib.sha256(self.message.encode()).hexdigest()[:12]
        return f"{self.code}:{self.path}:{self.anchor}:{digest}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} [{self.severity}] {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: str  # repo-relative posix path
    dotted: str  # best-effort dotted module name ("repro_torch.graph.engine")
    source: str
    tree: ast.Module
    lines: list

    @classmethod
    def from_source(cls, path: str, source: str) -> "Module":
        rel = Path(path).as_posix()
        parts = list(Path(rel).with_suffix("").parts)
        if "src" in parts:
            parts = parts[parts.index("src") + 1 :]
        dotted = ".".join(p for p in parts if p != "__init__")
        return cls(
            path=rel,
            dotted=dotted or rel,
            source=source,
            tree=ast.parse(source, filename=rel),
            lines=source.splitlines(),
        )

    @property
    def name(self) -> str:
        """Last dotted component ("engine" for repro_torch/graph/engine.py)."""
        return self.dotted.rsplit(".", 1)[-1]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class Checker:
    """Base class: subclass, set the class attributes, implement one hook.

    A project checker's hook also gets `resources`, {repo-relative path:
    text} of the non-Python sources in the analysed set (`.cu`)."""

    code: str = ""
    name: str = ""
    description: str = ""
    severity: str = "error"
    scope: str = "module"  # "module" | "project"

    def check_module(self, module: Module, report: Callable) -> None:  # pragma: no cover
        raise NotImplementedError

    def check_project(self, modules: list, report: Callable,
                      resources: Optional[dict] = None) -> None:  # pragma: no cover
        raise NotImplementedError


CHECKERS: dict = {}


def register_checker(cls):
    """Class decorator: register a Checker subclass by its code."""
    if not cls.code or not cls.code.isalnum():
        raise ValueError(f"checker {cls!r} needs an alphanumeric `code`")
    if cls.code in CHECKERS:
        raise ValueError(f"checker code {cls.code!r} already registered")
    if cls.severity not in SEVERITIES:
        raise ValueError(f"checker severity must be one of {SEVERITIES}, got {cls.severity!r}")
    CHECKERS[cls.code] = cls()
    return cls


def all_checkers() -> tuple:
    """Registered checker instances, stable order. Importing the checkers
    package is what populates the registry."""
    from repro_torch.analysis import checkers  # noqa: F401  (registration side effect)

    return tuple(CHECKERS[c] for c in sorted(CHECKERS))


def _suppressed(module: Module, finding: Finding, file_directives: list) -> bool:
    for codes in file_directives:
        if codes is None or finding.code in codes:
            return True
    text = module.line_text(finding.line)
    m = _SUPPRESS_RE.search(text)
    if m and not m.group("file"):
        codes = m.group("codes")
        if codes is None or finding.code in {c.strip() for c in codes.split(",")}:
            return True
    if finding.code in _NOQA_CODES and _NOQA_RE.search(text):
        return True
    return False


def _file_directives(module: Module) -> list:
    """All `# repro_torch: ignore-file[...]` directives in the file (None = all codes)."""
    out = []
    for line in module.lines:
        m = _SUPPRESS_RE.search(line)
        if m and m.group("file"):
            codes = m.group("codes")
            out.append(None if codes is None else {c.strip() for c in codes.split(",")})
    return out


def run_checkers(modules: list, select: Optional[Iterable] = None,
                 resources: Optional[dict] = None) -> list:
    """Run every (selected) checker over parsed modules (and the
    `resources` texts); returns findings with suppression comments already
    applied, sorted by position."""
    selected = None if select is None else set(select)
    resources = dict(resources or {})
    by_path = {m.path: m for m in modules}
    findings: list = []

    def reporter(checker):
        def report(path, line, col, message, anchor=""):
            findings.append(
                Finding(
                    code=checker.code,
                    path=path,
                    line=int(line),
                    col=int(col),
                    message=message,
                    severity=checker.severity,
                    anchor=anchor,
                )
            )

        return report

    for checker in all_checkers():
        if selected is not None and checker.code not in selected:
            continue
        report = reporter(checker)
        if checker.scope == "project":
            checker.check_project(modules, report, resources)
        else:
            for module in modules:
                checker.check_module(module, report)

    directives = {m.path: _file_directives(m) for m in modules}
    kept = [
        f
        for f in findings
        if f.path not in by_path or not _suppressed(by_path[f.path], f, directives[f.path])
    ]
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    # A checker may legitimately hit the same position twice via different
    # traversal routes; report each (pos, code, message) once.
    seen, unique = set(), []
    for f in kept:
        key = (f.path, f.line, f.col, f.code, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def collect_files(paths: Iterable, root: Optional[Path] = None) -> list:
    """Expand files/directories into a sorted list of .py (and .cu) files."""
    suffixes = (".py", *RESOURCE_SUFFIXES)
    out = []
    for p in paths:
        p = Path(p)
        if not p.is_absolute() and root is not None:
            p = root / p
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*") if f.suffix in suffixes and f.is_file()))
        elif p.suffix in suffixes:
            out.append(p)
    seen, files = set(), []
    for f in out:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            files.append(f)
    return files


def _relpath(f: Path, rel_root: Optional[Path]) -> str:
    if rel_root is not None:
        try:
            return str(f.resolve().relative_to(Path(rel_root).resolve()))
        except ValueError:
            pass
    return str(f)


def load_modules(files: Iterable, rel_root: Optional[Path] = None) -> list:
    """Parse the .py files of `files` (the others are skipped)."""
    return [
        Module.from_source(_relpath(Path(f), rel_root), Path(f).read_text())
        for f in files
        if Path(f).suffix == ".py"
    ]


def load_resources(files: Iterable, rel_root: Optional[Path] = None) -> dict:
    """{relpath: text} of the non-Python files of `files`, and of the CUDA
    sources in a `csrc/` directory beside any collected module (so a run
    over one kernel wrapper still sees the C entries it binds)."""
    found = [Path(f) for f in files if Path(f).suffix in RESOURCE_SUFFIXES]
    for d in sorted({Path(f).resolve().parent for f in files if Path(f).suffix == ".py"}):
        if (d / "csrc").is_dir():
            found.extend(sorted((d / "csrc").glob("*.cu")))
    return {Path(_relpath(f, rel_root)).as_posix(): f.read_text() for f in found}


def analyze_sources(sources: dict, select: Optional[Iterable] = None) -> list:
    """Analyze in-memory sources: {relpath: code} -> findings (test seam).
    Paths ending in .cu are resources (C sources), the rest Python."""
    resources = {p: s for p, s in sources.items() if Path(p).suffix in RESOURCE_SUFFIXES}
    modules = [Module.from_source(p, s) for p, s in sources.items() if p not in resources]
    return run_checkers(modules, select, resources)


def analyze_paths(
    paths: Iterable,
    *,
    root: Optional[Path] = None,
    select: Optional[Iterable] = None,
) -> list:
    files = collect_files(paths, root=root)
    return run_checkers(load_modules(files, rel_root=root), select,
                        load_resources(files, rel_root=root))


# ------------------------------------------------------------------ baseline


def load_baseline(path) -> set:
    """Fingerprint set from a committed baseline file (empty set if absent)."""
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text() or "{}")
    return set(data.get("findings", []))


def apply_baseline(findings: list, baseline: set) -> list:
    return [f for f in findings if f.fingerprint not in baseline]


def write_baseline(findings: list, path) -> None:
    Path(path).write_text(
        json.dumps({"findings": sorted(f.fingerprint for f in findings)}, indent=2) + "\n"
    )
