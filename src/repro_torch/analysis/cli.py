"""`python -m repro_torch.analysis` — the CI lint gate.

Default target is the `repro_torch` package source (so the no-arg gate
analyzes `src/repro_torch` wherever the checkout lives); pass files or
directories to narrow the run (a kernel wrapper's `csrc/` sources are read
with it). Exit status is 0 unless
`--fail-on-findings` is set and error-severity findings survive
suppressions and the baseline.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.core import (
    all_checkers,
    analyze_paths,
    apply_baseline,
    load_baseline,
    write_baseline,
)

DEFAULT_BASELINE = "analysis_baseline_torch.json"


def _default_target() -> Path:
    return Path(__file__).resolve().parent.parent  # src/repro_torch


def _repo_root() -> Path:
    return _default_target().parent.parent  # src/repro_torch -> repo checkout


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis over the repro_torch package (host syncs in "
        "captured CUDA graphs, kernel wrappers and C bindings, registry consistency, "
        "hygiene).",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the repro_torch package source)",
    )
    parser.add_argument(
        "--fail-on-findings", action="store_true",
        help="exit 1 if any finding (error or warning) survives suppressions/baseline",
    )
    parser.add_argument(
        "--json", metavar="FILE", default=None,
        help="write the full findings report as JSON (use '-' for stdout)",
    )
    parser.add_argument(
        "--baseline", metavar="FILE", default=None,
        help=f"baseline file of accepted fingerprints (default: {DEFAULT_BASELINE} "
        "at the repo root, when present)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--select", metavar="CODES", default=None,
        help="comma-separated checker codes to run (e.g. HS01,XD01)",
    )
    parser.add_argument(
        "--list-checkers", action="store_true",
        help="print the registered checkers and exit",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_checkers:
        for c in all_checkers():
            print(f"{c.code}  {c.severity:7s}  {c.name}: {c.description}")
        return 0

    root = _repo_root()
    targets = args.paths or [_default_target()]
    select = None if args.select is None else [c.strip() for c in args.select.split(",")]
    findings = analyze_paths(targets, root=root, select=select)

    baseline_path = Path(args.baseline) if args.baseline else root / DEFAULT_BASELINE
    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"wrote {len(findings)} fingerprint(s) to {baseline_path}")
        return 0
    baselined = len(findings)
    findings = apply_baseline(findings, load_baseline(baseline_path))
    baselined -= len(findings)

    if args.json:
        payload = json.dumps(
            {
                "checkers": {c.code: c.description for c in all_checkers()},
                "findings": [f.to_dict() for f in findings],
                "baselined": baselined,
            },
            indent=2,
        )
        if args.json == "-":
            print(payload)
        else:
            Path(args.json).write_text(payload + "\n")

    for f in findings:
        print(f.render())
    errors = sum(1 for f in findings if f.severity == "error")
    warnings = len(findings) - errors
    tail = f" ({baselined} baselined)" if baselined else ""
    print(f"repro_torch.analysis: {errors} error(s), {warnings} warning(s){tail}")

    if args.fail_on_findings and findings:
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
