"""Runner of the three analysis passes: file discovery, suppressions, CLI.

Kept import-light (stdlib only until a pass needs more) so the gate runs
in any CI environment that has Python, independent of numpy/jax installs.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from . import contracts, lint, report, state_lint
from .report import Finding

__all__ = ["check_paths", "check_file", "main"]

#: file basenames never linted (vendored/generated would go here)
_SKIP_NAMES = {"__main__.py"}


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(".py") and f not in _SKIP_NAMES:
                        out.append(os.path.join(root, f))
    return out


def check_file(path: str) -> Tuple[List[Finding], List[Dict[str, object]]]:
    """All three passes on one file; returns (findings, suppressed)."""
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, (e.offset or 0), "syntax",
                        "unit", f"file does not parse: {e.msg}")], []
    findings: List[Finding] = []
    findings.extend(lint.lint_units(path, tree))
    findings.extend(contracts.lint_contracts(path, tree))
    findings.extend(state_lint.lint_state(path, tree))
    table, bad = report.collect_suppressions(path, source)
    kept, suppressed = report.apply_suppressions(findings, table)
    return kept + bad, suppressed


def check_paths(paths: Sequence[str]) -> Tuple[
        List[Finding], List[Dict[str, object]], int]:
    """Run on files/directories; returns (findings, suppressed, n_files)."""
    files = _iter_py_files(paths)
    findings: List[Finding] = []
    suppressed: List[Dict[str, object]] = []
    for path in files:
        f, s = check_file(path)
        findings.extend(f)
        suppressed.extend(s)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed, len(files)


def _default_target() -> str:
    """src/repro_torch relative to this package (the tree the gate
    protects)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="units / shape-contract / global-state lint for repro_torch")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the repro_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable findings report")
    args = ap.parse_args(argv)
    paths = list(args.paths) or [_default_target()]
    findings, suppressed, n_files = check_paths(paths)
    if args.json:
        print(report.render_json(findings, suppressed, n_files))
    else:
        print(report.render_text(findings, suppressed, n_files))
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
