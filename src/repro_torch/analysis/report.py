"""Findings, suppressions, and report rendering for `repro_torch.analysis`.

A :class:`Finding` is one diagnostic: file, 1-based line/col, a rule id
(``unit-mismatch``, ``contract-bad-spec``, ``state-unlocked-write``, ...),
the family it belongs to (``unit`` / ``contract`` / ``state``), and a
human message.  Suppressions are source comments of the form

    x = flops + secs  # unit: ignore[explained why this is fine]

matched by family on the finding's line.  An *empty* reason is itself a
finding (``bad-suppression``): the whole point of the mechanism is that
every silenced diagnostic carries its justification in the diff.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Iterable, List, Tuple

__all__ = ["Finding", "collect_suppressions", "apply_suppressions",
           "render_text", "render_json", "SCHEMA"]

SCHEMA = "repro_torch.analysis/v1"

_SUPPRESS_RE = re.compile(
    r"#\s*(?P<family>unit|contract|state)\s*:\s*ignore\[(?P<reason>[^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    family: str
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.family}/{self.rule}: {self.message}")

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def collect_suppressions(path: str, source: str) -> Tuple[
        Dict[Tuple[int, str], str], List[Finding]]:
    """Scan source for suppression comments.

    Returns ``({(line, family): reason}, bad)`` where ``bad`` holds a
    ``bad-suppression`` finding for each empty-reason comment.  Works on
    raw source lines, so suppressions inside strings are (rare, harmless)
    false matches — acceptable for a lint of our own tree.
    """
    table: Dict[Tuple[int, str], str] = {}
    bad: List[Finding] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        for m in _SUPPRESS_RE.finditer(text):
            family = m.group("family")
            reason = m.group("reason").strip()
            if not reason:
                bad.append(Finding(
                    path, lineno, m.start() + 1, "bad-suppression", family,
                    f"# {family}: ignore[] needs a reason — say why the "
                    f"finding is safe to silence"))
            else:
                table[(lineno, family)] = reason
    return table, bad


def apply_suppressions(
        findings: Iterable[Finding],
        table: Dict[Tuple[int, str], str],
) -> Tuple[List[Finding], List[Dict[str, object]]]:
    """Split findings into (kept, suppressed-with-reason)."""
    kept: List[Finding] = []
    suppressed: List[Dict[str, object]] = []
    for f in findings:
        reason = table.get((f.line, f.family))
        if reason is None:
            kept.append(f)
        else:
            d = f.to_dict()
            d["suppressed_reason"] = reason
            suppressed.append(d)
    return kept, suppressed


def render_text(findings: List[Finding], suppressed: List[Dict[str, object]],
                n_files: int) -> str:
    lines = [f.format() for f in findings]
    lines.append(
        f"repro_torch.analysis: {len(findings)} finding(s), "
        f"{len(suppressed)} suppressed, {n_files} file(s) checked")
    return "\n".join(lines)


def render_json(findings: List[Finding], suppressed: List[Dict[str, object]],
                n_files: int) -> str:
    return json.dumps({
        "schema": SCHEMA,
        "n_files": n_files,
        "n_findings": len(findings),
        "findings": [f.to_dict() for f in findings],
        "suppressed": suppressed,
    }, indent=2, sort_keys=True)
