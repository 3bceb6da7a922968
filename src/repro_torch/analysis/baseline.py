"""Committed-baseline workflow for the port's lint gate.

Port of ``repro/analysis/baseline.py``, the same format in a file of its
own: ``analysis-baseline-torch.json`` at the repo root (the reference's
``analysis-baseline.json`` is the JAX package's and is never written
here).  The baseline file is the contract between the linter and CI: the gate fails on findings that are
NOT in the baseline, so new code is held to the rules while any
grandfathered findings stay visible (and shrink over time) instead of
blocking unrelated work.  The shipped baseline has an EMPTY ``findings``
list — ``src/repro_torch/`` lints clean — and a populated ``suppressed`` section
documenting every inline ``# lint-ok`` rationale for the record.

Matching is by :meth:`Finding.fingerprint` — ``(rule, path, stripped
source line)`` — counted with multiplicity, so a finding survives edits
that only move its line, but duplicating a flagged construct is a new
finding.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from repro_torch.analysis.lint import Finding, LintReport

BASELINE_NAME = "analysis-baseline-torch.json"


def _entry(f: Finding) -> dict:
    d = {"rule": f.rule, "path": f.path, "line": f.line,
         "code": f.code, "message": f.message}
    if f.reason:
        d["reason"] = f.reason
    return d


def write_baseline(report: LintReport, path: str | Path) -> None:
    payload = {
        "comment": (
            "Lint baseline for `python -m repro_torch.analysis --check`. "
            "`findings` are grandfathered violations the gate tolerates "
            "(kept empty on purpose: src/repro_torch/ lints clean); "
            "`suppressed` is an informational record of every inline "
            "`# lint-ok` suppression the port's rules honour, and its "
            "rationale. Regenerate with "
            "`python -m repro_torch.analysis --write-baseline src/repro_torch`."),
        "findings": [_entry(f) for f in report.findings],
        "suppressed": [_entry(f) for f in report.suppressed],
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n",
                          encoding="utf-8")


def load_baseline(path: str | Path) -> Counter:
    """Fingerprint multiset of the baselined (tolerated) findings."""
    p = Path(path)
    if not p.exists():
        return Counter()
    data = json.loads(p.read_text(encoding="utf-8"))
    return Counter((e["rule"], e["path"], e["code"])
                   for e in data.get("findings", ()))


def diff_against_baseline(report: LintReport,
                          baseline: Counter) -> tuple[list[Finding],
                                                      Counter]:
    """Split the current findings into (new, fixed).

    ``new``   — findings whose fingerprint exceeds the baselined count
                (these fail the gate);
    ``fixed`` — baselined fingerprints no longer present (informational;
                the baseline should be regenerated to shrink).
    """
    remaining = Counter(baseline)
    new: list[Finding] = []
    for f in report.findings:
        fp = f.fingerprint()
        if remaining[fp] > 0:
            remaining[fp] -= 1
        else:
            new.append(f)
    fixed = Counter({fp: n for fp, n in remaining.items() if n > 0})
    return new, fixed
