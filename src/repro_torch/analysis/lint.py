"""The lint engine: file walking, suppression parsing, rule dispatch.

Port of ``repro/analysis/lint.py``, the engine unchanged.  The rules
themselves live in :mod:`repro_torch.analysis.rules`; this module
owns everything rule-agnostic:

* :class:`Finding` — one diagnostic, carrying a rule id, location, the
  stripped source line it fired on, and a stable :meth:`fingerprint`
  (rule + path + code text, NOT line numbers — findings survive
  unrelated edits above them).

* **Suppression** — a finding is suppressed by an inline comment on the
  SAME physical line::

      losses.append(float(loss))   # lint-ok: R3 log-gated periodic sync

  One comment can clear several rules (``# lint-ok: R3,R5 reason``).
  The rationale text after the rule ids is mandatory in spirit — the
  baseline writer records it — but not enforced syntactically.
  Suppressed findings are kept (``LintReport.suppressed``) so the
  baseline file can document every accepted deviation.

* :func:`lint_source` / :func:`lint_paths` — run every registered rule
  over a source string / a tree of ``.py`` files.

The engine is stdlib-only (``ast`` + ``re``): it must run in the CI
gate before any heavyweight dependency imports, and imports neither
torch nor anything of the package it lints.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

#: ``# lint-ok: R3`` / ``# lint-ok: R1, R5 free-form rationale``
_SUPPRESS_RE = re.compile(
    r"#\s*lint-ok:\s*(?P<rules>R\d+(?:\s*,\s*R\d+)*)\s*(?P<reason>.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # "R1".."R5"
    path: str            # as given to the linter (repo-relative in CI)
    line: int            # 1-based
    col: int             # 0-based
    message: str
    code: str            # stripped source of the flagged line
    reason: str = ""     # suppression rationale (suppressed findings only)

    def fingerprint(self) -> tuple[str, str, str]:
        """Line-number-free identity used for baseline matching: two
        findings with the same rule, file, and flagged source text are
        the same finding wherever the line moved to."""
        return (self.rule, self.path, self.code)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}\n    {self.code}")


@dataclasses.dataclass
class LintReport:
    findings: list[Finding] = dataclasses.field(default_factory=list)
    suppressed: list[Finding] = dataclasses.field(default_factory=list)
    errors: list[str] = dataclasses.field(default_factory=list)  # parse fails

    def extend(self, other: "LintReport"):
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.errors.extend(other.errors)

    def by_rule(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return counts


def parse_suppressions(source: str) -> tuple[dict[int, set[str]],
                                             dict[int, str]]:
    """Per-line rule-id suppressions: {lineno: {"R3", ...}} plus the
    free-form rationale text per line (for the baseline record)."""
    rules_at: dict[int, set[str]] = {}
    reason_at: dict[int, str] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules_at[lineno] = {r.strip() for r in m.group("rules").split(",")}
        reason_at[lineno] = m.group("reason").strip()
    return rules_at, reason_at


def lint_source(source: str, path: str = "<string>",
                rules: set[str] | None = None) -> LintReport:
    """Run the registered rules over one source string."""
    from repro_torch.analysis.rules import CHECKERS
    report = LintReport()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        report.errors.append(f"{path}: syntax error: {e}")
        return report
    lines = source.splitlines()
    suppress_at, reason_at = parse_suppressions(source)

    def line_text(lineno: int) -> str:
        if 1 <= lineno <= len(lines):
            return lines[lineno - 1].strip()
        return ""

    for rule_id, checker in sorted(CHECKERS.items()):
        if rules is not None and rule_id not in rules:
            continue
        for raw in checker(tree, source, path):
            lineno, col, message = raw
            finding = Finding(rule=rule_id, path=path, line=lineno, col=col,
                              message=message, code=line_text(lineno))
            if rule_id in suppress_at.get(lineno, ()):
                finding = dataclasses.replace(
                    finding, reason=reason_at.get(lineno, ""))
                report.suppressed.append(finding)
            else:
                report.findings.append(finding)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    report.suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return report


def iter_py_files(paths: list[str | Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(paths: list[str | Path], rules: set[str] | None = None,
               root: Path | None = None) -> LintReport:
    """Lint every ``.py`` file under ``paths``.  Finding paths are made
    relative to ``root`` (default: cwd) when possible, so fingerprints
    are stable between local runs and CI."""
    report = LintReport()
    root = Path.cwd() if root is None else Path(root)
    for f in iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root.resolve())
        except ValueError:
            rel = f
        report.extend(lint_source(f.read_text(encoding="utf-8"),
                                  path=str(rel), rules=rules))
    return report
