"""CLI for the port's lint tier (port of ``repro/analysis/__main__.py``:
the same flags, lines and exit codes).

Usage::

    python -m repro_torch.analysis --check src/repro_torch           # gate vs baseline
    python -m repro_torch.analysis src/repro_torch tests/            # plain report
    python -m repro_torch.analysis --write-baseline src/repro_torch  # regenerate baseline
    python -m repro_torch.analysis --rules R3,R5 src/repro_torch     # subset of rules

``--check`` exits nonzero on (a) any finding not covered by the
committed baseline, or (b) a syntax error in a linted file.  Baselined-
but-fixed findings are reported as a nudge to regenerate the baseline
but do not fail the gate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (BASELINE_NAME,
                                           diff_against_baseline,
                                           load_baseline, write_baseline)
from repro_torch.analysis.lint import lint_paths


def _find_root(start: Path) -> Path:
    """Nearest ancestor holding the baseline or a .git dir, else cwd —
    finding paths are made root-relative so fingerprints match CI."""
    cur = start.resolve()
    for cand in [cur, *cur.parents]:
        if (cand / BASELINE_NAME).exists() or (cand / ".git").exists():
            return cand
    return start


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static analysis (rules R1-R5).")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    parser.add_argument("--check", action="store_true",
                        help="fail on findings not in the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from this run")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline path (default: <root>/{BASELINE_NAME})")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset, e.g. R3,R5")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    args = parser.parse_args(argv)

    root = _find_root(Path(args.paths[0]))
    baseline_path = Path(args.baseline) if args.baseline \
        else root / BASELINE_NAME
    rules = ({r.strip() for r in args.rules.split(",")}
             if args.rules else None)

    report = lint_paths(args.paths, rules=rules, root=root)

    for err in report.errors:
        print(f"ERROR {err}", file=sys.stderr)

    if args.write_baseline:
        write_baseline(report, baseline_path)
        print(f"wrote {baseline_path} ({len(report.findings)} findings, "
              f"{len(report.suppressed)} suppressions recorded)")
        return 1 if report.errors else 0

    if args.check:
        new, fixed = diff_against_baseline(report,
                                           load_baseline(baseline_path))
        for f in new:
            print(f)
        if fixed:
            print(f"note: {sum(fixed.values())} baselined finding(s) no "
                  f"longer present — regenerate the baseline to lock in "
                  f"the fix (--write-baseline)")
        counts = ", ".join(f"{k}={v}" for k, v in
                           sorted(report.by_rule().items())) or "none"
        print(f"{len(new)} new finding(s) vs baseline "
              f"[{counts} total; {len(report.suppressed)} suppressed]")
        return 1 if (new or report.errors) else 0

    for f in report.findings:
        print(f)
    if args.show_suppressed:
        for f in report.suppressed:
            print(f"SUPPRESSED ({f.reason or 'no rationale'}): {f}")
    print(f"{len(report.findings)} finding(s), "
          f"{len(report.suppressed)} suppressed")
    return 1 if (report.findings or report.errors) else 0


if __name__ == "__main__":
    raise SystemExit(main())
