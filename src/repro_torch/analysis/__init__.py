"""The port's static analysis and runtime sanitizers.

Port of ``repro/analysis``, both halves:

* **Static** (:mod:`.lint`, :mod:`.rules`, :mod:`.baseline`): the
  reference's AST lint engine with rules R1-R5 read for PyTorch (R1
  recompile and rebuild hazards, R2 stale aliases across an in-place
  write, R3 hidden host syncs, R4 codec accounting completeness, R5
  asyncio race/hygiene), inline ``# lint-ok: R<n> rationale``
  suppression, and a committed-baseline gate of its own,
  ``analysis-baseline-torch.json``.  Stdlib-only: it imports neither
  torch nor anything of the package it lints.  CLI:
  ``python -m repro_torch.analysis --check src/repro_torch``.

* **Runtime** (:mod:`.sanitize`, the ``--sanitize`` tier): per-tick
  engine invariant checks (pool accounting, slot hygiene, live-slot
  zeroing of the cut before the batch-wise codec), per-step finite checks
  for the train loops with autograd's anomaly mode and a finite-output
  step wrapper in place of the reference's ``jax_debug_nans`` and
  checkify, and an event-loop stall detector for the front door.  Its
  names load on first use (a module ``__getattr__``), so the lint CLI
  runs on a host without torch.

See ``src/repro_torch/README.md`` for the rule catalog and the baseline
workflow.
"""
from repro_torch.analysis.baseline import (BASELINE_NAME, diff_against_baseline,
                                           load_baseline, write_baseline)
from repro_torch.analysis.lint import (Finding, LintReport, lint_paths,
                                       lint_source)

_SANITIZE = ("SanitizerError", "EngineSanitizer", "TrainSanitizer",
             "SlowCallbackDetector", "finite_outputs")

__all__ = ["Finding", "LintReport", "lint_source", "lint_paths",
           "BASELINE_NAME", "load_baseline", "write_baseline",
           "diff_against_baseline", *_SANITIZE]


def __getattr__(name):
    if name in _SANITIZE:
        from repro_torch.analysis import sanitize
        return getattr(sanitize, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
