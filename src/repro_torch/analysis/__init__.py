"""Runtime sanitizers, the ``--sanitize`` tier (:mod:`.sanitize`).

Port of the runtime half of ``repro/analysis``: per-tick engine invariant
checks (pool accounting, slot hygiene, live-slot zeroing of the cut
before the batch-wise codec), per-step finite checks for the train loops
with autograd's anomaly mode and a finite-output step wrapper in place of
the reference's ``jax_debug_nans`` and checkify, and an event-loop stall
detector for the front door.  The static half (the lint rules and their
baseline) is not ported yet.
"""
from repro_torch.analysis.sanitize import (EngineSanitizer, SanitizerError,
                                           SlowCallbackDetector, TrainSanitizer,
                                           finite_outputs)

__all__ = ["SanitizerError", "EngineSanitizer", "TrainSanitizer",
           "SlowCallbackDetector", "finite_outputs"]
