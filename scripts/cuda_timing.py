"""What the timing scripts in this directory share: the device timer and the
card line of ``chip_smoke.py`` (imported from the repo root, so a script
times as the smoke run does), and ``enqueue_ms``, the host's clock around
back-to-back calls.

``cuda_ms(fn)`` is the device's time of one call (CUDA events around 10
calls queued behind a sleep kernel; median of 21 runs);
``cuda_ms(fn, hide_host=False)`` the time a caller sees, host included (the
same events with nothing queued before the calls).
"""
from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, cuda_ms  # noqa: E402,F401


def enqueue_ms(fn, calls=200, reps=21) -> float:
    """The host's clock around ``calls`` back-to-back calls, before the
    device is synchronised, per call; median of ``reps`` runs.  Where the
    device keeps up, this is the caller's own cost (checks, allocation, the
    ``ctypes`` call, the launches)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)
