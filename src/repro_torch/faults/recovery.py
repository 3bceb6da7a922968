"""Erasure-vs-retransmit recovery policy for payload-level faults.

Port of ``repro/faults/recovery.py`` (numpy only).

The superposition structure C3-SL compresses with is also a
graceful-degradation primitive: quasi-orthogonal bindings mean losing a
span of a superposed payload degrades retrieval SNR smoothly, and the
mask-aware decode (``decode_masked``) renormalizes over the surviving
elements so the reconstruction stays unbiased.  That gives two ways to
handle a lossy step, chosen per :class:`RecoveryPolicy`:

* ``mode="erasure"`` — accept the loss up to ``max_erasure_frac`` and
  decode through the mask; the erasure-degraded SNR flows into the
  adaptive deadband controller, so sustained loss shows up as an R
  step-down, not a crash.  Beyond the threshold, NACK/retransmit the
  missing packets (each retransmission redrawn under the plan's
  attempt-keyed rng) until within budget.

* ``mode="retransmit"`` — a lossless link: every missing packet is
  retransmitted until the payload is complete (classic NACK loop), and
  the extra wire traffic is accounted in ``wire_mult``.

Either way, a bounded ``retry_budget``: when retransmission cannot get
the loss under the acceptable threshold, :class:`ChannelErasure` is
raised — the typed "this step's payload is gone" signal callers handle
(skip the step, drop the connection) instead of training on garbage.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.faults.plan import ChannelErasure, FaultPlan


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How a channel responds to payload loss.

    ``max_erasure_frac``: largest fraction of packets the erasure-tolerant
    decode accepts without retransmitting (mode="erasure" only; the
    retransmit mode accepts zero).  ``retry_budget``: max NACK rounds per
    payload before the step surfaces as :class:`ChannelErasure`.
    """
    mode: str = "erasure"            # "erasure" | "retransmit"
    max_erasure_frac: float = 0.5
    retry_budget: int = 4

    def __post_init__(self):
        if self.mode not in ("erasure", "retransmit"):
            raise ValueError(f"unknown recovery mode {self.mode!r} "
                             "(expected erasure | retransmit)")
        if not 0.0 <= self.max_erasure_frac <= 1.0:
            raise ValueError(f"max_erasure_frac={self.max_erasure_frac} "
                             "outside [0, 1]")
        if self.retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, "
                             f"got {self.retry_budget}")


def negotiate_payload(plan: FaultPlan, direction: str, step: int,
                      shape: tuple[int, ...],
                      policy: RecoveryPolicy | None = None):
    """Resolve one payload's faults under a recovery policy.

    Simulates the NACK loop a real receiver runs: the first transmission
    loses packets per ``plan``; while the loss exceeds what the policy
    accepts, the missing packets are retransmitted (attempt-keyed redraw,
    so a retransmitted packet can be lost again) and the loss masks
    intersect.  Returns ``(keep, info)``:

    * ``keep`` — float32 element keep-mask of ``shape`` (all-ones when
      nothing was ultimately lost),
    * ``info`` — ``{"attempts", "erased_frac", "erased_packets",
      "wire_mult"}``; ``wire_mult`` is total-transmitted / payload-size
      (1.0 = no retransmissions), the chaos bench's goodput denominator.

    Raises :class:`ChannelErasure` when the retry budget is exhausted and
    the residual loss still exceeds the policy's acceptance threshold.
    """
    policy = policy or RecoveryPolicy()
    allowed = 0.0 if policy.mode == "retransmit" else policy.max_erasure_frac
    lost = plan.packet_faults(direction, step, shape, attempt=0)
    attempts = 1
    resent_frac = 0.0
    while lost.any() and float(lost.mean()) > allowed \
            and attempts <= policy.retry_budget:
        # NACK round: only the missing packets are resent; the
        # retransmission sees fresh attempt-keyed faults on those packets
        resent_frac += float(lost.mean())
        fresh = plan.packet_faults(direction, step, shape, attempt=attempts)
        lost = lost & fresh
        attempts += 1
    erased = float(lost.mean())
    if lost.any() and erased > allowed:
        raise ChannelErasure(
            f"{direction} payload at step {step}: {erased:.0%} of packets "
            f"still missing after {attempts - 1} retransmission rounds "
            f"(policy {policy.mode}, accepts {allowed:.0%})",
            direction=direction, step=step, erased_frac=erased,
            attempts=attempts)
    keep = plan.expand_packets(shape, ~lost)
    info = {"attempts": attempts,
            "erased_frac": erased,
            "erased_packets": int(lost.sum()),
            "wire_mult": 1.0 + resent_frac}
    return keep, info


def erasure_mask_like(shape: tuple[int, ...]) -> np.ndarray:
    """An all-ones keep mask (the no-loss mask) for ``shape`` — what a
    fault-free step feeds a masked program so every step shares one
    compiled branch."""
    return np.ones(shape, dtype=np.float32)
