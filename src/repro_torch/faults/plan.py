"""Deterministic fault injection for the split link.

Port of ``repro/faults/plan.py`` (numpy only, kept as its own copy: the
port imports nothing of ``repro``).  Every mask and event equals the
reference's for the same plan.

A :class:`FaultPlan` is a SEEDED description of what the network does to
the cut-layer exchange: per-direction rates (drop / corrupt / delay /
duplicate / truncate / disconnect) plus an optional explicit schedule of
step -> events.  Every draw is keyed by ``(seed, direction, step,
attempt, salt)`` through a crc32 hash, so the same plan replays the same
failures bit-for-bit — a chaos run is an experiment, not a flake.

The plan installs at two layers:

* **payload level** (``repro_torch.transport.Channel``): each training step's
  payload is split into ``packets`` contiguous spans of the feature axis;
  each packet is independently dropped or corrupted.  A per-packet CRC on
  a real wire detects corruption, so both faults surface identically as
  ERASURES — a keep-mask over the payload that the mask-aware HRR decode
  (``decode_masked``) renormalizes over, never as garbage activations.

* **wire level** (``repro_torch.frontdoor.stream.FrameStream``, as the
  reference's ``repro.frontdoor.stream.FrameStream``): faults apply
  to individual frames as they are written — dropped from the wire,
  byte-flipped (caught by the frame CRC32), truncated (length prefix
  fixed up so the stream stays in sync but the CRC fails), duplicated,
  delayed, or a forced ``disconnect`` (transport abort, exercising the
  reconnect-with-resume path).  ``attempt`` is the connection epoch:
  explicit scheduled events fire on epoch 0 only, so a scheduled
  disconnect does not re-trigger after the resume it was meant to test.

An all-zero plan (``FaultPlan()`` or rates all 0 with no schedule) is
structurally inert: every install site checks :meth:`is_zero` and takes
the exact pre-fault code path, so zero-plan runs are bit-identical to no
plan at all (pinned in tests/test_faults.py and tests/test_torch_faults.py).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

#: fault kinds a plan can draw.  ``disconnect`` is wire-only (a payload
#: has no connection to sever); the rest apply at both layers.
FAULT_KINDS = ("drop", "corrupt", "delay", "duplicate", "truncate",
               "disconnect")
_PAYLOAD_KINDS = ("drop", "corrupt")


class ChannelErasure(Exception):
    """A payload (or frame) was lost or corrupted beyond what the
    configured recovery policy can repair.  Typed so callers branch on
    "the channel ate it" instead of decoding garbage activations."""

    def __init__(self, msg: str, *, direction: str | None = None,
                 step: int | None = None, erased_frac: float | None = None,
                 attempts: int | None = None):
        super().__init__(msg)
        self.direction = direction
        self.step = step
        self.erased_frac = erased_frac
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault: a kind plus a uniform-[0,1) argument the
    injector interprets (corrupt: which byte to flip; truncate: fraction
    of the body to keep; delay: scaled sleep)."""
    kind: str
    arg: float = 0.0


def _normalize_rates(rates) -> dict:
    """Accept flat ``{kind: rate}`` (all directions) or nested
    ``{direction: {kind: rate}}``; return the nested form with the flat
    part under the wildcard direction ``"*"``."""
    if not rates:
        return {}
    flat = {k: float(v) for k, v in rates.items()
            if not isinstance(v, dict)}
    nested = {d: {k: float(v) for k, v in r.items()}
              for d, r in rates.items() if isinstance(r, dict)}
    for scope in (flat, *nested.values()):
        for kind, rate in scope.items():
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate {kind}={rate} outside [0, 1]")
    if flat:
        nested["*"] = flat
    return nested


def _normalize_schedule(schedule) -> dict:
    """``{direction: {step: kind | (kind, ...) | FaultEvent(s)}}`` (or the
    flat ``{step: ...}`` form for all directions) -> nested dict of
    FaultEvent tuples."""
    if not schedule:
        return {}
    if all(isinstance(k, int) for k in schedule):
        schedule = {"*": schedule}
    out = {}
    for direction, steps in schedule.items():
        out[direction] = {}
        for step, events in steps.items():
            if isinstance(events, (str, FaultEvent)):
                events = (events,)
            norm = []
            for ev in events:
                if isinstance(ev, str):
                    ev = FaultEvent(ev)
                if ev.kind not in FAULT_KINDS:
                    raise ValueError(f"unknown fault kind {ev.kind!r} in "
                                     f"schedule (expected {FAULT_KINDS})")
                norm.append(ev)
            out[direction][int(step)] = tuple(norm)
    return out


class FaultPlan:
    """Seeded, replayable fault schedule for one link.

    ``rates``: flat ``{kind: rate}`` applied to every direction, or
    ``{direction: {kind: rate}}`` (directions are free-form tags —
    ``"fwd"``/``"bwd"`` at the payload layer, ``"c2s"``/``"s2c"`` on the
    wire; the wildcard ``"*"`` applies everywhere).

    ``schedule``: explicit ``{direction: {step: events}}`` fired exactly
    once, at connection epoch 0 (``attempt=0``) — the deterministic
    "fault X at step N" hook chaos tests are built from.

    ``packets``: payload packetization granularity — the feature axis is
    split into this many contiguous spans, each an independent erasure
    unit (a real wire frames payloads in MTU-sized packets; losing one
    loses a span of features, not IID elements).
    """

    def __init__(self, seed: int = 0, rates=None, schedule=None,
                 packets: int = 16):
        if packets < 1:
            raise ValueError(f"packets must be >= 1, got {packets}")
        self.seed = int(seed)
        self.packets = int(packets)
        self.rates = _normalize_rates(rates)
        self.schedule = _normalize_schedule(schedule)

    # ---- determinism core ------------------------------------------------

    def _rng(self, direction: str, step: int, attempt: int,
             salt: int) -> np.random.RandomState:
        key = f"{self.seed}|{direction}|{step}|{attempt}|{salt}"
        return np.random.RandomState(
            zlib.crc32(key.encode("utf-8")) & 0x7FFFFFFF)

    def rates_for(self, direction: str) -> dict:
        merged = dict(self.rates.get("*", {}))
        merged.update(self.rates.get(direction, {}))
        return merged

    def scheduled(self, direction: str, step: int) -> tuple:
        events = ()
        for scope in ("*", direction):
            events += self.schedule.get(scope, {}).get(int(step), ())
        return events

    def is_zero(self) -> bool:
        """True when this plan can never inject anything — install sites
        use this to take the structurally identical no-fault code path."""
        if any(self.schedule.get(d) for d in self.schedule):
            return False
        return all(r == 0.0 for scope in self.rates.values()
                   for r in scope.values())

    # ---- wire layer ------------------------------------------------------

    def frame_events(self, direction: str, seq: int,
                     epoch: int = 0) -> tuple[FaultEvent, ...]:
        """The faults hitting frame ``seq`` of ``direction`` on connection
        ``epoch``.  Scheduled events fire on epoch 0 only; rate-drawn
        events key the rng on the epoch, so a retried connection sees a
        fresh (but still deterministic) fault pattern."""
        events = list(self.scheduled(direction, seq)) if epoch == 0 else []
        rates = self.rates_for(direction)
        if rates:
            rng = self._rng(direction, seq, epoch, salt=1)
            # one draw per kind in canonical order, fire-if-below: draws
            # stay aligned when a single rate changes between configs
            for kind in FAULT_KINDS:
                u = rng.random_sample()
                if rates.get(kind, 0.0) > 0.0 and u < rates[kind]:
                    events.append(FaultEvent(kind, rng.random_sample()))
        return tuple(events)

    # ---- payload layer ---------------------------------------------------

    def packet_edges(self, D: int) -> np.ndarray:
        """Packet boundary sizes along a D-wide feature axis."""
        p = min(self.packets, D)
        base = D // p
        sizes = np.full(p, base, dtype=np.int64)
        sizes[:D - base * p] += 1
        return sizes

    def packet_faults(self, direction: str, step: int,
                      shape: tuple[int, ...],
                      attempt: int = 0) -> np.ndarray:
        """Bool (rows, packets) array, True where a packet of this step's
        payload is LOST (dropped, or corrupted and caught by its CRC —
        both are erasures by the time they reach the decoder).

        ``attempt`` indexes retransmissions: attempt k redraws only from
        the rng keyed on k, so a NACK/retransmit loop converges
        deterministically (the recovery layer intersects the loss masks).
        """
        rates = self.rates_for(direction)
        drop = rates.get("drop", 0.0)
        corrupt = rates.get("corrupt", 0.0)
        if attempt == 0:
            for ev in self.scheduled(direction, step):
                if ev.kind == "drop":
                    drop = max(drop, ev.arg or 1.0)
                elif ev.kind == "corrupt":
                    corrupt = max(corrupt, ev.arg or 1.0)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
        p = min(self.packets, int(shape[-1]))
        if drop == 0.0 and corrupt == 0.0:
            return np.zeros((rows, p), dtype=bool)
        rng = self._rng(direction, step, attempt, salt=2)
        u_drop = rng.random_sample((rows, p))
        u_corr = rng.random_sample((rows, p))
        return (u_drop < drop) | (u_corr < corrupt)

    def expand_packets(self, shape: tuple[int, ...],
                       keep_packets: np.ndarray) -> np.ndarray:
        """Packet keep-mask (rows, packets) -> element keep-mask of
        ``shape`` (float32, 1.0 kept / 0.0 erased)."""
        D = int(shape[-1])
        sizes = self.packet_edges(D)
        keep = np.repeat(keep_packets.astype(np.float32), sizes, axis=-1)
        return keep.reshape(shape)

    def payload_keep(self, direction: str, step: int,
                     shape: tuple[int, ...],
                     attempt: int = 0) -> np.ndarray:
        """Convenience: the element-level keep mask for one payload with
        no recovery (first transmission only)."""
        lost = self.packet_faults(direction, step, shape, attempt)
        return self.expand_packets(shape, ~lost)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, rates={self.rates}, "
                f"schedule_steps="
                f"{ {d: sorted(s) for d, s in self.schedule.items()} }, "
                f"packets={self.packets})")
