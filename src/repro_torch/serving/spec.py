"""Speculative decoding over the split link: config, controller, helpers.

Port of ``repro/serving/spec.py``, on tensors.  The serving engine decodes
one token per cut-layer round trip; with a draft/verify channel it
amortizes the link instead.  Per round, a cheap CLIENT-side draft head
proposes ``k - 1`` tokens from the last verified cut-layer feature (shipped
server->client through the link's ``draft:`` channel at its own, coarser
R), and the server advances every live slot 1..k positions in one round
that verifies the drafts against the target model's greedy tokens and
commits the longest accepted prefix.  Greedy verification makes the
emitted stream equal to vanilla decode's: the draft channel's compression
loss can only lower the ACCEPTANCE RATE, never change an output token.

A round has two phases:

* **verify**: ``lm.verify_chunk`` runs the k-position chunk forward on the
  committed cache in its no-write mode and returns per-position logits;
  nothing speculative lands in the KV cache, the ring-SWA buffers, a page
  or the recurrent state.
* **commit**: the accepted prefix is re-ingested through the
  ``valid``-masked ``lm.chunk_forward`` write path, so rollback is position
  truncation: no snapshot, no page copy.

Acceptance is GROUP-LOCKSTEP under a batch-wise codec: C3-SL superposes R
consecutive slots, so one slot accepting past its group partners would
change the partners' superposition contents against vanilla decode.  The
accepted length is the min over each codec group's live rows (group size 1
without a codec).

:class:`AdaptiveK` schedules k over a power-of-two ladder from the measured
acceptance rate with an EMA deadband; k = 1 is the vanilla decode window
(speculation off), so ramping down is always safe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import matmul

DRAFT_HEADS = ("tied", "copy")

_LADDER = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine-facing speculative-decoding configuration.

    ``k``: verify-window positions per round (1 input + k-1 drafts); each
    round emits between 1 and k tokens.  ``ladder``: the k values
    :class:`AdaptiveK` may schedule (each gets its own program, made once);
    k=1 is the vanilla window.  ``draft``: codec spec of the draft feedback
    channel (overrides a link spec's ``draft:`` segment; None ships raw
    float32 feedback).  ``draft_head``: "tied" (the tied-embedding head over
    the fed-back cut feature) or "copy" (repeat the last token; needs NO
    feedback, so the draft channel ships only token ids).  ``adaptive``
    enables the acceptance-rate controller; otherwise k stays pinned.
    """
    k: int = 4
    ladder: tuple[int, ...] = _LADDER
    draft: str | None = None
    draft_head: str = "tied"
    adaptive: bool = False
    target_accept: float = 0.5
    ema: float = 0.9
    hysteresis: float = 0.1

    def __post_init__(self):
        ladder = tuple(sorted(set(int(k) for k in self.ladder)))
        object.__setattr__(self, "ladder", ladder)
        if not ladder or ladder[0] < 1:
            raise ValueError(f"ladder must be >= 1, got {self.ladder}")
        for k in ladder:
            if k & (k - 1):
                raise ValueError(
                    f"ladder entries must be powers of two (one pre-built "
                    f"program per k), got {self.ladder}")
        if self.k not in ladder:
            raise ValueError(f"k={self.k} not in ladder {ladder}")
        if self.draft_head not in DRAFT_HEADS:
            raise ValueError(f"unknown draft_head {self.draft_head!r} "
                             f"(expected one of {DRAFT_HEADS})")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")
        if self.hysteresis < 0.0:
            raise ValueError(f"hysteresis must be >= 0, got "
                             f"{self.hysteresis}")
        if not 0.0 < self.target_accept <= 1.0:
            raise ValueError(f"target_accept must be in (0, 1], got "
                             f"{self.target_accept}")

    @property
    def needs_feedback(self) -> bool:
        """Does the draft head consume the fed-back cut feature?  The "copy"
        head drafts from token ids alone: its draft channel ships no
        feedback payload at all."""
        return self.draft_head != "copy"


class AdaptiveK:
    """Acceptance-rate-driven k scheduler (EMA deadband over a ladder).

    ``observe`` folds one window's acceptance rate into an EMA and returns
    the k to use NEXT: up while acceptance clears ``target + hysteresis``,
    down below ``target - hysteresis``.  ``pin``/``unpin`` fix the schedule.
    Dropping to k = 1 IS speculation off: the engine serves the vanilla
    window for that bucket.
    """

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg
        self.ladder = cfg.ladder
        self._k = cfg.k
        self._pinned: int | None = None if cfg.adaptive else cfg.k
        self._ema_accept: float | None = None

    @property
    def current_k(self) -> int:
        return self._k

    @property
    def ema_accept(self) -> float | None:
        return self._ema_accept

    def pin(self, k: int) -> "AdaptiveK":
        if k not in self.ladder:
            raise ValueError(f"k={k} not in ladder {self.ladder}")
        self._pinned = self._k = k
        return self

    def unpin(self) -> "AdaptiveK":
        self._pinned = None
        return self

    def observe(self, accept_rate: float | None) -> int:
        """Feed one window's measured acceptance rate (accepted tokens /
        (rounds * k), in [1/k, 1]); returns the k for the NEXT window."""
        if accept_rate is not None:
            a = float(accept_rate)
            self._ema_accept = (a if self._ema_accept is None
                                else self.cfg.ema * self._ema_accept
                                + (1.0 - self.cfg.ema) * a)
        if self._pinned is not None or self._ema_accept is None:
            return self._k
        i = self.ladder.index(self._k)
        if (self._ema_accept > self.cfg.target_accept + self.cfg.hysteresis
                and i + 1 < len(self.ladder)):
            self._k = self.ladder[i + 1]
        elif (self._ema_accept < self.cfg.target_accept - self.cfg.hysteresis
                and i > 0):
            self._k = self.ladder[i - 1]
        return self._k


def token_wire_bytes(vocab_size: int) -> int:
    """Bytes one draft token id costs on the wire: the smallest unsigned
    integer dtype covering the vocabulary."""
    if vocab_size <= 1 << 8:
        return 1
    if vocab_size <= 1 << 16:
        return 2
    return 4


def propose_drafts(params, draft_feat, last_tok, k: int, mode: str):
    """Draft proposal on the device: (B, k-1) int32 token ids.

    ``mode="tied"`` reuses the TARGET model's embedding and head as the
    draft model: the first draft reads the fed-back cut-layer feature plus
    the last verified token's embedding through the output head, later
    drafts chain through embedding->head alone.  ``mode="copy"`` repeats the
    last verified token.  Drafts are argmax, so client and server agree on
    the proposal without extra wire traffic."""
    if k <= 1:
        return torch.zeros((last_tok.shape[0], 0), dtype=torch.int32,
                           device=last_tok.device)
    if mode == "copy":
        return last_tok[:, None].expand(-1, k - 1).to(torch.int32)
    if mode != "tied":
        raise ValueError(f"unknown draft head {mode!r} "
                         f"(expected one of {DRAFT_HEADS})")
    emb, head = params["embed"], params["head"]
    x = draft_feat + emb[last_tok.long()]
    d = torch.argmax(matmul(x, head), dim=-1).to(torch.int32)
    drafts = [d]
    for _ in range(k - 2):
        d = torch.argmax(matmul(emb[d.long()], head), dim=-1).to(torch.int32)
        drafts.append(d)
    return torch.stack(drafts, dim=1)


def accept_lengths(fed, targets, live, *, group: int, eos_id, rem_new,
                   rem_pos):
    """Accepted-prefix lengths, group-lockstep: (B,) int32.

    ``fed`` (B, k): the tokens the verify chunk consumed (last verified
    token followed by the k-1 drafts); ``targets`` (B, k): the target
    model's greedy tokens for those positions.  ``targets[:, j]`` is a valid
    greedy continuation only while every earlier draft matched its target,
    so the raw accepted length is (longest matching prefix) + 1, with three
    caps: the first EOS among the targets, the row's remaining budget
    (``rem_new``/``rem_pos``), and the min over the row's codec group (size
    ``group``; dead rows never cap their group).  Live rows accept at least
    1 token."""
    B, k = targets.shape
    matched = fed[:, 1:] == targets[:, :-1]               # draft j == target j
    raw = torch.cumprod(matched.to(torch.int32), dim=1).sum(dim=1) + 1
    limit = raw
    if eos_id is not None:
        is_eos = (targets == eos_id).to(torch.int32)
        first = torch.argmax(is_eos, dim=1) + 1           # first EOS, 1-based
        limit = torch.minimum(limit, torch.where(is_eos.any(dim=1), first, k))
    limit = torch.minimum(limit, torch.clamp(rem_new, min=1))
    limit = torch.minimum(limit, torch.clamp(rem_pos, min=1))
    limit = torch.where(live, limit, k)                   # dead rows never cap
    if group > 1:
        limit = limit.reshape(B // group, group).amin(dim=1)
        limit = limit.repeat_interleave(group)
    return limit.to(torch.int32)
