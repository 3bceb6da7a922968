"""Composable codec pipelines: a transform codec + wire-format stages.

Port of ``repro/codecs/compose.py``.
"""
from __future__ import annotations

import dataclasses
import math


def payload_wire_bytes(codec, shape: tuple[int, ...]) -> int:
    """Wire bytes for an ALREADY-SHAPED payload.

    ``codec.wire_bytes(B)`` covers the decode path's (B, D) features; the
    chunked-prefill path ships the 3-D sequence-grouped payload
    (C, B/R, D) from ``sequence_group_encode``, whose per-row scale/mask
    counts depend on the true leading shape — this entry point feeds that
    shape straight to the codec's last wire stage (stages are rank-generic:
    a "row" is everything but the trailing axis).  Bare transforms ship f32.
    """
    stages = getattr(codec, "stages", ())
    if stages:
        return stages[-1].wire_bytes(tuple(shape))
    return math.prod(shape) * 4


@dataclasses.dataclass(frozen=True)
class Chain:
    """Pipeline a transform codec with one or more wire stages.

    encode: transform.encode, then each wire stage's straight-through
    ``apply`` (fake-quant style round-trip, so the payload keeps the
    transform's shape/dtype in-graph).  decode: the transform's decode.

    Accounting composes: params/FLOPs add across stages; wire bytes are
    whatever the LAST wire stage puts on the wire for the transform's
    payload shape (earlier stages are in-graph conditioning).  With a single
    ``int8`` stage behind C3-SL this reproduces the old inlined
    ``quant_bits=8`` numbers exactly.
    """
    transform: object
    stages: tuple = ()

    def __post_init__(self):
        for s in self.stages:
            if not hasattr(s, "apply"):
                raise TypeError(f"{s!r} is not a wire stage (no .apply)")

    # ---- protocol passthroughs -------------------------------------------

    @property
    def feature_layout(self) -> str:
        return self.transform.feature_layout

    @property
    def R(self) -> int:
        return getattr(self.transform, "R", 1)

    @property
    def D(self) -> int:
        return self.transform.D

    def init(self, rng=None, device="cuda"):
        return self.transform.init(rng, device=device)

    def encode(self, params, Z):
        payload = self.transform.encode(params, Z)
        for stage in self.stages:
            payload = stage.apply(payload)
        return payload

    def decode(self, params, payload):
        return self.transform.decode(params, payload)

    def decode_masked(self, params, payload, keep):
        """Erasure-aware decode: wire stages are straight-through (the
        in-graph payload keeps the transform's shape), so the mask
        applies at the transform's decode."""
        fn = getattr(self.transform, "decode_masked", None)
        if fn is None:
            return self.transform.decode(params, payload * keep)
        return fn(params, payload, keep)

    # ---- accounting ------------------------------------------------------

    def param_count(self) -> int:
        return self.transform.param_count() + sum(
            s.param_count() for s in self.stages)

    def flops(self, B: int) -> int:
        shape = self.payload_shape(B)
        return self.transform.flops(B) + sum(
            s.flops(shape) for s in self.stages)

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return self.transform.payload_shape(B)

    def wire_bytes(self, B: int) -> int:
        if not self.stages:
            return self.transform.wire_bytes(B)
        return self.stages[-1].wire_bytes(self.payload_shape(B))

    def spec(self) -> str:
        return "|".join([self.transform.spec()]
                        + [s.spec() for s in self.stages])
