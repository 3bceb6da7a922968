"""The uncompressed baseline codec (vanilla split learning).

Port of ``repro/codecs/identity.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.codecs.base import SpecMixin, register


@register("identity")
@dataclasses.dataclass(frozen=True)
class IdentityCodec(SpecMixin):
    """Vanilla SL — features cross the wire untouched, f32."""
    D: int

    feature_layout = "flat"
    R = 1

    def init(self, rng=None, device="cuda"):
        return {}

    def encode(self, params, Z):
        return Z

    def decode(self, params, payload):
        return payload

    def param_count(self) -> int:
        return 0

    def flops(self, B: int) -> int:
        return 0

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return (B, self.D)

    def wire_bytes(self, B: int) -> int:
        return B * self.D * 4
