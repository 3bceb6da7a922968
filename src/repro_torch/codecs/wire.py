"""Standalone wire-format stages for the SL boundary.

Port of ``repro/codecs/wire.py``.  A wire stage changes how a payload is
*represented on the wire*, not its shape or the codec math.  Each stage's
``apply`` is a straight-through round-trip (fake-quant style: the forward
applies the lossy representation, the backward passes the gradient
unchanged), so stages chain behind any transform codec via
``repro_torch.codecs.compose.Chain`` / build specs like ``"c3sl:R=8|int8"``.

Byte accounting takes the transform's ``payload_shape(B)``; FLOP accounting
follows the paper's convention of counting only MAC-dominated work, so the
elementwise stages here report 0.

Implemented stages:
  * Int8STEQuant  — per-row absmax int8 fake-quant (f32 scale per row).
  * TopKSparsify  — magnitude top-k per row, mask-encoded indices on the
                    wire (1 bit/position + k f32 values).
  * NoOpWire      — f32 passthrough (accounting baseline).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.codecs.base import SpecMixin, register


def _rows(shape: tuple[int, ...]) -> int:
    """Quantization rows of a payload: everything but the trailing axis
    (scale/mask granularity is axis=-1 for payloads of ANY rank)."""
    return math.prod(shape[:-1]) if len(shape) > 1 else 1


# --------------------------------------------------------------------------
# straight-through int8 fake-quant
# --------------------------------------------------------------------------

class _SteQuantInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.round(x / scale).to(torch.int8)      # round half to even
        return q.to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def ste_quant_int8(x: torch.Tensor) -> torch.Tensor:
    return _SteQuantInt8.apply(x)


@register("int8", kind="wire")
@dataclasses.dataclass(frozen=True)
class Int8STEQuant(SpecMixin):
    """Per-row absmax int8 wire format with a straight-through estimator."""

    def apply(self, payload):
        return ste_quant_int8(payload)

    def param_count(self) -> int:
        return 0

    def flops(self, shape: tuple[int, ...]) -> int:
        return 0  # elementwise; excluded by the paper's MAC accounting

    def wire_bytes(self, shape: tuple[int, ...]) -> int:
        # 1 byte per value + one f32 scale per row
        return math.prod(shape) + 4 * _rows(shape)


# --------------------------------------------------------------------------
# straight-through top-k sparsification (mask-encoded indices)
# --------------------------------------------------------------------------

class _SteTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        # exact-k scatter mask (a >= kth-magnitude threshold would keep every
        # tied value and break the k-values-per-row wire accounting)
        D = x.shape[-1]
        flat = x.reshape(-1, D)
        idx = torch.topk(flat.abs(), k, dim=-1).indices
        mask = torch.zeros(flat.shape, dtype=torch.bool, device=x.device)
        mask.scatter_(1, idx, True)
        return torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    return _SteTopK.apply(x, k)


@register("topk", kind="wire")
@dataclasses.dataclass(frozen=True)
class TopKSparsify(SpecMixin):
    """Keep the top-k magnitudes per row; gradient is straight-through.

    On the wire the kept positions are mask-encoded — a D-bit mask per row
    plus the k surviving f32 values — instead of 32-bit indices.  Give
    either an absolute ``k`` or a ``ratio`` of the row dim (k wins when both
    are set).
    """
    k: int = 0
    ratio: float = 0.25

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"k must be >= 0, got {self.k}")
        if self.k == 0 and not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {self.ratio}")

    def _k_for(self, D: int) -> int:
        k = self.k if self.k else max(1, int(round(self.ratio * D)))
        return min(k, D)

    def apply(self, payload):
        return ste_topk(payload, self._k_for(payload.shape[-1]))

    def param_count(self) -> int:
        return 0

    def flops(self, shape: tuple[int, ...]) -> int:
        return 0  # comparison-dominated; excluded by the MAC accounting

    def wire_bytes(self, shape: tuple[int, ...]) -> int:
        D = shape[-1]
        k = self._k_for(D)
        mask_bytes = (D + 7) // 8
        return _rows(shape) * (mask_bytes + 4 * k)


@register("noop", kind="wire")
@dataclasses.dataclass(frozen=True)
class NoOpWire(SpecMixin):
    """f32 passthrough — the accounting baseline for wire formats."""

    def apply(self, payload):
        return payload

    def param_count(self) -> int:
        return 0

    def flops(self, shape: tuple[int, ...]) -> int:
        return 0

    def wire_bytes(self, shape: tuple[int, ...]) -> int:
        return math.prod(shape) * 4
