"""Communication accounting for the split-learning boundary.

Port of ``repro/core/metrics.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommReport:
    """Per-training-step boundary traffic, both directions."""
    method: str
    R: int
    bytes_fwd: int
    bytes_bwd: int
    baseline_bytes: int

    @property
    def total(self) -> int:
        return self.bytes_fwd + self.bytes_bwd

    @property
    def compression(self) -> float:
        return self.baseline_bytes / max(self.total, 1)

    def row(self) -> str:
        return (f"{self.method:>14s} R={self.R:<3d} fwd={self.bytes_fwd:>12,d} B "
                f"bwd={self.bytes_bwd:>12,d} B  total={self.total:>13,d} B "
                f"({self.compression:5.2f}x vs vanilla)")


def comm_report(codec, B: int, D: int, method: str | None = None) -> CommReport:
    baseline = 2 * B * D * 4
    wire = codec.wire_bytes(B)
    return CommReport(
        method=method or type(codec).__name__,
        R=getattr(codec, "R", 1),
        bytes_fwd=wire,
        bytes_bwd=wire,
        baseline_bytes=baseline,
    )
