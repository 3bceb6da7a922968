"""Thin re-export shim: BottleNet++ lives in ``repro_torch.codecs.bottleneck``.

Port of ``repro/core/bottlenet.py``.
"""
from __future__ import annotations

from repro_torch.codecs.bottleneck import BottleNetPPCodec, _batchnorm  # noqa: F401
