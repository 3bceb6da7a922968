"""Thin re-export shim: the split-step machinery lives in
``repro_torch.transport``.

Port of ``repro/core/split.py``.  Imports are lazy (module ``__getattr__``),
as in the reference.
"""
from __future__ import annotations

_EXPORTS = {
    "apply_codec": ("repro_torch.transport.split", "apply_codec"),
    "make_split_loss_fn": ("repro_torch.transport.split", "make_split_loss_fn"),
    "split_comm_bytes": ("repro_torch.transport.split", "split_comm_bytes"),
    "make_pod_pipeline_loss_fn": ("repro_torch.transport.pipeline",
                                  "make_pod_pipeline_loss_fn"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
