"""Thin re-export shim: the split-step machinery lives in
``repro_torch.transport``.

Port of ``repro/core/split.py``.  Imports are lazy (module ``__getattr__``),
as in the reference.  The pod pipeline (``make_pod_pipeline_loss_fn``) is
not ported yet: it comes with ROADMAP.md item 15 (slice 7), and the name
raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

_EXPORTS = {
    "apply_codec": ("repro_torch.transport.split", "apply_codec"),
    "make_split_loss_fn": ("repro_torch.transport.split", "make_split_loss_fn"),
    "split_comm_bytes": ("repro_torch.transport.split", "split_comm_bytes"),
}

__all__ = [*_EXPORTS, "make_pod_pipeline_loss_fn"]


def make_pod_pipeline_loss_fn(*args, **kwargs):
    raise NotImplementedError(
        "the pod pipeline (transport/pipeline.py) is not ported yet: it "
        "comes with ROADMAP.md item 15 (slice 7, multi-device)")


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
