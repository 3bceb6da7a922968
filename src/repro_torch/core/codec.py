"""Thin re-export shim: the codec layer lives in ``repro_torch.codecs``.

Port of ``repro/core/codec.py``.  Old imports keep working::

    from repro_torch.core.codec import C3SLCodec, IdentityCodec, ...

``C3SLCodec`` here is a compatibility factory: the historical
``quant_bits=8`` option is a composed wire stage in the registry API
(``repro_torch.codecs.build("c3sl:R=...|int8")``), so passing it returns a
``Chain`` with the same encode/decode and accounting.  Imports are lazy
(module ``__getattr__``), as in the reference.
"""
from __future__ import annotations

_EXPORTS = {
    "IdentityCodec": ("repro_torch.codecs.identity", "IdentityCodec"),
    "DenseBottleneckCodec": ("repro_torch.codecs.bottleneck",
                             "DenseBottleneckCodec"),
    "Chain": ("repro_torch.codecs.compose", "Chain"),
    "Int8STEQuant": ("repro_torch.codecs.wire", "Int8STEQuant"),
    "_ste_quant_int8": ("repro_torch.codecs.wire", "ste_quant_int8"),
    "sequence_group_encode": ("repro_torch.codecs.c3sl",
                              "sequence_group_encode"),
    "sequence_group_decode": ("repro_torch.codecs.c3sl",
                              "sequence_group_decode"),
}


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def C3SLCodec(*, R: int, D: int, backend: str = "fft", unitary: bool = False,
              quant_bits: int | None = None, key_seed: int = 0):
    """Build the paper codec; ``quant_bits=8`` composes the int8 wire stage."""
    from repro_torch.codecs.c3sl import C3SLCodec as _C3SLCodec
    from repro_torch.codecs.compose import Chain
    from repro_torch.codecs.wire import Int8STEQuant

    codec = _C3SLCodec(R=R, D=D, backend=backend, unitary=unitary,
                       key_seed=key_seed)
    if quant_bits is None:
        return codec
    if quant_bits != 8:
        raise ValueError("only int8 wire quantization supported")
    return Chain(codec, (Int8STEQuant(),))
