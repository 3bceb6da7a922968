"""Codec protocol, spec grammar, and the string-keyed codec registry.

Port of ``repro/codecs/base.py`` (pure Python, kept as its own copy: the
port imports nothing of ``repro``).  Spec strings are byte-identical to the
reference's.

This module is the single source of truth for what a boundary codec *is*:

* ``Codec`` — a runtime-checkable protocol.  A codec owns the cut-layer
  transform (init/encode/decode over pytree params) plus the analytic
  accounting the paper-repro benchmarks consume (``param_count`` /
  ``flops`` / ``wire_bytes`` / ``payload_shape``) and a ``feature_layout``
  attribute ("flat" for (B, D) codecs, "nchw" for conv codecs) that the
  split-step machinery dispatches on instead of ``isinstance``.

* ``CodecSpec`` — one parsed stage of a spec string (serializable:
  ``str(spec)`` round-trips through ``CodecSpec.parse``).

* the registry — ``@register("name")`` for transform codecs,
  ``@register("name", kind="wire")`` for wire-format stages, and
  ``build("c3sl:R=8,backend=fft|int8", D=4096)`` to construct a codec
  (optionally chained with wire stages) from a spec string.  Keyword
  ``defaults`` passed to ``build`` fill fields the spec string leaves out
  (typically runtime dims like ``D``); explicit spec args always win, and
  defaults that a stage's dataclass doesn't declare are ignored.

The full spec grammar is documented in ``repro_torch.codecs.__init__``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch


@runtime_checkable
class Codec(Protocol):
    """What every boundary codec implements (structural — no base class)."""

    #: "flat" — encode/decode consume (B, D); "nchw" — (B, C, H, W).
    feature_layout: str

    def init(self, rng, device="cuda") -> Any: ...       # params tree
    def encode(self, params, Z) -> Any: ...              # wire payload
    def decode(self, params, payload) -> Any: ...        # reconstruction
    def param_count(self) -> int: ...                    # codec parameters
    def flops(self, B: int) -> int: ...                  # FLOPs per batch
    def wire_bytes(self, B: int) -> int: ...             # bytes/direction/step
    def payload_shape(self, B: int) -> tuple[int, ...]: ...
    def spec(self) -> str: ...                           # canonical spec string


@runtime_checkable
class WireStage(Protocol):
    """A wire-format stage: reshapes the *bytes* of a payload, not its math.

    ``apply`` runs in-graph as a straight-through round-trip (fake-quant
    style), so encode-side chaining needs no decode-side counterpart; the
    byte accounting lives in ``wire_bytes(shape)`` over the transform
    codec's payload shape.
    """

    def apply(self, payload): ...
    def param_count(self) -> int: ...
    def flops(self, shape: tuple[int, ...]) -> int: ...
    def wire_bytes(self, shape: tuple[int, ...]) -> int: ...
    def spec(self) -> str: ...


# --------------------------------------------------------------------------
# Spec strings
# --------------------------------------------------------------------------

def _parse_value(text: str):
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _format_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One parsed stage: ``name[:k=v[,k=v...]]``.  Serializable both ways."""
    name: str
    args: dict

    @classmethod
    def parse(cls, text: str) -> "CodecSpec":
        stage = text.strip()
        name, _, argtext = stage.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"empty stage name in codec spec {text!r}")
        args = {}
        if argtext.strip():
            for kv in argtext.split(","):
                k, sep, v = kv.partition("=")
                if not sep or not k.strip():
                    raise ValueError(
                        f"malformed arg {kv!r} in codec stage {stage!r} "
                        "(expected key=value)")
                args[k.strip()] = _parse_value(v.strip())
        return cls(name, args)

    def __str__(self) -> str:
        if not self.args:
            return self.name
        body = ",".join(f"{k}={_format_value(v)}" for k, v in self.args.items())
        return f"{self.name}:{body}"


def parse_spec(text: str) -> list[CodecSpec]:
    """Parse a full spec string into its ``|``-separated stages."""
    if not text or not text.strip():
        raise ValueError("empty codec spec")
    return [CodecSpec.parse(stage) for stage in text.split("|")]


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_TRANSFORMS: dict[str, type] = {}
_WIRES: dict[str, type] = {}


def register(name: str, *aliases: str, kind: str = "transform"):
    """Class decorator: register a codec (or wire stage) under spec name(s).

    The first name is canonical — it is what ``spec()`` emits.
    """
    if kind not in ("transform", "wire"):
        raise ValueError(f"kind must be 'transform' or 'wire', got {kind!r}")
    table = _WIRES if kind == "wire" else _TRANSFORMS

    def deco(cls):
        for n in (name, *aliases):
            if n in _TRANSFORMS or n in _WIRES:
                raise ValueError(f"codec name {n!r} already registered")
            table[n] = cls
        cls.spec_name = name
        return cls

    return deco


def available() -> dict[str, list[str]]:
    """Registered spec names, for error messages and docs."""
    return {"transform": sorted(_TRANSFORMS), "wire": sorted(_WIRES)}


def _spec_fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)
            if f.metadata.get("spec", True)}


def _construct(table: dict, stage: CodecSpec, defaults: dict, what: str):
    if stage.name not in table:
        raise ValueError(
            f"unknown {what} {stage.name!r}; registered transforms: "
            f"{sorted(_TRANSFORMS)}, wire stages: {sorted(_WIRES)}")
    cls = table[stage.name]
    fields = _spec_fields(cls)
    unknown = sorted(set(stage.args) - set(fields))
    if unknown:
        raise ValueError(
            f"{stage.name}: unknown spec arg(s) {unknown}; "
            f"valid args: {sorted(fields)}")
    kwargs = dict(stage.args)
    for k, v in defaults.items():
        if k in fields and k not in kwargs and v is not None:
            kwargs[k] = v
    missing = sorted(k for k, f in fields.items()
                     if f.default is dataclasses.MISSING
                     and f.default_factory is dataclasses.MISSING
                     and k not in kwargs)
    if missing:
        raise ValueError(
            f"{stage.name}: missing required arg(s) {missing} — supply them "
            f"in the spec string or as build(..., {missing[0]}=...) defaults")
    return cls(**kwargs)


def build(spec: str, /, **defaults):
    """Build a codec from a spec string; later ``|`` stages are wire formats.

    ``defaults`` fill spec-omitted dataclass fields (runtime dims like ``D``);
    explicit spec args win, and defaults unknown to a stage are ignored.

    An ``adaptive:`` prefix wraps the rest of the spec in the Adaptive-R
    scheduler (see ``repro_torch.codecs.adaptive``): the inner codec's spec
    grammar is unchanged, and adaptive args (``min_R``/``target_snr``/...)
    ride in the first stage's arg list.
    """
    stripped = spec.strip()
    if stripped == "adaptive" or stripped.startswith("adaptive:"):
        from repro_torch.codecs.adaptive import build_adaptive
        return build_adaptive(stripped, **defaults)
    head, *rest = parse_spec(spec)
    codec = _construct(_TRANSFORMS, head, defaults, "transform codec")
    if rest:
        from repro_torch.codecs.compose import Chain
        wires = tuple(_construct(_WIRES, s, defaults, "wire stage")
                      for s in rest)
        codec = Chain(codec, wires)
    return codec


# --------------------------------------------------------------------------
# Spec emission + generic helpers shared by implementations
# --------------------------------------------------------------------------

def format_stage(obj) -> str:
    """Canonical stage string: registered name + non-default fields in
    declaration order.  ``build(format_stage(c)) == c`` for registered
    dataclass codecs."""
    parts = []
    for f in dataclasses.fields(obj):
        if not f.metadata.get("spec", True):
            continue
        v = getattr(obj, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        parts.append(f"{f.name}={_format_value(v)}")
    name = obj.spec_name
    return f"{name}:{','.join(parts)}" if parts else name


def apply_quant_bits(spec: str, quant_bits) -> str:
    """Legacy ``--quant`` flag: 8 appends the int8 wire stage (unless the
    spec already names one); any other non-None value is an error."""
    if quant_bits is None:
        return spec
    if quant_bits != 8:
        raise ValueError(
            f"only int8 wire quantization supported, got quant_bits={quant_bits}")
    if any(s.name == "int8" for s in parse_spec(spec)):
        return spec
    return spec + "|int8"


def fork_rng(rng: torch.Generator | None) -> torch.Generator | None:
    """A copy of ``rng`` at its current state (None stays None).  A jax key
    is a value, so the reference feeds one key to several inits and each
    draws the same numbers; a ``torch.Generator`` is stateful, so each of
    those inits takes its own copy instead."""
    if rng is None:
        return None
    out = torch.Generator(device=rng.device)
    out.set_state(rng.get_state())
    return out


class SpecMixin:
    """Default ``spec()`` for registered dataclass codecs/wire stages."""

    def spec(self) -> str:
        return format_stage(self)


def clamp_R(codec, max_R: int):
    """Return ``codec`` with its grouping factor R clamped to ``max_R``.

    Works through ``Chain`` wrappers (re-building the inner transform), lets
    codecs with their own clamping logic handle it (``with_max_R``, e.g. the
    Adaptive-R wrapper trims its bucket ladder), and is a no-op for codecs
    without an R field.  The returned codec's ``spec()`` always round-trips
    through ``build`` (pinned in tests/test_torch_codecs.py).  NOTE: the
    caller must re-``init`` params if the codec changed — C3-SL keys have
    shape (R, D).
    """
    with_max = getattr(codec, "with_max_R", None)
    if with_max is not None:
        return with_max(max_R)
    R = getattr(codec, "R", 1)
    if R <= max_R:
        return codec
    inner = getattr(codec, "transform", None)
    if inner is not None:  # composed codec: clamp the transform stage
        return dataclasses.replace(codec, transform=clamp_R(inner, max_R))
    if "R" not in {f.name for f in dataclasses.fields(codec)}:
        return codec
    return dataclasses.replace(codec, R=max_R)
