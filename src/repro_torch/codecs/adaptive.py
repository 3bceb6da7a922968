"""The serving engine's codec-schedule helpers, for static codecs.

Port of three helpers of ``repro/codecs/adaptive.py``: ``program_key``,
``build_program_table`` (the static-codec case) and
``chunk_payload_shape``.  ``AdaptiveC3SL`` (the ``adaptive:`` spec prefix,
its R ladder and controller) comes with ROADMAP.md slice 3 (the codec
control plane); until then every codec here is static, so the program
table has the one entry ``None``.
"""
from __future__ import annotations


def program_key(codec):
    """The host-side dispatch key for the next dispatch: None for a static
    (or absent) codec, the only kind ported so far."""
    return None


def build_program_table(codec, codec_params, make):
    """One program entry per schedulable bucket: for a static codec (or
    None) the table is ``{None: make(codec, codec_params)}``.  Index the
    result with :func:`program_key`."""
    return {None: make(codec, codec_params)}


def chunk_payload_shape(codec, num_rows: int, chunk: int) -> tuple[int, ...]:
    """Payload shape ``sequence_group_encode`` ships for a prefill chunk of
    ``chunk`` positions across ``num_rows`` slots: 3-D sequence-grouped
    ``(chunk, rows/R, D)`` when rows divide by R, else the flat wrap-around
    form.  Lets byte accounting run host-side without a payload."""
    R = getattr(codec, "R", 1)
    D = codec.D
    if num_rows % R == 0:
        return (chunk, num_rows // R, D)
    return ((chunk * num_rows) // R, D)
