"""repro_torch.codecs — the boundary-codec API for split learning.

Port of ``repro.codecs`` with the same protocol, spec grammar and registry;
spec strings round-trip byte for byte like the reference's.  Every codec is
a drop-in module at the cut layer implementing the ``Codec`` protocol
(see ``repro_torch.codecs.base``)::

    params  = codec.init(rng, device)         # dict of tensors ({} if stateless)
    payload = codec.encode(params, Z)         # what crosses the wire
    Zhat    = codec.decode(params, payload)   # reconstruction

    codec.param_count() / flops(B) / wire_bytes(B) / payload_shape(B)
    codec.feature_layout                      # "flat" (B, D) | "nchw"
    codec.spec()                              # canonical spec string

Spec grammar::

    SPEC  := STAGE ("|" STAGE)*
    STAGE := NAME [":" KEY "=" VALUE ("," KEY "=" VALUE)*]

The first stage names a registered *transform* codec; every later stage
names a registered *wire format* applied to the transform's payload
(straight-through, fake-quant style).

Registered transforms:
    identity                  — vanilla SL.              args: D
    c3sl     (alias: hrr)     — the paper's HRR codec.   args: R, D,
                                backend=fft|direct|pallas, unitary, key_seed

Registered wire stages:
    int8  — per-row absmax int8 STE quant.
    topk  — magnitude top-k, mask-encoded indices.  args: k | ratio
    noop  — f32 passthrough.

Serving's codec-schedule helpers (``program_key``, ``build_program_table``,
``chunk_payload_shape``) are ported for static codecs.  Not ported yet: the
Adaptive-R wrapper (``adaptive:``), and the dense and BottleNet++ baselines.
"""
from repro_torch.codecs.adaptive import (build_program_table,
                                         chunk_payload_shape, program_key)
from repro_torch.codecs.base import (Codec, CodecSpec, WireStage,
                                     apply_quant_bits, available, build,
                                     clamp_R, format_stage, parse_spec,
                                     register)
from repro_torch.codecs.c3sl import (C3SLCodec, sequence_group_decode,
                                     sequence_group_encode)
from repro_torch.codecs.compose import Chain, payload_wire_bytes
from repro_torch.codecs.identity import IdentityCodec
from repro_torch.codecs.wire import Int8STEQuant, NoOpWire, TopKSparsify

__all__ = [
    "Codec", "CodecSpec", "WireStage", "apply_quant_bits", "available",
    "build", "clamp_R", "format_stage", "parse_spec", "register",
    "IdentityCodec", "C3SLCodec",
    "Chain", "Int8STEQuant", "TopKSparsify", "NoOpWire", "payload_wire_bytes",
    "sequence_group_encode", "sequence_group_decode",
    "build_program_table", "chunk_payload_shape", "program_key",
]
