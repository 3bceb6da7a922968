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
    dense    (alias: dense-bottleneck)
                              — linear autoencoder.      args: R, D
    bnpp     (alias: bottlenetpp)
                              — BottleNet++ conv codec.  args: R, C, H, W, k

Registered wire stages:
    int8  — per-row absmax int8 STE quant.
    topk  — magnitude top-k, mask-encoded indices.  args: k | ratio
    noop  — f32 passthrough.

An ``adaptive:`` prefix wraps the rest of the spec in the Adaptive-R
scheduler (``repro_torch.codecs.adaptive``): one pre-built inner codec per
bucket of a {min_R, ..., R} ladder, switched host-side from an EMA of the
measured retrieval SNR.  Adaptive args (``min_R``, ``target_snr``,
``ema``, ``hysteresis``) ride in the first stage's arg list::

    build("bnpp:R=4,C=512,H=2,W=2")                     # BottleNet++ baseline
    build("adaptive:c3sl:R=16,min_R=2,target_snr=12|int8", D=4096)

``repro_torch.core.codec`` and ``repro_torch.core.bottlenet`` are thin
re-export shims for the reference's older import paths.
"""
from repro_torch.codecs.adaptive import (AdaptiveC3SL, bucket_key,
                                         build_adaptive, build_program_table,
                                         chunk_payload_shape, program_key)
from repro_torch.codecs.base import (Codec, CodecSpec, WireStage,
                                     apply_quant_bits, available, build,
                                     clamp_R, fork_rng, format_stage,
                                     parse_spec, register)
from repro_torch.codecs.bottleneck import (BottleNetPPCodec,
                                           DenseBottleneckCodec)
from repro_torch.codecs.c3sl import (C3SLCodec, sequence_group_decode,
                                     sequence_group_encode)
from repro_torch.codecs.compose import Chain, payload_wire_bytes
from repro_torch.codecs.identity import IdentityCodec
from repro_torch.codecs.wire import Int8STEQuant, NoOpWire, TopKSparsify

__all__ = [
    "Codec", "CodecSpec", "WireStage", "apply_quant_bits", "available",
    "build", "clamp_R", "fork_rng", "format_stage", "parse_spec", "register",
    "IdentityCodec", "C3SLCodec", "DenseBottleneckCodec", "BottleNetPPCodec",
    "AdaptiveC3SL", "bucket_key", "build_adaptive",
    "Chain", "Int8STEQuant", "TopKSparsify", "NoOpWire", "payload_wire_bytes",
    "sequence_group_encode", "sequence_group_decode",
    "build_program_table", "chunk_payload_shape", "program_key",
]
