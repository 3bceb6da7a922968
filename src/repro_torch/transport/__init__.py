"""repro_torch.transport — the directional cut-layer transport subsystem.

Port of ``repro.transport``.  The split-learning exchange has two
directions with different payloads: client→server activations (``fwd``)
and server→client gradients (``bwd``).  Each is a :class:`Channel` (codec +
adaptive controller + exact wire accounting); a :class:`SplitLink` composes
them and builds from a spec string::

    build_link("c3sl:R=16|int8 >> bwd:c3sl:R=8", D=4096)

No ``bwd:`` stage: a MIRRORED link, both directions share one codec.  An
explicit ``bwd:`` codec inserts an autograd seam on the payload that
re-compresses the gradient with the backward channel's own codec and R and
measures the gradient-retrieval SNR in the same backward pass (the probe's
gradient), the feedback for an independent backward ``AdaptiveC3SL``.

The loss builder is :func:`make_split_loss_fn` (logical split, front and
back in one process) and the train step :func:`make_split_train_step`; the
2-stage pod pipeline is :func:`make_pod_pipeline_loss_fn` (microbatches
through a front and a back stage, the payload handed across the boundary,
one autograd graph).
"""
from repro_torch.faults import ChannelErasure, FaultPlan, RecoveryPolicy
from repro_torch.transport.channel import Channel, grad_roundtrip, masked_decode
from repro_torch.transport.link import (BWD_PREFIX, DRAFT_PREFIX, LINK_SEP,
                                        SplitLink, as_link, build_link,
                                        build_link_or_codec,
                                        build_link_program_table,
                                        has_trainable_params, is_link_spec,
                                        link_program_key, parse_link_spec,
                                        pin_link, roundtrip, slice_link_params)
from repro_torch.transport.split import (apply_codec, make_split_loss_fn,
                                         make_split_train_step,
                                         split_comm_bytes,
                                         split_value_and_grad,
                                         trainable_params)
from repro_torch.transport.pipeline import make_pod_pipeline_loss_fn

__all__ = [
    "Channel", "SplitLink", "grad_roundtrip", "roundtrip", "masked_decode",
    "as_link", "build_link", "build_link_or_codec", "is_link_spec",
    "parse_link_spec", "LINK_SEP", "BWD_PREFIX", "DRAFT_PREFIX",
    "build_link_program_table", "link_program_key", "pin_link",
    "slice_link_params", "has_trainable_params",
    "apply_codec", "make_split_loss_fn", "split_comm_bytes",
    "make_split_train_step", "split_value_and_grad", "trainable_params",
    "make_pod_pipeline_loss_fn",
    "FaultPlan", "RecoveryPolicy", "ChannelErasure",
]
