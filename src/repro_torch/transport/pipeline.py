"""2-stage pod pipeline over the transport layer: one program, one autograd
graph, the codec's payload handed across the stage boundary.

Port of ``repro/transport/pipeline.py``.  The reference is a ``lax.scan``
under ``shard_map`` that ``jax.value_and_grad`` differentiates whole, with
``ppermute`` as the wire.  Here the schedule is a Python loop over the same
steps, and the wire is ``payload.to(stage_devices[1])``: autograd carries
the gradient back across it.  On one card both stages share the device and
the handover moves nothing (wire mode ``"same-device"``); on two devices it
is a peer copy (``"peer-copy"``).

* **Per-direction codecs.**  A static ``SplitLink`` that is not mirrored
  puts the gradient seam (``grad_roundtrip``) on the payload, so the
  gradient crossing back is round-tripped through the backward channel's
  own codec and R, as in the reference.

* **The asynchronous channel.**  ``async_depth`` sizes a ring of in-flight
  payloads: the payload of microbatch m is consumed by the back stage at
  step m + depth and paired with ITS OWN labels, so loss and gradients do
  not depend on the depth.  All the work is enqueued on one stream, so the
  depth changes only the order in which the stages' work is enqueued and
  how many payloads are held (at most ``async_depth``); overlapping the
  stages on two streams is later speed work.

Schedule (M = num_microbatches, d = async_depth, steps t = 0 .. M + d - 1):
    back:   consume the oldest payload (microbatch t - d)   for t >= d
    front:  microbatch t -> payload, into the ring          for t < M

The reference's SPMD step runs both stages on every step, so it also sends
d payloads of the clamped last microbatch that no stage consumes, and the
back stage decodes d zero buffers whose loss it masks.  The port skips that
dead work (ROADMAP C13): M payloads move over M + d steps, and loss and
gradients are unchanged.

Each call leaves a record of how it ran in ``loss.last_call``
(:class:`PipelineCall`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch.codecs import AdaptiveC3SL
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.transport.channel import grad_roundtrip, masked_decode
from repro_torch.transport.link import SplitLink


@dataclasses.dataclass(frozen=True)
class PipelineCall:
    """How one pipeline loss call ran, as its loop saw it: ``steps``
    schedule steps run, ``payloads`` payloads handed across the boundary,
    ``payload_bytes`` the bytes of those payload tensors (the gradient
    crossing back has the payload's shape), the most payloads held at
    once, and the wire mode (``"same-device"``: the stages share a device,
    no copy is made; ``"peer-copy"``)."""
    steps: int
    payloads: int
    payload_bytes: int
    max_held: int
    wire: str


def _require_static(codec):
    chans = (codec.fwd.codec, codec.bwd.codec) if isinstance(codec, SplitLink) \
        else (codec,)
    for c in chans:
        if isinstance(c, AdaptiveC3SL):
            raise ValueError(
                "the pod pipeline compiles ONE program; resolve adaptive "
                "channels to static buckets first (transport.pin_link / "
                "AdaptiveC3SL.current) — see repro.launch.train.run_pipeline")


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def make_pod_pipeline_loss_fn(
    embed_fn: Callable,        # (embed_params, x_mb) -> h (mb, S, E)
    stage_fn: Callable,        # (stage_blocks, h) -> h  (one stage's blocks; same fn both stages)
    head_loss_fn: Callable,    # (head_params, h, y_mb) -> scalar mean loss
    codec,                     # flat codec OR static SplitLink
    stage_devices=None,
    num_microbatches: int = 1,
    async_depth: int = 1,
    with_erasure: bool = False,
) -> Callable:
    """Returns loss(params, batch) implementing the 2-stage compressed pipeline.

    params = {"embed", "blocks" (leading stage axis 2), "head", "codec"}.
    batch  = {"x": (B, S) or (B, S, E_in), "y": (B, S)}.

    ``stage_devices`` is the pair of ``torch.device`` the two stages run
    on (the reference's mesh); by default both are the device of
    ``params["blocks"]``.  The front stage (embed, blocks[0], the encode)
    runs on the first, the back stage (the decode, blocks[1], the head) on
    the second; each stage's params and inputs are moved to its device (no
    copy where they are there already), and the loss is on the second.

    ``with_erasure=True`` builds the chaos variant instead:
    ``loss(params, batch, keep)`` where ``keep`` is an
    ``(M + depth, mb // R_fwd, D)`` float32 stack of per-step keep masks
    — ``keep[t]`` masks the payload the back stage CONSUMES at step t (the
    one sent at t - depth), decoded through the renormalizing
    ``decode_masked`` path; ``keep[:depth]`` belongs to steps that consume
    nothing.  An all-ones stack reproduces the clean schedule bitwise.
    """
    M = num_microbatches
    depth = int(async_depth)
    if depth < 1:
        raise ValueError(f"async_depth must be >= 1, got {async_depth}")
    _require_static(codec)
    link = codec if isinstance(codec, SplitLink) else None
    fwd_codec = link.fwd.codec if link is not None else codec

    def loss(params, batch, keep=None):
        if with_erasure and keep is None:
            raise ValueError(
                "with_erasure=True compiles the masked consume path: pass "
                "the (M + depth, rows, D) keep-mask stack (all-ones for a "
                "loss-free step)")
        if not with_erasure and keep is not None:
            raise ValueError("keep masks need the with_erasure=True builder")
        blocks = params["blocks"]
        devices = stage_devices or (tree_leaves(blocks)[0].device,) * 2
        x, y = batch["x"], batch["y"]
        B = x.shape[0]
        assert B % M == 0, (B, M)
        mb = B // M
        x_mbs = x.reshape(M, mb, *x.shape[1:]).to(devices[0])
        y_mbs = y.reshape(M, mb, *y.shape[1:]).to(devices[1])

        codec_p = params["codec"]
        fwd_p = link.fwd_params(codec_p) if link is not None else codec_p
        seam_p = (_to(link.bwd_params(codec_p), devices[0])
                  if link is not None and not link.mirrored else None)
        embed_p = _to(params["embed"], devices[0])
        front = _to(tree_map(lambda a: a[0], blocks), devices[0])
        enc_p = _to(fwd_p, devices[0])
        back = _to(tree_map(lambda a: a[1], blocks), devices[1])
        head_p = _to(params["head"], devices[1])
        dec_p = _to(fwd_p, devices[1])
        if keep is not None:
            keep = keep.to(devices[1])

        ring = collections.deque()
        losses = []
        steps = payloads = nbytes = held = 0
        copied = False
        for t in range(M + depth):
            steps += 1
            if t >= depth:
                payload, shape = ring.popleft()
                if keep is None:
                    h = fwd_codec.decode(dec_p, payload)
                else:
                    h = masked_decode(fwd_codec, dec_p, payload, keep[t])
                h = stage_fn(back, h.reshape(shape))
                losses.append(head_loss_fn(head_p, h, y_mbs[t - depth]))
            if t < M:
                h = stage_fn(front, embed_fn(embed_p, x_mbs[t]))
                payload = fwd_codec.encode(enc_p, h.reshape(mb, -1))
                if seam_p is not None:
                    # gradient seam: the cotangent crossing back over the
                    # boundary is round-tripped by the backward channel's
                    # codec (straight-through, shape-preserving)
                    payload = grad_roundtrip(link.bwd.codec, payload, seam_p)
                moved = payload.to(devices[1])       # the wire
                copied = copied or moved is not payload
                payloads += 1
                nbytes += moved.numel() * moved.element_size()
                ring.append((moved, h.shape))
                held = max(held, len(ring))
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        loss.last_call = PipelineCall(
            steps=steps, payloads=payloads, payload_bytes=nbytes,
            max_held=held, wire="peer-copy" if copied else "same-device")
        return total / M

    loss.last_call = None
    return loss
