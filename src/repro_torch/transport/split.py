"""Split-learning step machinery: the codec at the cut layer.

Port of ``repro/transport/split.py`` for bare codecs and ``Chain``s (the
per-direction ``SplitLink`` is not ported yet), with the bare-codec branch
of the reference's ``transport.link.roundtrip`` as :func:`roundtrip`, and
the paper's train step (the reference's ``benchmarks/bench_accuracy.py``
step: loss, gradients, optimizer update) as :func:`make_split_train_step`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import hrr
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.optimizers import apply_updates


def masked_decode(codec, params, payload, keep):
    """Erasure-aware decode dispatch: codecs that implement
    ``decode_masked`` (C3-SL's renormalized unbind, Chain) get the mask
    natively; anything else decodes the zeroed payload."""
    fn = getattr(codec, "decode_masked", None)
    if fn is None:
        return codec.decode(params, payload * keep)
    return fn(params, payload, keep)


def roundtrip(codec, params, Zf, *, with_snr: bool = False, erasure=None):
    """Round-trip flat (B, D) cut features through a codec: encode, then
    decode.  ``with_snr`` adds the forward retrieval SNR (dB).

    ``erasure`` injects payload loss: ``{"fwd": keep}`` with a keep mask
    shaped like the payload (1.0 kept / 0.0 erased); the decode
    renormalizes over survivors and ``with_snr`` reports the degraded SNR.
    """
    fwd_keep = erasure.get("fwd") if erasure else None
    payload = codec.encode(params, Zf)
    if fwd_keep is None:
        Zhat = codec.decode(params, payload)
    else:
        Zhat = masked_decode(codec, params, payload, fwd_keep)
    if with_snr:
        return Zhat, hrr.retrieval_snr(Zf, Zhat)
    return Zhat


def apply_codec(codec, params, Z, *, with_snr=False, erasure=None):
    """Round-trip Z through a codec, preserving Z's shape.

    Dispatch is protocol-level via ``codec.feature_layout``: "nchw" codecs
    consume (B, C, H, W) natively; "flat" codecs work on flattened (B, D).
    ``with_snr=True`` additionally returns the retrieval SNR (dB).
    ``erasure`` is the payload keep-mask dict of :func:`roundtrip` (flat
    codecs only).
    """
    if getattr(codec, "feature_layout", "flat") == "nchw":
        if erasure:
            raise ValueError("payload erasure is modeled for flat codecs "
                             "only (nchw has no packetized payload layout)")
        payload = codec.encode(params, Z)
        Zhat = codec.decode(params, payload)
        if with_snr:
            return Zhat, hrr.retrieval_snr(Z, Zhat)
        return Zhat
    shape = Z.shape
    Zf = Z.reshape(shape[0], -1)
    out = roundtrip(codec, params, Zf, with_snr=with_snr, erasure=erasure)
    if with_snr:
        Zhat, snr = out
        return Zhat.reshape(shape), snr
    return out.reshape(shape)


def make_split_loss_fn(front_apply: Callable, back_apply: Callable, codec,
                       loss_fn: Callable, with_metrics: bool = False) -> Callable:
    """Logical split: loss(params, batch) with the codec at the cut layer.

    params = {"front": ..., "back": ..., "codec": ...}
    batch  = {"x": ..., "y": ...}

    ``with_metrics=True`` makes the returned fn yield (loss, metrics) where
    metrics["cut_snr"] is the cut-layer retrieval SNR in dB.  The returned
    fn also accepts ``erasure`` (see :func:`roundtrip`).
    """

    def loss(params, batch, erasure=None):
        Z = front_apply(params["front"], batch["x"])
        if with_metrics:
            Zhat, snr = apply_codec(codec, params["codec"], Z, with_snr=True,
                                    erasure=erasure)
            logits = back_apply(params["back"], Zhat)
            return loss_fn(logits, batch["y"]), {"cut_snr": snr}
        Zhat = apply_codec(codec, params["codec"], Z, erasure=erasure)
        logits = back_apply(params["back"], Zhat)
        return loss_fn(logits, batch["y"])

    return loss


def split_comm_bytes(codec, B: int, directions: int = 2) -> int:
    """Wire bytes per step (activations up + gradients down)."""
    return directions * codec.wire_bytes(B)


def split_value_and_grad(split_loss: Callable, params, batch):
    """Loss and gradients of ``params["net"]`` for a model whose front and
    back both read ``params["net"]`` (the paper's VGG-16 / ResNet-50);
    ``params["codec"]`` is fixed.  ``split_loss`` is a
    :func:`make_split_loss_fn` result.  Returns (loss, grads tree)."""
    net = tree_map(lambda t: t.detach().requires_grad_(), params["net"])
    loss = split_loss({"front": net, "back": net, "codec": params["codec"]},
                      batch)
    grads = torch.autograd.grad(loss, tree_leaves(net))
    return loss.detach(), tree_unflatten(net, grads)


def make_split_train_step(split_loss: Callable, opt) -> Callable:
    """The paper's split-learning train step: front -> codec encode ->
    decode -> back -> loss, the backward pass (through the codec's adjoint),
    and the optimizer update of ``params["net"]``.

    Returns ``step(params, opt_state, batch) -> (params, opt_state, loss)``
    with ``params = {"net": ..., "codec": ...}`` and ``opt_state =
    opt.init(params["net"])``.  No host sync: the loss stays on the device.
    """

    def step(params, opt_state, batch):
        loss, grads = split_value_and_grad(split_loss, params, batch)
        net = params["net"]
        updates, opt_state = opt.update(grads, opt_state, net)
        return ({"net": apply_updates(net, updates), "codec": params["codec"]},
                opt_state, loss)

    return step
