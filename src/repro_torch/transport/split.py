"""Split-learning step machinery over the transport layer.

Port of ``repro/transport/split.py``: the logical-split loss builder and the
codec round-trip dispatch, link-aware (a ``SplitLink`` at the cut layer
compresses the two directions independently, see
``repro_torch.transport.link``, while bare codecs encode then decode).
Also the paper's train step (the reference's ``benchmarks/bench_accuracy.py``
step: loss, gradients, optimizer update) as :func:`make_split_train_step`,
which trains the codec's own params too when the codec has any (dense,
BottleNet++), as the reference's ``jax.grad`` over the whole tree does.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import hrr
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.optimizers import apply_updates
from repro_torch.transport.channel import masked_decode  # noqa: F401
from repro_torch.transport.link import (SplitLink, has_trainable_params,
                                        roundtrip)


def apply_codec(codec, params, Z, *, with_snr=False, bwd_probe=None,
                erasure=None):
    """Round-trip Z through a codec or SplitLink, preserving Z's shape.

    Dispatch is protocol-level via ``codec.feature_layout``: "nchw" codecs
    (BottleNet++) consume (B, C, H, W) natively; "flat" codecs work on
    flattened (B, D).  Wrapper codecs (the Adaptive-R scheduler, SplitLink)
    expose the same attribute, so they dispatch identically.

    ``with_snr=True`` additionally returns the retrieval SNR (dB) of the
    round trip, the forward Adaptive-R controller's feedback signal.
    ``bwd_probe`` is the asymmetric link's gradient-SNR tap (see
    ``repro_torch.transport.channel.grad_roundtrip``); ignored otherwise.
    ``erasure`` is the per-direction payload keep-mask dict of
    ``repro_torch.transport.link.roundtrip`` (flat codecs and links only).
    """
    if getattr(codec, "feature_layout", "flat") == "nchw":
        if erasure:
            raise ValueError("payload erasure is modeled for flat codecs "
                             "and links only (nchw has no packetized "
                             "payload layout)")
        if isinstance(codec, SplitLink):
            # only mirrored links can be nchw (asymmetric is rejected at
            # construction); unwrap to the one shared codec
            params = codec.fwd_params(params)
            codec = codec.fwd.codec
        payload = codec.encode(params, Z)
        Zhat = codec.decode(params, payload)
        if with_snr:
            return Zhat, hrr.retrieval_snr(Z, Zhat)
        return Zhat
    shape = Z.shape
    Zf = Z.reshape(shape[0], -1)
    out = roundtrip(codec, params, Zf, with_snr=with_snr, bwd_probe=bwd_probe,
                    erasure=erasure)
    if with_snr:
        Zhat, snr = out
        return Zhat.reshape(shape), snr
    return out.reshape(shape)


def make_split_loss_fn(front_apply: Callable, back_apply: Callable, codec,
                       loss_fn: Callable, with_metrics: bool = False) -> Callable:
    """Logical split: loss(params, batch) with the codec at the cut layer.

    params = {"front": ..., "back": ..., "codec": ...}
    batch  = {"x": ..., "y": ...}

    ``codec`` may be a static codec or a static ``SplitLink``.  The returned
    fn also accepts the backward-SNR probe as a third argument (see
    :func:`split_value_and_grad`, which makes it) and ``erasure``, the
    per-direction keep-mask dict of ``roundtrip``.

    ``with_metrics=True`` makes the returned fn yield (loss, metrics) where
    metrics["cut_snr"] is the cut-layer retrieval SNR in dB.  The returned
    fn carries the codec as ``.codec``, for the train step.
    """

    def loss(params, batch, bwd_probe=None, erasure=None):
        Z = front_apply(params["front"], batch["x"])
        if with_metrics:
            Zhat, snr = apply_codec(codec, params["codec"], Z, with_snr=True,
                                    bwd_probe=bwd_probe, erasure=erasure)
            logits = back_apply(params["back"], Zhat)
            return loss_fn(logits, batch["y"]), {"cut_snr": snr}
        Zhat = apply_codec(codec, params["codec"], Z, bwd_probe=bwd_probe,
                           erasure=erasure)
        logits = back_apply(params["back"], Zhat)
        return loss_fn(logits, batch["y"])

    loss.codec = codec
    return loss


def split_comm_bytes(codec, B: int, directions: int = 2) -> int:
    """Wire bytes per step (activations up + gradients down).  A SplitLink
    accounts each direction with its own channel's codec/bucket."""
    if isinstance(codec, SplitLink):
        total = codec.wire_bytes_fwd(B)
        if directions >= 2:
            total += codec.wire_bytes_bwd(B)
        return total
    return directions * codec.wire_bytes(B)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _codec_train_key(codec):
    """Where the codec's trainable params sit in its tree: None (nothing
    trains: C3-SL's keys are fixed), ``""`` (the whole tree: a trainable bare
    or adaptive codec, or a mirrored link of one), or ``"fwd"`` (a tagged
    link's forward channel; a trainable bwd or draft codec is refused when
    the link is built)."""
    if isinstance(codec, SplitLink):
        if not has_trainable_params(codec.fwd.codec):
            return None
        return "fwd" if codec._nested else ""
    return "" if has_trainable_params(codec) else None


def trainable_params(split_loss: Callable, params) -> dict:
    """What a train step updates, as a tree: ``{"net": params["net"]}``,
    plus ``"codec"`` (the codec's trainable params) when the codec trains.
    ``split_loss`` is a :func:`make_split_loss_fn` result.  Make the
    optimizer state with ``opt.init(trainable_params(split_loss, params))``.
    """
    out = {"net": params["net"]}
    key = _codec_train_key(split_loss.codec)
    if key is not None:
        out["codec"] = params["codec"][key] if key else params["codec"]
    return out


def _with_codec(codec_params, key, sub):
    return {**codec_params, key: sub} if key else sub


def split_value_and_grad(split_loss: Callable, params, batch, *,
                         bwd_probe: bool = False, erasure=None):
    """Loss, gradients and metrics of one split step, for a model whose
    front and back both read ``params["net"]`` (the paper's VGG-16 /
    ResNet-50).  ``split_loss`` is a :func:`make_split_loss_fn` result.

    Returns ``(loss, grads, metrics)``: ``grads`` has the structure of
    :func:`trainable_params` (the net's leaves, and the codec's when it
    trains); ``metrics`` holds ``"cut_snr"`` when the loss was built
    ``with_metrics`` and, with ``bwd_probe=True``, ``"bwd_snr"``: the
    gradient-retrieval SNR (dB) the asymmetric link's seam measured in this
    backward pass, 0 for a mirrored link or a bare codec.  ``erasure`` is
    passed to the loss.  Nothing here waits for the device.
    """
    key = _codec_train_key(split_loss.codec)
    fresh = lambda tree: tree_map(lambda t: t.detach().requires_grad_(), tree)  # noqa: E731
    train = {"net": fresh(params["net"])}
    codec_params = params["codec"]
    if key is not None:
        train["codec"] = fresh(codec_params[key] if key else codec_params)
        codec_params = _with_codec(codec_params, key, train["codec"])
    probe = None
    if bwd_probe:
        probe = torch.zeros((), dtype=torch.float32, device=batch["x"].device,
                            requires_grad=True)
    out = split_loss({"front": train["net"], "back": train["net"],
                      "codec": codec_params}, batch, probe, erasure)
    loss, metrics = out if isinstance(out, tuple) else (out, {})
    leaves = tree_leaves(train)
    wrt = leaves + ([probe] if probe is not None else [])
    got = torch.autograd.grad(loss, wrt, allow_unused=True)
    # a codec leaf or the probe the step does not reach (an adaptive
    # codec's other buckets, the probe of a mirrored link) takes a zero
    # gradient, as in jax.grad; a net leaf off the graph is an error
    net = {id(t) for t in tree_leaves(train["net"])}
    if any(g is None and id(x) in net for x, g in zip(wrt, got)):
        raise RuntimeError("split_value_and_grad: a net leaf is not on the "
                           "loss's graph")
    got = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, got)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if probe is not None:
        metrics["bwd_snr"] = got.pop()
    return loss.detach(), tree_unflatten(train, got), metrics


def make_split_train_step(split_loss: Callable, opt) -> Callable:
    """The paper's split-learning train step: front -> codec encode ->
    decode -> back -> loss, the backward pass (through the codec's adjoint,
    and an asymmetric link's gradient seam), and the optimizer update of
    :func:`trainable_params`.

    Returns ``step(params, opt_state, batch, *, bwd_probe=False,
    erasure=None) -> (params, opt_state, loss, metrics)`` with ``params =
    {"net": ..., "codec": ...}``, ``opt_state =
    opt.init(trainable_params(split_loss, params))`` and ``metrics`` as in
    :func:`split_value_and_grad`.  No host sync: the loss and metrics stay
    on the device.
    """
    key = _codec_train_key(split_loss.codec)

    def step(params, opt_state, batch, *, bwd_probe=False, erasure=None):
        loss, grads, metrics = split_value_and_grad(
            split_loss, params, batch, bwd_probe=bwd_probe, erasure=erasure)
        train = trainable_params(split_loss, params)
        updates, opt_state = opt.update(grads, opt_state, train)
        new = apply_updates(train, updates)
        codec_params = params["codec"]
        if key is not None:
            codec_params = _with_codec(codec_params, key, new["codec"])
        return {"net": new["net"], "codec": codec_params}, opt_state, loss, \
            metrics

    return step
