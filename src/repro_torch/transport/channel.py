"""One direction of the split-learning wire: codec + controller + accounting.

Port of ``repro/transport/channel.py``.  A ``Channel`` owns everything one
direction of the cut-layer exchange needs:

* the codec that re-represents the payload on the wire (a static codec or
  an ``AdaptiveC3SL`` wrapper scheduling R from measured SNR),
* the controller feedback entry point (``observe``) when it is adaptive,
* exact wire-byte accounting for an already-shaped payload.

Two channels compose into a ``SplitLink`` (``repro_torch.transport.link``):
``fwd`` carries the client→server activation payload, ``bwd`` the
server→client gradient payload.  The backward channel is a
``torch.autograd.Function`` seam (:func:`grad_roundtrip`): the identity in
the forward pass; in the backward pass the cotangent (the gradient payload
that would cross the wire) is round-tripped through the backward codec, its
own R and wire stages, and the measured gradient-retrieval SNR comes back
as the probe argument's gradient, so a second deadband controller can
schedule the backward R without a second pass.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.codecs import AdaptiveC3SL, payload_wire_bytes, program_key
from repro_torch.core import hrr


def masked_decode(codec, params, payload, keep):
    """Erasure-aware decode dispatch: codecs that implement
    ``decode_masked`` (C3-SL's renormalized unbind, Chain, adaptive
    buckets) get the mask natively; anything else decodes the zeroed
    payload (lost elements contribute nothing, no renormalization)."""
    fn = getattr(codec, "decode_masked", None)
    if fn is None:
        return codec.decode(params, payload * keep)
    return fn(params, payload, keep)


def _roundtrip_grad(bwd_codec, bwd_params, g, keep):
    """The backward payload's trip: ``g`` grouped row-wise through
    ``bwd_codec`` (decoded through ``keep`` when given), and the retrieval
    SNR of that trip.  An autograd cotangent may be a strided or expanded
    view, and the circconv kernels take contiguous rows only."""
    g2 = g.contiguous().reshape(-1, g.shape[-1])
    payload = bwd_codec.encode(bwd_params, g2)
    if keep is None:
        ghat = bwd_codec.decode(bwd_params, payload)
    else:
        ghat = masked_decode(bwd_codec, bwd_params, payload, keep)
    snr = hrr.retrieval_snr(g2, ghat)
    return ghat.reshape(g.shape), snr


@functools.lru_cache(maxsize=None)
def _grad_seam(bwd_codec):
    """The backward channel's seam, specialised to ONE static codec (codecs
    are frozen dataclasses, so the cache key is the codec), as the
    reference's ``lru_cache``'d ``custom_vjp``.

    Forward: the identity on the payload.  Backward: ``(ghat, None, snr)``,
    the compressed gradient for the payload, nothing for the codec params
    (fixed keys), and the gradient-retrieval SNR in dB as the probe's
    gradient, raw (the probe feeds no output, so nothing scales it)."""

    class _GradSeam(torch.autograd.Function):
        @staticmethod
        def forward(ctx, payload, bwd_params, probe):
            ctx.bwd_params = bwd_params
            ctx.probe_dtype = probe.dtype
            return payload.view_as(payload)

        @staticmethod
        def backward(ctx, g):
            ghat, snr = _roundtrip_grad(bwd_codec, ctx.bwd_params, g, None)
            return ghat, None, snr.to(ctx.probe_dtype)

    return _GradSeam


@functools.lru_cache(maxsize=None)
def _grad_seam_masked(bwd_codec):
    """The erasure-aware variant of :func:`_grad_seam`: the backward
    payload's keep mask rides as a runtime argument, the cotangent decodes
    through :func:`masked_decode`, and the probe's gradient is the
    erasure-DEGRADED gradient SNR the backward controller observes.
    Backward: ``(ghat, None, snr, None)``."""

    class _GradSeamMasked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, payload, bwd_params, probe, keep):
            ctx.bwd_params = bwd_params
            ctx.probe_dtype = probe.dtype
            ctx.save_for_backward(keep)
            return payload.view_as(payload)

        @staticmethod
        def backward(ctx, g):
            (keep,) = ctx.saved_tensors
            ghat, snr = _roundtrip_grad(bwd_codec, ctx.bwd_params, g, keep)
            return ghat, None, snr.to(ctx.probe_dtype), None

    return _GradSeamMasked


def grad_roundtrip(bwd_codec, payload, bwd_params, probe=None, keep=None):
    """Identity on ``payload``; compresses its GRADIENT through ``bwd_codec``.

    ``probe`` (a 0-dim float32 tensor with ``requires_grad=True``) is a
    gradient tap: ``torch.autograd.grad(loss, probe)`` gives back the
    measured gradient-retrieval SNR in dB, the backward ``AdaptiveC3SL``
    controller's feedback, measured in the same backward pass that ships
    the payload.  ``bwd_codec`` must be a STATIC codec (an adaptive
    wrapper's bucket).

    ``keep`` (optional, backward-payload-shaped) is the backward
    direction's erasure mask: the gradient round trip decodes through the
    mask-aware path and the probe SNR degrades accordingly.  ``keep=None``
    takes the fault-free seam.
    """
    if probe is None:
        probe = torch.zeros((), dtype=torch.float32, device=payload.device)
    if keep is None:
        return _grad_seam(bwd_codec).apply(payload, bwd_params, probe)
    return _grad_seam_masked(bwd_codec).apply(payload, bwd_params, probe,
                                              keep)


@dataclasses.dataclass
class Channel:
    """One direction of the split link: a codec plus its schedule state.

    ``codec`` is either a static codec (possibly a ``Chain``) or an
    ``AdaptiveC3SL`` wrapper; the channel is the one place that knows which,
    so callers talk directions ("the forward channel's current bucket")
    instead of isinstance checks.
    """
    direction: str                 # "fwd" | "bwd" | "draft"
    codec: object
    faults: object = None          # repro_torch.faults.FaultPlan (None = clean)
    recovery: object = None        # repro_torch.faults.RecoveryPolicy
    _step: int = dataclasses.field(default=0, repr=False, compare=False)

    @property
    def adaptive(self) -> bool:
        return isinstance(self.codec, AdaptiveC3SL)

    @property
    def current(self):
        """The static codec serving the next step (the adaptive wrapper's
        current bucket, or the codec itself)."""
        return self.codec.current if self.adaptive else self.codec

    @property
    def current_R(self) -> int:
        return getattr(self.current, "R", 1)

    def program_key(self):
        """Host-side step-callable key: current bucket R, None if static."""
        return program_key(self.codec)

    def observe(self, snr_db=None, loss_slack=None) -> int:
        """Feed this direction's controller one step's signals (no-op for a
        static codec); returns the R serving the NEXT step."""
        if self.adaptive:
            return self.codec.observe(snr_db, loss_slack)
        return self.current_R

    def params_for(self, params, key=None):
        """Slice one bucket's params (identity for a static codec)."""
        if self.adaptive:
            return self.codec.params_for(params, key)
        return params

    def install_faults(self, plan, recovery=None) -> "Channel":
        """Install a ``FaultPlan`` (and optional ``RecoveryPolicy``) on this
        direction; resets the step counter so the injected schedule replays
        from step 0.  Returns self."""
        self.faults = plan
        self.recovery = recovery
        self._step = 0
        return self

    def next_erasure(self, rows: int | None = None, shape=None):
        """Draw the NEXT step's erasure mask for this direction under the
        installed plan, advancing the channel's per-direction step
        counter.  Returns ``(keep, info)``: both ``None`` with no plan (or a
        zero plan), so clean runs stay fault-free; otherwise ``keep`` is the
        float32 numpy element mask of the current bucket's payload shape
        (all-ones on loss-free steps) and ``info`` the retransmission
        accounting of :func:`repro_torch.faults.negotiate_payload`.
        Raises ``ChannelErasure`` when the recovery budget cannot repair
        the step."""
        step = self._step
        self._step += 1
        if self.faults is None or self.faults.is_zero():
            return None, None
        if shape is None:
            if rows is None:
                raise ValueError("next_erasure needs rows or an explicit "
                                 "payload shape")
            shape = self.current.payload_shape(rows)
        from repro_torch.faults import negotiate_payload
        return negotiate_payload(self.faults, self.direction, step,
                                 tuple(shape), self.recovery)

    def wire_bytes(self, rows: int) -> int:
        """Exact bytes this direction ships for ``rows`` feature rows: the
        current bucket's payload shape fed to its last wire stage."""
        c = self.current
        return payload_wire_bytes(c, c.payload_shape(rows))

    def spec(self) -> str:
        return self.codec.spec()

    def __repr__(self) -> str:
        return f"Channel({self.direction!r}, {self.spec()!r})"
