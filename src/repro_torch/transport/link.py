"""SplitLink: the bidirectional cut-layer exchange as a pair of Channels.

Port of ``repro/transport/link.py``.  Spec grammar (extends the codec
grammar of ``repro_torch.codecs``)::

    LINK := CODEC_SPEC [" >> bwd:" CODEC_SPEC] [" >> draft:" CODEC_SPEC]

The part before ``>>`` is the forward (client→server activation) codec; the
``bwd:``-prefixed part is the backward (server→client gradient) codec.  With
no ``bwd:`` stage the link is MIRRORED: both directions share ONE codec and
the backward payload simply has the forward's compressed shape, exactly the
shared-codec behaviour of a bare codec.

The ``draft:``-prefixed segment is the speculative-decoding DRAFT channel, a
third :class:`Channel` with its own codec and wire accounting.  It is parsed
and accounted here; the speculative decoding that runs it comes with
ROADMAP.md slice 5 (serving II).

    build_link("c3sl:R=16|int8 >> bwd:c3sl:R=8", D=4096)
    build_link("adaptive:c3sl:R=8,min_R=2|int8 >> "
               "bwd:adaptive:c3sl:R=4,min_R=2|int8", D=256)

An asymmetric link inserts :func:`repro_torch.transport.channel.grad_roundtrip`
on the payload: the forward pass is unchanged (the seam is the identity),
and the backward pass round-trips the gradient payload, shape
``(B/R_fwd, D)``, through the backward codec, so the wire carries
``(B/(R_fwd·R_bwd), D)`` gradient rows in the backward codec's wire format.
The gradient-retrieval SNR is measured in the same backward pass and comes
back through a probe's gradient, feeding a SECOND deadband controller (the
backward channel's own ``AdaptiveC3SL``) that schedules R_bwd independently
of R_fwd.

Adaptive channels are resolved to static bucket pairs by
:func:`build_link_program_table`: one step callable per (R_fwd, R_bwd)
pair, made once and switched host-side.
"""
from __future__ import annotations

from repro_torch import codecs
from repro_torch.codecs import AdaptiveC3SL, clamp_R, fork_rng
from repro_torch.core import hrr
from repro_torch.transport.channel import Channel, grad_roundtrip, masked_decode

LINK_SEP = ">>"
BWD_PREFIX = "bwd:"
DRAFT_PREFIX = "draft:"


def is_link_spec(spec: str) -> bool:
    """True for per-direction specs (``... >> bwd:...`` / ``... >> draft:...``)."""
    return isinstance(spec, str) and LINK_SEP in spec


def parse_link_spec(spec: str) -> tuple[str, str | None, str | None]:
    """Split a link spec into (fwd_spec, bwd_spec-or-None, draft_spec-or-None).

    Tagged segments after the forward codec may appear in either order but
    at most once each; every segment after ``>>`` must carry a ``bwd:`` or
    ``draft:`` tag."""
    if not is_link_spec(spec):
        return spec.strip(), None, None
    parts = [p.strip() for p in spec.split(LINK_SEP)]
    if len(parts) > 3:
        raise ValueError(f"more than two '{LINK_SEP}' in link spec {spec!r}")
    fwd_spec = parts[0]
    if not fwd_spec:
        raise ValueError(f"empty forward codec spec in {spec!r}")
    bwd_spec = draft_spec = None
    for part in parts[1:]:
        if part.startswith(BWD_PREFIX):
            if bwd_spec is not None:
                raise ValueError(f"duplicate '{BWD_PREFIX}' stage in {spec!r}")
            bwd_spec = part[len(BWD_PREFIX):].strip()
            if not bwd_spec:
                raise ValueError(f"empty backward codec spec in {spec!r}")
        elif part.startswith(DRAFT_PREFIX):
            if draft_spec is not None:
                raise ValueError(
                    f"duplicate '{DRAFT_PREFIX}' stage in {spec!r}")
            draft_spec = part[len(DRAFT_PREFIX):].strip()
            if not draft_spec:
                raise ValueError(f"empty draft codec spec in {spec!r}")
        else:
            raise ValueError(
                f"stages after '{LINK_SEP}' must be tagged '{BWD_PREFIX}' or "
                f"'{DRAFT_PREFIX}', got {part!r} in {spec!r}")
    return fwd_spec, bwd_spec, draft_spec


def has_trainable_params(codec) -> bool:
    """True when any stage of ``codec`` declares ``trainable = True``
    (dense/bnpp autoencoders), unwrapping Chain transforms and adaptive
    buckets.  C3-SL's keys are fixed, so c3sl chains report False."""
    if isinstance(codec, AdaptiveC3SL):
        return any(has_trainable_params(b) for b in codec.buckets.values())
    inner = getattr(codec, "transform", None)
    if inner is not None:                      # Chain: the transform stage
        return has_trainable_params(inner)
    return bool(getattr(codec, "trainable", False))


class SplitLink:
    """(fwd: Channel, bwd: Channel[, draft: Channel]): the cut-layer
    exchange, both ways, plus the optional speculative draft channel.

    ``bwd_codec=None`` builds a MIRRORED link: the backward channel aliases
    the forward codec (one codec object, one params tree).  An explicit
    backward codec makes the link asymmetric: its params tree becomes
    ``{"fwd": ..., "bwd": ...}`` and the gradient seam is inserted at the
    payload.  ``draft_codec`` adds the draft channel (direction tag
    ``"draft"``), outside the fwd/bwd numeric path; the params tree gains a
    ``"draft"`` key only when the channel exists.
    """

    def __init__(self, fwd_codec, bwd_codec=None, draft_codec=None):
        if bwd_codec is not None:
            for tag, c in (("fwd", fwd_codec), ("bwd", bwd_codec)):
                if getattr(c, "feature_layout", "flat") != "flat":
                    raise ValueError(
                        f"per-direction links support flat codecs only; the "
                        f"{tag} codec has feature_layout="
                        f"{getattr(c, 'feature_layout', None)!r}")
            if has_trainable_params(bwd_codec):
                # the gradient seam applies the bwd codec INSIDE a backward
                # pass and returns no gradient for its params: a trainable
                # bwd codec would silently stay at init while corrupting
                # every gradient.  Fail loudly instead.
                raise ValueError(
                    f"the backward channel cannot train codec params "
                    f"({bwd_codec.spec()}): the gradient seam runs in the "
                    f"backward pass, where codec params receive no "
                    f"gradient — use a fixed-key codec (c3sl/identity) or "
                    f"wire stages on the bwd: side")
        if draft_codec is not None:
            if getattr(draft_codec, "feature_layout", "flat") != "flat":
                raise ValueError(
                    f"the draft channel supports flat codecs only, got "
                    f"feature_layout="
                    f"{getattr(draft_codec, 'feature_layout', None)!r}")
            if has_trainable_params(draft_codec):
                raise ValueError(
                    f"the draft channel cannot train codec params "
                    f"({draft_codec.spec()}): serving never backpropagates "
                    f"through the feedback payload — use a fixed-key codec "
                    f"(c3sl/identity) or wire stages on the draft: side")
        self.fwd = Channel("fwd", fwd_codec)
        self.bwd = Channel("bwd", bwd_codec if bwd_codec is not None
                           else fwd_codec)
        self.mirrored = bwd_codec is None
        self.draft = (Channel("draft", draft_codec)
                      if draft_codec is not None else None)

    # ---- codec-protocol-ish surface (forward channel's view) -------------

    @property
    def feature_layout(self) -> str:
        return getattr(self.fwd.codec, "feature_layout", "flat")

    @property
    def D(self) -> int:
        return self.fwd.codec.D

    @property
    def _nested(self) -> bool:
        """True when the params tree is the tagged ``{"fwd": ...}`` dict
        (any non-mirrored or draft-carrying link); a mirrored draft-free
        link keeps the bare forward tree."""
        return (not self.mirrored) or (self.draft is not None)

    def init(self, rng=None, device="cuda"):
        """Codec params.  Mirrored (no draft): exactly the forward codec's
        params.  Otherwise ``{"fwd": ...[, "bwd": ...][, "draft": ...]}``,
        each from its own copy of ``rng`` at the caller's state, so equal
        specs get bitwise equal key tables."""
        if not self._nested:
            return self.fwd.codec.init(fork_rng(rng), device=device)
        tree = {"fwd": self.fwd.codec.init(fork_rng(rng), device=device)}
        if not self.mirrored:
            tree["bwd"] = self.bwd.codec.init(fork_rng(rng), device=device)
        if self.draft is not None:
            tree["draft"] = self.draft.codec.init(fork_rng(rng), device=device)
        return tree

    def fwd_params(self, params):
        return params["fwd"] if self._nested else params

    def bwd_params(self, params):
        if self.mirrored:
            return self.fwd_params(params)
        return params["bwd"]

    def serving_codec(self, params=None):
        """``(codec, params)`` of the forward channel, what a forward-only
        consumer (the serving engine, where no gradient crosses the cut)
        compresses with; ``params`` follows the link's tree, None stays
        None."""
        return self.fwd.codec, (None if params is None else self.fwd_params(params))

    def draft_params(self, params):
        if self.draft is None:
            raise ValueError("link has no draft channel")
        return params["draft"]

    def spec(self) -> str:
        out = self.fwd.spec()
        if not self.mirrored:
            out = f"{out} {LINK_SEP} {BWD_PREFIX}{self.bwd.spec()}"
        if self.draft is not None:
            out = f"{out} {LINK_SEP} {DRAFT_PREFIX}{self.draft.spec()}"
        return out

    def __repr__(self) -> str:
        return f"SplitLink({self.spec()!r}{', mirrored' if self.mirrored else ''})"

    # ---- controllers -----------------------------------------------------

    def observe(self, fwd_snr=None, bwd_snr=None, loss_slack=None):
        """Feed both direction controllers one step's signals; returns the
        (R_fwd, R_bwd) pair serving the NEXT step.  Mirrored links have ONE
        controller: ``fwd_snr`` drives it and ``bwd_snr`` is ignored."""
        rf = self.fwd.observe(fwd_snr, loss_slack)
        if self.mirrored:
            return rf, rf
        return rf, self.bwd.observe(bwd_snr, loss_slack)

    # ---- fault injection -------------------------------------------------

    def install_faults(self, plan, recovery=None) -> "SplitLink":
        """Install one ``FaultPlan`` on both directions (the channels draw
        independently: their rngs key on the direction tag).  Returns self."""
        self.fwd.install_faults(plan, recovery)
        self.bwd.install_faults(plan, recovery)
        return self

    def next_erasure(self, B: int):
        """Draw both directions' erasure masks for the next step:
        ``{"fwd": keep, "bwd": keep}`` (numpy float32; entries absent on
        clean directions; None when nothing is installed) for
        ``roundtrip``'s ``erasure`` argument once copied to the payload's
        device, plus the retransmission info ``{"fwd": ..., "bwd": ...}``."""
        kf, inf_f = self.fwd.next_erasure(rows=B)
        kb, inf_b = (None, None)
        if not self.mirrored:
            rows = B // self.fwd.current_R
            kb, inf_b = self.bwd.next_erasure(rows=rows)
        if kf is None and kb is None:
            return None, None
        erasure = {}
        if kf is not None:
            erasure["fwd"] = kf
        if kb is not None:
            erasure["bwd"] = kb
        return erasure, {"fwd": inf_f, "bwd": inf_b}

    # ---- accounting ------------------------------------------------------

    def wire_bytes_fwd(self, B: int) -> int:
        """Bytes the forward payload ships for a B-row cut activation."""
        return self.fwd.wire_bytes(B)

    def wire_bytes_bwd(self, B: int) -> int:
        """Bytes the backward (gradient) payload ships.  Mirrored: the
        gradient has the forward's compressed shape (the adjoint of a linear
        codec), so it equals the forward bytes.  Asymmetric: the gradient
        payload's ``B/R_fwd`` rows re-grouped through the backward codec."""
        if self.mirrored:
            return self.fwd.wire_bytes(B)
        rows = B // self.fwd.current_R
        return self.bwd.wire_bytes(rows)

    def wire_bytes_draft(self, B: int) -> int:
        """Bytes one draft-feedback payload ships (the (B, D) cut feature
        through the draft channel's current bucket); 0 without one."""
        if self.draft is None:
            return 0
        return self.draft.wire_bytes(B)

    def total_wire_bytes(self, B: int) -> int:
        return self.wire_bytes_fwd(B) + self.wire_bytes_bwd(B)

    # ---- clamp_R integration --------------------------------------------

    def with_max_R(self, max_R: int) -> "SplitLink":
        """``clamp_R`` entry point: clamp the forward channel to the batch,
        then the backward channel to the SMALLEST gradient-payload row count
        any forward bucket can produce (``max_R / max_R_fwd`` rows), so no
        (R_fwd, R_bwd) pair can hit a divisibility error mid-schedule.  The
        draft channel's payload is the full B-row feature, so it clamps to
        the batch like the forward one."""
        f2 = clamp_R(self.fwd.codec, max_R)
        d2 = (clamp_R(self.draft.codec, max_R)
              if self.draft is not None else None)
        if self.mirrored:
            return SplitLink(f2, draft_codec=d2)
        max_R_f = getattr(f2, "max_R", getattr(f2, "R", 1))
        b2 = clamp_R(self.bwd.codec, max(max_R // max(max_R_f, 1), 1))
        return SplitLink(f2, b2, draft_codec=d2)


def as_link(codec_or_link) -> SplitLink:
    """Wrap a bare codec into a mirrored link (links pass through)."""
    if isinstance(codec_or_link, SplitLink):
        return codec_or_link
    return SplitLink(codec_or_link)


def build_link(spec: str, /, **defaults) -> SplitLink:
    """Build a ``SplitLink`` from a link spec (all segments share the
    keyword ``defaults``, e.g. the runtime ``D``)."""
    fwd_spec, bwd_spec, draft_spec = parse_link_spec(spec)
    fwd_codec = codecs.build(fwd_spec, **defaults)
    bwd_codec = (codecs.build(bwd_spec, **defaults)
                 if bwd_spec is not None else None)
    draft_codec = (codecs.build(draft_spec, **defaults)
                   if draft_spec is not None else None)
    return SplitLink(fwd_codec, bwd_codec, draft_codec)


def build_link_or_codec(spec: str, /, *, quant_bits=None, **defaults):
    """The one spec dispatcher the CLIs share: a ``... >> bwd:...`` spec
    builds a ``SplitLink``, anything else a plain codec through the
    registry.  The legacy ``quant_bits=8`` flag appends the int8 wire stage
    to plain specs only; a link spec names its wire stages per direction.
    """
    if is_link_spec(spec):
        if quant_bits is not None:
            raise ValueError(
                "the quant flag composes only with single-codec specs; put "
                "the wire stage in the link spec itself, e.g. "
                "'c3sl:R=8|int8 >> bwd:c3sl:R=4|int8'")
        return build_link(spec, **defaults)
    return codecs.build(codecs.apply_quant_bits(spec, quant_bits), **defaults)


# --------------------------------------------------------------------------
# the round-trip seam (shared by the loss builders)
# --------------------------------------------------------------------------

def roundtrip(codec, params, Zf, *, with_snr: bool = False, bwd_probe=None,
              erasure=None):
    """Round-trip flat (B, D) cut features through a STATIC codec or a
    STATIC ``SplitLink`` (adaptive channels already resolved to buckets).

    Bare codecs and mirrored links encode then decode; an asymmetric link
    inserts the gradient seam on the payload, so the forward numbers are
    IDENTICAL to mirrored and only the backward pass changes.  ``with_snr``
    adds the forward retrieval SNR; ``bwd_probe`` is the gradient-SNR tap
    (see ``grad_roundtrip``).

    ``erasure`` injects payload loss: ``{"fwd": keep}`` (and, for an
    asymmetric link, ``"bwd": keep``), keep tensors shaped like each
    direction's payload (1.0 kept / 0.0 erased) on the payload's device.
    The decode renormalizes over survivors (``decode_masked``) and
    ``with_snr`` reports the erasure-DEGRADED retrieval SNR, which is what
    the adaptive controller should observe.  ``erasure=None`` is the
    fault-free path.
    """
    fwd_keep = erasure.get("fwd") if erasure else None
    bwd_keep = erasure.get("bwd") if erasure else None
    if isinstance(codec, SplitLink):
        fwd_c = codec.fwd.codec
        fwd_p = codec.fwd_params(params)
        payload = fwd_c.encode(fwd_p, Zf)
        if not codec.mirrored:
            payload = grad_roundtrip(codec.bwd.codec, payload,
                                     codec.bwd_params(params), bwd_probe,
                                     keep=bwd_keep)
        if fwd_keep is None:
            Zhat = fwd_c.decode(fwd_p, payload)
        else:
            Zhat = masked_decode(fwd_c, fwd_p, payload, fwd_keep)
    else:
        payload = codec.encode(params, Zf)
        if fwd_keep is None:
            Zhat = codec.decode(params, payload)
        else:
            Zhat = masked_decode(codec, params, payload, fwd_keep)
    if with_snr:
        return Zhat, hrr.retrieval_snr(Zf, Zhat)
    return Zhat


# --------------------------------------------------------------------------
# per-direction step tables (host-side schedule switching)
# --------------------------------------------------------------------------

def link_program_key(codec_or_link):
    """Host-side dispatch key for the next step callable.  Links key by the
    (fwd, bwd) bucket pair, ``(R_fwd, None)`` when mirrored or the backward
    channel is static; bare codecs keep the scalar key."""
    if isinstance(codec_or_link, SplitLink):
        link = codec_or_link
        bwd_key = None if link.mirrored else link.bwd.program_key()
        return (link.fwd.program_key(), bwd_key)
    return codecs.program_key(codec_or_link)


def _static_pair(link: SplitLink, params, kf, kb):
    """Resolve one (fwd bucket, bwd bucket) pair to a static link+params.
    The draft channel is not on the fwd/bwd numeric path (it never enters
    ``roundtrip``), so static pairs drop it."""
    fwd_c = link.fwd.codec.buckets[kf] if kf is not None else link.fwd.codec
    if link.mirrored:
        static = SplitLink(fwd_c)
        p = (None if params is None
             else link.fwd.params_for(link.fwd_params(params), kf))
        return static, p
    bwd_c = link.bwd.codec.buckets[kb] if kb is not None else link.bwd.codec
    static = SplitLink(fwd_c, bwd_c)
    if params is None:
        return static, None
    return static, {"fwd": link.fwd.params_for(link.fwd_params(params), kf),
                    "bwd": link.bwd.params_for(link.bwd_params(params), kb)}


def build_link_program_table(codec_or_link, params, make):
    """One step-callable entry per schedulable (R_fwd, R_bwd) pair.

    ``make(static_codec_or_link, static_params)`` builds the caller's step
    for ONE static configuration.  Bare codecs defer to
    ``repro_torch.codecs.build_program_table``; links build the cross
    product of the two channels' ladders, ``make`` called once per pair,
    indexed by :func:`link_program_key` at dispatch time.
    """
    if not isinstance(codec_or_link, SplitLink):
        return codecs.build_program_table(codec_or_link, params, make)
    link = codec_or_link
    fwd_keys = (link.fwd.codec.ladder
                if isinstance(link.fwd.codec, AdaptiveC3SL) else (None,))
    bwd_keys = ((None,) if link.mirrored else
                (link.bwd.codec.ladder
                 if isinstance(link.bwd.codec, AdaptiveC3SL) else (None,)))
    table = {}
    for kf in fwd_keys:
        for kb in bwd_keys:
            static, p = _static_pair(link, params, kf, kb)
            table[(kf, kb)] = make(static, p)
    return table


def pin_link(link: SplitLink) -> SplitLink:
    """Freeze both channels at their CURRENT buckets; returns the static
    link (pair with :func:`slice_link_params` for the matching params)."""
    kf = link.fwd.program_key()
    kb = None if link.mirrored else link.bwd.program_key()
    static, _ = _static_pair(link, None, kf, kb)
    return static


def slice_link_params(link: SplitLink, params):
    """Current-bucket params matching :func:`pin_link`'s static link."""
    if link.mirrored:
        return link.fwd.params_for(link.fwd_params(params))
    return {"fwd": link.fwd.params_for(link.fwd_params(params)),
            "bwd": link.bwd.params_for(link.bwd_params(params))}
