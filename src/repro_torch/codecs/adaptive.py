"""Adaptive-R wrapper codec: SNR-driven batch-wise compression scheduling.

Port of ``repro/codecs/adaptive.py``.  C3-SL's cross-talk grows ~sqrt(R-1)
(``repro_torch.core.hrr``), so a fixed grouping factor R either wastes
bandwidth (R too small) or bleeds accuracy (R too large) depending on where
training is.  ``AdaptiveC3SL`` wraps any R-bearing transform codec (or a
``Chain`` ending in wire stages) and picks R each step from a bucketed
ladder {min_R, 2*min_R, ..., max_R}, driven by an EMA of the measured
retrieval SNR at the cut layer.

Spec grammar (handled by ``repro_torch.codecs.build``)::

    adaptive:<inner stage>[,<adaptive args>][|<wire stages>]

    build("adaptive:c3sl:R=16,min_R=2,target_snr=12", D=4096)
    build("adaptive:c3sl:R=8,min_R=2|int8", D=256)

The adaptive args (``min_R``, ``target_snr``, ``ema``, ``hysteresis``) are
spliced into the FIRST stage's arg list and extracted before the inner codec
is built; everything else (including later ``|`` wire stages) is the inner
spec.  ``spec()`` round-trips through ``build``.

Dispatch: the wrapper pre-builds ONE static inner codec per bucket, and a
caller builds one step callable per bucket with :func:`build_program_table`
(``make`` runs once per bucket, never again) and indexes it with
:func:`program_key` on the host at every step.  The reference's contract is
"zero recompiles after warm-up"; the port runs eagerly, so it becomes "one
step callable per bucket, made once".  The wrapper's own encode/decode
delegate to whatever bucket is current at the call.

The controller is host-side and simple: a deadband ladder walk.  SNR is
non-increasing in R (in expectation), so "EMA above target + hysteresis"
means head-room for one more doubling of R, "below target - hysteresis"
means back off.  An optional ``loss_slack`` signal (positive = loss better
than budget) vetoes ramp-ups and forces ramp-downs when negative.  Its
floats follow the reference's arithmetic, so a sequence of observations
gives the reference's R trajectory exactly.
"""
from __future__ import annotations

from repro_torch.codecs.base import (CodecSpec, _format_value, build, clamp_R,
                                     fork_rng, parse_spec)

#: adaptive args recognized in the first spec stage (everything else is the
#: inner codec's), with their defaults.  Order is the canonical emission order.
_ADAPTIVE_DEFAULTS = {
    "min_R": 1,           # smallest bucket (ladder doubles up to inner R)
    "target_snr": 0.0,    # retrieval-SNR setpoint, dB
    "ema": 0.9,           # EMA coefficient on the observed SNR
    "hysteresis": 1.0,    # deadband around the setpoint, dB
}


def bucket_key(R: int) -> str:
    """Params-tree key of one bucket's codec params."""
    return f"R{R}"


class AdaptiveC3SL:
    """Codec-protocol wrapper that schedules R over a bucketed ladder.

    ``inner`` is the max-R codec (a bare transform or a ``Chain``); every
    smaller bucket is pre-built at construction with ``clamp_R`` so chained
    specs (e.g. ``c3sl:R=16|int8``) rebuild correctly.  The accounting
    surface (``flops``/``wire_bytes``/``payload_shape``) reports the CURRENT
    bucket; ``param_count`` reports every resident bucket's params (all key
    tables live in memory at once, the price of switching without a
    rebuild).
    """

    def __init__(self, inner, min_R: int = 1, target_snr: float = 0.0,
                 ema: float = 0.9, hysteresis: float = 1.0):
        max_R = getattr(inner, "R", None)
        if not isinstance(max_R, int) or max_R < 1:
            raise ValueError(
                f"adaptive needs an inner codec with an integer R >= 1, got "
                f"{inner!r}")
        if not 1 <= min_R <= max_R:
            raise ValueError(f"min_R={min_R} must be in [1, max_R={max_R}]")
        ratio = max_R // min_R
        if min_R * ratio != max_R or ratio & (ratio - 1):
            raise ValueError(
                f"bucket ladder doubles from min_R to max_R: max_R/min_R "
                f"must be a power of two, got {max_R}/{min_R}")
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        if hysteresis < 0.0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.inner = inner
        self.min_R = min_R
        self.max_R = max_R
        self.target_snr = float(target_snr)
        self.ema = float(ema)
        self.hysteresis = float(hysteresis)
        self.ladder: tuple[int, ...] = tuple(
            min_R * 2 ** i for i in range((ratio).bit_length()))
        # one pre-built static codec per bucket; clamp_R rebuilds chained
        # specs, the max bucket is `inner`
        self.buckets = {R: (inner if R == max_R else clamp_R(inner, R))
                        for R in self.ladder}
        self._R = min_R               # start conservative, ramp up on headroom
        self._pinned: int | None = None
        self._ema_snr: float | None = None

    # ---- controller ------------------------------------------------------

    @property
    def current_R(self) -> int:
        return self._R

    @property
    def current(self):
        """The currently selected bucket codec."""
        return self.buckets[self._R]

    @property
    def ema_snr(self) -> float | None:
        return self._ema_snr

    def pin(self, R: int) -> "AdaptiveC3SL":
        """Fix the schedule to a constant R (e.g. for equivalence tests or an
        externally driven controller).  Returns self for chaining."""
        if R not in self.buckets:
            raise ValueError(f"R={R} not in bucket ladder {self.ladder}")
        self._pinned = self._R = R
        return self

    def unpin(self) -> "AdaptiveC3SL":
        self._pinned = None
        return self

    def observe(self, snr_db=None, loss_slack=None) -> int:
        """Feed the controller one step's signals; returns the R to use NEXT.

        ``snr_db`` — measured retrieval SNR at the cut layer (a number on
        the host; see ``repro_torch.core.hrr.retrieval_snr``), folded into
        the EMA.  ``loss_slack`` — optional task-loss budget signal:
        negative (loss over budget) forces a ramp-down and positive is
        required for a ramp-up when provided.
        """
        if snr_db is not None:
            snr = float(snr_db)
            self._ema_snr = (snr if self._ema_snr is None
                             else self.ema * self._ema_snr
                             + (1.0 - self.ema) * snr)
        if self._pinned is not None:
            return self._R
        i = self.ladder.index(self._R)
        if loss_slack is not None and loss_slack < 0.0:
            self._R = self.ladder[max(i - 1, 0)]
        elif self._ema_snr is not None:
            if (self._ema_snr > self.target_snr + self.hysteresis
                    and i + 1 < len(self.ladder)
                    and (loss_slack is None or loss_slack > 0.0)):
                self._R = self.ladder[i + 1]
            elif (self._ema_snr < self.target_snr - self.hysteresis
                    and i > 0):
                self._R = self.ladder[i - 1]
        return self._R

    # ---- codec protocol (delegates to the CURRENT bucket) ----------------

    @property
    def feature_layout(self) -> str:
        return self.inner.feature_layout

    @property
    def R(self) -> int:
        return self._R

    @property
    def D(self) -> int:
        return self.inner.D

    @property
    def stages(self):
        """Wire stages of the current bucket (so shape-based accounting like
        ``payload_wire_bytes`` sees the chain through the wrapper)."""
        return getattr(self.current, "stages", ())

    def init(self, rng=None, device="cuda"):
        """Params for EVERY bucket, keyed ``R<k>``.  Each bucket inits from
        its own copy of ``rng`` at the caller's state, so bucket k's params
        are bitwise the static ``c3sl:R=k`` codec's initialised with that
        generator (the reference feeds every bucket the same jax key)."""
        return {bucket_key(R): c.init(fork_rng(rng), device=device)
                for R, c in self.buckets.items()}

    def params_for(self, params, R: int | None = None):
        """Slice one bucket's params out of the ``init`` tree."""
        return params[bucket_key(self._R if R is None else R)]

    def encode(self, params, Z):
        return self.current.encode(self.params_for(params), Z)

    def decode(self, params, payload):
        return self.current.decode(self.params_for(params), payload)

    def decode_masked(self, params, payload, keep):
        return self.current.decode_masked(self.params_for(params),
                                          payload, keep)

    def param_count(self) -> int:
        return sum(c.param_count() for c in self.buckets.values())

    def flops(self, B: int) -> int:
        return self.current.flops(B)

    def wire_bytes(self, B: int) -> int:
        return self.current.wire_bytes(B)

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return self.current.payload_shape(B)

    def spec(self) -> str:
        inner_stages = self.inner.spec().split("|")
        extra = ",".join(
            f"{k}={_format_value(getattr(self, k))}"
            for k, default in _ADAPTIVE_DEFAULTS.items()
            if getattr(self, k) != default)
        head = inner_stages[0]
        if extra:
            head = head + ("," if ":" in head else ":") + extra
        return "adaptive:" + "|".join([head] + inner_stages[1:])

    def __repr__(self) -> str:
        return (f"AdaptiveC3SL({self.spec()!r}, ladder={self.ladder}, "
                f"current_R={self._R}"
                f"{', pinned' if self._pinned is not None else ''})")

    # ---- clamp_R integration --------------------------------------------

    def with_max_R(self, max_R: int) -> "AdaptiveC3SL":
        """``clamp_R`` entry point: shrink the ladder to buckets that FIT
        ``max_R``.

        Callers pass the runtime batch / slot count as ``max_R``, and
        batch-wise grouping needs ``max_R % R == 0``, so a bucket fits only
        if it DIVIDES max_R (batch 12 must drop the R=8 bucket, or the
        controller would ramp into a shape error mid-training).  The
        surviving buckets keep the power-of-two ladder valid; if none fit,
        the ladder collapses to the single clamped bucket max_R."""
        if self.max_R <= max_R and all(max_R % r == 0 for r in self.ladder):
            return self
        cands = [r for r in self.ladder if r <= max_R and max_R % r == 0]
        # any surviving cand is a power-of-two multiple of min_R that divides
        # max_R, so min_R itself survives too and the ladder stays valid; an
        # empty cands collapses to the single bucket max_R (min == max)
        new_max = max(cands) if cands else max(max_R, 1)
        new_min = self.min_R if cands else new_max
        return AdaptiveC3SL(clamp_R(self.inner, new_max), min_R=new_min,
                            target_snr=self.target_snr, ema=self.ema,
                            hysteresis=self.hysteresis)


def build_adaptive(spec: str, /, **defaults) -> AdaptiveC3SL:
    """Build an ``AdaptiveC3SL`` from an ``adaptive:...`` spec string.

    The text after ``adaptive:`` is parsed as a normal spec; adaptive args
    are extracted from the first stage and the remainder builds the inner
    (max-R) codec through the registry, so defaults like ``D=...`` flow
    through, and later ``|`` stages become the inner ``Chain``'s wire
    formats.  ``defaults`` may also carry adaptive args a spec omits
    (explicit spec args win).
    """
    name, sep, body = spec.strip().partition(":")
    if name != "adaptive":
        raise ValueError(f"not an adaptive spec: {spec!r}")
    if not sep or not body.strip():
        raise ValueError(
            "adaptive needs an inner codec spec, e.g. "
            "'adaptive:c3sl:R=16,min_R=2,target_snr=12'")
    stages = parse_spec(body)
    head_args = dict(stages[0].args)
    kwargs = {k: head_args.pop(k) for k in list(head_args)
              if k in _ADAPTIVE_DEFAULTS}
    for k in _ADAPTIVE_DEFAULTS:
        if k not in kwargs and defaults.get(k) is not None:
            kwargs[k] = defaults[k]
    inner_spec = "|".join(
        str(s) for s in [CodecSpec(stages[0].name, head_args)] + stages[1:])
    inner_defaults = {k: v for k, v in defaults.items()
                      if k not in _ADAPTIVE_DEFAULTS}
    return AdaptiveC3SL(build(inner_spec, **inner_defaults), **kwargs)


def program_key(codec):
    """The host-side dispatch key for the NEXT step: the adaptive codec's
    current R bucket, or None for a static (or absent) codec.  Pair with
    :func:`build_program_table`."""
    return codec.current_R if isinstance(codec, AdaptiveC3SL) else None


def build_program_table(codec, codec_params, make):
    """One step-callable entry per schedulable bucket.

    ``make(codec, codec_params)`` builds whatever the caller runs for a
    SINGLE static codec (a step function, a dict of programs, ...).  For an
    ``AdaptiveC3SL`` the table maps every ladder bucket's R to
    ``make(bucket, bucket_params)``, each called exactly once here; for a
    static codec (or None) the table is the single entry
    ``{None: make(codec, codec_params)}``.  Index the result with
    :func:`program_key` at dispatch time: the wrapper itself never goes into
    a step callable.
    """
    if isinstance(codec, AdaptiveC3SL):
        return {R: make(codec.buckets[R],
                        codec.params_for(codec_params, R)
                        if codec_params is not None else None)
                for R in codec.ladder}
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
