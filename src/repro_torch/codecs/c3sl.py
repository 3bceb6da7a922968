"""C3-SL: the paper's batch-wise HRR codec (bind + superpose / unbind).

Port of ``repro/codecs/c3sl.py``.  Pure transform stage; wire formats such
as int8 compose via specs, e.g. ``build("c3sl:R=8|int8", D=4096)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.codecs.base import SpecMixin, register
from repro_torch.core import hrr
from repro_torch.kernels import circconv


@register("c3sl", "hrr")
@dataclasses.dataclass(frozen=True)
class C3SLCodec(SpecMixin):
    """Fixed random keys, bind+superpose R features into one D-vector.

    Z (B, D) is grouped into B/R groups; each group becomes one D-vector.
    Keys are constants (detached inside the HRR ops): param_count is the
    paper's R*D and flops(B) the paper's 2*B*D^2.  The HRR execution backend
    (fft | direct | pallas) is part of the spec; ``pallas`` names the
    hand-written circconv kernel, as in the reference's spec strings.
    """
    R: int
    D: int
    backend: str = "fft"
    unitary: bool = False          # beyond-paper: exact-rotation keys
    key_seed: int = 0

    feature_layout = "flat"

    def __post_init__(self):
        if self.R < 1:
            raise ValueError(f"R must be >= 1, got {self.R}")
        if self.backend not in ("fft", "direct", "pallas"):
            raise ValueError(f"unknown HRR backend {self.backend!r} "
                             "(expected fft | direct | pallas)")

    def init(self, rng: torch.Generator | None = None, device="cuda"):
        """Params ``{"keys"}`` (plus the cached spectrum ``"keys_fft"`` for
        the fft backend); ``rng`` defaults to a CPU generator seeded with
        ``key_seed``."""
        if rng is None:
            rng = torch.Generator().manual_seed(self.key_seed)
        keys = hrr.generate_keys(rng, self.R, self.D, unitary=self.unitary,
                                 device=device)
        params = {"keys": keys}
        if self.backend == "fft":
            # the keys are fixed, so is their spectrum: every encode/decode
            # (and each backward, again an HRR op) transforms activations only
            params["keys_fft"] = hrr.key_spectrum(keys)
        return params

    def _group(self, Z):
        """(..., B, D) -> (G, R, D) groups of R consecutive rows.  Rank-3
        inputs (S, B, D) group WITHIN each leading slice (B % R == 0), so a
        group never straddles two positions of a sequence-grouped payload."""
        *lead, B, D = Z.shape
        if D != self.D:
            raise ValueError(f"feature dim {D} != codec D={self.D}")
        if B % self.R:
            raise ValueError(f"batch {B} not divisible by R={self.R}")
        return Z.reshape(-1, self.R, D)

    def encode(self, params, Z):
        """Z (B, D) -> payload (B/R, D); Z (S, B, D) -> payload (S, B/R, D)."""
        payload = hrr.bind_superpose(self._group(Z), params["keys"],
                                     backend=self.backend,
                                     K_fft=params.get("keys_fft"))
        return payload.reshape(*Z.shape[:-2], Z.shape[-2] // self.R, self.D)

    def decode(self, params, payload):
        Zhat = hrr.unbind(payload.reshape(-1, self.D), params["keys"],
                          backend=self.backend, K_fft=params.get("keys_fft"))
        G, R, D = Zhat.shape
        return Zhat.reshape(*payload.shape[:-2], payload.shape[-2] * R, D)

    def decode_masked(self, params, payload, keep):
        """Erasure-aware decode: ``keep`` (payload-shaped, 1.0 kept / 0.0
        erased) marks the elements that survived the wire; the superposition
        is renormalized over the survivors (``hrr.masked_unbind``).  Bitwise
        identical to :meth:`decode` at an all-ones mask."""
        Zhat = hrr.masked_unbind(payload.reshape(-1, self.D),
                                 params["keys"], keep.reshape(-1, self.D),
                                 backend=self.backend,
                                 K_fft=params.get("keys_fft"))
        G, R, D = Zhat.shape
        return Zhat.reshape(*payload.shape[:-2], payload.shape[-2] * R, D)

    def execution_mode(self, device="cuda") -> str:
        """How this codec's HRR ops run on tensors of ``device`` (unlike
        ``spec()``, which stays the canonical registry string): ``"fft"`` /
        ``"direct"`` for the torch backends; for ``pallas``,
        ``"cuda-kernel"`` on a CUDA device and ``"torch-plain"`` (the
        kernel's plain version) on the CPU."""
        if self.backend != "pallas":
            return self.backend
        return circconv.execution_mode(device)

    def param_count(self) -> int:
        return self.R * self.D  # paper Table 2

    def flops(self, B: int) -> int:
        return 2 * B * self.D ** 2  # paper Table 2 (direct form; FFT is B*D*log D)

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return (B // self.R, self.D)

    def wire_bytes(self, B: int) -> int:
        return (B // self.R) * self.D * 4


def sequence_group_encode(codec, params, Z_bsd: torch.Tensor) -> torch.Tensor:
    """Beyond-paper: group along sequence blocks when batch==1, or per
    position across slots (chunked prefill feeds (C, B, d)).

    Z (B, S, D) with B*S divisible by R -> payload.  When S % R == 0 the
    payload keeps the 3-D sequence-grouped layout (B, S/R, D); otherwise
    groups wrap across the leading axis and the payload is the flat
    (B*S/R, D).  Both are bit-identical row-wise.
    """
    B, S, D = Z_bsd.shape
    R = getattr(codec, "R", 1)
    if (B * S) % R:
        raise ValueError(
            f"batch {B * S} (B={B} x S={S} sequence groups) not divisible "
            f"by R={R}")
    if S % R == 0:
        return codec.encode(params, Z_bsd)               # 3-D (B, S/R, D)
    return codec.encode(params, Z_bsd.reshape(B * S, D))


def sequence_group_decode(codec, params, payload: torch.Tensor,
                          B: int, S: int) -> torch.Tensor:
    return codec.decode(params, payload).reshape(B, S, -1)
