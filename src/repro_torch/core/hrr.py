"""Holographic Reduced Representation (HRR) primitives for C3-SL.

Port of ``repro/core/hrr.py``.  Conventions (Plate 1995):
    circular convolution  (a (*) b)[d] = sum_j a[j] * b[(d - j) mod D]
    circular correlation  (a (.) b)[d] = sum_j a[j] * b[(d + j) mod D]

In the Fourier domain:  F(a (*) b) = F(a) . F(b),   F(a (.) b) = conj(F(a)) . F(b)

C3-SL encoder:  S^g = sum_i  K_i (*) Z_i^g          (bind + superpose)
C3-SL decoder:  Zhat_i^g = K_i (.) S^g              (unbind)

Keys K_i ~ N(0, 1/D), unit-normalized, FIXED (never trained): every op here
detaches them.  Three backends: ``fft`` (O(D log D), torch.fft), ``direct``
(the O(D^2) gather contraction of ``kernels.ref``) and ``pallas`` (the
hand-written CUDA kernels of ``repro_torch.kernels``; the spec token keeps
the reference's name).  ``pallas`` on a CUDA tensor always launches a kernel,
for any D (the FFT-form one or the direct one, by ``circconv.route(D)``):
unlike the TPU kernel it needs no aligned D, so there is no reroute to the
fft backend.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def project_keys(k: torch.Tensor, unitary: bool = False) -> torch.Tensor:
    """Raw key draws (R, D) -> keys: optionally projected to unit spectral
    magnitude (|F(K)_f| = 1 for all f), then unit-normalized, in float32."""
    k = k.float()
    if unitary:
        F = torch.fft.fft(k, dim=-1)
        F = F / torch.clamp(F.abs(), min=1e-12)
        k = torch.fft.ifft(F, dim=-1).real
    return k / torch.linalg.vector_norm(k, dim=-1, keepdim=True)


def generate_keys(rng: torch.Generator, R: int, D: int, dtype=torch.float32,
                  unitary: bool = False, device="cuda") -> torch.Tensor:
    """R fixed random keys, each D-dim, ~N(0, 1/D) then unit-normalized.

    unitary=False is the paper-faithful sampler.  Its retrieval noise has two
    parts (Eq. 4): self-noise from |F(K)|^2 ~ Exp(1) spectral jitter (~1.0
    relative) plus cross-talk (~sqrt(R-1) relative); training through the
    codec absorbs it.

    unitary=True (beyond the paper) projects each key to unit spectral
    magnitude: binding becomes an exact rotation, self-retrieval is EXACT
    and only the sqrt(R-1) cross-talk remains, at the same cost.

    ``rng`` is a CPU ``torch.Generator``: the draw is made on the CPU and
    moved to ``device``, so a seed gives the same keys on every device.  On
    ``meta`` nothing is drawn (the dry run's abstract keys).
    """
    if torch.device(device).type == "meta":
        return torch.empty((R, D), dtype=dtype, device="meta")
    k = torch.randn((R, D), generator=rng, dtype=torch.float32) * (D ** -0.5)
    return project_keys(k, unitary).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Pairwise circular convolution / correlation along the last axis (leading
# dims broadcast).  The fft forms transform in float32 and return the
# operands' promoted dtype, as the reference's do; the direct forms are the
# exact O(D^2) contraction of ``kernels.ref``.
# --------------------------------------------------------------------------

def _fft_pair(a: torch.Tensor, b: torch.Tensor, conj: bool) -> torch.Tensor:
    D = b.shape[-1]
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    fa = torch.fft.rfft(a.float(), dim=-1)
    fb = torch.fft.rfft(b.float(), dim=-1)
    prod = (fa.conj() if conj else fa) * fb
    return torch.fft.irfft(prod, n=D, dim=-1).to(out_dtype)


def circ_conv_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution along the last axis (leading dims broadcast)."""
    return _fft_pair(a, b, conj=False)


def circ_corr_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation along the last axis (leading dims broadcast)."""
    return _fft_pair(a, b, conj=True)


def circ_conv_direct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution by the O(D^2) gather contraction."""
    return kref.circ_conv_ref(a, b)


def circ_corr_direct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation by the O(D^2) gather contraction."""
    return kref.circ_corr_ref(a, b)


# --------------------------------------------------------------------------
# Grouped encode / decode (the paper's Algorithm 1 inner loop, vectorized)
# --------------------------------------------------------------------------

def key_spectrum(K: torch.Tensor) -> torch.Tensor:
    """rfft(K) along the last axis: precompute once at codec init and pass
    as ``K_fft`` so the fft backend never re-transforms the fixed keys."""
    return torch.fft.rfft(K.float(), dim=-1)


def _bind_impl(Z, K, KF, backend):
    if backend == "fft":
        # superpose in the Fourier domain: S = irfft(sum_i F(K_i) . F(Z_i)),
        # one irfft of (..., D) instead of R of them
        D = Z.shape[-1]
        fk = KF if KF is not None else key_spectrum(K)
        fz = torch.fft.rfft(Z.float(), dim=-1)
        return torch.fft.irfft((fk * fz).sum(dim=-2), n=D, dim=-1).to(Z.dtype)
    if backend == "direct":
        return kref.bind_superpose_ref(Z, K)
    raise ValueError(f"unknown backend {backend!r}")


def _unbind_impl(S, K, KF, backend):
    if backend == "fft":
        D = S.shape[-1]
        fk = KF if KF is not None else key_spectrum(K)
        fs = torch.fft.rfft(S.float(), dim=-1)
        prod = fk.conj() * fs[..., None, :]
        return torch.fft.irfft(prod, n=D, dim=-1).to(S.dtype)
    if backend == "direct":
        return kref.unbind_ref(S, K)
    raise ValueError(f"unknown backend {backend!r}")


# Custom backward passes: the codec is linear and its adjoints are again HRR
# ops with the same keys (adjoint of bind = unbind, and vice versa), which
# makes the compressed-gradient property explicit.

class _BindFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, K, KF, backend):
        ctx.backend = backend
        ctx.save_for_backward(K, KF)
        return _bind_impl(Z, K, KF, backend)

    @staticmethod
    def backward(ctx, dS):
        K, KF = ctx.saved_tensors
        return _unbind_impl(dS, K, KF, ctx.backend), None, None, None


class _UnbindFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, K, KF, backend):
        ctx.backend = backend
        ctx.save_for_backward(K, KF)
        return _unbind_impl(S, K, KF, backend)

    @staticmethod
    def backward(ctx, dZhat):
        K, KF = ctx.saved_tensors
        return _bind_impl(dZhat, K, KF, ctx.backend), None, None, None


def _key_fft(K_fft, backend):
    return K_fft.detach() if (K_fft is not None and backend == "fft") else None


def bind_superpose(Z: torch.Tensor, K: torch.Tensor, backend: str = "fft",
                   K_fft: torch.Tensor | None = None) -> torch.Tensor:
    """Encode a group: Z (..., R, D) + keys K (R, D) -> S (..., D).

    S = sum_i K_i (*) Z_i.  Keys take no gradient (paper Sec. 3.1).
    ``K_fft`` (from :func:`key_spectrum`) skips the keys' rfft in the fft
    backend: forward and backward both transform only activations.
    ``backend="pallas"`` runs the hand-written bind kernel (its plain
    version on a CPU tensor) on Z viewed as (G, R, D).
    """
    K = K.detach()
    if backend == "pallas":
        *lead, R, D = Z.shape
        return kops.bind_superpose_pallas(Z.reshape(-1, R, D), K).reshape(*lead, D)
    return _BindFn.apply(Z, K, _key_fft(K_fft, backend), backend)


def unbind(S: torch.Tensor, K: torch.Tensor, backend: str = "fft",
           K_fft: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a group: S (..., D) + keys K (R, D) -> Zhat (..., R, D).

    Zhat_i = K_i (.) S.  ``K_fft`` and ``backend`` as in :func:`bind_superpose`.
    """
    K = K.detach()
    if backend == "pallas":
        *lead, D = S.shape
        return kops.unbind_pallas(S.reshape(-1, D), K).reshape(*lead, K.shape[0], D)
    return _UnbindFn.apply(S, K, _key_fft(K_fft, backend), backend)


def masked_unbind(S: torch.Tensor, K: torch.Tensor, keep: torch.Tensor,
                  backend: str = "fft",
                  K_fft: torch.Tensor | None = None) -> torch.Tensor:
    """Erasure-aware decode: unbind ``S`` with elements marked 0 in
    ``keep`` treated as LOST, renormalizing each superposition row over
    its surviving elements.

    ``keep`` (same shape as S, 1.0 kept / 0.0 erased) zeroes the lost
    elements before correlation; the per-row scale ``D / #kept`` makes the
    retrieval unbiased under random erasure.  Exact at an all-ones mask:
    ``S * 1.0`` and the scale ``D / D == 1.0`` are IEEE-exact, so the
    result is bitwise ``unbind(S, K)``.
    """
    keep = keep.to(S.dtype)
    D = S.shape[-1]
    kept = keep.sum(dim=-1, keepdim=True)               # (..., 1)
    scale = (float(D) / torch.clamp(kept.float(), min=1.0)).to(S.dtype)
    Zhat = unbind(S * keep, K, backend=backend, K_fft=K_fft)
    # unbind adds the R axis before D: broadcast the per-row scale over it
    return Zhat * scale[..., None, :]


def retrieval_snr(Z: torch.Tensor, Zhat: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio (dB) of HRR retrieval — diagnostics for Eq. 4."""
    sig = torch.sum(Z.float() ** 2)
    err = torch.sum((Z.float() - Zhat.float()) ** 2)
    return 10.0 * torch.log10(sig / torch.clamp(err, min=1e-12))
