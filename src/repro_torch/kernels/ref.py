"""Plain torch oracles for the HRR kernels (port of ``repro/kernels/ref.py``).

Exact O(D^2) gather-based circular convolution / correlation, plus the
grouped encode/decode used by C3-SL.  Both operands are promoted to a
common dtype first (float32 keys with bfloat16 data sum in float32, with
float64 data in float64): the kernels' plain versions, the ``direct`` HRR
backend and the tests all run this one contraction.
"""
from __future__ import annotations

import torch


def _gather_contract(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    mat = a.to(dt)[..., idx]                           # (..., D, D)
    return torch.einsum("...dj,...j->...d", mat, b.to(dt))


def circ_conv_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a (*) b)[d] = sum_j a[j] b[(d-j) mod D], last axis, exact."""
    D = b.shape[-1]
    d = torch.arange(D, device=b.device)
    return _gather_contract(a, b, (d[:, None] - d[None, :]) % D)


def circ_corr_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a (.) b)[d] = sum_j a[j] b[(d+j) mod D], last axis, exact.

    Rewritten as sum_m a[(m-d) mod D] b[m] so the gather runs over `a`.
    """
    D = b.shape[-1]
    d = torch.arange(D, device=b.device)
    return _gather_contract(a, b, (d[None, :] - d[:, None]) % D)


def bind_superpose_ref(Z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Z (G, R, D), K (R, D) -> S (G, D): S_g = sum_i K_i (*) Z_gi."""
    return circ_conv_ref(K, Z).sum(dim=-2)


def unbind_ref(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """S (G, D), K (R, D) -> Zhat (G, R, D): Zhat_gi = K_i (.) S_g."""
    return circ_corr_ref(K, S[..., None, :])
