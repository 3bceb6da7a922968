"""Plain torch oracles for the HRR kernels (port of ``repro/kernels/ref.py``).

Exact O(D^2) gather-based circular convolution / correlation, plus the
grouped encode/decode used by C3-SL.  Both operands are promoted to a
common dtype first (float32 keys with bfloat16 data sum in float32, with
float64 data in float64): the kernels' plain versions, the ``direct`` HRR
backend and the tests all run this one contraction.
"""
from __future__ import annotations

import torch


# Past CHUNK_D points the contraction runs in chunks of output positions,
# each gathering at most CHUNK_BYTES (the whole (D, D) gather would take
# D^2 words a leading row: 34 GB of indices alone at D = 65536).  The chunks
# compute the same sums; at D <= CHUNK_D nothing changes.
CHUNK_D = 16384
CHUNK_BYTES = 1 << 28


def _gather_contract(a: torch.Tensor, b: torch.Tensor, sign: int):
    """sum_j a[..., (sign * (d - j)) mod D] b[..., j] for every d."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    D = b.shape[-1]
    d = torch.arange(D, device=b.device)
    if D <= CHUNK_D:
        idx = (sign * (d[:, None] - d[None, :])) % D
        return torch.einsum("...dj,...j->...d", a[..., idx], b)
    lead = max(a[..., 0].numel(), b[..., 0].numel())
    step = max(1, CHUNK_BYTES // (D * max(lead * a.element_size(), 8)))
    return torch.cat([
        torch.einsum("...dj,...j->...d",
                     a[..., (sign * (d[d0:d0 + step, None] - d[None, :])) % D], b)
        for d0 in range(0, D, step)], dim=-1)


def circ_conv_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a (*) b)[d] = sum_j a[j] b[(d-j) mod D], last axis, exact."""
    return _gather_contract(a, b, 1)


def circ_corr_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a (.) b)[d] = sum_j a[j] b[(d+j) mod D], last axis, exact.

    Rewritten as sum_m a[(m-d) mod D] b[m] so the gather runs over `a`.
    """
    return _gather_contract(a, b, -1)


def bind_superpose_ref(Z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Z (G, R, D), K (R, D) -> S (G, D): S_g = sum_i K_i (*) Z_gi."""
    return circ_conv_ref(K, Z).sum(dim=-2)


def unbind_ref(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """S (G, D), K (R, D) -> Zhat (G, R, D): Zhat_gi = K_i (.) S_g."""
    return circ_corr_ref(K, S[..., None, :])
