"""Autograd wrappers over the circconv kernels (port of ``repro/kernels/ops.py``).

Adds the doubled-key layout and the backward passes.  The codec is linear
in its data, and its adjoints are again HRR ops with the SAME keys:

    d/dZ of bind_superpose  == unbind         (correlate the upstream grad)
    d/dS of unbind          == bind_superpose (bind+superpose the upstream grad)

so each kernel's backward is the other kernel: the cut-layer gradient
crosses back compressed with no extra machinery.  Keys are constants and
take no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import circconv


def _kext(K: torch.Tensor) -> torch.Tensor:
    """Doubled keys [K || K] (R, 2D), float32, as the kernels read them."""
    K = K.detach().float()
    return torch.cat([K, K], dim=-1).contiguous()


class _BindSuperpose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, K):
        kext = _kext(K)
        ctx.save_for_backward(kext)
        return circconv.bind_superpose_kernel(Z.contiguous(), kext)

    @staticmethod
    def backward(ctx, dS):
        (kext,) = ctx.saved_tensors
        return circconv.unbind_kernel(dS.contiguous(), kext), None


class _Unbind(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, K):
        kext = _kext(K)
        ctx.save_for_backward(kext)
        return circconv.unbind_kernel(S.contiguous(), kext)

    @staticmethod
    def backward(ctx, dZhat):
        (kext,) = ctx.saved_tensors
        return circconv.bind_superpose_kernel(dZhat.contiguous(), kext), None


def bind_superpose_pallas(Z: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Z (G, R, D), K (R, D) -> S (G, D) through the bind kernel."""
    return _BindSuperpose.apply(Z, K.detach())


def unbind_pallas(S: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """S (G, D), K (R, D) -> Zhat (G, R, D) through the unbind kernel."""
    return _Unbind.apply(S, K.detach())
