"""Public ops over the hand-written kernels (port of ``repro/kernels/ops.py``):
autograd wrappers over the circconv kernels, and the paged-attention decode
dispatch.

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


# ---------------------------------------------------------------------------
# Paged-attention decode (repro_torch.kernels.paged_attention)
# ---------------------------------------------------------------------------

def paged_attention_decode(q, cache, table, pos, *, length: int,
                           sliding_window=None, compute_dtype=None):
    """Decode-step attention over paged KV pools, page-table walk in-kernel.

    ``q`` (B, 1, H, hd) post-rope; ``cache`` the attn sublayer's pool dict
    ({"k", "v"} float pools, plus {"k_scale", "v_scale"} when int8-
    quantized); ``table`` (B, P) int32 page table; ``pos`` (B,) int32
    per-slot positions.  Returns (B, 1, H*hd).  Inference-only: decode
    never differentiates through the cache read, so there is no autograd
    Function.  Quantized vs float dispatch mirrors ``apply_gqa_decode``'s
    ``"k_scale" in cache`` seam.
    """
    from repro_torch.kernels import paged_attention as pa
    if "k_scale" in cache:
        return pa.paged_attention_quant(
            q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            table, pos, length=length, sliding_window=sliding_window,
            compute_dtype=compute_dtype)
    return pa.paged_attention(q, cache["k"], cache["v"], table, pos,
                              length=length, sliding_window=sliding_window)
