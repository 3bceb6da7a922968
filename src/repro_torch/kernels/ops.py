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

from collections import OrderedDict

import torch

from repro_torch.kernels import circconv

KEY_CACHE_SIZE = 16                 # key tensors kept on the card
_KEYS: OrderedDict = OrderedDict()


def _doubled(K: torch.Tensor) -> torch.Tensor:
    K = K.detach().float()
    return torch.cat([K, K], dim=-1).contiguous()


def _kept_keys(K: torch.Tensor, memo: OrderedDict) -> tuple:
    """(Kext, spectra) of key tensor K (``_keys``), kept in ``memo`` while K
    is unchanged: the entry is found by K's storage address, shape, strides,
    dtype and device, holds K (so the storage, and its address, stay taken)
    and its ``_version``, which an in-place write bumps; such a write makes
    both anew.  Writes that bypass autograd's version counter (``.data``,
    DLPack) are not seen.  At most KEY_CACHE_SIZE entries, the least
    recently used dropped."""
    K = K.detach()
    ident = (K.data_ptr(), tuple(K.shape), K.stride(), K.dtype, K.device)
    hit = memo.get(ident)
    if hit is not None and hit[1] == K._version:
        memo.move_to_end(ident)
        return hit[2]
    kext = _doubled(K)
    D = K.shape[-1]
    spectra = (circconv.key_spectra(kext, circconv.plan(D))
               if K.device.type == "cuda" and circconv.route(D) == "fft4" else None)
    memo[ident] = (K, K._version, (kext, spectra))
    while len(memo) > KEY_CACHE_SIZE:
        memo.popitem(last=False)
    return kext, spectra


def _keys(K: torch.Tensor) -> tuple:
    """(Kext, spectra) for the keys K (R, D): the doubled keys [K || K] (R,
    2D), float32, as the kernels read them, and where ``route(D)`` is
    "fft4" the four-step kernels' key spectra (``circconv.key_spectra``),
    else None.  On the card both are kept per key tensor (``_kept_keys``),
    so a codec's fixed keys are transformed once; on the CPU Kext is made
    for the call."""
    if K.device.type != "cuda":
        return _doubled(K), None
    return _kept_keys(K, _KEYS)


def _kext(K: torch.Tensor) -> torch.Tensor:
    """The doubled keys of ``_keys``."""
    return _keys(K)[0]


def clear_key_caches() -> None:
    """Drop the kept Kexts and key spectra and the circconv kernels' kept
    tables, and with them their device memory."""
    _KEYS.clear()
    circconv.clear_caches()


class _BindSuperpose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, K):
        kext, spectra = _keys(K)
        ctx.save_for_backward(kext, spectra)
        return circconv.bind_superpose_kernel(Z.contiguous(), kext, spectra)

    @staticmethod
    def backward(ctx, dS):
        kext, spectra = ctx.saved_tensors
        return circconv.unbind_kernel(dS.contiguous(), kext, spectra), None


class _Unbind(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, K):
        kext, spectra = _keys(K)
        ctx.save_for_backward(kext, spectra)
        return circconv.unbind_kernel(S.contiguous(), kext, spectra)

    @staticmethod
    def backward(ctx, dZhat):
        kext, spectra = ctx.saved_tensors
        return circconv.bind_superpose_kernel(dZhat.contiguous(), kext, spectra), None


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
