"""Mamba (S6) selective state-space block: the training forward and the
O(1) decode step.

Port of ``repro/models/mamba.py``: the same params,
projections, causal depthwise conv and chunked scan.  The reference scans
each chunk with ``jax.lax.associative_scan`` over the recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``; PyTorch has no stable
associative scan, so ``_prefix_scan`` runs the same combine as a
Hillis-Steele prefix scan: ceil(log2(chunk)) whole-chunk steps in float32,
not one launch a time step.  The two trees of products round differently:
they agree within float32 rounding (``tests/test_torch_ssm.py`` states the
tolerance).  As in the reference, each chunk discretises inside itself
and is recomputed in the backward (``torch.utils.checkpoint``), so the
float32 (B, chunk, d_inner, d_state) tensors never exist for the whole
sequence, and its outputs are stored at model precision.

Decode keeps the reference's recurrent state, ``h`` (B, d_inner, d_state)
in float32 and ``conv`` (B, d_conv - 1, d_inner), the last inputs of the
causal conv, and advances it one token a call in the reference's order.
Mixed products promote as JAX does (``layers.matmul``): a float32 state
under bfloat16 weights computes in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import _normal, dense_init, matmul, promote


def init_mamba(rng: torch.Generator, d_model: int, d_inner: int, *,
               d_state: int = 16, d_conv: int = 4, dt_rank: int | None = None,
               dtype=torch.float32, lead: tuple = ()):
    dt_rank = dt_rank or max(d_model // 16, 1)
    dev = rng.device
    A = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=dev))
    return {
        "w_in": dense_init(rng, d_model, 2 * d_inner, dtype, lead=lead),
        "conv_w": _normal(rng, (*lead, d_conv, d_inner), d_conv ** -0.5, dtype),
        "conv_b": torch.zeros((*lead, d_inner), dtype=dtype, device=dev),
        "w_x": dense_init(rng, d_inner, dt_rank + 2 * d_state, dtype, lead=lead),
        "w_dt": dense_init(rng, dt_rank, d_inner, dtype, lead=lead),
        "dt_bias": torch.zeros((*lead, d_inner), dtype=dtype, device=dev),
        "A_log": A.expand(*lead, d_inner, d_state).to(dtype).clone(),
        "D": torch.ones((*lead, d_inner), dtype=dtype, device=dev),
        "w_out": dense_init(rng, d_inner, d_model, dtype, lead=lead),
    }


def _ssm_inputs(p, x_conv, *, d_state: int):
    """x_conv (B, S, di) -> dt, Bmat, Cmat, A."""
    dt_rank = p["w_dt"].shape[0]
    proj = matmul(x_conv, p["w_x"])
    dt_low = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + d_state]
    Cmat = proj[..., dt_rank + d_state:]
    dt = F.softplus(matmul(dt_low, p["w_dt"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                         # (di, ds)
    return dt, Bmat, Cmat, A


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B,S,di), w (K,di)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def _prefix_scan(a, b):
    """Inclusive scan along axis 1 of the reference's combine
    ((a1, b1), (a2, b2)) -> (a1 a2, b1 a2 + b2): at step k each element
    takes the running pair k places back (the identity (1, 0) before the
    start).  Returns (cumulative a, cumulative b)."""
    k = 1
    while k < a.shape[1]:
        a_prev = F.pad(a[:, :-k], (0, 0, 0, 0, k, 0), value=1.0)
        b_prev = F.pad(b[:, :-k], (0, 0, 0, 0, k, 0))
        a, b = a_prev * a, b_prev * a + b
        k *= 2
    return a, b


def _chunk_scan(h0, dt_c, B_c, C_c, x_c, A):
    """One chunk: h0 (B, di, ds) float32 and the chunk's inputs (B, c, .)
    -> (the last state, y (B, c, di) in dt's dtype)."""
    dA = torch.exp(dt_c[..., None].float() * A)                 # (B,c,di,ds)
    dBx = (dt_c * x_c)[..., None].float() * B_c[:, :, None, :].float()
    cumA, s = _prefix_scan(dA, dBx)
    h_all = s + cumA * h0[:, None]                               # (B,c,di,ds)
    y = torch.einsum("bcds,bcs->bcd", h_all, C_c.float())
    return h_all[:, -1], y.to(dt_c.dtype)


def apply_mamba(p, x: torch.Tensor, *, d_state: int = 16,
                chunk: int = 256) -> torch.Tensor:
    """x (B, S, d_model) -> (B, S, d_model), causal."""
    B, S, _ = x.shape
    di = p["w_in"].shape[-1] // 2
    xz = x @ p["w_in"]
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, Bmat, Cmat, A = _ssm_inputs(p, x_conv, d_state=d_state)

    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    h = torch.zeros((B, di, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        args = (h, dt[:, sl], Bmat[:, sl], Cmat[:, sl], x_conv[:, sl], A)
        if torch.is_grad_enabled():
            h, y_c = checkpoint(_chunk_scan, *args, use_reentrant=False)
        else:
            h, y_c = _chunk_scan(*args)
        ys.append(y_c)
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + p["D"] * x_conv
    return (y * F.silu(z)) @ p["w_out"]


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------

def init_mamba_state(batch: int, d_inner: int, *, d_state: int = 16,
                     d_conv: int = 4, dtype=torch.float32, lead: tuple = (),
                     device="cuda"):
    """``lead`` prepends the stacked superblock axis."""
    return {"h": torch.zeros((*lead, batch, d_inner, d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, d_conv - 1, d_inner),
                                dtype=dtype, device=device)}


def apply_mamba_decode(p, x, state, *, d_state: int = 16):
    """One-token step.  x (B, 1, d_model) -> (y (B, 1, d_model), new state);
    ``state`` is read, not written: the caller commits the new one."""
    di = p["w_in"].shape[-1] // 2
    xz = matmul(x[:, 0], p["w_in"])
    x_in, z = xz[..., :di], xz[..., di:]
    window = torch.cat(promote(state["conv"], x_in[:, None, :]), dim=1)  # (B,K,di)
    x_conv = F.silu(torch.einsum("bkd,kd->bd", *promote(window, p["conv_w"]))
                    + p["conv_b"])
    dt, Bmat, Cmat, A = _ssm_inputs(p, x_conv[:, None, :], d_state=d_state)
    dt, Bmat, Cmat = dt[:, 0], Bmat[:, 0], Cmat[:, 0]
    dA = torch.exp(dt[..., None].float() * A)                          # (B,di,ds)
    dBx = (dt * x_conv)[..., None].float() * Bmat[:, None, :].float()
    h = dA * state["h"] + dBx
    y = torch.einsum("bds,bs->bd", h, Cmat.float()).to(x.dtype)
    y = y + p["D"] * x_conv
    out = matmul(y * F.silu(z), p["w_out"])
    return out[:, None, :], {"h": h, "conv": window[:, 1:]}

