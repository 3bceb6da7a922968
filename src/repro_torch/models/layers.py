"""Shared neural-net building blocks (pure functions, explicit params).

Port of ``repro/models/layers.py``: the initializers take a
``torch.Generator`` (the draws land on the generator's device, so a
generator on the card makes the weights there) or a :class:`MetaRng` (empty
``meta`` leaves, nothing drawn), and the norms, RoPE and the cross-entropy
compute in float32 as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.constraints import whole_inner


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class MetaRng:
    """What the initializers take in place of a ``torch.Generator`` on the
    ``meta`` device, which has none: they draw nothing and make empty meta
    leaves with the shapes, dtypes and tree a real init makes (the dry
    run's abstract params, which allocate nothing)."""
    device = torch.device("meta")


def _normal(rng: torch.Generator, shape, scale: float, dtype):
    if rng.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=rng, device=rng.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(rng: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               *, lead: tuple = ()):
    """(d_in, d_out) weights ~ N(0, 1/d_in); ``lead`` prepends stacked axes
    (the superblock axis of a stacked layer)."""
    return _normal(rng, (*lead, d_in, d_out), d_in ** -0.5, dtype)


def embed_init(rng: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return _normal(rng, (vocab, d), d ** -0.5, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(rng: torch.Generator, d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.float32, *, lead: tuple = ()):
    p = {"w_up": dense_init(rng, d_model, d_ff, dtype, lead=lead),
         "w_down": dense_init(rng, d_ff, d_model, dtype, lead=lead)}
    if gated:
        p["w_gate"] = dense_init(rng, d_model, d_ff, dtype, lead=lead)
    return p


def promote(*ts: torch.Tensor) -> tuple:
    """The tensors cast to their common dtype, as JAX promotes a mixed
    product: a float32 residual stream through bfloat16 weights computes in
    float32 (a bfloat16 model served past its float32 cache reads)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's dtype promotion (see :func:`promote`)."""
    x, w = promote(x, w)
    return x @ w


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # over a mesh the hidden's partial sums are reduced before the
    # activation (the first dense superblock's weights take the experts'
    # rules, split over d_model), which DTensor would resolve by splitting
    # the sequence
    up = whole_inner(matmul(x, p["w_up"]))
    if "w_gate" in p:
        up = F.silu(whole_inner(matmul(x, p["w_gate"]))) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return matmul(up, p["w_down"])


# ---------------------------------------------------------------------------
# RoPE (full / partial / GLM "2d" = partial-0.5)
# ---------------------------------------------------------------------------

def rope_frequencies(rotary_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / rotary_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S). Rotates the first rotary_dim dims."""
    if rotary_dim == 0:
        return x
    dt = x.dtype
    freqs = rope_frequencies(rotary_dim, theta, x.device)      # (rot/2,)
    angles = positions[..., :, None].float() * freqs             # (..., S, rot/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if x_pass.shape[-1]:
        return torch.cat([out.to(dt), x_pass], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (..., V), labels (...) int: mean CE over unmasked positions.

    The reference picks the label's logit with a one-hot einsum (it
    partitions under a vocab-sharded head); a gather computes the same
    value without the (tokens, V) one-hot, 0.84 GB at deepseek-7b's
    vocabulary and 2,048 tokens.
    """
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted.float()), dim=-1))
    picked = torch.gather(shifted, -1, labels.long()[..., None])[..., 0].float()
    ll = picked - lse
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
