"""Trainable bottleneck codecs (the paper's dimension-wise baselines).

Port of ``repro/codecs/bottleneck.py``.

* ``BottleNetPPCodec`` — BottleNet++ (Shao & Zhang 2020), the paper's conv
  autoencoder on (B, C, H, W) cut-layer feature maps
  (``feature_layout = "nchw"``).
* ``DenseBottleneckCodec`` — the same idea for flattened (B, D) features.

Parameters keep the reference's layouts, so they carry across one to one:
the encoder conv is OIHW (C', C, k, k) and the decoder's transposed conv
IOHW (C', C, k, k).  Two places where the libraries differ:

* ``jax.lax.conv_transpose`` (no ``transpose_kernel``) does not flip the
  kernel, while ``F.conv_transpose2d`` (the adjoint of ``conv2d``) does, so
  the decoder passes the weight flipped in both spatial axes;
* the reference's BatchNorm always normalises with the batch statistics
  and the population variance (``correction=0`` here, not torch's default
  unbiased form).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.codecs.base import SpecMixin, register


def _generator(rng):
    return rng if rng is not None else torch.Generator().manual_seed(0)


def _normal(rng, shape, scale, device):
    """N(0, scale^2) drawn on the CPU from ``rng``, then moved to ``device``
    (a seed gives the same weights on every device)."""
    return (torch.randn(shape, generator=rng, dtype=torch.float32)
            * scale).to(device)


@register("dense", "dense-bottleneck")
@dataclasses.dataclass(frozen=True)
class DenseBottleneckCodec(SpecMixin):
    """BottleNet++-style trainable autoencoder on flattened features.

    encoder: Linear(D -> D/R) + sigmoid;  decoder: Linear(D/R -> D) + ReLU.
    """
    R: int
    D: int

    feature_layout = "flat"
    #: params take gradients in normal training (vs C3-SL's fixed keys):
    #: the transport layer's gradient seam, which cannot train codec
    #: params, checks this to fail loudly
    trainable = True

    def __post_init__(self):
        if self.D % self.R:
            raise ValueError("D must be divisible by R")

    @property
    def d_code(self) -> int:
        return self.D // self.R

    def init(self, rng: torch.Generator | None = None, device="cuda"):
        rng = _generator(rng)
        z = lambda n: torch.zeros((n,), device=device)  # noqa: E731
        return {
            "w_enc": _normal(rng, (self.D, self.d_code), self.D ** -0.5, device),
            "b_enc": z(self.d_code),
            "w_dec": _normal(rng, (self.d_code, self.D), self.d_code ** -0.5,
                             device),
            "b_dec": z(self.D),
        }

    def encode(self, params, Z):
        return torch.sigmoid(Z @ params["w_enc"] + params["b_enc"])

    def decode(self, params, payload):
        return torch.relu(payload @ params["w_dec"] + params["b_dec"])

    def param_count(self) -> int:
        return (self.D + 1) * self.d_code + (self.d_code + 1) * self.D

    def flops(self, B: int) -> int:
        return 2 * B * 2 * self.D * self.d_code  # enc + dec matmuls (MAC*2)

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return (B, self.d_code)

    def wire_bytes(self, B: int) -> int:
        return B * self.d_code * 4


def _batchnorm(x: torch.Tensor, scale, bias, eps=1e-5) -> torch.Tensor:
    """Batch statistics over (B, H, W), population variance."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[None, :, None, None] + bias[None, :, None, None]


@register("bnpp", "bottlenetpp")
@dataclasses.dataclass(frozen=True)
class BottleNetPPCodec(SpecMixin):
    """The paper's conv codec on (B, C, H, W) cut-layer feature maps.

    encoder: Conv(k=2, stride=2, C -> C' = 4C/R) + BatchNorm + sigmoid
    decoder: ConvTranspose(k=2, stride=2, C' -> C) + BatchNorm + ReLU
    (channel-condition layers removed, as in C3-SL Sec. 4.1).

    Total compression R = (C*H*W) / (C'*(H/2)*(W/2)) = 4C/C'  =>  C' = 4C/R.
    param_count() and flops(B) implement C3-SL Table 2's formulas verbatim.
    """
    R: int
    C: int
    H: int
    W: int
    k: int = 2  # kernel size and stride, per C3-SL Sec. 4.1

    feature_layout = "nchw"
    trainable = True  # see DenseBottleneckCodec

    def __post_init__(self):
        if (4 * self.C) % self.R:
            raise ValueError("4C must be divisible by R")

    @property
    def c_code(self) -> int:
        return 4 * self.C // self.R

    @property
    def D(self) -> int:
        return self.C * self.H * self.W

    def init(self, rng: torch.Generator | None = None, device="cuda"):
        rng = _generator(rng)
        Cp, C, k = self.c_code, self.C, self.k
        ones = lambda n: torch.ones((n,), device=device)    # noqa: E731
        zeros = lambda n: torch.zeros((n,), device=device)  # noqa: E731
        return {
            "w_enc": _normal(rng, (Cp, C, k, k), (C * k * k) ** -0.5, device),
            "b_enc": zeros(Cp),
            "bn_enc_scale": ones(Cp),
            "bn_enc_bias": zeros(Cp),
            "w_dec": _normal(rng, (Cp, C, k, k), (Cp * k * k) ** -0.5, device),
            "b_dec": zeros(C),
            "bn_dec_scale": ones(C),
            "bn_dec_bias": zeros(C),
        }

    def encode(self, params, Z):
        """Z (B, C, H, W) -> payload (B, C', H/k, W/k)."""
        y = F.conv2d(Z, params["w_enc"], stride=self.k)
        y = y + params["b_enc"][None, :, None, None]
        y = _batchnorm(y, params["bn_enc_scale"], params["bn_enc_bias"])
        return torch.sigmoid(y)

    def decode(self, params, payload):
        """payload (B, C', H/k, W/k) -> (B, C, H, W)."""
        y = F.conv_transpose2d(payload, params["w_dec"].flip(2, 3),
                               stride=self.k)
        y = y + params["b_dec"][None, :, None, None]
        y = _batchnorm(y, params["bn_dec_scale"], params["bn_dec_bias"])
        return torch.relu(y)

    # ---- paper Table 2 accounting (BN params excluded, as in the paper) ----

    def param_count(self) -> int:
        C, k, R = self.C, self.k, self.R
        return (C * k * k + 1) * (4 * C // R) + ((4 * C // R) * k * k + 1) * C

    def flops(self, B: int) -> int:
        C, k, R, H, W = self.C, self.k, self.R, self.H, self.W
        Hp, Wp = H // self.k, W // self.k
        enc = B * (2 * C * k * k + 1) * (4 * C // R) * Hp * Wp
        dec = B * ((8 * C // R) * k * k + 1) * C * H * W
        return enc + dec

    def payload_shape(self, B: int) -> tuple[int, ...]:
        return (B, self.c_code, self.H // self.k, self.W // self.k)

    def wire_bytes(self, B: int) -> int:
        return B * self.c_code * (self.H // self.k) * (self.W // self.k) * 4
