"""VGG-16 and ResNet-50 split models — the paper's experimental setup.

Port of ``repro/models/convnets.py``, same param trees and layouts (NCHW
activations, OIHW conv weights, fc weights (d_in, d_out) applied as x @ w).

Split points (C3-SL Sec. 4.1):
  * VGG-16 on CIFAR-10:  split at the 4th max-pool -> cut feature
    (512, 2, 2), D = 2048
  * ResNet-50 on CIFAR-100: split at the output of the 3rd residual stage
    (ImageNet-style stem) -> cut feature (1024, 2, 2), D = 4096

BatchNorm runs in batch-stats mode (no running averages), with the
population variance, as the reference does.

``padding="SAME"`` follows XLA: for a stride-2 conv the padding can be
uneven, and then the low side gets ``total // 2`` and the high side the rest
(the ResNet stem, 7x7 stride 2 on 32x32, pads (2, 3)).  ``F.conv2d``'s own
symmetric padding would give other numbers, so the pads are computed here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride=1, padding="SAME"):
    """NCHW x, OIHW w; ``padding`` "SAME" (XLA's split) or "VALID"."""
    if padding == "VALID":
        return F.conv2d(x, w, stride=stride)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    kh, kw = w.shape[-2:]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _bn(x, p):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    xn = (x - mean) * torch.rsqrt(var + 1e-5)
    return xn * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _normal(rng, shape, std, device):
    return (torch.randn(shape, generator=rng) * std).to(device)


def _init_conv(rng, c_in, c_out, k, device="cuda"):
    fan = c_in * k * k
    return _normal(rng, (c_out, c_in, k, k), (2.0 / fan) ** 0.5, device)


def _init_bn(c, device="cuda"):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def max_pool(x, k=2):
    return F.max_pool2d(x, k, k)


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

VGG16_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M"]
VGG_SPLIT_AFTER_POOL = 4  # paper: output of the 4th max-pool


def init_vgg16(rng: torch.Generator, n_classes: int = 10, in_ch: int = 3,
               device="cuda"):
    """Random VGG-16 params from a CPU generator (the reference's shapes
    and scales; the draws differ from ``jax.random``)."""
    params = {"convs": [], "bns": []}
    c = in_ch
    for item in VGG16_LAYOUT:
        if item == "M":
            continue
        params["convs"].append(_init_conv(rng, c, item, 3, device))
        params["bns"].append(_init_bn(item, device))
        c = item
    params["fc"] = {"w": _normal(rng, (512, n_classes), 512 ** -0.5, device),
                    "b": torch.zeros((n_classes,), device=device)}
    return params


def _vgg_convs(params, x, start_pool: int, end_pool: int):
    """Run VGG conv layers between max-pool counts [start_pool, end_pool)."""
    ci = 0
    pools = 0
    for item in VGG16_LAYOUT:
        if item == "M":
            if start_pool <= pools < end_pool:
                x = max_pool(x)
            pools += 1
            continue
        if start_pool <= pools < end_pool:
            x = torch.relu(_bn(conv2d(x, params["convs"][ci]), params["bns"][ci]))
        ci += 1
    return x


def vgg16_front(params, x):
    """x (B,3,32,32) -> cut feature (B, 512, 2, 2)."""
    return _vgg_convs(params, x, 0, VGG_SPLIT_AFTER_POOL)


def vgg16_back(params, z):
    x = _vgg_convs(params, z, VGG_SPLIT_AFTER_POOL, 5)
    x = x.mean(dim=(2, 3))  # (B, 512)
    return x @ params["fc"]["w"] + params["fc"]["b"]


VGG_CUT_SHAPE = (512, 2, 2)   # D = 2048


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

RESNET50_STAGES = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)  # bottleneck mid-widths; out = 4x


def _init_bottleneck(rng, c_in, width, stride, device="cuda"):
    p = {
        "conv1": _init_conv(rng, c_in, width, 1, device), "bn1": _init_bn(width, device),
        "conv2": _init_conv(rng, width, width, 3, device), "bn2": _init_bn(width, device),
        "conv3": _init_conv(rng, width, width * 4, 1, device),
        "bn3": _init_bn(width * 4, device),
    }
    if stride != 1 or c_in != width * 4:
        p["proj"] = _init_conv(rng, c_in, width * 4, 1, device)
        p["bn_proj"] = _init_bn(width * 4, device)
    return p


def _apply_bottleneck(p, x, stride):
    y = torch.relu(_bn(conv2d(x, p["conv1"]), p["bn1"]))
    y = torch.relu(_bn(conv2d(y, p["conv2"], stride=stride), p["bn2"]))
    y = _bn(conv2d(y, p["conv3"]), p["bn3"])
    if "proj" in p:
        x = _bn(conv2d(x, p["proj"], stride=stride), p["bn_proj"])
    return torch.relu(x + y)


def init_resnet50(rng: torch.Generator, n_classes: int = 100, in_ch: int = 3,
                  device="cuda"):
    """Random ResNet-50 params from a CPU generator (reference shapes)."""
    params = {"stem": _init_conv(rng, in_ch, 64, 7, device),
              "bn_stem": _init_bn(64, device), "stages": []}
    c = 64
    for si, (n_blocks, width) in enumerate(zip(RESNET50_STAGES, RESNET50_WIDTHS)):
        blocks = []
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            blocks.append(_init_bottleneck(rng, c, width, stride, device))
            c = width * 4
        params["stages"].append(blocks)
    params["fc"] = {"w": _normal(rng, (2048, n_classes), 2048 ** -0.5, device),
                    "b": torch.zeros((n_classes,), device=device)}
    return params


def _resnet_stage(params, x, si):
    for bi, bp in enumerate(params["stages"][si]):
        stride = 2 if (bi == 0 and si > 0) else 1
        x = _apply_bottleneck(bp, x, stride)
    return x


def resnet50_front(params, x):
    """x (B,3,32,32) -> cut (B, 1024, 2, 2): stem + stages 1-3."""
    x = torch.relu(_bn(conv2d(x, params["stem"], stride=2), params["bn_stem"]))
    x = max_pool(x)                 # 32 -> 16 -> 8
    for si in range(3):
        x = _resnet_stage(params, x, si)   # 8 -> 8 -> 4 -> 2
    return x


def resnet50_back(params, z):
    x = _resnet_stage(params, z, 3)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]


RESNET_CUT_SHAPE = (1024, 2, 2)  # D = 4096


# conv feature D values the paper's Table 1 analytics use
VGG_D = 512 * 2 * 2        # 2048
RESNET_D = 1024 * 2 * 2    # 4096
