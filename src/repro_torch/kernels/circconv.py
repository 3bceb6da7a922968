"""Wrappers over the hand-written CUDA circconv kernels (``csrc/circconv.cu``).

Port of ``repro/kernels/circconv.py``.  Same interface as the reference's
kernel entry points: both take the doubled keys Kext = [K || K] (R, 2D)::

    bind_superpose_kernel(Z (G, R, D), Kext) -> S (G, D)
        S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
    unbind_kernel(S (G, D), Kext)            -> Zhat (G, R, D)
        Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the kernel's plain version beside it (``*_plain``, the direct O(D^2)
form), and only there.  Every launch adds one to ``LAUNCHES[name]``.

Unlike the TPU kernel, the CUDA kernel masks its ragged last tile, so it
takes any D: there is no alignment rule and no reroute to another backend.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"bind_superpose": 0, "unbind": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def execution_mode(device="cuda") -> str:
    """How a ``backend=pallas`` op on a tensor of ``device`` runs:
    ``"cuda-kernel"`` (the hand-written kernel) or ``"torch-plain"`` (the
    kernel's plain version, CPU tensors only)."""
    return "cuda-kernel" if torch.device(device).type == "cuda" else "torch-plain"


# --------------------------------------------------------------------------
# plain versions: the oracles of ``ref`` on the keys K = Kext[:, :D].  The
# float32 keys make them sum in float32, or in float64 for float64 data,
# which makes them an oracle for the kernels' rounding.
# --------------------------------------------------------------------------

def bind_superpose_plain(Z: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """Plain version of the bind kernel: Z (G, R, D), Kext (R, 2D) -> (G, D)."""
    return ref.bind_superpose_ref(Z, Kext[:, :Z.shape[-1]]).to(Z.dtype)


def unbind_plain(S: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """Plain version of the unbind kernel: S (G, D), Kext (R, 2D) -> (G, R, D)."""
    return ref.unbind_ref(S, Kext[:, :S.shape[-1]]).to(S.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(x: torch.Tensor, Kext: torch.Tensor, G: int, R: int, D: int):
    if Kext.shape != (R, 2 * D):
        raise ValueError(f"Kext shape {tuple(Kext.shape)} != {(R, 2 * D)}")
    if min(G, R, D) < 1:
        raise ValueError(f"empty operand: G={G}, R={R}, D={D}")
    if Kext.device != x.device:
        raise ValueError(f"Kext on {Kext.device}, data on {x.device}")


def _launch(fn_name: str, count_name: str, x, Kext, out, G, R, D):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"circconv kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if Kext.dtype != torch.float32:
        raise TypeError(f"Kext must be float32, got {Kext.dtype}")
    if not (x.is_contiguous() and Kext.is_contiguous()):
        raise ValueError("circconv kernels need contiguous operands")
    lib = build.load("circconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(x.data_ptr(), Kext.data_ptr(),
                                    out.data_ptr(), G, R, D,
                                    _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    return out


def bind_superpose_kernel(Z: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """Z (G, R, D), Kext (R, 2D) float32 -> S (G, D) in Z's dtype."""
    G, R, D = Z.shape
    _check(Z, Kext, G, R, D)
    if Z.device.type == "cpu":
        return bind_superpose_plain(Z, Kext)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    out = torch.empty((G, D), dtype=Z.dtype, device=Z.device)
    return _launch("circconv_bind_superpose", "bind_superpose", Z, Kext, out,
                   G, R, D)


def unbind_kernel(S: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """S (G, D), Kext (R, 2D) float32 -> Zhat (G, R, D) in S's dtype."""
    G, D = S.shape
    R = Kext.shape[0]
    _check(S, Kext, G, R, D)
    if S.device.type == "cpu":
        return unbind_plain(S, Kext)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    out = torch.empty((G, R, D), dtype=S.dtype, device=S.device)
    return _launch("circconv_unbind", "unbind", S, Kext, out, G, R, D)
