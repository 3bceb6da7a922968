"""Wrappers over the hand-written CUDA circconv kernels.

Port of ``repro/kernels/circconv.py``.  Same interface as the reference's
kernel entry points: both take the doubled keys Kext = [K || K] (R, 2D)::

    bind_superpose_kernel(Z (G, R, D), Kext) -> S (G, D)
        S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
    unbind_kernel(S (G, D), Kext)            -> Zhat (G, R, D)
        Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]

Each function has two CUDA kernels, and ``route(D)`` picks one by D alone:

- ``"fft"`` (``csrc/circconv_fft.cu``) for every power of two
  ``FFT_MIN_D <= D <= FFT_MAX_D`` (4 to 16384): one pass in shared memory
  through a float32 FFT, the keys' spectra made in the kernel;
- ``"direct"`` (``csrc/circconv.cu``) for every other D: the O(D^2) form
  on tiles, which masks its ragged last tile and so takes any D.

The choice is deterministic and is not a fallback: a build or launch
failure of the chosen kernel raises, and nothing retries on the other.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the kernel's plain version beside it (``*_plain``, the direct O(D^2)
form), and only there.  Every launch adds one to ``LAUNCHES[name]``, to
``ROUTE_LAUNCHES[(name, route)]`` and to ``SHAPE_LAUNCHES[(name, G, R, D)]``.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build, ref

ROUTES = ("fft", "direct")
FFT_MIN_D, FFT_MAX_D = 4, 16384   # 16384: 224 KB of the 227 KB of shared memory

# kernel launches since the last reset_launch_counts(), by wrapper name, by
# (wrapper name, route) and by (wrapper name, G, R, D)
LAUNCHES = {"bind_superpose": 0, "unbind": 0}
ROUTE_LAUNCHES = {(name, r): 0 for name in LAUNCHES for r in ROUTES}
SHAPE_LAUNCHES: Counter = Counter()

# (wrapper name, route) -> C entry point; route -> source in csrc/
_FN = {("bind_superpose", "direct"): "circconv_bind_superpose",
       ("unbind", "direct"): "circconv_unbind",
       ("bind_superpose", "fft"): "circconv_fft_bind_superpose",
       ("unbind", "fft"): "circconv_fft_unbind"}
_SOURCE = {"direct": "circconv", "fft": "circconv_fft"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def route(D: int) -> str:
    """The kernel the wrappers launch for rows of D points: ``"fft"`` for a
    power of two in [FFT_MIN_D, FFT_MAX_D], ``"direct"`` for any other D.

    The limits are what the FFT kernels accept, not where they turn faster:
    they load a row as 4-point float4 chunks, so a row holds at least 4
    points, and above 16384 its working set outgrows shared memory.  Below
    about D = 256 the direct kernel is the faster (PERF.md)."""
    D = int(D)
    return ("fft" if FFT_MIN_D <= D <= FFT_MAX_D and D & (D - 1) == 0
            else "direct")


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (a view
    into another tensor): the FFT kernels load rows with 16-byte loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(count_name: str, kernel_route: str, x, Kext, out, G, R, D):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"circconv kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if Kext.dtype != torch.float32:
        raise TypeError(f"Kext must be float32, got {Kext.dtype}")
    if not (x.is_contiguous() and Kext.is_contiguous()):
        raise ValueError("circconv kernels need contiguous operands")
    fn_name = _FN[(count_name, kernel_route)]
    if kernel_route == "fft":
        x, Kext = _aligned(x), _aligned(Kext)
    lib = build.load(_SOURCE[kernel_route])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(x.data_ptr(), Kext.data_ptr(),
                                    out.data_ptr(), G, R, D,
                                    _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    ROUTE_LAUNCHES[(count_name, kernel_route)] += 1
    SHAPE_LAUNCHES[(count_name, G, R, D)] += 1
    return out


def _check_route(kernel_route: str, D: int):
    if kernel_route not in ROUTES:
        raise ValueError(f"unknown route {kernel_route!r}, not in {ROUTES}")
    if kernel_route == "fft" and route(D) != "fft":
        raise ValueError(f"the fft kernels take a power of two D in "
                         f"[{FFT_MIN_D}, {FFT_MAX_D}], got D={D}")


def bind_superpose_kernel(Z: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """Z (G, R, D), Kext (R, 2D) float32 -> S (G, D) in Z's dtype, through
    the kernel of ``route(D)``."""
    return _bind_superpose_on(route(Z.shape[-1]), Z, Kext)


def unbind_kernel(S: torch.Tensor, Kext: torch.Tensor) -> torch.Tensor:
    """S (G, D), Kext (R, 2D) float32 -> Zhat (G, R, D) in S's dtype,
    through the kernel of ``route(D)``."""
    return _unbind_on(route(S.shape[-1]), S, Kext)


def _bind_superpose_on(kernel_route: str, Z, Kext):
    """bind through the named route's kernel (chip_smoke.py holds the direct
    kernels at the main-path shapes with it)."""
    G, R, D = Z.shape
    _check(Z, Kext, G, R, D)
    _check_route(kernel_route, D)
    if Z.device.type == "cpu":
        return bind_superpose_plain(Z, Kext)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    out = torch.empty((G, D), dtype=Z.dtype, device=Z.device)
    return _launch("bind_superpose", kernel_route, Z, Kext, out, G, R, D)


def _unbind_on(kernel_route: str, S, Kext):
    """unbind through the named route's kernel."""
    G, D = S.shape
    R = Kext.shape[0]
    _check(S, Kext, G, R, D)
    _check_route(kernel_route, D)
    if S.device.type == "cpu":
        return unbind_plain(S, Kext)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    out = torch.empty((G, R, D), dtype=S.dtype, device=S.device)
    return _launch("unbind", kernel_route, S, Kext, out, G, R, D)
