"""Wrappers over the hand-written CUDA circconv kernels.

Port of ``repro/kernels/circconv.py``.  Same interface as the reference's
kernel entry points: both take the doubled keys Kext = [K || K] (R, 2D)::

    bind_superpose_kernel(Z (G, R, D), Kext) -> S (G, D)
        S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
    unbind_kernel(S (G, D), Kext)            -> Zhat (G, R, D)
        Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]

Each function has three CUDA kernels, and ``route(D)`` picks one by D
alone:

- ``"fft"`` (``csrc/circconv_fft.cu``) for every power of two
  ``FFT_MIN_D <= D <= FFT_MAX_D`` (4 to 16384): one pass in shared memory
  through a float32 FFT, the keys' spectra made in the kernel;
- ``"fft4"`` (``csrc/circconv_fft4.cu``) for every power of two
  ``FFT_MAX_D < D <= FFT4_MAX_D`` (up to 2^22, the LM training path's
  D = S * d_model): the four-step FFT in three launches through a complex
  float32 scratch the wrapper allocates;
- ``"direct"`` (``csrc/circconv.cu``) for every D that is not a power of
  two: the O(D^2) form on tiles, which masks its ragged last tile.

A power of two past ``FFT4_MAX_D`` has no route and raises.  The choice is
deterministic and is not a fallback: a build or launch failure of the
chosen kernel raises, and nothing retries on another.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the kernel's plain version beside it (``*_plain``, the direct O(D^2)
form), and only there.  Every launch adds one to ``LAUNCHES[name]``, to
``ROUTE_LAUNCHES[(name, route)]`` and to ``SHAPE_LAUNCHES[(name, G, R, D)]``.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build, ref

ROUTES = ("fft", "fft4", "direct")
FFT_MIN_D, FFT_MAX_D = 4, 16384   # 16384: 224 KB of the 227 KB of shared memory
FFT4_MAX_D = 1 << 22              # sub-transforms of 2048 points a block

# kernel launches since the last reset_launch_counts(), by wrapper name, by
# (wrapper name, route) and by (wrapper name, G, R, D)
LAUNCHES = {"bind_superpose": 0, "unbind": 0}
ROUTE_LAUNCHES = {(name, r): 0 for name in LAUNCHES for r in ROUTES}
SHAPE_LAUNCHES: Counter = Counter()

# (wrapper name, route) -> C entry point; route -> source in csrc/
_FN = {("bind_superpose", "direct"): "circconv_bind_superpose",
       ("unbind", "direct"): "circconv_unbind",
       ("bind_superpose", "fft"): "circconv_fft_bind_superpose",
       ("unbind", "fft"): "circconv_fft_unbind",
       ("bind_superpose", "fft4"): "circconv_fft4_bind_superpose",
       ("unbind", "fft4"): "circconv_fft4_unbind"}
_SOURCE = {"direct": "circconv", "fft": "circconv_fft", "fft4": "circconv_fft4"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def route(D: int) -> str:
    """The kernel the wrappers launch for rows of D points: ``"fft"`` for a
    power of two in [FFT_MIN_D, FFT_MAX_D], ``"fft4"`` for a power of two in
    (FFT_MAX_D, FFT4_MAX_D], ``"direct"`` for any D that is not a power of
    two.  A power of two past FFT4_MAX_D raises ``ValueError``.

    The limits are what the kernels accept, not where they turn faster: the
    one-pass FFT kernels load a row as 4-point float4 chunks, so a row holds
    at least 4 points, and above 16384 its working set outgrows shared
    memory; the four-step kernels' sub-transforms (at most 2048 points)
    fit a block up to 2^22.  Below about D = 256 the direct kernel is the
    faster (PERF.md)."""
    D = int(D)
    fft_route = _fft_route(D)
    if fft_route is not None:
        return fft_route
    if D > FFT4_MAX_D and D & (D - 1) == 0:
        raise ValueError(f"no circconv kernel takes a power of two D = {D} "
                         f"past {FFT4_MAX_D} (the four-step kernels' limit)")
    return "direct"


def _fft_route(D: int) -> str | None:
    """The FFT-form route that takes D (a power of two within its limits),
    or None."""
    if D & (D - 1) or not FFT_MIN_D <= D <= FFT4_MAX_D:
        return None
    return "fft" if D <= FFT_MAX_D else "fft4"


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
        args = (x.data_ptr(), Kext.data_ptr(), out.data_ptr())
        if kernel_route == "fft4":
            scratch = torch.empty(fft4_scratch_floats(count_name, G, R, D),
                                  dtype=torch.float32, device=x.device)
            args += (scratch.data_ptr(), scratch.numel() * 4)
        err = getattr(lib, fn_name)(*args, G, R, D, _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    ROUTE_LAUNCHES[(count_name, kernel_route)] += 1
    SHAPE_LAUNCHES[(count_name, G, R, D)] += 1
    return out


def fft4_scratch_floats(name: str, G: int, R: int, D: int) -> int:
    """Float32 words of the four-step kernels' scratch: D complex points for
    each row of pass A (the data rows and the R keys) and of pass B (the
    output's rows).  ``name`` is "bind_superpose" or "unbind"."""
    data, outs = (G * R, G) if name == "bind_superpose" else (G, G * R)
    return (data + R + outs) * D * 2


def _check_route(kernel_route: str, D: int):
    if kernel_route not in ROUTES:
        raise ValueError(f"unknown route {kernel_route!r}, not in {ROUTES}")
    if kernel_route != "direct" and _fft_route(D) != kernel_route:
        limits = {"fft": f"[{FFT_MIN_D}, {FFT_MAX_D}]",
                  "fft4": f"({FFT_MAX_D}, {FFT4_MAX_D}]"}[kernel_route]
        raise ValueError(f"the {kernel_route} kernels take a power of two D "
                         f"in {limits}, got D={D}")


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
