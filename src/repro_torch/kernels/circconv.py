"""Wrappers over the hand-written CUDA circconv kernels.

Port of ``repro/kernels/circconv.py``.  Same interface as the reference's
kernel entry points: both take the doubled keys Kext = [K || K] (R, 2D)::

    bind_superpose_kernel(Z (G, R, D), Kext) -> S (G, D)
        S[g, d]       = sum_i sum_j Z[g, i, j] * K_i[(d - j) mod D]
    unbind_kernel(S (G, D), Kext)            -> Zhat (G, R, D)
        Zhat[g, i, d] = sum_j S[g, j] * K_i[(j - d) mod D]

Each function has three CUDA kernels, and ``route(D)`` picks one by D
alone, from ``plan(D)``:

- ``"fft"`` (``csrc/circconv_fft.cu``) for every D = 2^a 3^b 5^c with
  a >= 2 and ``FFT_MIN_D <= D <= FFT_MAX_D`` (4 to 16384): one pass in
  shared memory through a float32 FFT (radix-8/4/2 passes, then radix-3 and
  radix-5 stages), the keys' spectra made in the kernel;
- ``"fft4"`` (``csrc/circconv_fft4.cu``) for every such D past it up to
  ``FFT4_MAX_D`` = 2^22 (the LM training path's D = S * d_model) that
  splits into two sub-transforms of at most 2048 points, each a multiple
  of 4: the four-step FFT in three launches through a complex float32
  scratch the wrapper allocates, with the keys' spectra made by
  ``key_spectra`` (``ops`` keeps them per key tensor and passes them in);
- ``"direct"`` (``csrc/circconv.cu``) for every other D (odd, a factor of
  7 or a larger prime, a single factor of 2): the O(D^2) form on tiles,
  which masks its ragged last tile.

A D = 2^a 3^b 5^c (a >= 2) past ``FFT4_MAX_D``, or past 16384 with no such
split, has no route and raises.  The choice is deterministic and is not a
fallback: a build or launch failure of the chosen kernel raises, and
nothing retries on another.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the kernel's plain version beside it (``*_plain``, the direct O(D^2)
form), and only there.  Every launch adds one to ``LAUNCHES[name]``, to
``ROUTE_LAUNCHES[(name, route)]`` and to ``SHAPE_LAUNCHES[(name, G, R, D)]``;
a build of a key tensor's spectra adds one to ``KEY_SPECTRA_BUILDS``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

ROUTES = ("fft", "fft4", "direct")
FFT_MIN_D, FFT_MAX_D = 4, 16384   # 16384: 224 KB of the 227 KB of shared memory
FFT4_MAX_SIDE = 2048              # points of a four-step sub-transform
FFT4_MAX_D = FFT4_MAX_SIDE ** 2   # 2^22
SMEM_BYTES = 232448               # shared memory a block may opt in to (227 KB)

# kernel launches since the last reset_launch_counts(), by wrapper name, by
# (wrapper name, route) and by (wrapper name, G, R, D)
LAUNCHES = {"bind_superpose": 0, "unbind": 0}
ROUTE_LAUNCHES = {(name, r): 0 for name in LAUNCHES for r in ROUTES}
SHAPE_LAUNCHES: Counter = Counter()
KEY_SPECTRA_BUILDS = 0

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
    global KEY_SPECTRA_BUILDS
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()
    KEY_SPECTRA_BUILDS = 0


# --------------------------------------------------------------------------
# the plan: D's factors, the FFT kernels' radices and the four-step split
# --------------------------------------------------------------------------

def factor(n: int) -> tuple[int, int, int, int]:
    """(a, b, c, rest) with n = 2^a 3^b 5^c rest and rest prime to 30."""
    out = []
    for p in (2, 3, 5):
        e = 0
        while n > 0 and n % p == 0:
            n //= p
            e += 1
        out.append(e)
    return (*out, n)


def radix_passes(n: int) -> tuple[int, ...]:
    """The passes of the kernels' transform of n = 2^a 3^b 5^c points (a >=
    1), as their radices in order: the radix-2 stages fused three to a pass,
    the first taking the remainder (8, 4 or 2), then one pass per radix-3
    and per radix-5 stage."""
    a, b, c, rest = factor(n)
    if rest != 1 or a < 1:
        raise ValueError(f"no radix passes for n = {n}")
    first = (a - 1) % 3 + 1
    return (1 << first,) + (8,) * ((a - first) // 3) + (3,) * b + (5,) * c


class Radices(ctypes.Structure):
    """One row transform, as ``struct Radices`` of
    ``csrc/circconv_fft_common.cuh`` (same fields, same order): n = 2^la
    3^n3 5^n5 points, m = 3^n3 5^n5 and magic = ceil(2^32 / m) (0 for m =
    1), with which the kernels divide by m."""
    _fields_ = [("n", ctypes.c_int), ("la", ctypes.c_int), ("n3", ctypes.c_int),
                ("n5", ctypes.c_int), ("m", ctypes.c_int), ("magic", ctypes.c_uint)]


class Plan(ctypes.Structure):
    """A launch's plan, as ``struct Plan`` of ``csrc/circconv_fft_common.cuh``:
    ``d`` the transform of D points, and for the four-step kernels D = d1.n
    d2.n (the column and row sub-transforms) and ``cols``, the columns of a
    pass A / C tile.  The C entry points take a pointer to it."""
    _fields_ = [("d", Radices), ("d1", Radices), ("d2", Radices),
                ("cols", ctypes.c_int)]


def _radices(n: int) -> Radices:
    if n == 0:
        return Radices()
    a, b, c, _ = factor(n)
    m = n >> a
    return Radices(n, a, b, c, m, 0 if m == 1 else (2 ** 32 - 1) // m + 1)


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def onepass_smem_bytes(D: int) -> int:
    """Shared memory of the one-pass bind kernel with one key a block, the
    larger of the two: a row of D points, the D/2 + 1 accumulator, the
    quarter table (padded to whole 16-point swizzle rows), 4 maxima."""
    return (D + D // 2 + 1 + _pad16(D // 4)) * 8 + 16


@dataclass(frozen=True)
class FftPlan:
    """The FFT-form kernels' plan for rows of D points: ``route`` "fft" (one
    pass, ``sides`` = (D,)) or "fft4" (``sides`` = (D1, D2), D = D1 D2, and
    ``cols`` columns a pass A / C tile); ``passes`` gives each side's radix
    passes in order."""
    route: str
    D: int
    sides: tuple[int, ...]
    cols: int = 0

    @property
    def passes(self) -> tuple[tuple[int, ...], ...]:
        return tuple(radix_passes(n) for n in self.sides)

    @property
    def mixed(self) -> bool:
        """D is not a power of two (the one-pass kernels read a table)."""
        return self.D & (self.D - 1) != 0

    @functools.cached_property
    def struct(self) -> Plan:
        if self.route == "fft":
            return Plan(_radices(self.D), _radices(0), _radices(0), 0)
        D1, D2 = self.sides
        return Plan(_radices(self.D), _radices(D1), _radices(D2), self.cols)


def _split(D: int) -> tuple[int, int] | None:
    """D = D1 D2 for the four-step kernels: both sides at most FFT4_MAX_SIDE
    and multiples of 4, D2 <= D1; D2 the largest power of two that allows
    it, or else the largest such divisor."""
    best = None
    for e in range(2, FFT4_MAX_SIDE.bit_length()):
        D2 = 1 << e
        if D % D2:
            break
        D1 = D // D2
        if D2 <= D1 <= FFT4_MAX_SIDE and D1 % 4 == 0:
            best = (D1, D2)
    if best is None:
        best = max(((D // d2, d2) for d2 in range(4, FFT4_MAX_SIDE + 1, 4)
                    if D % d2 == 0 and (D // d2) % 4 == 0
                    and d2 <= D // d2 <= FFT4_MAX_SIDE),
                   key=lambda s: s[1], default=None)
    return best


@functools.lru_cache(maxsize=None)
def plan(D: int) -> FftPlan | None:
    """The FFT-form plan for D, or None where D goes to the direct kernels
    (D is not 2^a 3^b 5^c with a >= 2).  A D = 2^a 3^b 5^c (a >= 2) that no
    FFT kernel takes raises ``ValueError``: past FFT4_MAX_D, or past
    FFT_MAX_D with no four-step split.

    The limits are what the kernels accept, not where they turn faster: the
    one-pass kernels load a row as 4-point float4 chunks and keep a
    quarter-wave table, so 4 divides D, and up to 16384 their working set
    fits the 227 KB of shared memory; the four-step kernels' sub-transforms
    (at most 2048 points, each a multiple of 4) fit a block up to 2^22.
    Below about D = 256 the direct kernel is the faster (PERF.md)."""
    D = int(D)
    a, b, c, rest = factor(D)
    if rest != 1 or a < 2:
        return None
    if D <= FFT_MAX_D and onepass_smem_bytes(D) <= SMEM_BYTES:
        return FftPlan("fft", D, (D,))
    if D > FFT4_MAX_D:
        raise ValueError(f"no circconv kernel takes D = {D} = 2^{a} 3^{b} 5^{c} "
                         f"past {FFT4_MAX_D} (the four-step kernels' limit)")
    split = _split(D)
    if split is None:
        raise ValueError(f"no circconv kernel takes D = {D} = 2^{a} 3^{b} 5^{c}: "
                         f"no four-step split into two sides of at most "
                         f"{FFT4_MAX_SIDE} points, each a multiple of 4")
    return FftPlan("fft4", D, split, cols=8 if split[1] % 8 == 0 else 4)


def route(D: int) -> str:
    """The kernel the wrappers launch for rows of D points: ``"fft"`` or
    ``"fft4"`` where ``plan(D)`` has an FFT-form plan, ``"direct"`` for any
    D that is not 2^a 3^b 5^c with a >= 2.  Raises ``ValueError`` where
    ``plan`` does."""
    p = plan(int(D))
    return "direct" if p is None else p.route


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
    into another tensor): the FFT-form kernels load rows with 16-byte
    loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(count_name: str, kernel_route: str, x, Kext, out, G, R, D, spectra=None):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"circconv kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if Kext.dtype != torch.float32:
        raise TypeError(f"Kext must be float32, got {Kext.dtype}")
    if not (x.is_contiguous() and Kext.is_contiguous()):
        raise ValueError("circconv kernels need contiguous operands")
    fn_name = _FN[(count_name, kernel_route)]
    if kernel_route != "direct":
        x, Kext = _aligned(x), _aligned(Kext)
    lib = build.load(_SOURCE[kernel_route])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = getattr(lib, fn_name)
        dtype = _DTYPE_CODE[x.dtype]
        if kernel_route == "direct":
            err = fn(x.data_ptr(), Kext.data_ptr(), out.data_ptr(), G, R, D, dtype,
                     stream)
        elif kernel_route == "fft":
            p = plan(D)
            table = tables(p, x.device).data_ptr() if p.mixed else None
            err = fn(ctypes.byref(p.struct), table, x.data_ptr(), Kext.data_ptr(),
                     out.data_ptr(), G, R, dtype, stream)
        else:
            p = plan(D)
            spec = key_spectra(Kext, p) if spectra is None else spectra
            scratch = torch.empty(fft4_scratch_floats(count_name, G, R, D),
                                  dtype=torch.float32, device=x.device)
            err = fn(ctypes.byref(p.struct), x.data_ptr(), spec.data_ptr(),
                     tables(p, x.device).data_ptr(), out.data_ptr(),
                     scratch.data_ptr(), scratch.numel() * 4, G, R, dtype, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    ROUTE_LAUNCHES[(count_name, kernel_route)] += 1
    SHAPE_LAUNCHES[(count_name, G, R, D)] += 1
    return out


# --------------------------------------------------------------------------
# what the FFT kernels read besides the data: twiddle tables (kept per D)
# and the four-step kernels' key spectra
# --------------------------------------------------------------------------

_TABLES: dict = {}                     # (D, device) -> float32 tensor


def table_floats(p: FftPlan) -> int:
    """Float32 words of a plan's tables: the one-pass kernels' quarter table
    (D/4 complex points) or the four-step kernels' twiddles between the
    passes (D) and both sides' quarter tables."""
    if p.route == "fft":
        return p.D // 4 * 2
    D1, D2 = p.sides
    return (p.D + D1 // 4 + D2 // 4) * 2


def tables(p: FftPlan, device) -> torch.Tensor:
    """The plan's twiddle tables on ``device``, made by the kernels' own
    library once per D and device (in double precision, rounded once) and
    kept."""
    device = torch.device(device)
    key = (p.D, device)
    t = _TABLES.get(key)
    if t is None:
        t = torch.empty(table_floats(p), dtype=torch.float32, device=device)
        name = "circconv_fft_table" if p.route == "fft" else "circconv_fft4_tables"
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(build.load(_SOURCE[p.route]), name)(
                ctypes.byref(p.struct), t.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        _TABLES[key] = t
    return t


def key_spectra_floats(p: FftPlan, R: int) -> int:
    """Float32 words of R keys' four-step spectra: the rows k1 <= D1/2 of
    the (D1, D2) spectrum (a real key's other rows are their mirror)."""
    D1, D2 = p.sides
    return R * (D1 // 2 + 1) * D2 * 2


def key_spectra(Kext: torch.Tensor, p: FftPlan) -> torch.Tensor:
    """The four-step kernels' spectra of the keys in ``Kext`` (R, 2D), made
    anew on every call (``ops`` keeps them per key tensor while the keys are
    unchanged, so a codec's fixed keys are transformed once)."""
    global KEY_SPECTRA_BUILDS
    R = Kext.shape[0]
    spec = torch.empty(key_spectra_floats(p, R), dtype=torch.float32,
                       device=Kext.device)
    scratch = torch.empty(R * p.D * 2, dtype=torch.float32, device=Kext.device)
    with torch.cuda.device(Kext.device):
        stream = torch.cuda.current_stream(Kext.device).cuda_stream
        err = build.load("circconv_fft4").circconv_fft4_key_spectra(
            ctypes.byref(p.struct), _aligned(Kext).data_ptr(),
            tables(p, Kext.device).data_ptr(), spec.data_ptr(), scratch.data_ptr(),
            scratch.numel() * 4, R, stream)
    if err:
        raise RuntimeError(f"circconv_fft4_key_spectra launch failed: cudaError {err}")
    KEY_SPECTRA_BUILDS += 1
    return spec


def clear_caches() -> None:
    """Drop the kept twiddle tables (their device memory)."""
    _TABLES.clear()


def fft4_scratch_floats(name: str, G: int, R: int, D: int) -> int:
    """Float32 words of the four-step kernels' scratch: D complex points
    for each packed row of pass A (two groups' data rows as one complex
    row, ceil(G/2) R for bind, ceil(G/2) for unbind) and of pass B (the
    output's rows, packed alike).  ``name`` is "bind_superpose" or
    "unbind"."""
    pairs = (G + 1) // 2
    data, outs = (pairs * R, pairs) if name == "bind_superpose" else (pairs, pairs * R)
    return (data + outs) * D * 2


def _check_route(kernel_route: str, D: int):
    if kernel_route not in ROUTES:
        raise ValueError(f"unknown route {kernel_route!r}, not in {ROUTES}")
    if kernel_route == "direct":
        return
    try:
        p = plan(D)
    except ValueError:
        p = None
    if p is None or p.route != kernel_route:
        limits = {"fft": f"[{FFT_MIN_D}, {FFT_MAX_D}]",
                  "fft4": f"({FFT_MAX_D}, {FFT4_MAX_D}] with a four-step split"
                  }[kernel_route]
        raise ValueError(f"the {kernel_route} kernels take a power of two times "
                         f"3^b 5^c, D = 2^a 3^b 5^c with a >= 2, in {limits}; "
                         f"got D={D}")


def bind_superpose_kernel(Z: torch.Tensor, Kext: torch.Tensor,
                          spectra: torch.Tensor | None = None) -> torch.Tensor:
    """Z (G, R, D), Kext (R, 2D) float32 -> S (G, D) in Z's dtype, through
    the kernel of ``route(D)``.  ``spectra``: Kext's ``key_spectra``, which
    the four-step kernels read (made for the call where None); no other
    route takes them."""
    return _bind_superpose_on(route(Z.shape[-1]), Z, Kext, spectra)


def unbind_kernel(S: torch.Tensor, Kext: torch.Tensor,
                  spectra: torch.Tensor | None = None) -> torch.Tensor:
    """S (G, D), Kext (R, 2D) float32 -> Zhat (G, R, D) in S's dtype,
    through the kernel of ``route(D)``; ``spectra`` as for bind."""
    return _unbind_on(route(S.shape[-1]), S, Kext, spectra)


def _check_spectra(kernel_route: str, spectra, Kext, R: int, D: int):
    if spectra is None:
        return
    if kernel_route != "fft4":
        raise ValueError(f"the {kernel_route} kernels take no key spectra")
    want = key_spectra_floats(plan(D), R)
    if (spectra.dtype != torch.float32 or spectra.device != Kext.device
            or not spectra.is_contiguous() or spectra.numel() != want):
        raise ValueError(f"key spectra {spectra.dtype} {tuple(spectra.shape)} on "
                         f"{spectra.device}, want {want} contiguous float32 on "
                         f"{Kext.device}")


def _bind_superpose_on(kernel_route: str, Z, Kext, spectra=None):
    """bind through the named route's kernel (chip_smoke.py holds the direct
    kernels at the main-path shapes with it)."""
    G, R, D = Z.shape
    _check(Z, Kext, G, R, D)
    _check_route(kernel_route, D)
    _check_spectra(kernel_route, spectra, Kext, R, D)
    if Z.device.type == "cpu":
        return bind_superpose_plain(Z, Kext)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    out = torch.empty((G, D), dtype=Z.dtype, device=Z.device)
    return _launch("bind_superpose", kernel_route, Z, Kext, out, G, R, D, spectra)


def _unbind_on(kernel_route: str, S, Kext, spectra=None):
    """unbind through the named route's kernel."""
    G, D = S.shape
    R = Kext.shape[0]
    _check(S, Kext, G, R, D)
    _check_route(kernel_route, D)
    _check_spectra(kernel_route, spectra, Kext, R, D)
    if S.device.type == "cpu":
        return unbind_plain(S, Kext)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    out = torch.empty((G, R, D), dtype=S.dtype, device=S.device)
    return _launch("unbind", kernel_route, S, Kext, out, G, R, D, spectra)
