"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by a
hash of their source and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  Nothing is built at import time: the
first wrapper call on a CUDA tensor builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points of each source: name -> argtypes (every one returns an
# int: a cudaError_t, or a size).  Sources include the shared headers
# ``csrc/*.cuh``.  Pointers and the stream go in as c_void_p.
SIGNATURES = {
    "circconv": {
        "circconv_bind_superpose": [_P, _P, _P, _I, _I, _I, _I, _P],
        "circconv_unbind": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "circconv_fft": {   # plan, table, x, kext, out, G, R, dtype, stream
        "circconv_fft_table": [_P, _P, _P],
        "circconv_fft_bind_superpose": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "circconv_fft_unbind": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "circconv_fft4": {   # plan, x, spec, tables, out, scratch, bytes, G, R, dtype, stream
        "circconv_fft4_tables": [_P, _P, _P],
        "circconv_fft4_key_spectra": [_P, _P, _P, _P, _P, _LL, _I, _P],
        "circconv_fft4_bind_superpose": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
        "circconv_fft4_unbind": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    },
    "paged_attention": {
        "paged_attention_prepare": [_P, _I, _I, _I],
        "paged_attention_float": [_P] * 8 + [_I, _I, _P],
        "paged_attention_int8": [_P] * 10 + [_I, _I, _I, _P],
    },
}

# one lock per source, so two sources can compile at the same time
_locks = {name: threading.Lock() for name in SIGNATURES}
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    of ``csrc/`` (``*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        build_logs.setdefault(name, "(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{build_logs[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _locks[name]:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return lib
