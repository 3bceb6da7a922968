"""Wrappers over the hand-written CUDA paged-attention decode kernels
(``csrc/paged_attention.cu``).

Port of ``repro/kernels/paged_attention.py``, with the reference's
signatures::

    paged_attention(q, k_pool, v_pool, table, pos, *, length,
                    sliding_window=None)                     -> (B, 1, H*hd)
    paged_attention_quant(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                          table, pos, *, length, sliding_window=None,
                          compute_dtype=None)                -> (B, 1, H*hd)

q (B, 1, H, hd) post-rope; pools (num_pages, ps, KV, hd); scale pools
(num_pages, ps, KV, 1) float32; table (B, P) int32; pos (B,) int32.  The
kernel walks the page table itself, so the contiguous (B, T, KV, hd) view
is never built, and reads only the positions the decode mask admits.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version beside it (``*_plain``: ``gather_pages``, then
the reference's literal ``_sdpa`` / ``_sdpa_quant`` op sequence), and only
there.  Every launch adds one to ``LAUNCHES[name]``.

The TPU kernel is bit-identical to the gather read because it reduces a
slot's whole K/V strip at once.  The CUDA kernel's online softmax sums in
another order, so it agrees with the gather read within float tolerance
(1e-5 in float32 against a float64 plain version).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import _sdpa, _sdpa_quant, decode_mask
from repro_torch.models.paging import gather_pages

# kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"paged_attention": 0, "paged_attention_quant": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def execution_mode(device="cuda") -> str:
    """How a ``kv_read="kernel"`` read of a cache on ``device`` runs:
    ``"cuda-kernel"`` or ``"torch-plain"`` (CPU tensors only)."""
    return "cuda-kernel" if torch.device(device).type == "cuda" else "torch-plain"


def _check_geometry(q, pool, table, length):
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise ValueError(f"decode kernel takes one query token, got Sq={Sq}")
    P = table.shape[1]
    ps, KV = pool.shape[1], pool.shape[2]
    if table.shape[0] != B:
        raise ValueError(f"page table batch {table.shape[0]} != query batch {B}")
    if length > P * ps:
        raise ValueError(f"length {length} exceeds table capacity {P}x{ps}")
    if H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    return B, H, hd, P, ps, KV


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _gathered(pools, table, pos, length, sliding_window):
    views = [gather_pages(p, table, length) for p in pools]
    mask = decode_mask(pos.long(), length, sliding_window)[:, None, None, :]
    return views, mask


def paged_attention_plain(q, k_pool, v_pool, table, pos, *, length: int,
                          sliding_window=None):
    """``_sdpa`` over ``gather_pages`` of the pools, with the decode mask."""
    _check_geometry(q, k_pool, table, length)
    (k, v), mask = _gathered((k_pool, v_pool), table, pos, length, sliding_window)
    return _sdpa(q, k, v, mask)


def paged_attention_quant_plain(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                                table, pos, *, length: int, sliding_window=None,
                                compute_dtype=None):
    """``_sdpa_quant`` over ``gather_pages`` of the int8 and scale pools."""
    _check_geometry(q, k_pool, table, length)
    (k, ks, v, vs), mask = _gathered(
        (k_pool, k_scale_pool, v_pool, v_scale_pool), table, pos, length,
        sliding_window)
    return _sdpa_quant(q, k, ks, v, vs, mask, compute_dtype or q.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _on_card(q, tensors, name):
    """False for a CPU q (the plain route); True when every operand is a
    contiguous CUDA tensor on q's device; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
    return True


def _launch_args(q, k_pool, table, pos, length, lib):
    B, H, hd, P, ps, KV = _check_geometry(q, k_pool, table, length)
    if tuple(k_pool.shape) != (k_pool.shape[0], ps, KV, hd):
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not hold "
                         f"head dim {hd}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"table and pos must be int32, got {table.dtype}, "
                        f"{pos.dtype}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos shape {tuple(pos.shape)} != {(B,)}")
    chunk = 16 // k_pool.element_size()
    if hd % chunk:
        raise ValueError(f"head dim {hd} not a multiple of {chunk} "
                         f"({k_pool.dtype} rows load 16 bytes at a time)")
    if min(B, KV, length) < 1:
        raise ValueError(f"empty operand: B={B}, KV={KV}, length={length}")
    G = H // KV
    smem = lib.paged_attention_smem_bytes(G, hd)
    if smem > 232448:
        raise ValueError(f"groups {G} x head dim {hd} need {smem} bytes of "
                         "shared memory, over the 227 KB a block can have")
    return [B, P, ps, k_pool.shape[0], KV, G, hd, length, hd ** -0.5]


def _run(lib, fn_name, count_name, q, ptrs, args, codes, out):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in ptrs), out.data_ptr(), *args, *codes, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    return out


def paged_attention(q, k_pool, v_pool, table, pos, *, length: int,
                    sliding_window=None):
    """q (B, 1, H, hd) post-rope; k/v pools (num_pages, ps, KV, hd) float32
    or bfloat16 (q's dtype); table (B, P) int32; pos (B,) int32.  Returns
    the (B, 1, H*hd) attention output in q's dtype.  Both decode masks
    (linear, or the ring of ``sliding_window``) admit the same prefix of
    positions, so the kernel takes no mask argument."""
    if not _on_card(q, (k_pool, v_pool, table, pos), "paged_attention"):
        return paged_attention_plain(q, k_pool, v_pool, table, pos,
                                     length=length, sliding_window=sliding_window)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention takes float32 or bfloat16, got {q.dtype}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v pool {tuple(v_pool.shape)} != k pool "
                         f"{tuple(k_pool.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype} must match q "
                        f"({q.dtype})")
    lib = build.load("paged_attention")
    args = _launch_args(q, k_pool, table, pos, length, lib)
    B, _, H, hd = q.shape
    out = torch.empty((B, 1, H * hd), dtype=q.dtype, device=q.device)
    q = q.contiguous()
    return _run(lib, "paged_attention_float", "paged_attention", q,
                (q, k_pool, v_pool, table, pos), args,
                (_DTYPE_CODE[q.dtype],), out)


def paged_attention_quant(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                          table, pos, *, length: int, sliding_window=None,
                          compute_dtype=None):
    """int8-KV variant: int8 pools with float32 scale pools
    (num_pages, ps, KV, 1) on the same page table; q float32 or bfloat16.
    Returns (B, 1, H*hd) in ``compute_dtype`` (default q's dtype)."""
    compute_dtype = compute_dtype or q.dtype
    operands = (k_pool, k_scale_pool, v_pool, v_scale_pool, table, pos)
    if not _on_card(q, operands, "paged_attention_quant"):
        return paged_attention_quant_plain(
            q, k_pool, k_scale_pool, v_pool, v_scale_pool, table, pos,
            length=length, sliding_window=sliding_window,
            compute_dtype=compute_dtype)
    if q.dtype not in _DTYPE_CODE or compute_dtype not in _DTYPE_CODE:
        raise TypeError(f"q and compute_dtype must be float32 or bfloat16, "
                        f"got {q.dtype}, {compute_dtype}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v pool {tuple(v_pool.shape)} != k pool "
                         f"{tuple(k_pool.shape)}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"quant pools must be int8, got {k_pool.dtype}/"
                        f"{v_pool.dtype}")
    scale_shape = (*k_pool.shape[:3], 1)
    for s in (k_scale_pool, v_scale_pool):
        if s.dtype != torch.float32 or tuple(s.shape) != scale_shape:
            raise TypeError(f"scale pools must be float32 {scale_shape}, got "
                            f"{s.dtype} {tuple(s.shape)}")
    lib = build.load("paged_attention")
    args = _launch_args(q, k_pool, table, pos, length, lib)
    B, _, H, hd = q.shape
    out = torch.empty((B, 1, H * hd), dtype=compute_dtype, device=q.device)
    q = q.contiguous()
    return _run(lib, "paged_attention_int8", "paged_attention_quant", q,
                (q, k_pool, k_scale_pool, v_pool, v_scale_pool, table, pos),
                args, (_DTYPE_CODE[q.dtype], _DTYPE_CODE[compute_dtype]), out)
