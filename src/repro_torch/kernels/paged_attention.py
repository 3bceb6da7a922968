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

The kernels split each slot's positions into chunks over blocks
(flash-decoding).  The plan has one home, this module: ``split_plan`` picks
the split count and the chunk, and ``head_block`` the query heads a block
keeps, from the shapes alone, never from ``pos``; the C entry points take
them as arguments.  ``launch_plan`` keeps a shape's plan, its checks and the
kernel's shared-memory set-up, so the 30 reads of a decode step plan once
and a call reads no device value on the host (it can be captured in a CUDA
graph).  One wrapper call launches the chunks' kernel and, with more than
one split, the kernel that combines their partials in a fixed order; it
counts as one launch.

The TPU kernel is bit-identical to the gather read because it reduces a
slot's whole K/V strip at once.  The CUDA kernels' online softmax and
combine sum in another order, so they agree with the gather read within
float tolerance (1e-5 in float32 against a float64 plain version); with no
atomics, two calls on the same inputs give bitwise-equal results.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import _sdpa, _sdpa_quant, decode_mask
from repro_torch.models.paging import gather_pages

# kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"paged_attention": 0, "paged_attention_quant": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The plan's constants.  TILE_ROWS is TR in csrc/paged_attention.cu, the
# rows a block stages at a time: a chunk of whole tiles wastes none of its
# loads.  BLOCKS_PER_SM is what the split count aims at over the card: a
# slot's admitted prefix may be far shorter than ``length`` and ``pos`` is
# not read on the host, so splits past what fills the SMs only add blocks
# that exit at once and the combine pass.  Its value, 2, was fitted to a
# sweep of forced split counts on the H100 at the serving shape, one live
# slot, eight full slots and eight slots at position 0, float32 and int8
# pools (scripts/paged_attention_times.py --splits, PERF.md section 6).
TILE_ROWS = 32
BLOCKS_PER_SM = 2
MAX_HEAD_DIM = 512


def head_block(G: int, hd: int) -> int:
    """The query heads one block of the kernel keeps: G rounded up to a
    power of two, at most 16 for a head dim up to 128, 8 up to 256 and 4 up
    to 512 (a lane holds 16 chunks of 4 dims over its heads, at most 4 a
    head).  A group of more heads takes ceil(G / heads) blocks.  The kernel
    is instantiated for exactly these counts and refuses any other."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} over {MAX_HEAD_DIM}, the most the "
                         "kernel keeps in registers")
    cap = 16 if hd <= 128 else 8 if hd <= 256 else 4
    gb = 1
    while gb < min(G, cap):
        gb *= 2
    return gb


def split_plan(B: int, KV: int, G: int, hd: int, length: int, ps: int,
               sm_count: int) -> tuple[int, int]:
    """(splits, chunk) of a decode read: split s takes the positions
    [s * chunk, min((s + 1) * chunk, length)), so the splits cover
    [0, length) exactly once.  The chunk is a multiple of the tile (32
    rows) and, where their least common multiple is at most 8 tiles, of the
    page size.  The splits are as many as keep ``BLOCKS_PER_SM`` blocks an
    SM over the launch's B * KV * ceil(G / head_block) blocks a split (at
    least 1, at most the chunks of ``length``).  A pure function of the
    shapes and the SM count: the same inputs give the same plan, and ``pos``
    plays no part."""
    if min(B, KV, G, hd, length, ps, sm_count) < 1:
        raise ValueError(f"split_plan needs positive sizes, got B={B}, KV={KV}, "
                         f"G={G}, hd={hd}, length={length}, ps={ps}, "
                         f"sm_count={sm_count}")
    unit = math.lcm(TILE_ROWS, ps)
    if unit > 8 * TILE_ROWS:
        unit = TILE_ROWS
    blocks = B * KV * -(-G // head_block(G, hd))
    splits = max(1, min(BLOCKS_PER_SM * sm_count // blocks, -(-length // unit)))
    chunk = -(-(-(-length // splits)) // unit) * unit
    return -(-length // chunk), chunk


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device ``device_index``, read once."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class Plan(ctypes.Structure):
    """The shapes and the plan of a launch, as ``struct Plan`` of
    ``csrc/paged_attention.cu`` (same fields, same order); the C entry
    points take a pointer to it.  ``stages``, the depth of the kernel's
    tile ring, is the device's: ``paged_attention_prepare`` writes it (the
    deepest of 3, 2, 1 that fits the shared memory)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "P", "ps", "num_pages", "KV", "G", "gb", "hd", "T", "splits",
        "chunk", "stages")] + [("scale", ctypes.c_float)]


@functools.lru_cache(maxsize=256)
def launch_plan(device_index: int, quant: bool, q_shape, pool_shape,
                table_shape, pos_shape, kv_bytes: int, length: int):
    """What a launch of these shapes needs, kept per shape: its shape checks,
    the ``Plan``, and the kernel's shared-memory set-up on the device
    (``paged_attention_prepare``, which also refuses what the kernel cannot
    take, and sets the plan's ring depth).  Returns (C entry point, scratch
    elements (0 with one split), the ``Plan``)."""
    B, H, hd, P, ps, KV = _check_geometry(q_shape, pool_shape, table_shape,
                                          length)
    if tuple(pool_shape) != (pool_shape[0], ps, KV, hd):
        raise ValueError(f"pool shape {tuple(pool_shape)} does not hold "
                         f"head dim {hd}")
    if tuple(pos_shape) != (B,):
        raise ValueError(f"pos shape {tuple(pos_shape)} != {(B,)}")
    per_load = 16 // kv_bytes
    if hd % per_load:
        raise ValueError(f"head dim {hd} not a multiple of {per_load} "
                         f"({kv_bytes}-byte pool rows load 16 bytes at a time)")
    if min(B, KV, length) < 1:
        raise ValueError(f"empty operand: B={B}, KV={KV}, length={length}")
    G = H // KV
    gb = head_block(G, hd)
    splits, chunk = split_plan(B, KV, G, hd, length, ps, sm_count(device_index))
    plan = Plan(B, P, ps, pool_shape[0], KV, G, gb, hd, length, splits, chunk,
                0, hd ** -0.5)
    lib = build.load("paged_attention")
    smem = lib.paged_attention_prepare(ctypes.addressof(plan), kv_bytes,
                                       int(quant), device_index)
    if smem < 0:
        raise ValueError(f"the kernel refuses groups {G} x head dim {hd}, "
                         f"{splits} splits of {chunk}, page size {ps} "
                         f"(cudaError {-smem}: 9 means its block needs more "
                         "shared memory than the device gives one)")
    fn = lib.paged_attention_int8 if quant else lib.paged_attention_float
    return fn, B * H * splits * (hd + 2) if splits > 1 else 0, plan


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def execution_mode(device="cuda") -> str:
    """How a ``kv_read="kernel"`` read of a cache on ``device`` runs:
    ``"cuda-kernel"`` or ``"torch-plain"`` (CPU tensors only)."""
    return "cuda-kernel" if torch.device(device).type == "cuda" else "torch-plain"


def _check_geometry(q_shape, pool_shape, table_shape, length):
    B, Sq, H, hd = q_shape
    if Sq != 1:
        raise ValueError(f"decode kernel takes one query token, got Sq={Sq}")
    P = table_shape[1]
    ps, KV = pool_shape[1], pool_shape[2]
    if table_shape[0] != B:
        raise ValueError(f"page table batch {table_shape[0]} != query batch {B}")
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
    _check_geometry(q.shape, k_pool.shape, table.shape, length)
    (k, v), mask = _gathered((k_pool, v_pool), table, pos, length, sliding_window)
    return _sdpa(q, k, v, mask)


def paged_attention_quant_plain(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                                table, pos, *, length: int, sliding_window=None,
                                compute_dtype=None):
    """``_sdpa_quant`` over ``gather_pages`` of the int8 and scale pools."""
    _check_geometry(q.shape, k_pool.shape, table.shape, length)
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


def _launch(count_name, q, k_pool, v_pool, table, pos, operands, out_dtype,
            codes, *, quant, length):
    """One kernel launch on q's device and current stream: the per-shape
    plan (``launch_plan``), the output, the scratch only with more than one
    split, and the ``ctypes`` call.  ``operands`` are the tensors whose
    pointers lead the C entry point's arguments."""
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"table and pos must be int32, got {table.dtype}, "
                        f"{pos.dtype}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary")
    dev = q.device
    fn, part_numel, plan = launch_plan(dev.index, quant, q.shape, k_pool.shape,
                                       table.shape, pos.shape,
                                       k_pool.element_size(), length)
    B, _, H, hd = q.shape
    out = torch.empty((B, 1, H * hd), dtype=out_dtype, device=dev)
    part = (torch.empty(part_numel, dtype=torch.float32, device=dev)
            if part_numel else None)
    err = fn(*(t.data_ptr() for t in operands),
             None if part is None else part.data_ptr(), out.data_ptr(),
             ctypes.addressof(plan), *codes, dev.index,
             _current_stream(dev.index))
    if err:
        raise RuntimeError(f"{count_name} launch failed: cudaError {err}")
    LAUNCHES[count_name] += 1
    return out


def _current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of the device's current stream (the call
    ``torch.cuda.current_stream(i).cuda_stream`` makes, without building a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


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
    q = q.contiguous()
    return _launch("paged_attention", q, k_pool, v_pool, table, pos,
                   (q, k_pool, v_pool, table, pos), q.dtype,
                   (_DTYPE_CODE[q.dtype],), quant=False, length=length)


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
    q = q.contiguous()
    return _launch("paged_attention_quant", q, k_pool, v_pool, table, pos,
                   (q, k_pool, k_scale_pool, v_pool, v_scale_pool, table, pos),
                   compute_dtype,
                   (_DTYPE_CODE[q.dtype], _DTYPE_CODE[compute_dtype]),
                   quant=True, length=length)
