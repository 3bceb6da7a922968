"""Grouped-query attention (GQA, + bias, sliding window) for training and
serving.

Port of the GQA part of ``repro/models/attention.py``; params are plain
dicts with the reference's keys.  Shapes: x (B, S, D); q heads H, kv heads
KV, head dim hd.  Decode functions take a KV cache and one new token
(B, 1, D) at position ``pos`` (scalar or (B,) int32) and return
(y, cache); sliding-window caches are ring buffers of length ``window``.

Both cache layouts of the reference:

* contiguous — cache leaves are per-slot strips (B, T, ...).
* paged — cache leaves are shared pools (num_pages, page_size, ...) and
  ``pages`` carries the per-slot page table (B, P); ``length`` gives the
  logical per-slot length T the contiguous layout would have.  The gather
  read builds the exact contiguous (B, T, ...) view
  (``repro_torch.models.paging.gather_pages``), so masks and SDPA are the
  same code on both layouts.  GQA decode also takes ``kv_read="kernel"``:
  the hand-written CUDA paged-attention kernel walks the page table itself
  (``repro_torch.kernels.paged_attention``).  Its online softmax sums in
  another order than the gather read, so the two agree within float
  tolerance, not bit for bit as the reference's Pallas kernel does.

Cache writes happen IN PLACE (the reference returns new caches): decode
and prefill return the cache dict they were given, with its leaves
updated.  ``live`` (B,) bool makes rows marked False write NOTHING.

Training and prefill without a cache: ``apply_gqa`` over a causal mask,
q-chunked past ``CHUNK_THRESHOLD`` with each chunk recomputed in the
backward (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
per chunk.  The reference computes this attention in plain jnp with no
Pallas kernel, so the port runs the same plain matmul and softmax as the
serving path's ``_sdpa``.

MLA and cross-attention are not ported yet: they come with ROADMAP.md
slice 4, part 2.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import paging
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(rng: torch.Generator, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, qkv_bias: bool = False,
             dtype=torch.float32, *, lead: tuple = ()):
    p = {
        "w_q": dense_init(rng, d_model, num_heads * head_dim, dtype, lead=lead),
        "w_k": dense_init(rng, d_model, num_kv_heads * head_dim, dtype, lead=lead),
        "w_v": dense_init(rng, d_model, num_kv_heads * head_dim, dtype, lead=lead),
        "w_o": dense_init(rng, num_heads * head_dim, d_model, dtype, lead=lead),
    }
    if qkv_bias:
        dev = rng.device
        p["b_q"] = torch.zeros((*lead, num_heads * head_dim), dtype=dtype, device=dev)
        p["b_k"] = torch.zeros((*lead, num_kv_heads * head_dim), dtype=dtype, device=dev)
        p["b_v"] = torch.zeros((*lead, num_kv_heads * head_dim), dtype=dtype, device=dev)
    return p


def _qkv(p, x, num_heads, num_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return (q.reshape(B, S, num_heads, head_dim),
            k.reshape(B, S, num_kv_heads, head_dim),
            v.reshape(B, S, num_kv_heads, head_dim))


def _expand_mask(mask):
    return mask[:, :, None, :, :] if mask.ndim == 4 else mask


def _acc_dtype(dtype):
    """The reference's float32 casts: float32 for float32 and bfloat16
    inputs; float64 inputs stay float64 (the plain versions run float64
    copies as an oracle for the kernels' rounding)."""
    return torch.promote_types(dtype, torch.float32)


def _sdpa(q, k, v, mask):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd), v (B,Sk,KV,hd_v).  mask broadcastable
    (B,1,Sq,Sk).  The reference's op order: scores cast to float32,
    ``hd ** -0.5`` after the dot, masked to NEG_INF, softmax in float32,
    probs cast back to q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    hd_v = v.shape[-1]
    groups = H // KV
    qg = q.reshape(B, Sq, KV, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    scores = scores.to(_acc_dtype(scores.dtype)) * (hd ** -0.5)
    scores = scores.masked_fill(~_expand_mask(mask), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H * hd_v)


def causal_mask(Sq: int, Sk: int, window: int | None = None, q0: int = 0,
                k0: int = 0, device=None):
    """(1, 1, Sq, Sk) boolean for a (q, k) tile at absolute offsets (q0, k0)."""
    qpos = q0 + torch.arange(Sq, device=device)[:, None]
    kpos = k0 + torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


# Above this sequence length, attention runs q-chunked with per-chunk
# recomputation, so the live score tensor is (B, H, q_chunk, kv_len) instead
# of (B, H, S, S).
CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024


def _sdpa_causal(q, k, v, window: int | None = None, q_chunk: int = Q_CHUNK):
    """Causal SDPA, q-chunked above CHUNK_THRESHOLD.  Static chunk bounds:
    chunk i attends kv[max(0, i*qc - window + 1) : (i+1)*qc), its start
    aligned down to the chunk grid."""
    S = q.shape[1]
    if S <= CHUNK_THRESHOLD:
        return _sdpa(q, k, v, causal_mask(S, S, window, device=q.device))
    qc = min(q_chunk, S)
    while S % qc:
        qc -= 1
    outs = []
    for i in range(S // qc):
        q0 = i * qc
        kv_end = q0 + qc
        kv_start = 0 if window is None else max(0, q0 - window + 1)
        kv_start -= kv_start % qc
        mask = causal_mask(qc, kv_end - kv_start, window, q0=q0, k0=kv_start,
                           device=q.device)
        outs.append(checkpoint(_sdpa, q[:, q0:kv_end], k[:, kv_start:kv_end],
                               v[:, kv_start:kv_end], mask, use_reentrant=False))
    return torch.cat(outs, dim=1)


def apply_gqa(p, x, positions, *, num_heads, num_kv_heads, head_dim,
              rotary_dim, rope_theta=10000.0, sliding_window=None):
    """Training-time GQA over the whole sequence: x (B,S,D), positions
    (B,S) -> (B,S,D)."""
    q, k, v = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    q = apply_rope(q, positions, rotary_dim, rope_theta)
    k = apply_rope(k, positions, rotary_dim, rope_theta)
    return _sdpa_causal(q, k, v, sliding_window) @ p["w_o"]


def init_gqa_cache(batch: int, length: int, num_kv_heads: int, head_dim: int,
                   dtype=torch.float32, quant: bool = False, *, lead: tuple = (),
                   device="cuda"):
    """KV cache.  quant=True stores int8 values + per-(pos, kv-head) float32
    scales (folded into scores/probs at use, so the dequantized cache is
    never built).  ``lead`` prepends the stacked superblock axis."""
    shape = (*lead, batch, length, num_kv_heads, head_dim)
    if quant:
        sshape = (*lead, batch, length, num_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x):
    """x (B,S,KV,hd) -> (int8 values, (B,S,KV,1) float32 scales)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _sdpa_quant(q, k_q, k_scale, v_q, v_scale, mask, compute_dtype):
    """SDPA over an int8 cache: scales fold into scores/probs, so the
    dequantized cache is never built."""
    B, Sq, H, hd = q.shape
    KV = k_q.shape[2]
    groups = H // KV
    acc = _acc_dtype(q.dtype)
    qg = q.reshape(B, Sq, KV, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(acc), k_q.to(acc))
    scores = scores * k_scale[:, :, :, 0].permute(0, 2, 1)[:, :, None, None, :]
    scores = scores * (hd ** -0.5)
    scores = scores.masked_fill(~_expand_mask(mask), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_scale[:, :, :, 0].permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_q.to(acc))
    return out.reshape(B, Sq, H * hd).to(compute_dtype)


def _write_rows(cache, new, slots, T, *, pages, live):
    """Decode-step cache write (one position per row), in place, on either
    layout.  ``new`` maps leaf name -> (B, 1, ...) values.  Paged: scatter
    through the page table.  Contiguous with ``live``: rows not live (and
    slots past T) write nothing.  Contiguous without ``live``: the
    reference's dynamic-update path, whose start index clamps to T - 1."""
    if pages is not None:
        for n, val in new.items():
            paging.scatter_rows(cache[n], pages, slots, val, live=live)
        return cache
    B = slots.shape[0]
    b_idx = torch.arange(B, device=slots.device)
    slots = slots.long()
    if live is None:
        keep = torch.ones((B,), dtype=torch.bool, device=slots.device)
        slots = torch.clamp(slots, 0, T - 1)
    else:
        keep = live & (slots < T)
    idx = b_idx * T + torch.clamp(slots, 0, T - 1)
    for n, val in new.items():
        leaf = cache[n]
        paging.masked_write(leaf.view(-1, *leaf.shape[2:]), idx, val[:, 0], keep)
    return cache


def _write_chunk(cache, new, slots, valid, T, *, pages):
    """Prefill-chunk cache write, in place: ``new`` maps leaf name ->
    (B, C, ...) values at logical slots (B, C); ``valid`` False (padded
    tails, rows not prefilling) drops the write on both layouts."""
    if pages is not None:
        for n, val in new.items():
            paging.scatter_chunk(cache[n], pages, slots, valid, val)
        return cache
    B, C = slots.shape
    slots = slots.long()
    keep = (valid & (slots < T)).reshape(-1)
    b_idx = torch.arange(B, device=slots.device)[:, None]
    idx = (b_idx * T + torch.clamp(slots, 0, T - 1)).reshape(-1)
    for n, val in new.items():
        leaf = cache[n]
        paging.masked_write(leaf.view(-1, *leaf.shape[2:]), idx,
                            val.reshape(-1, *val.shape[2:]), keep)
    return cache


def _view(cache, pages, T):
    """The (B, T, ...) per-slot view attention reads: the cache itself on
    the contiguous layout, a gather of the pools on the paged one."""
    if pages is None:
        return cache
    return {n: paging.gather_pages(cache[n], pages, T) for n in cache}


def decode_mask(pos_b, T: int, sliding_window):
    """(B, T) decode validity: linear caches admit written positions
    (``idx <= pos``), ring buffers the last ``min(pos + 1, T)`` writes."""
    idx = torch.arange(T, device=pos_b.device)[None, :]
    if sliding_window is not None:
        slots = pos_b % T
        age = (slots[:, None] - idx) % T
        return age < torch.clamp(pos_b + 1, max=T)[:, None]
    return idx <= pos_b[:, None]


def apply_gqa_decode(p, x, cache, pos, *, num_heads, num_kv_heads, head_dim,
                     rotary_dim, rope_theta=10000.0, sliding_window=None,
                     pages=None, length=None, live=None, kv_read="gather"):
    """One-token decode.  x (B,1,D); cache k/v (B,T,KV,hd) (T=window for
    SWA), or pooled (num_pages, ps, KV, hd) when ``pages`` is given.
    Returns (y (B,1,D), cache) with the cache written in place.

    ``kv_read`` selects how a PAGED cache is read: ``"gather"`` builds the
    contiguous view and reuses the contiguous SDPA; ``"kernel"`` walks the
    page table inside the CUDA paged-attention kernel (its plain version on
    a CPU tensor), reading the same post-write pools.
    """
    B = x.shape[0]
    paged = pages is not None
    if kv_read not in ("gather", "kernel"):
        raise ValueError(f"unknown kv_read {kv_read!r} "
                         "(expected 'gather' | 'kernel')")
    if kv_read == "kernel" and not paged:
        raise ValueError("kv_read='kernel' requires the paged cache layout "
                         "(the kernel is a page-table walk; contiguous "
                         "caches have no table to walk)")
    T = length if paged else cache["k"].shape[1]
    q, k, v = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).expand(B).contiguous()
    positions = pos_b[:, None]
    q = apply_rope(q, positions, rotary_dim, rope_theta)
    k = apply_rope(k, positions, rotary_dim, rope_theta)
    slots = pos_b % T if sliding_window is not None else pos_b
    quant = "k_scale" in cache
    if quant:
        k_q, k_s = _quantize_kv(k)
        v_q, v_s = _quantize_kv(v)
        new = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    else:
        new = {"k": k, "v": v}
    _write_rows(cache, new, slots, T, pages=pages, live=live)
    if kv_read == "kernel":
        att = kops.paged_attention_decode(q, cache, pages, pos_b, length=T,
                                          sliding_window=sliding_window,
                                          compute_dtype=x.dtype)
        return att @ p["w_o"], cache
    view = _view(cache, pages, T)
    mask = decode_mask(pos_b, T, sliding_window)[:, None, None, :]
    if quant:
        y = _sdpa_quant(q, view["k"], view["k_scale"], view["v"],
                        view["v_scale"], mask, x.dtype) @ p["w_o"]
    else:
        y = _sdpa(q, view["k"], view["v"], mask) @ p["w_o"]
    return y, cache


def apply_gqa_prefill(p, x, cache, pos, valid, *, num_heads, num_kv_heads,
                      head_dim, rotary_dim, rope_theta=10000.0,
                      sliding_window=None, pages=None, length=None):
    """Chunked prefill: ingest C tokens per row in one call.

    x (B,C,D); cache as in :func:`apply_gqa_decode`; pos (B,) per-row start
    positions; valid (B,C) marks real tokens (False: no cache write, no
    attention contribution).  Attention runs over [pre-chunk cache ; chunk
    keys] — never the post-write cache — so ring buffers stay correct.
    Returns (y (B,C,D), cache) with the chunk written in place.
    """
    B, C, D = x.shape
    paged = pages is not None
    T = length if paged else cache["k"].shape[1]
    if sliding_window is not None and C > T:
        raise ValueError(f"chunk size {C} exceeds ring-buffer length {T}")
    q, k, v = _qkv(p, x, num_heads, num_kv_heads, head_dim)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    qpos = pos[:, None] + torch.arange(C, dtype=torch.int32, device=x.device)
    q = apply_rope(q, qpos, rotary_dim, rope_theta)
    k = apply_rope(k, qpos, rotary_dim, rope_theta)

    # pre-chunk cache validity: slot s last held absolute position
    # last_s = (pos-1) - ((pos-1-s) mod T)  (< 0 => never written)
    s_idx = torch.arange(T, dtype=torch.int32, device=x.device)
    last = (pos[:, None] - 1) - torch.remainder(pos[:, None] - 1 - s_idx, T)
    m_cache = (last >= 0)[:, None, :].expand(B, C, T)
    m_chunk = (qpos[:, :, None] >= qpos[:, None, :]) & valid[:, None, :]
    if sliding_window is not None:
        m_cache = m_cache & (last[:, None, :] > qpos[:, :, None] - sliding_window)
        m_chunk = m_chunk & (qpos[:, None, :] > qpos[:, :, None] - sliding_window)
    mask = torch.cat([m_cache, m_chunk], dim=-1)[:, None]         # (B,1,C,T+C)

    cview = _view(cache, pages, T)
    quant = "k_scale" in cache
    if quant:
        # dequantized *view* for the prefill matmuls (transient)
        ck = (cview["k"].float() * cview["k_scale"]).to(x.dtype)
        cv = (cview["v"].float() * cview["v_scale"]).to(x.dtype)
    else:
        ck, cv = cview["k"], cview["v"]
    y = _sdpa(q, torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1),
              mask) @ p["w_o"]

    slot = qpos % T if sliding_window is not None else qpos
    if quant:
        k_q, k_s = _quantize_kv(k)
        v_q, v_s = _quantize_kv(v)
        new = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    else:
        new = {"k": k, "v": v}
    return y, _write_chunk(cache, new, slot, valid, T, pages=pages)
