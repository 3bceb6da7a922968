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

MLA (DeepSeek-V2 multi-head latent attention): ``apply_mla`` trains over
the whole sequence; ``apply_mla_decode`` and ``apply_mla_prefill`` serve
over the compressed cache (the latent ``c_kv`` and the shared rope key
``k_pe``, on either layout) in the absorbed form, with ``W_uk`` folded into
the query and ``W_uv`` applied after the read, as the reference.  Their
sums run in another order than ``apply_mla``'s.  A paged latent cache is
always read by the gather (the reference has no kernel for it).  Cross-attention
(``apply_cross_attention``) trains; its decode comes with ROADMAP.md slice
4, part 3.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import paging
from repro_torch.models.layers import (apply_rope, dense_init, matmul, promote,
                                       rms_norm)
from repro_torch.sharding.constraints import (is_dtensor, on_local_heads,
                                              rows_only, split_heads,
                                              whole_grad)

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
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return (split_heads(q, num_heads, head_dim),
            split_heads(k, num_kv_heads, head_dim),
            split_heads(v, num_kv_heads, head_dim))


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
    scores = torch.einsum("bqkgh,bskh->bkgqs", *promote(qg, k))
    scores = scores.to(_acc_dtype(scores.dtype)) * (hd ** -0.5)
    scores = scores.masked_fill(~_expand_mask(mask), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", *promote(probs, v))
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
    aligned down to the chunk grid.  Over a mesh (DTensor inputs), each
    rank attends with its own rows and heads on local tensors
    (``sharding.constraints.on_local_heads``)."""
    if is_dtensor(q):
        return on_local_heads(_sdpa_causal, q, k, v, window, q_chunk)
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


def apply_cross_attention(p, x, memory, *, num_heads, num_kv_heads, head_dim):
    """x (B,Sq,D) attends to memory (B,Sk,D); no mask, no rope."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    q = x @ p["w_q"]
    k = memory @ p["w_k"]
    v = memory @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=x.device)
    return _sdpa(q.reshape(B, Sq, num_heads, head_dim),
                 k.reshape(B, Sk, num_kv_heads, head_dim),
                 v.reshape(B, Sk, num_kv_heads, head_dim), mask) @ p["w_o"]


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


def _written_view(cache, new, slots, T, *, pages, live):
    """The (B, T, ...) view attention reads after ``_write_rows(cache, new,
    slots, T, pages=pages, live=live)``, built without writing: the view of
    the cache as it is, with each row that write would store in every
    position of the view that reads its place (on the paged layout a slot
    without pages reads page 0, which a live slot may own).  The decode
    step's no-write mode."""
    B = slots.shape[0]
    dev = slots.device
    slots = slots.long()
    t = torch.arange(T, device=dev)
    if pages is not None:
        ps = next(iter(cache.values())).shape[1]
        table = pages.long()
        P = table.shape[1]
        page = torch.gather(table, 1, torch.clamp(slots // ps, 0, P - 1)[:, None])[:, 0]
        keep = slots < P * ps
        if live is not None:
            keep = keep & live
        idx = page * ps + slots % ps
        reads = table[:, t // ps] * ps + t % ps                   # (B, T)
    else:
        if live is None:
            keep = torch.ones((B,), dtype=torch.bool, device=dev)
        else:
            keep = live & (slots < T)
        b_idx = torch.arange(B, device=dev)
        idx = b_idx * T + torch.clamp(slots, 0, T - 1)
        reads = b_idx[:, None] * T + t[None, :]
    hit = (reads[:, :, None] == idx[None, None, :]) & keep[None, None, :]
    written = hit.any(-1)                                         # (B, T)
    writer = torch.argmax(hit.to(torch.int32), dim=-1)            # (B, T)
    view = _view(cache, pages, T)
    out = {}
    for n, leaf in view.items():
        mask = written.reshape(B, T, *(1,) * (leaf.ndim - 2))
        out[n] = torch.where(mask, new[n][:, 0][writer].to(leaf.dtype), leaf)
    return out


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
                     pages=None, length=None, live=None, kv_read="gather",
                     write=True):
    """One-token decode.  x (B,1,D); cache k/v (B,T,KV,hd) (T=window for
    SWA), or pooled (num_pages, ps, KV, hd) when ``pages`` is given.
    Returns (y (B,1,D), cache) with the cache written in place.

    ``kv_read`` selects how a PAGED cache is read: ``"gather"`` builds the
    contiguous view and reuses the contiguous SDPA; ``"kernel"`` walks the
    page table inside the CUDA paged-attention kernel (its plain version on
    a CPU tensor), reading the same post-write pools.

    ``write=False`` writes nothing: attention reads the view the write
    would have left (``_written_view``), so ``y`` is the same.  The kernel
    reads the pools themselves, so that mode takes the gather read only.
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
    if kv_read == "kernel" and not write:
        raise ValueError("a decode step with write=False reads through "
                         "kv_read='gather': the kernel reads the pools, "
                         "which hold none of the step's rows")
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
    if not write:
        view = _written_view(cache, new, slots, T, pages=pages, live=live)
    else:
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
        y = matmul(_sdpa(q, view["k"], view["v"], mask), p["w_o"])
    return y, cache


def apply_gqa_prefill(p, x, cache, pos, valid, *, num_heads, num_kv_heads,
                      head_dim, rotary_dim, rope_theta=10000.0,
                      sliding_window=None, pages=None, length=None,
                      write=True):
    """Chunked prefill: ingest C tokens per row in one call.

    x (B,C,D); cache as in :func:`apply_gqa_decode`; pos (B,) per-row start
    positions; valid (B,C) marks real tokens (False: no cache write, no
    attention contribution).  Attention runs over [pre-chunk cache ; chunk
    keys] — never the post-write cache — so ring buffers stay correct.
    Returns (y (B,C,D), cache) with the chunk written in place, or, with
    ``write=False`` (the speculative verify), the cache untouched.
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
    y = matmul(_sdpa(q, torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1),
                     mask), p["w_o"])

    if not write:
        return y, cache
    slot = qpos % T if sliding_window is not None else qpos
    if quant:
        k_q, k_s = _quantize_kv(k)
        v_q, v_s = _quantize_kv(v)
        new = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    else:
        new = {"k": k, "v": v}
    return y, _write_chunk(cache, new, slot, valid, T, pages=pages)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention), training forward
# ---------------------------------------------------------------------------

def init_mla(rng: torch.Generator, d_model: int, num_heads: int, *,
             kv_lora_rank: int, qk_nope_dim: int, qk_rope_dim: int,
             v_head_dim: int, dtype=torch.float32, lead: tuple = ()):
    H = num_heads
    return {
        "w_q": dense_init(rng, d_model, H * (qk_nope_dim + qk_rope_dim), dtype,
                          lead=lead),
        "w_dkv": dense_init(rng, d_model, kv_lora_rank, dtype, lead=lead),
        "kv_norm": torch.ones((*lead, kv_lora_rank), dtype=dtype,
                              device=rng.device),
        "w_uk": dense_init(rng, kv_lora_rank, H * qk_nope_dim, dtype, lead=lead),
        "w_uv": dense_init(rng, kv_lora_rank, H * v_head_dim, dtype, lead=lead),
        "w_kpe": dense_init(rng, d_model, qk_rope_dim, dtype, lead=lead),
        "w_o": dense_init(rng, H * v_head_dim, d_model, dtype, lead=lead),
    }


def _mla_qc(p, x, positions, *, num_heads, qk_nope_dim, qk_rope_dim, rope_theta):
    """(q_nope, q_rope, c_kv, k_pe): the per-head query halves, the
    normalised latent (B,S,L) and the shared rope key (B,S,rope)."""
    q = split_heads(matmul(x, p["w_q"]), num_heads, qk_nope_dim + qk_rope_dim)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, qk_rope_dim, rope_theta)
    # over a mesh the latent and the rope key, from weights no rule
    # splits, are kept whole but for their rows: DTensor would split their
    # columns over "model" and then their sequence for the norm
    c_kv = whole_grad(rms_norm(rows_only(matmul(x, p["w_dkv"])), p["kv_norm"]))
    k_pe = apply_rope(rows_only(matmul(x, p["w_kpe"]))[:, :, None, :], positions,
                      qk_rope_dim, rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_pe


def apply_mla(p, x, positions, *, num_heads, kv_lora_rank, qk_nope_dim,
              qk_rope_dim, v_head_dim, rope_theta=10000.0, sliding_window=None):
    """Training-time MLA over the whole sequence: the rope key, shared by
    the heads, is concatenated to each head's key so that the concatenated
    score is the MLA score, through the causal SDPA (scaled by the query
    head dim, qk_nope_dim + qk_rope_dim, as the reference)."""
    B, S, _ = x.shape
    H = num_heads
    q_nope, q_rope, c_kv, k_pe = _mla_qc(
        p, x, positions, num_heads=H, qk_nope_dim=qk_nope_dim,
        qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    k_nope = split_heads(c_kv @ p["w_uk"], H, qk_nope_dim)
    v = split_heads(c_kv @ p["w_uv"], H, v_head_dim)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, qk_rope_dim)],
                      dim=-1)
    return _sdpa_causal(q_cat, k_cat, v, sliding_window) @ p["w_o"]


# ---------------------------------------------------------------------------
# MLA serving: absorbed-matrix decode and chunked prefill over the latents
# ---------------------------------------------------------------------------

def init_mla_cache(batch: int, length: int, kv_lora_rank: int, qk_rope_dim: int,
                   dtype=torch.float32, *, lead: tuple = (), device="cuda"):
    """MLA's cache: the compressed latent ``c_kv`` (B, T, kv_lora) and the
    shared rope key ``k_pe`` (B, T, rope); (num_pages, page_size, ...)
    pools on the paged layout.  ``lead`` prepends the superblock axis."""
    return {"c_kv": torch.zeros((*lead, batch, length, kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((*lead, batch, length, qk_rope_dim),
                                dtype=dtype, device=device)}


def apply_mla_decode(p, x, cache, pos, *, num_heads, kv_lora_rank, qk_nope_dim,
                     qk_rope_dim, v_head_dim, rope_theta=10000.0, pages=None,
                     length=None, live=None, write=True):
    """One-token absorbed-matrix decode: scores live in the kv_lora space.
    x (B,1,D); pos scalar or (B,); ``pages``/``length`` select the paged
    layout, ``live`` masks the cache writes.  Returns (y (B,1,D), cache)
    with the new latents written in place (nothing written with
    ``write=False``: the read is the view the write would have left)."""
    B = x.shape[0]
    H = num_heads
    T = length if pages is not None else cache["c_kv"].shape[1]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).expand(B).contiguous()
    q_nope, q_rope, c_kv_new, k_pe_new = _mla_qc(
        p, x, pos_b[:, None], num_heads=H, qk_nope_dim=qk_nope_dim,
        qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    new = {"c_kv": c_kv_new, "k_pe": k_pe_new}
    if write:
        _write_rows(cache, new, pos_b, T, pages=pages, live=live)
        view = _view(cache, pages, T)
    else:
        view = _written_view(cache, new, pos_b, T, pages=pages, live=live)
    c_kv, k_pe = view["c_kv"], view["k_pe"]
    w_uk = p["w_uk"].reshape(kv_lora_rank, H, qk_nope_dim)
    q_eff = torch.einsum("bhd,lhd->bhl", *promote(q_nope[:, 0], w_uk))  # (B,H,L)
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5
    scores = (torch.einsum("bhl,btl->bht", *promote(q_eff, c_kv))
              + torch.einsum("bhd,btd->bht", *promote(q_rope[:, 0], k_pe)))
    scores = scores.to(_acc_dtype(scores.dtype)) * scale
    valid = torch.arange(T, device=x.device)[None, None, :] <= pos_b[:, None, None]
    probs = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1).to(x.dtype)
    o_c = torch.einsum("bht,btl->bhl", *promote(probs, c_kv))          # (B,H,L)
    w_uv = p["w_uv"].reshape(kv_lora_rank, H, v_head_dim)
    out = torch.einsum("bhl,lhv->bhv", *promote(o_c, w_uv))
    out = out.reshape(B, 1, H * v_head_dim)
    return matmul(out, p["w_o"]), cache


def apply_mla_prefill(p, x, cache, pos, valid, *, num_heads, kv_lora_rank,
                      qk_nope_dim, qk_rope_dim, v_head_dim, rope_theta=10000.0,
                      pages=None, length=None, write=True):
    """Chunked absorbed-matrix prefill: x (B,C,D); pos (B,) start
    positions; valid (B,C) as in :func:`apply_gqa_prefill`.  The scores run
    over [the cache before the chunk ; the chunk's latents].  Returns
    (y (B,C,D), cache) with the chunk written in place (untouched with
    ``write=False``)."""
    B, C, _ = x.shape
    H = num_heads
    T = length if pages is not None else cache["c_kv"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    qpos = pos[:, None] + torch.arange(C, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_pe_new = _mla_qc(
        p, x, qpos, num_heads=H, qk_nope_dim=qk_nope_dim,
        qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    cview = _view(cache, pages, T)
    c_all = torch.cat([cview["c_kv"], c_kv_new], dim=1)          # (B,T+C,L)
    pe_all = torch.cat([cview["k_pe"], k_pe_new], dim=1)
    w_uk = p["w_uk"].reshape(kv_lora_rank, H, qk_nope_dim)
    q_eff = torch.einsum("bchd,lhd->bchl", *promote(q_nope, w_uk))
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5
    scores = (torch.einsum("bchl,btl->bhct", *promote(q_eff, c_all))
              + torch.einsum("bchd,btd->bhct", *promote(q_rope, pe_all)))
    scores = scores.to(_acc_dtype(scores.dtype)) * scale
    t_idx = torch.arange(T, dtype=torch.int32, device=x.device)
    m_cache = (t_idx[None, :] < pos[:, None])[:, None, :].expand(B, C, T)
    m_chunk = (qpos[:, :, None] >= qpos[:, None, :]) & valid[:, None, :]
    mask = torch.cat([m_cache, m_chunk], dim=-1)[:, None]        # (B,1,C,T+C)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1).to(x.dtype)
    o_c = torch.einsum("bhct,btl->bchl", *promote(probs, c_all))
    w_uv = p["w_uv"].reshape(kv_lora_rank, H, v_head_dim)
    out = torch.einsum("bchl,lhv->bchv", *promote(o_c, w_uv))
    out = out.reshape(B, C, H * v_head_dim)
    if not write:
        return matmul(out, p["w_o"]), cache
    new = {"c_kv": c_kv_new, "k_pe": k_pe_new}
    return matmul(out, p["w_o"]), _write_chunk(cache, new, qpos, valid, T,
                                               pages=pages)
