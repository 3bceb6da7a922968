"""Superblock layer-stack engine.

Port of ``repro/models/stack.py``.  The layer stack is ``num_superblocks``
repetitions of ``cfg.block_pattern``; one superblock's params are a flat
dict keyed "l{layer}_{idx}_{kind}", and the stack keeps every leaf stacked
with a leading superblock axis, exactly as the reference's trees, so they
carry across one to one.  Every sublayer is pre-norm residual:
h = h + f(norm(h)).

The reference's ``lax.scan`` over superblocks becomes a Python loop over
the views ``leaf[i]`` of the stacked leaves; cache writes into those views
land in place in the stacked pools.  In training, ``remat=True`` (the
reference's ``jax.checkpoint`` of the scan body) recomputes each
superblock in the backward through ``torch.utils.checkpoint``: it changes
memory, not numbers.

Every sublayer kind trains and serves (attn, mla, mlp, moe, mamba,
rwkv_tm, rwkv_cm, cross); ``ModelConfig`` rejects any other kind, and each
dispatch ends in ``raise ValueError(kind)``, as the reference's.  Serving
keeps a
decode cache per sublayer: attn and mla cache positions (paged or
contiguous), mamba and rwkv keep an O(1) per-slot state that is the same on
both layouts, and mlp, moe and cross keep nothing (cross re-reads the
encoder's memory at every call, as the reference does).  The chunked
prefill has a no-write mode (``write=False``), the speculative verify's:
attention reads the pre-chunk cache and the chunk's own keys as always, and
nothing is written, neither a cache position nor a recurrent state.  So
has the one-token decode step, the sanitizer's cut probe's: attention
reads the view the step's write would have left, built beside the cache,
and the recurrent state is computed and dropped.  moe serves at
``capacity_factor = num_experts``, so serving never drops a token copy.
A recurrent kind's chunked prefill runs the one-token decode step position
by position, committing state only where ``valid``, as the reference's
``_prefill_stateful`` does.

Caches are written in place: ``apply_stack_decode`` and
``apply_stack_prefill`` hand each superblock views of the stacked leaves,
so a recurrent kind copies its new state into its leaves (only on the rows
``live`` or ``valid`` marks) and never returns a fresh tensor in their
place.  As the reference's ``lax.scan`` over superblocks does, the serving
stack refuses a superblock that changes the residual stream's dtype
(``TypeError``): a bfloat16 model over a float32 cache or state promotes it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.layers import apply_mlp, init_mlp, layer_norm, rms_norm
from repro_torch.sharding.active import active_mesh
from repro_torch.sharding.constraints import (constrain, rows_only, unshard,
                                              whole_grad)

RECURRENT_KINDS = ("mamba", "rwkv_tm", "rwkv_cm")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, dtype, *, lead: tuple = (), device="cuda"):
    p = {"scale": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=device)
    return p


def _apply_norm(cfg: ModelConfig, p, x):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def init_sublayer(rng: torch.Generator, kind: str, cfg: ModelConfig, dtype, *,
                  dense_mlp: bool = False, lead: tuple = ()):
    """Params for one sublayer, including its pre-norm; ``lead`` prepends
    stacked axes to every leaf; ``dense_mlp`` makes a ``moe`` sublayer a
    dense MLP of ``d_ff`` (the ``first_dense_layers`` superblock)."""
    p: dict[str, Any] = {"norm": _init_norm(cfg, dtype, lead=lead,
                                            device=rng.device)}
    if kind in ("attn", "cross"):
        p.update(attn_lib.init_gqa(rng, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim_,
                                   cfg.qkv_bias, dtype, lead=lead))
    elif kind == "mla":
        p.update(attn_lib.init_mla(rng, cfg.d_model, cfg.num_heads,
                                   kv_lora_rank=cfg.kv_lora_rank,
                                   qk_nope_dim=cfg.qk_nope_dim,
                                   qk_rope_dim=cfg.qk_rope_dim,
                                   v_head_dim=cfg.v_head_dim, dtype=dtype,
                                   lead=lead))
    elif kind == "mlp" or (kind == "moe" and dense_mlp):
        p.update(init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                          lead=lead))
    elif kind == "moe":
        p.update(moe_lib.init_moe(rng, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                  cfg.num_experts,
                                  num_shared_experts=cfg.num_shared_experts,
                                  dtype=dtype, lead=lead))
    elif kind == "mamba":
        p.update(mamba_lib.init_mamba(rng, cfg.d_model, cfg.d_inner,
                                      d_state=cfg.d_state, d_conv=cfg.d_conv,
                                      dtype=dtype, lead=lead))
    elif kind == "rwkv_tm":
        p.update(rwkv_lib.init_rwkv_timemix(rng, cfg.d_model, cfg.num_heads,
                                            dtype=dtype, lead=lead))
    elif kind == "rwkv_cm":
        p.update(rwkv_lib.init_rwkv_channelmix(rng, cfg.d_model, cfg.d_ff,
                                               dtype=dtype, lead=lead))
    else:
        raise ValueError(kind)
    return p


def init_superblock(rng: torch.Generator, cfg: ModelConfig, dtype, *,
                    pattern=None, dense_mlp: bool = False, lead: tuple = ()):
    pattern = pattern or cfg.block_pattern
    return {f"l{li}_{si}_{kind}": init_sublayer(rng, kind, cfg, dtype,
                                                dense_mlp=dense_mlp, lead=lead)
            for li, layer in enumerate(pattern)
            for si, kind in enumerate(layer)}


def init_stack(rng: torch.Generator, cfg: ModelConfig, dtype):
    """Stacked superblock params: every leaf has leading dim num_superblocks."""
    return init_superblock(rng, cfg, dtype, lead=(cfg.num_superblocks,))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_sublayer_cache(kind: str, cfg: ModelConfig, batch: int, length: int,
                        dtype, *, paged=None, lead: tuple = (), device="cuda"):
    """One sublayer's decode cache.  With ``paged`` (a PagedLayout) the
    attn and mla leaves are shared page POOLS (num_pages, page_size, ...)
    instead of per-slot (B, T, ...) strips; an mla pool is always the
    full-length one (no ring) and never quantized.  The recurrent kinds'
    per-slot state is the same on both layouts."""
    if kind == "mamba":
        return mamba_lib.init_mamba_state(batch, cfg.d_inner, d_state=cfg.d_state,
                                          d_conv=cfg.d_conv, dtype=dtype,
                                          lead=lead, device=device)
    if kind in ("rwkv_tm", "rwkv_cm"):
        st = {"x_prev": torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                                    device=device)}
        if kind == "rwkv_tm":
            hd = cfg.d_model // cfg.num_heads
            st["wkv"] = torch.zeros((*lead, batch, cfg.num_heads, hd, hd),
                                    dtype=torch.float32, device=device)
        return st
    if kind == "mla":
        rows = (paged.num_pages, paged.page_size) if paged is not None \
            else (batch, length)
        return attn_lib.init_mla_cache(*rows, cfg.kv_lora_rank,
                                       cfg.qk_rope_dim, dtype, lead=lead,
                                       device=device)
    if kind != "attn":
        return {}                      # mlp, moe and cross keep nothing
    kw = dict(dtype=dtype, quant=cfg.kv_cache_quant, lead=lead, device=device)
    if paged is not None:
        np_ = paged.num_pages_swa if cfg.sliding_window else paged.num_pages
        return attn_lib.init_gqa_cache(np_, paged.page_size, cfg.num_kv_heads,
                                       cfg.head_dim_, **kw)
    T = min(length, cfg.sliding_window) if cfg.sliding_window else length
    return attn_lib.init_gqa_cache(batch, T, cfg.num_kv_heads, cfg.head_dim_, **kw)


def init_superblock_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                          pattern=None, *, paged=None, lead: tuple = (),
                          device="cuda"):
    pattern = pattern or cfg.block_pattern
    return {f"l{li}_{si}_{kind}": init_sublayer_cache(
                kind, cfg, batch, length, dtype, paged=paged, lead=lead,
                device=device)
            for li, layer in enumerate(pattern)
            for si, kind in enumerate(layer)}


def init_stack_cache(cfg: ModelConfig, batch: int, length: int, dtype, *,
                     paged=None, device="cuda"):
    return init_superblock_cache(cfg, batch, length, dtype, paged=paged,
                                 lead=(cfg.num_superblocks,), device=device)


def _paged_args(kind: str, cfg: ModelConfig, paged, pages, pages_swa):
    """(pages, length) kwargs for an attn or mla sublayer: SWA attn caches
    use the ring table + window length, everything else the full-length
    table."""
    if paged is None:
        return {"pages": None, "length": None}
    if kind == "attn" and cfg.sliding_window:
        return {"pages": pages_swa, "length": paged.len_swa}
    return {"pages": pages, "length": paged.len_linear}


def _index(tree, i):
    """Superblock ``i`` of a stacked tree: views ``leaf[i]`` of its leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> list:
    """The superblocks of a stacked tree, as views (``unbind`` of every
    leaf: its backward stacks the superblocks' gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# apply (train / prefill without a cache)
# ---------------------------------------------------------------------------

def _mla_args(cfg: ModelConfig) -> dict:
    """MLA's config keyword arguments, shared by training and serving."""
    return dict(num_heads=cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)


def apply_sublayer(kind: str, p, cfg: ModelConfig, h, positions, *,
                   memory=None, sliding_window=None):
    """Returns (residual_update, aux_loss); the aux loss is the MoE
    router's, 0.0 for every other kind.  Over a mesh the normed input's
    gradient is made whole before the norm's backward
    (``constraints.whole_grad``)."""
    x = whole_grad(_apply_norm(cfg, p["norm"], h))
    aux = 0.0
    if kind == "attn":
        y = attn_lib.apply_gqa(p, x, positions, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.head_dim_,
                               rotary_dim=cfg.rotary_dim,
                               rope_theta=cfg.rope_theta,
                               sliding_window=sliding_window)
    elif kind == "mla":
        y = attn_lib.apply_mla(p, x, positions, **_mla_args(cfg),
                               sliding_window=sliding_window)
    elif kind == "cross":
        y = attn_lib.apply_cross_attention(p, x, memory, num_heads=cfg.num_heads,
                                           num_kv_heads=cfg.num_kv_heads,
                                           head_dim=cfg.head_dim_)
    elif kind == "mlp" or (kind == "moe" and "router" not in p):
        y = apply_mlp(p, x)            # a moe without router: first_dense_layers
    elif kind == "moe":
        y, aux = moe_lib.apply_moe(p, x, top_k=cfg.experts_per_token,
                                   capacity_factor=cfg.capacity_factor)
    elif kind == "mamba":
        y = mamba_lib.apply_mamba(p, x, d_state=cfg.d_state)
    elif kind == "rwkv_tm":
        y = rwkv_lib.apply_rwkv_timemix(p, x, num_heads=cfg.num_heads,
                                        mode=cfg.rwkv_mode)
    elif kind == "rwkv_cm":
        y = rwkv_lib.apply_rwkv_channelmix(p, x)
    else:
        raise ValueError(kind)
    return y, aux


def apply_superblock(p_sb, cfg: ModelConfig, h, positions, *, pattern=None,
                     memory=None, sliding_window=None):
    pattern = pattern or cfg.block_pattern
    aux_total = 0.0
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            y, aux = apply_sublayer(kind, p_sb[f"l{li}_{si}_{kind}"], cfg, h,
                                    positions, memory=memory,
                                    sliding_window=sliding_window)
            # over a mesh the update is made whole but for its rows (a
            # row-parallel output's sum over "model"), so the stream keeps
            # its sequence whole inside the superblock: a matmul that
            # flattens (B, S) over a split sequence is what DTensor's
            # planner cannot place without replicating its operands
            h = h + rows_only(y)
            aux_total = aux_total + aux
    return h, aux_total


def _activation_constraint(h):
    """Sequence-shard the residual stream stored at superblock boundaries
    (Megatron-SP style): (B, S, D) -> (batch axes, "model", None).  What
    matters is that the per-superblock *stored* copies (the inputs each
    recomputed superblock keeps) are sharded.  A no-op outside a (data,
    model) mesh, on a plain tensor, or on non-divisible shapes."""
    mesh = active_mesh()
    if mesh is None or h.ndim != 3:
        return h
    names = set(mesh.axis_names)
    if "model" not in names or "data" not in names:
        return h
    batch_ax = ("pod", "data") if "pod" in names else ("data",)
    bsz = 1
    for a in batch_ax:
        bsz *= mesh.shape[a]
    B, S, _ = h.shape
    if B % bsz or S % mesh.shape["model"]:
        return h
    return constrain(h, (batch_ax, "model", None))


def apply_stack(stacked, cfg: ModelConfig, h, positions, *, memory=None,
                sliding_window=None, remat: bool = True):
    """Every superblock of ``stacked`` (leading axis: superblocks) in order.
    Returns (h, total_aux_loss).  ``remat`` recomputes each superblock in
    the backward instead of keeping its activations; ``memory`` (the
    encoder's output, for ``cross``) enters each recomputed superblock as
    an input.  Each superblock's output is sharded by
    :func:`_activation_constraint` inside the recomputed body, so the
    carry the next one keeps is the sharded one; the body gathers the
    sequence back over "model" for its own compute (Megatron-SP's
    all-gather), where the matmuls flatten (B, S).  The returned h is the
    last superblock's sharded carry."""
    def body(p_sb, h, memory):
        h, aux = apply_superblock(p_sb, cfg, unshard(h, "model"), positions,
                                  memory=memory, sliding_window=sliding_window)
        return _activation_constraint(h), aux

    aux = 0.0
    for p_sb in _unstack(stacked):
        if remat and torch.is_grad_enabled():
            h, a = checkpoint(body, p_sb, h, memory, use_reentrant=False)
        else:
            h, a = body(p_sb, h, memory)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# decode (one token, stacked caches)
# ---------------------------------------------------------------------------

def _serve_ffn(kind: str, p, cfg: ModelConfig, x):
    """A stateless sublayer's serving output.  A ``moe`` sublayer serves at
    ``capacity_factor = num_experts`` (cap = top_k * N: no copy is ever
    dropped, so every position is independent of its batch-mates); one
    without a router is the first superblock's dense MLP."""
    if kind == "moe" and "router" in p:
        return moe_lib.apply_moe(p, x, top_k=cfg.experts_per_token,
                                 capacity_factor=float(cfg.num_experts))[0]
    return apply_mlp(p, x)


def _cross(p, cfg: ModelConfig, x, memory):
    """``cross`` over the encoder's memory: its K and V are recomputed at
    every call, as in the reference (there is no cross-attention cache)."""
    return attn_lib.apply_cross_attention(p, x, memory, num_heads=cfg.num_heads,
                                          num_kv_heads=cfg.num_kv_heads,
                                          head_dim=cfg.head_dim_)


def _recurrent_step(kind: str, p, state, cfg: ModelConfig, x):
    """One token through a recurrent sublayer: x (B,1,d), ``state`` keyed as
    the sublayer's cache.  Returns (y (B,1,d), the new state keyed the
    same); ``state`` is only read."""
    if kind == "mamba":
        return mamba_lib.apply_mamba_decode(p, x, state, d_state=cfg.d_state)
    if kind == "rwkv_tm":
        y, st = rwkv_lib.apply_rwkv_timemix_decode(
            p, x, {"wkv": state["wkv"], "x_prev_tm": state["x_prev"]},
            num_heads=cfg.num_heads)
        return y, {"wkv": st["wkv"], "x_prev": st["x_prev_tm"]}
    y, st = rwkv_lib.apply_rwkv_channelmix_decode(p, x,
                                                  {"x_prev_cm": state["x_prev"]})
    return y, {"x_prev": st["x_prev_cm"]}


def _where_rows(mask, new, old):
    """``new`` on the rows (B,) ``mask`` marks, ``old`` elsewhere."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _commit(cache, state):
    """Copy ``state`` into the cache's leaves, in place: the caller's
    stacked leaves see it (a fresh tensor in the returned dict would be
    lost)."""
    for name, leaf in cache.items():
        leaf.copy_(state[name])


def apply_sublayer_decode(kind: str, p, cache, cfg: ModelConfig, h, pos, *,
                          memory=None, paged=None, pages=None, pages_swa=None,
                          live=None, kv_read="gather", write=True):
    """One-token decode sublayer step: (residual update, cache) with the
    cache written in place, or, with ``write=False``, nothing written
    (neither a cache position nor a recurrent state) and the same update."""
    x = _apply_norm(cfg, p["norm"], h)
    if kind in ("mlp", "moe"):
        return _serve_ffn(kind, p, cfg, x), cache
    if kind == "cross":
        return _cross(p, cfg, x, memory), cache
    if kind in RECURRENT_KINDS:
        y, new = _recurrent_step(kind, p, cache, cfg, x)
        if live is not None:
            # state commits only for live rows: a mid-prefill slot's state
            # must not advance on interleaved decode steps
            new = {k: _where_rows(live, n, cache[k]) for k, n in new.items()}
        if write:
            _commit(cache, new)
        return y, cache
    if kind == "mla":
        # kv_read="kernel" reaches GQA decode only: the latents stay on the
        # gather read, as in the reference (the engine warns about it)
        return attn_lib.apply_mla_decode(
            p, x, cache, pos, live=live, write=write,
            **_mla_args(cfg), **_paged_args(kind, cfg, paged, pages, pages_swa))
    if kind == "attn":
        return attn_lib.apply_gqa_decode(
            p, x, cache, pos, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
            rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta,
            sliding_window=cfg.sliding_window, live=live,
            kv_read=kv_read if paged is not None else "gather", write=write,
            **_paged_args(kind, cfg, paged, pages, pages_swa))
    raise ValueError(kind)


def apply_superblock_decode(p_sb, cache_sb, cfg: ModelConfig, h, pos, *,
                            pattern=None, memory=None, paged=None, pages=None,
                            pages_swa=None, live=None, kv_read="gather",
                            write=True):
    pattern = pattern or cfg.block_pattern
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            key = f"l{li}_{si}_{kind}"
            y, _ = apply_sublayer_decode(
                kind, p_sb[key], cache_sb[key], cfg, h, pos, memory=memory,
                paged=paged, pages=pages, pages_swa=pages_swa, live=live,
                kv_read=kv_read, write=write)
            h = h + y
    return h, cache_sb


def _check_carry(h_in, h_out, i: int):
    """The reference's ``lax.scan`` over superblocks rejects a body whose
    carry changes type; so does the serving stack."""
    if h_out.dtype != h_in.dtype:
        raise TypeError(
            f"scan body function carry input and carry output must have "
            f"equal types: the residual stream enters superblock {i} as "
            f"{h_in.dtype} and leaves it as {h_out.dtype} (a float32 cache or "
            f"state read promotes a narrower model's stream), as in the "
            f"reference")


def apply_stack_decode(stacked, cache, cfg: ModelConfig, h, pos, *,
                       memory=None, paged=None, pages=None, pages_swa=None,
                       live=None, kv_read="gather", start: int = 0,
                       stop: int | None = None, write=True):
    """One-token decode through superblocks [start, stop) of the stack
    (all by default); cache leaves have the leading superblock dim and are
    written in place (not at all with ``write=False``).  Returns (h,
    cache)."""
    stop = cfg.num_superblocks if stop is None else stop
    for i in range(start, stop):
        h_out, _ = apply_superblock_decode(
            _index(stacked, i), _index(cache, i), cfg, h, pos, memory=memory,
            paged=paged, pages=pages, pages_swa=pages_swa, live=live,
            kv_read=kv_read, write=write)
        _check_carry(h, h_out, i)
        h = h_out
    return h, cache


# ---------------------------------------------------------------------------
# chunked prefill (C tokens per row, per-row start positions, ragged tails)
# ---------------------------------------------------------------------------

def _prefill_stateful(kind: str, p, cache, cfg: ModelConfig, x, valid,
                      write=True):
    """A recurrent sublayer over a chunk, as the reference's scan over its C
    positions: each position reuses the one-token decode step and commits
    state only where ``valid`` (padded positions leave the state and
    token-shift inputs untouched).  Returns (y (B,C,d), cache) with the
    final state copied into the cache in place; ``write=False`` leaves the
    cache's state as it was."""
    state = dict(cache)
    ys = []
    for j in range(x.shape[1]):
        y, new = _recurrent_step(kind, p, state, cfg, x[:, j:j + 1])
        state = {k: _where_rows(valid[:, j], n, state[k]) for k, n in new.items()}
        ys.append(y[:, 0])
    if write:
        _commit(cache, state)
    return torch.stack(ys, dim=1), cache


def apply_sublayer_prefill(kind: str, p, cache, cfg: ModelConfig, h, pos,
                           valid, *, memory=None, paged=None, pages=None,
                           pages_swa=None, write=True):
    """Chunked-prefill sublayer step.  h (B,C,d); pos (B,) start positions;
    valid (B,C) marks real tokens.  Returns (residual update, cache);
    ``write=False`` writes nothing into the cache."""
    x = _apply_norm(cfg, p["norm"], h)
    if kind in ("mlp", "moe"):
        return _serve_ffn(kind, p, cfg, x), cache
    if kind == "cross":
        return _cross(p, cfg, x, memory), cache
    if kind in RECURRENT_KINDS:
        return _prefill_stateful(kind, p, cache, cfg, x, valid, write)
    if kind == "mla":
        return attn_lib.apply_mla_prefill(
            p, x, cache, pos, valid, write=write,
            **_mla_args(cfg), **_paged_args(kind, cfg, paged, pages, pages_swa))
    if kind == "attn":
        return attn_lib.apply_gqa_prefill(
            p, x, cache, pos, valid, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
            rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta,
            sliding_window=cfg.sliding_window, write=write,
            **_paged_args(kind, cfg, paged, pages, pages_swa))
    raise ValueError(kind)


def apply_superblock_prefill(p_sb, cache_sb, cfg: ModelConfig, h, pos, valid, *,
                             pattern=None, memory=None, paged=None, pages=None,
                             pages_swa=None, write=True):
    pattern = pattern or cfg.block_pattern
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            key = f"l{li}_{si}_{kind}"
            y, _ = apply_sublayer_prefill(
                kind, p_sb[key], cache_sb[key], cfg, h, pos, valid,
                memory=memory, paged=paged, pages=pages, pages_swa=pages_swa,
                write=write)
            h = h + y
    return h, cache_sb


def apply_stack_prefill(stacked, cache, cfg: ModelConfig, h, pos, valid, *,
                        memory=None, paged=None, pages=None, pages_swa=None,
                        start: int = 0, stop: int | None = None, write=True):
    """Chunked prefill through superblocks [start, stop); cache leaves have
    the leading superblock dim and are written in place (not at all with
    ``write=False``).  Returns (h (B,C,d), cache)."""
    stop = cfg.num_superblocks if stop is None else stop
    for i in range(start, stop):
        h_out, _ = apply_superblock_prefill(
            _index(stacked, i), _index(cache, i), cfg, h, pos, valid,
            memory=memory, paged=paged, pages=pages, pages_swa=pages_swa,
            write=write)
        _check_carry(h, h_out, i)
        h = h_out
    return h, cache
