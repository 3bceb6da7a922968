"""Superblock layer-stack engine (the ``attn`` and ``mlp`` kinds).

Port of ``repro/models/stack.py`` for the training forward and for serving.
The layer stack is ``num_superblocks`` repetitions of
``cfg.block_pattern``; one superblock's params are a flat dict keyed
"l{layer}_{idx}_{kind}", and the stack keeps every leaf stacked with a
leading superblock axis, exactly as the reference's trees, so they carry
across one to one.  Every sublayer is pre-norm residual: h = h + f(norm(h)).

The reference's ``lax.scan`` over superblocks becomes a Python loop over
the views ``leaf[i]`` of the stacked leaves; cache writes into those views
land in place in the stacked pools.  In training, ``remat=True`` (the
reference's ``jax.checkpoint`` of the scan body) recomputes each
superblock in the backward through ``torch.utils.checkpoint``: it changes
memory, not numbers.

Other sublayer kinds (mla, moe, mamba, rwkv_tm, rwkv_cm, cross) come with
ROADMAP.md slice 4, part 2, and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, init_mlp, layer_norm, rms_norm

PORTED_KINDS = ("attn", "mlp")


def _check_kind(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"sublayer kind {kind!r} is not ported yet: it comes with "
            f"ROADMAP.md slice 4, part 2; the port trains and serves "
            f"{PORTED_KINDS}")


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
                  lead: tuple = ()):
    """Params for one sublayer, including its pre-norm; ``lead`` prepends
    stacked axes to every leaf."""
    _check_kind(kind)
    p: dict[str, Any] = {"norm": _init_norm(cfg, dtype, lead=lead,
                                            device=rng.device)}
    if kind == "attn":
        p.update(attn_lib.init_gqa(rng, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim_,
                                   cfg.qkv_bias, dtype, lead=lead))
    else:
        p.update(init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                          lead=lead))
    return p


def init_superblock(rng: torch.Generator, cfg: ModelConfig, dtype, *,
                    pattern=None, lead: tuple = ()):
    pattern = pattern or cfg.block_pattern
    return {f"l{li}_{si}_{kind}": init_sublayer(rng, kind, cfg, dtype, lead=lead)
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
    attn leaves are shared page POOLS (num_pages, page_size, ...) instead
    of per-slot (B, T, ...) strips."""
    _check_kind(kind)
    if kind != "attn":
        return {}                      # mlp is stateless
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
    """(pages, length) kwargs for an attn sublayer: SWA attn caches use the
    ring table + window length, everything else the full-length table."""
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

def apply_sublayer(kind: str, p, cfg: ModelConfig, h, positions, *,
                   sliding_window=None):
    """Returns (residual_update, aux_loss); the ported kinds have no
    auxiliary loss (0.0)."""
    _check_kind(kind)
    x = _apply_norm(cfg, p["norm"], h)
    if kind == "attn":
        y = attn_lib.apply_gqa(p, x, positions, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.head_dim_,
                               rotary_dim=cfg.rotary_dim,
                               rope_theta=cfg.rope_theta,
                               sliding_window=sliding_window)
    else:
        y = apply_mlp(p, x)
    return y, 0.0


def apply_superblock(p_sb, cfg: ModelConfig, h, positions, *, pattern=None,
                     sliding_window=None):
    pattern = pattern or cfg.block_pattern
    aux_total = 0.0
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            y, aux = apply_sublayer(kind, p_sb[f"l{li}_{si}_{kind}"], cfg, h,
                                    positions, sliding_window=sliding_window)
            h = h + y
            aux_total = aux_total + aux
    return h, aux_total


def apply_stack(stacked, cfg: ModelConfig, h, positions, *,
                sliding_window=None, remat: bool = True):
    """Every superblock of ``stacked`` (leading axis: superblocks) in order.
    Returns (h, total_aux_loss).  ``remat`` recomputes each superblock in
    the backward instead of keeping its activations."""
    def body(p_sb, h):
        return apply_superblock(p_sb, cfg, h, positions,
                                sliding_window=sliding_window)

    aux = 0.0
    for p_sb in _unstack(stacked):
        if remat and torch.is_grad_enabled():
            h, a = checkpoint(body, p_sb, h, use_reentrant=False)
        else:
            h, a = body(p_sb, h)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# decode (one token, stacked caches)
# ---------------------------------------------------------------------------

def apply_sublayer_decode(kind: str, p, cache, cfg: ModelConfig, h, pos, *,
                          paged=None, pages=None, pages_swa=None, live=None,
                          kv_read="gather"):
    _check_kind(kind)
    x = _apply_norm(cfg, p["norm"], h)
    if kind == "mlp":
        return apply_mlp(p, x), cache
    return attn_lib.apply_gqa_decode(
        p, x, cache, pos, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window, live=live,
        kv_read=kv_read if paged is not None else "gather",
        **_paged_args(kind, cfg, paged, pages, pages_swa))


def apply_superblock_decode(p_sb, cache_sb, cfg: ModelConfig, h, pos, *,
                            pattern=None, paged=None, pages=None,
                            pages_swa=None, live=None, kv_read="gather"):
    pattern = pattern or cfg.block_pattern
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            key = f"l{li}_{si}_{kind}"
            y, _ = apply_sublayer_decode(
                kind, p_sb[key], cache_sb[key], cfg, h, pos, paged=paged,
                pages=pages, pages_swa=pages_swa, live=live, kv_read=kv_read)
            h = h + y
    return h, cache_sb


def apply_stack_decode(stacked, cache, cfg: ModelConfig, h, pos, *, paged=None,
                       pages=None, pages_swa=None, live=None, kv_read="gather",
                       start: int = 0, stop: int | None = None):
    """One-token decode through superblocks [start, stop) of the stack
    (all by default); cache leaves have the leading superblock dim and are
    written in place.  Returns (h, cache)."""
    stop = cfg.num_superblocks if stop is None else stop
    for i in range(start, stop):
        h, _ = apply_superblock_decode(_index(stacked, i), _index(cache, i),
                                       cfg, h, pos, paged=paged, pages=pages,
                                       pages_swa=pages_swa, live=live,
                                       kv_read=kv_read)
    return h, cache


# ---------------------------------------------------------------------------
# chunked prefill (C tokens per row, per-row start positions, ragged tails)
# ---------------------------------------------------------------------------

def apply_sublayer_prefill(kind: str, p, cache, cfg: ModelConfig, h, pos,
                           valid, *, paged=None, pages=None, pages_swa=None):
    """Chunked-prefill sublayer step.  h (B,C,d); pos (B,) start positions;
    valid (B,C) marks real tokens.  Returns (residual update, cache)."""
    _check_kind(kind)
    x = _apply_norm(cfg, p["norm"], h)
    if kind == "mlp":
        return apply_mlp(p, x), cache
    return attn_lib.apply_gqa_prefill(
        p, x, cache, pos, valid, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        **_paged_args(kind, cfg, paged, pages, pages_swa))


def apply_superblock_prefill(p_sb, cache_sb, cfg: ModelConfig, h, pos, valid, *,
                             pattern=None, paged=None, pages=None,
                             pages_swa=None):
    pattern = pattern or cfg.block_pattern
    for li, layer in enumerate(pattern):
        for si, kind in enumerate(layer):
            key = f"l{li}_{si}_{kind}"
            y, _ = apply_sublayer_prefill(
                kind, p_sb[key], cache_sb[key], cfg, h, pos, valid,
                paged=paged, pages=pages, pages_swa=pages_swa)
            h = h + y
    return h, cache_sb


def apply_stack_prefill(stacked, cache, cfg: ModelConfig, h, pos, valid, *,
                        paged=None, pages=None, pages_swa=None, start: int = 0,
                        stop: int | None = None):
    """Chunked prefill through superblocks [start, stop); cache leaves have
    the leading superblock dim and are written in place.  Returns
    (h (B,C,d), cache)."""
    stop = cfg.num_superblocks if stop is None else stop
    for i in range(start, stop):
        h, _ = apply_superblock_prefill(_index(stacked, i), _index(cache, i),
                                        cfg, h, pos, valid, paged=paged,
                                        pages=pages, pages_swa=pages_swa)
    return h, cache
