"""The causal LM: params, the training forward and loss, and the serving
entry points (decode cache, decode step, chunked prefill).

Port of ``repro/models/lm.py`` for decoder-only models built of ``attn``
and ``mlp`` sublayers (e.g. ``deepseek-7b``).  Params and caches keep the
reference's trees (stacked leaves with a leading superblock axis, dense
weights ``(d_in, d_out)`` applied as ``x @ w``), so reference trees carry
across one to one through ``repro_torch.interop``.

C3-SL integration: with a codec, the stack is split at the superblock
midpoint (``n_cut = num_superblocks // 2``).  In training the cut
activation (B, S, d) is flattened to (B, S*d) per-sample features and
round-tripped through the codec (``transport.link.roundtrip``): batch-wise
grouping over B with D = S*d_model, the paper's Algorithm 1.  In serving
the cut-layer features are compressed batch-wise across the decode batch
(decode), or per position across slots (chunked prefill), exactly as the
reference.

Caches are written IN PLACE: ``decode_step`` and ``prefill_chunk`` return
the cache dict they were given.  Entry points run on the card unless the
caller passes ``device="cpu"`` (or CPU tensors).

Not ported yet: encoder-decoder models, modality frontends and
``first_dense_layers`` (ROADMAP.md slice 4, part 2), and speculative
``verify_chunk`` (slice 5, serving II).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.codecs.c3sl import sequence_group_decode, sequence_group_encode
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_map
from repro_torch.models import stack as stack_lib
from repro_torch.models.layers import dense_init, embed_init, softmax_cross_entropy
from repro_torch.models.stack import _apply_norm, _init_norm
from repro_torch.transport.link import roundtrip


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for model features outside this slice."""
    for what, on in (("encoder-decoder models", cfg.is_encdec),
                     ("modality frontends", bool(cfg.frontend)),
                     ("first_dense_layers", bool(cfg.first_dense_layers))):
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet: they come with "
                f"ROADMAP.md slice 4, part 2")
    for layer in cfg.block_pattern:
        for kind in layer:
            stack_lib._check_kind(kind)


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def init_lm_params(rng, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
    """Random params with the reference's tree and scales.  ``rng`` is a
    seed (a generator on ``device`` is made from it, so the weights are
    drawn on the card by default) or a ``torch.Generator``, whose device
    the weights are drawn on."""
    check_supported(cfg)
    gen = _generator(rng, device)
    p: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "stack": stack_lib.init_stack(gen, cfg, dtype),
        "final_norm": _init_norm(cfg, dtype, device=gen.device),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }
    return p


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token embedding.  Returns (h (B,S,d), positions (B,S))."""
    h = params["embed"][batch["tokens"].long()]
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    return h, positions


def _split_stacked(stacked, n_front: int):
    """(superblocks [0, n_front), the rest) of a stacked tree, as views."""
    front = tree_map(lambda a: a[:n_front], stacked)
    back = tree_map(lambda a: a[n_front:], stacked)
    return front, back


def lm_forward(params, batch, cfg: ModelConfig, *, codec=None,
               codec_params=None, sliding_window=None, remat=True,
               last_only=False, with_metrics=False, bwd_probe=None,
               erasure=None):
    """Returns (logits (B,S,V), aux_loss), or (logits, aux_loss, metrics)
    with ``with_metrics=True``, where metrics carries ``cut_snr`` (the
    retrieval SNR in dB at the cut layer, the Adaptive-R controller's
    signal; absent without a codec).  ``last_only=True`` slices the final
    position before the head matmul.

    ``codec`` may be a static codec or a static ``SplitLink``; for an
    asymmetric link, ``bwd_probe`` is the gradient-SNR tap (a 0-dim
    float32 tensor with ``requires_grad``: its gradient is the measured
    gradient-retrieval SNR in dB).  ``erasure`` (``{"fwd": keep[, "bwd":
    keep]}``, masks on the payload's device) injects cut-payload loss.
    See ``repro_torch.transport.link.roundtrip``."""
    check_supported(cfg)
    if sliding_window is None:
        sliding_window = cfg.sliding_window
    h, positions = _embed_inputs(params, cfg, batch)

    def run(stacked, h):
        return stack_lib.apply_stack(stacked, cfg, h, positions,
                                     sliding_window=sliding_window, remat=remat)

    metrics = {}
    if codec is None:
        h, aux = run(params["stack"], h)
    else:
        front, back = _split_stacked(params["stack"], cfg.num_superblocks // 2)
        h, a1 = run(front, h)
        B, S, d = h.shape
        Zf = h.reshape(B, S * d)
        if with_metrics:
            Zhat, snr = roundtrip(codec, codec_params, Zf, with_snr=True,
                                  bwd_probe=bwd_probe, erasure=erasure)
            metrics["cut_snr"] = snr
        else:
            Zhat = roundtrip(codec, codec_params, Zf, bwd_probe=bwd_probe,
                             erasure=erasure)
        h, a2 = run(back, Zhat.reshape(B, S, d))
        aux = a1 + a2
    if last_only:
        h = h[:, -1:, :]
    h = _apply_norm(cfg, params["final_norm"], h)
    logits = h @ params["head"]
    if with_metrics:
        return logits, aux, metrics
    return logits, aux


def lm_loss(params, batch, cfg: ModelConfig, *, codec=None, codec_params=None,
            sliding_window=None, remat=True, with_metrics=False,
            bwd_probe=None, erasure=None):
    """Mean next-token CE (+ the aux loss, 0 for the ported kinds); labels
    == -1 are masked.  ``with_metrics=True`` returns (loss, metrics) with
    the cut-layer ``cut_snr`` (see :func:`lm_forward`)."""
    out = lm_forward(params, batch, cfg, codec=codec, codec_params=codec_params,
                     sliding_window=sliding_window, remat=remat,
                     with_metrics=with_metrics, bwd_probe=bwd_probe,
                     erasure=erasure)
    logits, aux = out[0], out[1]
    labels = batch["labels"]
    ce = softmax_cross_entropy(logits, torch.clamp(labels, min=0), labels >= 0)
    loss = ce + cfg.aux_loss_weight * aux
    if with_metrics:
        return loss, out[2]
    return loss


# ---------------------------------------------------------------------------
# serving (one-token decode with cache)
# ---------------------------------------------------------------------------

def init_decode_cache(params, cfg: ModelConfig, batch: int, length: int,
                      dtype=torch.float32, paged=None, device=None):
    """Decode cache tree.  With ``paged`` (a PagedLayout) the attn leaves
    are shared page pools and the cache carries the per-slot page tables
    under "pages" (full-length caches) and "pages_swa" (sliding-window
    rings): int32 (B, P) tensors of physical page ids.  ``device``
    defaults to the params' device."""
    check_supported(cfg)
    if device is None:
        device = params["embed"].device
    cache: dict[str, Any] = {
        "stack": stack_lib.init_stack_cache(cfg, batch, length, dtype,
                                            paged=paged, device=device)}
    if paged is not None:
        cache["pages"] = torch.zeros((batch, paged.pages_per_slot),
                                     dtype=torch.int32, device=device)
        if paged.len_swa:
            cache["pages_swa"] = torch.zeros(
                (batch, paged.pages_per_slot_swa), dtype=torch.int32,
                device=device)
    return cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                codec=None, codec_params=None, paged=None, live=None,
                return_cut=False, kv_read="gather"):
    """tokens (B, 1) int; pos scalar or (B,) int.  Returns (logits (B,1,V),
    cache) with the cache written in place.

    With a codec, the cut-layer feature (B, d_model) is compressed
    batch-wise across the decode batch.  ``live`` (B,) masks every cache
    write for rows that are not decoding AND zeroes their cut-layer
    contribution, so a dead slot's stale cache can never perturb live rows
    through cross-talk.  ``return_cut=True`` also returns the (B, d_model)
    cut-layer feature as it enters ``codec.encode`` (None without a codec).
    ``kv_read="kernel"`` routes the paged GQA reads through the CUDA
    paged-attention kernel.
    """
    h = params["embed"][tokens.long()]
    kw = dict(paged=paged, pages=cache.get("pages"),
              pages_swa=cache.get("pages_swa"), live=live, kv_read=kv_read)
    cut = None
    if codec is None:
        h, _ = stack_lib.apply_stack_decode(params["stack"], cache["stack"],
                                            cfg, h, pos, **kw)
    else:
        n_cut = cfg.num_superblocks // 2
        h, _ = stack_lib.apply_stack_decode(params["stack"], cache["stack"],
                                            cfg, h, pos, stop=n_cut, **kw)
        B, _, d = h.shape
        if live is not None:
            # a non-live row's feature is attention over stale pages: zero
            # it so dead slots add exact zeros to the superposition
            h = torch.where(live[:, None, None], h, torch.zeros((), dtype=h.dtype,
                                                                device=h.device))
        cut = h.reshape(B, d)
        payload = codec.encode(codec_params, cut)
        h = codec.decode(codec_params, payload).reshape(B, 1, d)
        h, _ = stack_lib.apply_stack_decode(params["stack"], cache["stack"],
                                            cfg, h, pos, start=n_cut, **kw)
    h = _apply_norm(cfg, params["final_norm"], h)
    if return_cut:
        return h @ params["head"], cache, cut
    return h @ params["head"], cache


# ---------------------------------------------------------------------------
# serving (chunked prefill: C prompt tokens per call)
# ---------------------------------------------------------------------------

def chunk_forward(params, cache, tokens, pos, cfg: ModelConfig, *,
                  codec=None, codec_params=None, valid=None, paged=None):
    """C positions per row in one call: the write path under chunked
    prefill.  tokens (B,C) int; pos (B,) per-row start positions; valid
    (B,C) marks real tokens (False: no cache write).  Returns
    ``(h, cache, cut_seq)``: the PRE-NORM final hidden states (B,C,d), the
    cache written in place, and the (B,C,d) cut-layer features as they
    entered the codec (None without one).  With a codec the features are
    grouped PER POSITION across slots (the ``sequence_group_encode`` layout
    (C,B,d)); non-valid positions contribute exact zeros."""
    B, C = tokens.shape
    if valid is None:
        valid = torch.ones((B, C), dtype=torch.bool, device=tokens.device)
    h = params["embed"][tokens.long()]
    kw = dict(paged=paged, pages=cache.get("pages"),
              pages_swa=cache.get("pages_swa"))
    cut_seq = None
    if codec is None:
        h, _ = stack_lib.apply_stack_prefill(params["stack"], cache["stack"],
                                             cfg, h, pos, valid, **kw)
    else:
        n_cut = cfg.num_superblocks // 2
        h, _ = stack_lib.apply_stack_prefill(params["stack"], cache["stack"],
                                             cfg, h, pos, valid, stop=n_cut,
                                             **kw)
        h = torch.where(valid[:, :, None], h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
        cut_seq = h
        payload = sequence_group_encode(codec, codec_params, h.transpose(0, 1))
        h = sequence_group_decode(codec, codec_params, payload,
                                  C, B).transpose(0, 1)
        h, _ = stack_lib.apply_stack_prefill(params["stack"], cache["stack"],
                                             cfg, h, pos, valid, start=n_cut,
                                             **kw)
    return h, cache, cut_seq


def prefill_chunk(params, cache, tokens, pos, cfg: ModelConfig, *,
                  codec=None, codec_params=None, valid=None, paged=None):
    """Ingest C prompt tokens per row in one call.  Returns (logits (B,V)
    at each row's LAST VALID position, cache); rows with no valid token
    get garbage logits the caller must ignore.  See :func:`chunk_forward`."""
    B, C = tokens.shape
    if valid is None:
        valid = torch.ones((B, C), dtype=torch.bool, device=tokens.device)
    h, cache, _ = chunk_forward(params, cache, tokens, pos, cfg, codec=codec,
                                codec_params=codec_params, valid=valid,
                                paged=paged)
    last = torch.clamp(valid.sum(-1) - 1, min=0)
    h_last = h[torch.arange(B, device=h.device), last]            # (B,d)
    h_last = _apply_norm(cfg, params["final_norm"], h_last)
    return h_last @ params["head"], cache
