"""The LM (causal, VLM and encoder-decoder): params, the training forward
and loss, the serving entry points (decode cache, decode step, chunked
prefill) and the pod pipeline's stage functions.

Port of ``repro/models/lm.py``.  Params and caches keep the
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

Training (``lm_forward``, ``lm_loss``) takes every registered arch: the
MoE/MLA/Mamba/RWKV sublayers, the ``first_dense_layers`` superblock, the
VLM frontend (patch embeddings projected and put in front of the text;
their label positions padded with -1) and the encoder-decoder models (the
frontend frames through an ``ENC_PATTERN`` encoder whose output every
``cross`` sublayer reads).  Modality frontends are stubs, as in the
reference: batches carry precomputed embeddings under "frontend".

Serving (the decode cache, ``decode_step``, ``prefill_chunk``) takes every
registered arch, as the reference serves it: every sublayer kind (the
recurrent kinds on an O(1) per-slot state, ``cross`` over the encoder's
memory), the ``first_dense_layers`` superblock (ahead of the stack and of
the codec's cut, on its own unstacked cache, always on the gather read),
an encoder-decoder model (its encoder runs once, in ``init_decode_cache``,
over the ``frontend_emb`` frames, into ``cache["memory"]``, which every
stack call reads) and a VLM, which is served text-only: the reference's
serving embeds tokens only, text positions from 0, and never reads the
patch embeddings.  The speculative ``verify_chunk`` runs the chunked
prefill in its no-write mode: per-position logits, and the cache exactly as
it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.codecs.c3sl import sequence_group_decode, sequence_group_encode
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_map
from repro_torch.models import stack as stack_lib
from repro_torch.models.layers import (MetaRng, dense_init, embed_init,
                                       matmul, softmax_cross_entropy)
from repro_torch.models.stack import _apply_norm, _init_norm
from repro_torch.sharding.constraints import (is_dtensor, lookup,
                                              on_local_rows, rows_only,
                                              unshard)
from repro_torch.transport.link import SplitLink, roundtrip


ENC_PATTERN = (("attn", "mlp"),)


def _generator(rng, device) -> torch.Generator | MetaRng:
    if isinstance(rng, (torch.Generator, MetaRng)):
        return rng
    if torch.device(device).type == "meta":
        return MetaRng()
    return torch.Generator(device=device).manual_seed(int(rng))


def init_lm_params(rng, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
    """Random params with the reference's tree and scales.  ``rng`` is a
    seed (a generator on ``device`` is made from it, so the weights are
    drawn on the card by default) or a ``torch.Generator``, whose device
    the weights are drawn on.  On ``device="meta"`` nothing is drawn: the
    leaves are empty meta tensors (:func:`abstract_params`)."""
    gen = _generator(rng, device)
    p: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "stack": stack_lib.init_stack(gen, cfg, dtype),
        "final_norm": _init_norm(cfg, dtype, device=gen.device),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }
    if cfg.first_dense_layers:
        p["first"] = stack_lib.init_superblock(gen, cfg, dtype, dense_mlp=True)
    if cfg.frontend:
        p["frontend_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model, dtype)
    if cfg.is_encdec:
        p["encoder"] = {"stack": stack_lib.init_stack(gen, _encoder_cfg(cfg), dtype),
                        "norm": _init_norm(cfg, dtype, device=gen.device)}
    return p


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    """The params' tree, shapes and dtypes on ``meta``: no allocation, at
    any width (the dry run's params; the reference's ``jax.eval_shape`` of
    ``init_lm_params``)."""
    return init_lm_params(MetaRng(), cfg, dtype, device="meta")


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, block_pattern=ENC_PATTERN,
                               num_layers=cfg.encoder_layers,
                               first_dense_layers=0)


def _positions(h):
    B, S = h.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token (+ VLM frontend) embedding.  Returns (h (B,S,d), positions
    (B,S)); a VLM's S is frontend_seq + the text's."""
    h = lookup(params["embed"], batch["tokens"].long())
    if cfg.frontend and not cfg.is_encdec:
        fe = batch["frontend"] @ params["frontend_proj"]
        h = torch.cat([fe.to(h.dtype), h], dim=1)
    return h, _positions(h)


def _run_encoder(params, cfg: ModelConfig, frontend_emb, remat=True):
    """The encoder over the frontend frames: (B, frontend_seq, d)."""
    h = frontend_emb @ params["frontend_proj"]
    h, _ = stack_lib.apply_stack(params["encoder"]["stack"], _encoder_cfg(cfg),
                                 h, _positions(h), remat=remat)
    return _apply_norm(cfg, params["encoder"]["norm"], h)


def _split_stacked(stacked, n_front: int):
    """(superblocks [0, n_front), the rest) of a stacked tree, as views."""
    front = tree_map(lambda a: a[:n_front], stacked)
    back = tree_map(lambda a: a[n_front:], stacked)
    return front, back


def _roundtrip_on_mesh(codec, codec_params, Zf, with_metrics, bwd_probe,
                       erasure):
    """The cut's round trip over a DTensor ``Zf`` (B, S*d): the codec's
    kernels run on each rank's local rows (``on_local_rows``: D made whole,
    the rows gathered first where a group of the payload's consecutive
    rows would span ranks), so each rank forms the groups the whole batch
    forms.  The cut's metrics, erasure masks and gradient-SNR probe are
    whole-batch quantities, and a ``SplitLink``'s gradient channel groups
    its own rows: both are refused here."""
    if with_metrics or erasure is not None or bwd_probe is not None:
        raise ValueError("the cut over a mesh takes no metrics, erasure "
                         "masks or gradient-SNR probe (whole-batch tensors)")
    if isinstance(codec, SplitLink):
        raise ValueError("the cut over a mesh takes a codec, not a SplitLink")
    B = Zf.shape[0]
    return on_local_rows(lambda z: roundtrip(codec, codec_params, z), Zf,
                         B // codec.payload_shape(B)[0])


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
    if sliding_window is None:
        sliding_window = cfg.sliding_window
    memory = None
    if cfg.is_encdec:
        memory = _run_encoder(params, cfg, batch["frontend"], remat=remat)
    h, positions = _embed_inputs(params, cfg, batch)
    aux = 0.0
    if cfg.first_dense_layers:
        h, aux = stack_lib.apply_superblock(params["first"], cfg, h, positions,
                                            memory=memory,
                                            sliding_window=sliding_window)

    def run(stacked, h):
        return stack_lib.apply_stack(stacked, cfg, h, positions, memory=memory,
                                     sliding_window=sliding_window, remat=remat)

    metrics = {}
    if codec is None:
        h, a = run(params["stack"], h)
        aux = aux + a
    else:
        front, back = _split_stacked(params["stack"], cfg.num_superblocks // 2)
        h, a1 = run(front, h)
        B, S, d = h.shape
        Zf = h.reshape(B, S * d)
        if is_dtensor(Zf):
            Zhat = _roundtrip_on_mesh(codec, codec_params, Zf, with_metrics,
                                      bwd_probe, erasure)
        elif with_metrics:
            Zhat, snr = roundtrip(codec, codec_params, Zf, with_snr=True,
                                  bwd_probe=bwd_probe, erasure=erasure)
            metrics["cut_snr"] = snr
        else:
            Zhat = roundtrip(codec, codec_params, Zf, bwd_probe=bwd_probe,
                             erasure=erasure)
        h, a2 = run(back, Zhat.reshape(B, S, d))
        aux = aux + a1 + a2
    # the stack's sharded carry, its sequence gathered for the head
    h = unshard(h, "model")
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
    """Mean next-token CE (+ ``aux_loss_weight`` times the MoE aux loss);
    labels == -1 are masked (a VLM's frontend positions are padded so).
    ``with_metrics=True`` returns (loss, metrics) with the cut-layer
    ``cut_snr`` (see :func:`lm_forward`)."""
    out = lm_forward(params, batch, cfg, codec=codec, codec_params=codec_params,
                     sliding_window=sliding_window, remat=remat,
                     with_metrics=with_metrics, bwd_probe=bwd_probe,
                     erasure=erasure)
    logits, aux = out[0], out[1]
    labels = batch["labels"]
    if cfg.frontend and not cfg.is_encdec:
        pad = torch.full((labels.shape[0], cfg.frontend_seq), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    # on a mesh the head's logits are split over vocab: made whole (each
    # rank keeps its rows) before the picked logit's gather
    logits = rows_only(logits)
    ce = softmax_cross_entropy(logits, torch.clamp(labels, min=0), labels >= 0)
    loss = ce + cfg.aux_loss_weight * aux
    if with_metrics:
        return loss, out[2]
    return loss


# ---------------------------------------------------------------------------
# serving (one-token decode with cache)
# ---------------------------------------------------------------------------

def init_decode_cache(params, cfg: ModelConfig, batch: int, length: int,
                      dtype=torch.float32, frontend_emb=None, paged=None,
                      device=None):
    """Decode cache tree.  With ``paged`` (a PagedLayout) the attn and mla
    leaves are shared page pools and the cache carries the per-slot page
    tables under "pages" (full-length caches) and "pages_swa"
    (sliding-window rings): int32 (B, P) tensors of physical page ids.  The
    first-dense superblock's cache is "first", with no superblock axis; its
    pools share the "pages" table.  An encoder-decoder model's cache holds
    "memory", the encoder's output (B, frontend_seq, d) over
    ``frontend_emb`` (B, frontend_seq, frontend_dim), which it needs; any
    other model ignores ``frontend_emb``.  ``device`` defaults to the
    params' device."""
    if cfg.is_encdec and frontend_emb is None:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: init_decode_cache needs "
            f"frontend_emb ({batch}, {cfg.frontend_seq}, {cfg.frontend_dim}), "
            "the frames its encoder reads into the cache's memory")
    if device is None:
        device = params["embed"].device
    cache: dict[str, Any] = {
        "stack": stack_lib.init_stack_cache(cfg, batch, length, dtype,
                                            paged=paged, device=device)}
    if cfg.first_dense_layers:
        cache["first"] = stack_lib.init_superblock_cache(
            cfg, batch, length, dtype, paged=paged, device=device)
    if cfg.is_encdec:
        cache["memory"] = _run_encoder(params, cfg, frontend_emb, remat=False)
    if paged is not None:
        cache["pages"] = torch.zeros((batch, paged.pages_per_slot),
                                     dtype=torch.int32, device=device)
        if paged.len_swa:
            cache["pages_swa"] = torch.zeros(
                (batch, paged.pages_per_slot_swa), dtype=torch.int32,
                device=device)
    return cache


def abstract_decode_cache(cfg: ModelConfig, batch: int, length: int,
                          dtype=torch.float32):
    """The decode cache on ``meta`` without params (the dry run's): the
    stack's, the first-dense superblock's under "first", and an
    encoder-decoder model's encoder output under "memory"."""
    cache: dict[str, Any] = {"stack": stack_lib.init_stack_cache(
        cfg, batch, length, dtype, device="meta")}
    if cfg.first_dense_layers:
        cache["first"] = stack_lib.init_superblock_cache(
            cfg, batch, length, dtype, device="meta")
    if cfg.is_encdec:
        cache["memory"] = torch.empty((batch, cfg.frontend_seq, cfg.d_model),
                                      dtype=dtype, device="meta")
    return cache


def _decode_kw(cache, paged, live, write):
    return dict(memory=cache.get("memory"), paged=paged, pages=cache.get("pages"),
                pages_swa=cache.get("pages_swa"), live=live, write=write)


def _decode_front(params, cache, tokens, pos, cfg: ModelConfig, kw, *,
                  kv_read="gather", stop=None):
    """The embedding and the superblocks before ``stop`` (all by default):
    (B, 1, d).  The first-dense superblock reads through the gather."""
    h = params["embed"][tokens.long()]
    if cfg.first_dense_layers:
        h, _ = stack_lib.apply_superblock_decode(params["first"], cache["first"],
                                                 cfg, h, pos, **kw)
    h, _ = stack_lib.apply_stack_decode(params["stack"], cache["stack"], cfg, h,
                                        pos, stop=stop, kv_read=kv_read, **kw)
    return h


def _mask_cut(h, live):
    """(B, 1, d) → the (B, d) cut: a non-live row's feature is attention
    over stale pages, zeroed so dead slots add exact zeros to the
    superposition."""
    B, _, d = h.shape
    if live is not None:
        h = torch.where(live[:, None, None], h, torch.zeros((), dtype=h.dtype,
                                                            device=h.device))
    return h.reshape(B, d)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                codec=None, codec_params=None, paged=None, live=None,
                return_cut=False, kv_read="gather", write=True):
    """tokens (B, 1) int; pos scalar or (B,) int.  Returns (logits (B,1,V),
    cache) with the cache written in place.

    With a codec, the cut-layer feature (B, d_model) is compressed
    batch-wise across the decode batch.  ``live`` (B,) masks every cache
    write for rows that are not decoding AND zeroes their cut-layer
    contribution, so a dead slot's stale cache can never perturb live rows
    through cross-talk.  ``return_cut=True`` also returns the (B, d_model)
    cut-layer feature as it enters ``codec.encode`` (None without a codec).
    ``kv_read="kernel"`` routes the stacked superblocks' paged GQA reads
    through the CUDA paged-attention kernel; the first-dense superblock
    stays on the gather read, as in the reference.

    ``write=False`` writes nothing into the cache, neither a position nor
    a recurrent state, and returns the same logits and cut.  It reads
    through the gather.
    """
    kw = _decode_kw(cache, paged, live, write)
    cut = None
    if codec is None:
        h = _decode_front(params, cache, tokens, pos, cfg, kw, kv_read=kv_read)
    else:
        n_cut = cfg.num_superblocks // 2
        h = _decode_front(params, cache, tokens, pos, cfg, kw, kv_read=kv_read,
                          stop=n_cut)
        cut = _mask_cut(h, live)
        payload = codec.encode(codec_params, cut)
        h = codec.decode(codec_params, payload).reshape(h.shape)
        h, _ = stack_lib.apply_stack_decode(params["stack"], cache["stack"],
                                            cfg, h, pos, start=n_cut,
                                            kv_read=kv_read, **kw)
    h = _apply_norm(cfg, params["final_norm"], h)
    logits = matmul(h, params["head"])
    if return_cut:
        return logits, cache, cut
    return logits, cache


def decode_cut(params, cache, tokens, pos, cfg: ModelConfig, *, paged=None,
               live=None):
    """The (B, d_model) cut-layer feature that ``decode_step`` with a codec
    hands to ``codec.encode``, bitwise, computed through the superblocks
    before the cut only and writing nothing into the cache (the
    sanitizer's probe: the reference's is a non-donating program whose
    compiler drops everything after the cut; the port writes its caches
    in place).  It reads through the gather."""
    kw = _decode_kw(cache, paged, live, False)
    h = _decode_front(params, cache, tokens, pos, cfg, kw,
                      stop=cfg.num_superblocks // 2)
    return _mask_cut(h, live)


# ---------------------------------------------------------------------------
# serving (chunked prefill: C prompt tokens per call)
# ---------------------------------------------------------------------------

def chunk_forward(params, cache, tokens, pos, cfg: ModelConfig, *,
                  codec=None, codec_params=None, valid=None, paged=None,
                  write=True):
    """C positions per row in one call: the write path under chunked
    prefill and the speculative commit.  tokens (B,C) int; pos (B,) per-row
    start positions; valid (B,C) marks real tokens (False: no cache write).
    Returns ``(h, cache, cut_seq)``: the PRE-NORM final hidden states
    (B,C,d), the cache written in place, and the (B,C,d) cut-layer features
    as they entered the codec (None without one).  With a codec the
    features are grouped PER POSITION across slots (the
    ``sequence_group_encode`` layout (C,B,d)); non-valid positions
    contribute exact zeros.  ``write=False`` (the speculative verify)
    writes nothing into the cache, neither positions nor recurrent state;
    every read is the same, since attention already reads the pre-chunk
    cache and the chunk's own keys."""
    B, C = tokens.shape
    if valid is None:
        valid = torch.ones((B, C), dtype=torch.bool, device=tokens.device)
    h = params["embed"][tokens.long()]
    kw = dict(memory=cache.get("memory"), paged=paged, pages=cache.get("pages"),
              pages_swa=cache.get("pages_swa"), write=write)
    if cfg.first_dense_layers:
        h, _ = stack_lib.apply_superblock_prefill(params["first"], cache["first"],
                                                  cfg, h, pos, valid, **kw)
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
    return matmul(h_last, params["head"]), cache


def verify_chunk(params, cache, tokens, pos, cfg: ModelConfig, *,
                 codec=None, codec_params=None, valid=None, paged=None):
    """Speculative VERIFY: a k-position forward with per-position logits
    that writes nothing into the cache.

    tokens (B,k): each row's last verified token followed by its k-1 draft
    proposals; ``valid`` marks live rows (all k positions).  Returns
    ``(logits (B,k,V), feat (B,k,d))``: ``feat`` is the cut-layer feature
    sequence as the codec encoded it or, without a codec, the pre-norm
    final hidden states; its position-(e-1) row is the draft head's next
    feedback feature.

    The reference discards the cache its verify writes; the port writes
    its caches in place, so the verify runs :func:`chunk_forward` with
    ``write=False``: no KV position (a ring-SWA write at p + j would
    overwrite p + j - W, still in the window; a paged write past the
    slot's reservation would land in another slot's page), no recurrent
    state advanced k positions.  The commit re-ingests the accepted prefix
    through the write path, so rollback is position truncation."""
    h, _, cut_seq = chunk_forward(params, cache, tokens, pos, cfg, codec=codec,
                                  codec_params=codec_params, valid=valid,
                                  paged=paged, write=False)
    feat = cut_seq if codec is not None else h
    hn = _apply_norm(cfg, params["final_norm"], h)
    return matmul(hn, params["head"]), feat


# ---------------------------------------------------------------------------
# pod-pipeline adapter (transport.make_pod_pipeline_loss_fn callables)
# ---------------------------------------------------------------------------

def make_pipeline_fns(cfg: ModelConfig):
    """(embed_fn, stage_fn, head_loss_fn) for the 2-stage pod pipeline.

    ``params["blocks"]`` must be the stacked superblocks with a leading
    stage axis of 2 (:func:`split_stack_for_pipeline`).  Each stage's
    superblocks run with remat; the head applies the final norm, the head
    matmul and the token CE with labels == -1 masked."""

    def embed_fn(embed_p, x_mb):
        return embed_p["embed"][x_mb.long()]

    def stage_fn(blocks_local, h):
        h, _ = stack_lib.apply_stack(blocks_local, cfg, h, _positions(h),
                                     remat=True)
        return h

    def head_loss_fn(head_p, h, y_mb):
        h = _apply_norm(cfg, head_p["final_norm"], h)
        logits = h @ head_p["head"]
        return softmax_cross_entropy(logits, torch.clamp(y_mb, min=0), y_mb >= 0)

    return embed_fn, stage_fn, head_loss_fn


def split_stack_for_pipeline(stacked, n_stages: int = 2):
    """The stacked superblocks with a leading stage axis: each leaf's
    (N, ...) reshaped to (n_stages, N // n_stages, ...), a view."""
    return tree_map(
        lambda a: a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:]),
        stacked)
