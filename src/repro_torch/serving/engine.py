"""Continuous-batching serving engine (vLLM-lite) on its chunked fast path.

Port of ``repro/serving/engine.py``'s ``BatchedEngine`` with chunked
prefill.  A fixed pool of ``num_slots`` decode slots shares one stacked KV
cache; every slot advances at its OWN position, and a finished slot is
recycled for the next queued request mid-flight.

* Chunked prefill: prompts are ingested ``chunk_size`` tokens per call
  through ``lm.prefill_chunk`` (ragged tails padded under a length mask).
* Slot state (positions, last token, active/done flags, output buffer)
  lives ON THE DEVICE and is advanced with ``torch.where`` masking.
* Decode runs in windows of up to ``sync_every`` steps.  The reference
  fuses a window into one ``lax.while_loop`` dispatch; here it is a Python
  loop that reads one pair of flags from the device before each step (any
  slot live; any slot done, for the starved-pool early exit), so
  ``stats["decode_steps"]`` equals the reference's exactly at the price of
  one host sync per step.
* The KV cache is written in place; nothing is copied per step.

KV layouts (``kv_layout``): ``"contiguous"`` per-slot strips, or
``"paged"`` shared page pools addressed through per-slot page tables, with
host-side FIFO page reservation (``repro_torch.serving.paging``).  Paged
reads (``kv_read``): ``"gather"`` builds the contiguous view;
``"kernel"`` walks the page table in the CUDA paged-attention kernel for
every stacked GQA decode read (its plain version on the CPU).  MLA latent
reads, the first-dense superblock and chunked-prefill reads stay on the
gather read, and the engine says so loudly at construction, in the
reference's words.
``stats["kv_read_execution_mode"]`` reports how the paged read really
runs: ``"cuda-kernel"``, ``"torch-plain"`` or ``"gather"``.

The C3-SL codec (a spec string or codec object) compresses each step's
cut-layer features across the slots, exactly as the reference.

Adaptive-R codecs (``codec="adaptive:c3sl:R=8,min_R=2|int8"``): the engine
makes ONE program set per R bucket (``build_program_table``, once, at
construction) and picks the set on the host at every dispatch by
``program_key``.  ``stats["payload_wire_bytes"]`` accumulates the bytes the
served buckets really shipped, and ``r_served`` counts the served R (one
count per executed decode step plus one per prefill chunk).  Serving has no
SNR probe in the step: drive the controller with ``observe_snr`` or pin it
(``engine.codec.pin(R)``).

Per-direction link specs (``codec="c3sl:R=8|int8 >> bwd:c3sl:R=4"``): serving
is forward-only, so the engine serves the link's forward channel
(``wire_bytes_fwd`` == ``payload_wire_bytes``, ``wire_bytes_bwd`` == 0).

Models: every decoder-only arch, of every sublayer kind (attn, mlp, mla,
moe, mamba, rwkv_tm, rwkv_cm), with or without the first-dense superblock;
a VLM is served text-only, as the reference serves it.  MLA latents draw
their pages from the full-length pool; a model without attn or mla (RWKV-6)
draws none, on either layout.  A recycled slot's rows, its Mamba and RWKV
state among them, are zeroed by cache key ("stack", "first"), as in the
reference.  An encoder-decoder model is refused at construction
(``ValueError``): the engine has no per-request encoder frames, and the
reference's engine fails there too (it builds its cache without
``frontend_emb``).  Serve one through the lockstep loop
(``init_decode_cache(..., frontend_emb=)`` and ``decode_step``, as
``launch/serve.py`` without ``--engine`` does).

Not ported yet, and raising ``NotImplementedError`` here: the legacy
``prefill_mode="decode"``, ``preemption``, ``spec_decode`` (and a link's
``draft:`` channel, which enables it), ``withdraw`` and stream events
(ROADMAP.md slice 5, serving II); the sanitizer (slice 7, tooling).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter, deque

import numpy as np
import torch

from repro_torch import codecs as codecs_lib
from repro_torch import transport
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_leaves
from repro_torch.kernels import paged_attention
from repro_torch.models import lm as lm_lib
from repro_torch.models.paging import PagedLayout
from repro_torch.serving.paging import PageAllocator

_SERVING_II = "ROADMAP.md slice 5 (serving II)"


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{slice_name}")


def _codec_execution_mode(codec, device) -> str:
    """How the codec's transform runs on ``device`` ("none" without one)."""
    if codec is None:
        return "none"
    codec = getattr(codec, "current", codec)    # Adaptive-R wrapper
    codec = getattr(codec, "transform", codec)  # Chain of wire stages
    if hasattr(codec, "execution_mode"):
        return codec.execution_mode(device)
    return "unknown"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list            # token ids
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0   # set by submit()
    t_first: float | None = None  # first token observed (TTFT = t_first - t_submit)


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    ingested: int = 0        # tokens of the feed already ingested
    feed: list = dataclasses.field(default_factory=list)   # what to prefill
    pages: list = dataclasses.field(default_factory=list)  # owned linear pages


class BatchedEngine:
    def __init__(self, params, cfg: ModelConfig, *, num_slots: int = 8,
                 max_len: int = 256, eos_id: int | None = None,
                 codec=None, codec_params=None, greedy: bool = True,
                 seed: int = 0, prefill_mode: str = "chunked",
                 chunk_size: int = 16, sync_every: int = 8,
                 kv_layout: str = "contiguous", page_size: int = 16,
                 num_pages: int | None = None, interleave: int = 0,
                 preemption: bool = False, kv_read: str = "gather",
                 spec_decode=None):
        # The engine runs where its params are (init_lm_params puts them on
        # the card unless asked for the CPU).
        self.device = params["embed"].device
        # `codec` may be a ready codec object, a registry spec string
        # (e.g. "c3sl:R=4|int8"), or a per-direction link spec/SplitLink
        # ("c3sl:R=8|int8 >> bwd:c3sl:R=4").  Serving is forward-only, so
        # the engine compresses with the link's FORWARD channel and accounts
        # the backward direction as 0.  Specs are built against the decode
        # cut layer (D = d_model) and clamped to the slot count; "none" is
        # no codec.
        # A link OBJECT (like a codec object) leaves clamping and init to
        # its caller; caller-supplied params follow the LINK's tree.
        self.link_spec = None
        from_spec = isinstance(codec, str)
        if from_spec and transport.is_link_spec(codec):
            codec = transport.build_link(codec, D=cfg.d_model)
        if isinstance(codec, transport.SplitLink):
            self._refuse_draft(codec)
            self.link_spec = codec.spec()
            codec, codec_params = codec.serving_codec(codec_params)
        if from_spec:
            if isinstance(codec, str) and codec == "none":
                codec = codec_params = None
            else:
                codec = codecs_lib.clamp_R(
                    codecs_lib.build(codec, D=cfg.d_model)
                    if isinstance(codec, str) else codec, num_slots)
                if codec_params is None:
                    codec_params = codec.init(torch.Generator().manual_seed(seed),
                                              device=self.device)
        if prefill_mode not in ("chunked", "decode"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r} "
                             "(expected 'chunked' | 'decode')")
        if prefill_mode == "decode":
            raise _not_ported("prefill_mode='decode' (the legacy path)",
                              _SERVING_II)
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r} "
                             "(expected 'contiguous' | 'paged')")
        if kv_read not in ("gather", "kernel"):
            raise ValueError(f"unknown kv_read {kv_read!r} "
                             "(expected 'gather' | 'kernel')")
        if kv_read == "kernel" and kv_layout != "paged":
            raise ValueError(
                "kv_read='kernel' requires kv_layout='paged': the CUDA "
                "paged-attention kernel is a page-table walk, and a "
                "contiguous cache has no table to walk")
        if preemption:
            raise _not_ported("preemption", _SERVING_II)
        if spec_decode:
            raise _not_ported("spec_decode (speculative decoding)", _SERVING_II)
        kinds = {k for layer in cfg.block_pattern for k in layer}
        if kv_read == "kernel":
            if "attn" not in kinds:
                raise ValueError(
                    "kv_read='kernel' covers GQA ('attn') decode reads only, "
                    f"but block_pattern {cfg.block_pattern!r} has no attn "
                    "sublayer — every cache read would silently stay on the "
                    "gather path; use kv_read='gather'")
            # loud by design: the reads the kernel does not cover stay on
            # gather_pages (the reference's text, in its order)
            fallbacks = []
            if "mla" in kinds:
                fallbacks.append("MLA latent reads")
            if cfg.first_dense_layers:
                fallbacks.append("the unstacked first-dense superblock")
            fallbacks.append("chunked-prefill reads")
            warnings.warn(
                "kv_read='kernel': " + ", ".join(fallbacks) + " stay on the "
                "gather read path (kernel tier covers stacked GQA decode "
                "only)", stacklevel=2)
        lm_lib.check_servable(cfg)
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: the engine has no "
                "per-request encoder frames for its cache's memory (the "
                "reference's engine fails there too); serve it through the "
                "lockstep loop, init_decode_cache(..., frontend_emb=) and "
                "decode_step (launch/serve.py without --engine)")
        self.codec = codec
        self.codec_params = codec_params
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.greedy = greedy
        self.prefill_mode = prefill_mode
        self.kv_layout = kv_layout
        self.kv_read = kv_read
        self.interleave = max(0, interleave)
        # each ring slot must be written at most once per chunk
        if cfg.sliding_window:
            chunk_size = min(chunk_size, cfg.sliding_window)
        self.chunk_size = max(1, min(chunk_size, max_len))
        self.sync_every = max(1, sync_every)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        self.paged: PagedLayout | None = None
        self.allocator: PageAllocator | None = None
        # which caches draw from the full-length pool: MLA latents always,
        # attn only without a sliding window (SWA rings own static pages)
        self._linear_backed = ("mla" in kinds
                               or ("attn" in kinds and not cfg.sliding_window))
        if kv_layout == "paged":
            len_swa = min(max_len, cfg.sliding_window) if cfg.sliding_window else 0
            pps = -(-max_len // page_size)
            pps_swa = -(-len_swa // page_size) if len_swa else 0
            if num_pages is None:
                num_pages = num_slots * pps      # fully provisioned pool
            # SWA rings keep their pages for the slot's lifetime (static
            # table); only full-length pages are allocated per request
            self.paged = PagedLayout(page_size, max_len, num_pages,
                                     len_swa, num_slots * pps_swa)
            self.allocator = PageAllocator(num_pages)
            self._table = np.zeros((num_slots, pps), np.int32)
        # As in the reference, the cache and the recurrent state are float32
        # whatever the weights' dtype (int8 values with float32 scales under
        # kv_cache_quant; the MLA latents are never quantized).  Reading
        # them promotes a narrower model's residual stream to float32, as
        # JAX does; the serving stack then rejects a superblock that changes
        # the stream's dtype with the reference scan's TypeError, at the
        # first dispatch, unless the first-dense superblock, ahead of the
        # stack, has promoted it already.  The port raises after that
        # superblock has written its rows and state in place (the
        # reference's scan raises as it traces, before any write), so the
        # cache is then partly advanced; the engine cannot serve the model
        # either way: every later dispatch raises the same TypeError.
        self.cache = lm_lib.init_decode_cache(params, cfg, num_slots, max_len,
                                              paged=self.paged)
        if self.paged is not None:
            self.cache["pages"] = self._to_device(self._table)
            if self.paged.len_swa:
                self.cache["pages_swa"] = self._to_device(
                    np.arange(num_slots * self.paged.pages_per_slot_swa,
                              dtype=np.int32)
                    .reshape(num_slots, self.paged.pages_per_slot_swa))
        self.slots = [_Slot() for _ in range(num_slots)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._dirty = True            # force the first boundary to run
        # the reference's keys, so stats line up with it; serving ships the
        # forward direction only and the speculative counters stay 0 until
        # spec_decode is ported
        self.stats = {"dispatches": 0, "decode_steps": 0, "prefill_chunks": 0,
                      "payload_wire_bytes": 0, "wire_bytes_fwd": 0,
                      "wire_bytes_bwd": 0, "wire_bytes_draft": 0,
                      "eos_early_exits": 0, "evictions": 0, "withdrawn": 0,
                      "spec_windows": 0, "spec_rounds": 0, "spec_accepted": 0,
                      "spec_rejected": 0, "spec_rollbacks": 0}
        self.stats["kv_read_execution_mode"] = (
            paged_attention.execution_mode(self.device) if kv_read == "kernel"
            else "gather")
        self.stats["kv_read"] = kv_read
        self.stats["codec_execution_mode"] = _codec_execution_mode(self.codec,
                                                                   self.device)
        # the served R schedule under an adaptive codec, as {R: count} with
        # one count per EXECUTED decode step plus one per prefill chunk, so
        # total() == decode_steps + prefill_chunks
        self.r_served: Counter[int] = Counter()
        self._adaptive = isinstance(self.codec, codecs_lib.AdaptiveC3SL)
        self.state = self._init_state()
        self._window_len = max(self.sync_every, self.interleave, 1)
        # one program set per R bucket, made here and never again; a
        # dispatch picks its set on the host (_bucket)
        self._programs = codecs_lib.build_program_table(
            self.codec, self.codec_params, self._make_programs)

    @staticmethod
    def _refuse_draft(link):
        if link.draft is not None:
            raise _not_ported("a link's draft: channel (speculative decoding)",
                              _SERVING_II)

    # ------------------------------------------------------------------
    # device state and programs
    # ------------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _init_state(self):
        """Device-resident slot state: advanced by the decode and prefill
        programs, read back only at admit/retire boundaries."""
        B = self.num_slots
        z = lambda dt: torch.zeros((B,), dtype=dt, device=self.device)  # noqa: E731
        return {
            "pos": z(torch.int32),         # next cache position to write
            "last_tok": z(torch.int32),    # decode input for the next step
            "active": z(torch.bool),       # prompt fully ingested, generating
            "done": z(torch.bool),         # finished, awaiting retire
            "out_len": z(torch.int32),     # generated tokens so far
            "max_new": torch.ones((B,), dtype=torch.int32, device=self.device),
            "out_buf": torch.zeros((B, self.max_len + 1), dtype=torch.int32,
                                   device=self.device),
        }

    def _host_state(self) -> dict:
        return {k: v.cpu().numpy().copy() for k, v in self.state.items()}

    def _make_programs(self, codec, codec_params) -> dict:
        """One codec's program set: the decode window and the chunked-
        prefill call.  Both update the slot state with masked writes only,
        so decoding can run while other slots are empty or mid-prefill."""
        cfg, params, cache = self.cfg, self.params, self.cache
        eos_id, max_len = self.eos_id, self.max_len
        paged, kv_read, gen = self.paged, self.kv_read, self._gen

        def pick(logits):
            if self.greedy:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            u = torch.rand(logits.shape, generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)

        def commit(state, nxt, write, pos):
            """Masked bookkeeping shared by both programs: rows in ``write``
            append ``nxt`` to their output and may finish."""
            B, cap = state["out_buf"].shape
            col = torch.where(write, torch.clamp(state["out_len"], max=cap - 1),
                              cap)
            hit = torch.arange(cap, device=col.device)[None, :] == col[:, None]
            out_buf = torch.where(hit, nxt[:, None], state["out_buf"])
            out_len = state["out_len"] + write.to(torch.int32)
            fin = (out_len >= state["max_new"]) | (pos >= max_len)
            if eos_id is not None:
                fin = fin | (nxt == eos_id)
            done = state["done"] | (write & fin)
            return {**state, "pos": pos, "last_tok": nxt, "done": done,
                    "out_len": out_len, "out_buf": out_buf}

        def step_fn(state):
            """One decode step: model forward + all slot bookkeeping."""
            live = state["active"] & ~state["done"]
            logits, _ = lm_lib.decode_step(
                params, cache, state["last_tok"][:, None], state["pos"], cfg,
                codec=codec, codec_params=codec_params, paged=paged, live=live,
                kv_read=kv_read)
            nxt = torch.where(live, pick(logits[:, -1]), state["last_tok"])
            return commit(state, nxt, live, state["pos"] + live.to(torch.int32))

        def window_fn(state, n: int, stop_on_done: bool):
            """Up to n decode steps; stops as soon as no slot is live, and,
            with ``stop_on_done`` (a starving page pool), as soon as any
            slot finishes.  Returns (steps executed, state)."""
            i = 0
            while i < n:
                live_any, done_any = torch.stack(
                    [(state["active"] & ~state["done"]).any(),
                     state["done"].any()]).tolist()
                if not live_any or (stop_on_done and done_any):
                    break
                state = step_fn(state)
                i += 1
            return i, state

        def prefill_fn(state, tokens, valid, completes):
            """Ingest one prompt chunk for the rows ``valid`` marks; rows
            whose prompt ends in this chunk (``completes``) commit their
            first generated token from the last prompt position's logits."""
            logits, _ = lm_lib.prefill_chunk(
                params, cache, tokens, state["pos"], cfg, codec=codec,
                codec_params=codec_params, valid=valid, paged=paged)
            nxt = torch.where(completes, pick(logits), state["last_tok"])
            pos = state["pos"] + valid.sum(-1).to(torch.int32)
            state = commit(state, nxt, completes, pos)
            return {**state, "active": state["active"] | completes}

        return {"window": window_fn, "prefill": prefill_fn}

    # ------------------------------------------------------------------
    # wire accounting
    # ------------------------------------------------------------------

    def _account_fwd_bytes(self, nbytes: int):
        """The one place cut-layer bytes enter the stats: serving ships the
        forward direction only."""
        self.stats["payload_wire_bytes"] += nbytes
        self.stats["wire_bytes_fwd"] += nbytes

    def _bucket(self):
        """Host-side program-set key for this dispatch: the adaptive codec's
        current R bucket, or None for a static (or absent) codec."""
        return codecs_lib.program_key(self.codec)

    def _current_codec(self):
        """The codec the next dispatch applies (the bucket codec under
        Adaptive-R, never the wrapper)."""
        if self.codec is None:
            return None
        return self.codec.current if self._adaptive else self.codec

    def observe_snr(self, snr_db, loss_slack=None):
        """Feed the Adaptive-R controller between dispatches (no-op for
        static codecs).  The serving step has no SNR probe, so the signal
        comes from outside: the training side's schedule, an SLA monitor,
        or a pinned R."""
        if self._adaptive:
            self.codec.observe(snr_db, loss_slack)

    def _step_wire_bytes(self) -> int:
        """Cut-layer bytes one decode step ships across the slots."""
        c = self._current_codec()
        if c is None:
            return 0
        return codecs_lib.payload_wire_bytes(c, c.payload_shape(self.num_slots))

    def _chunk_wire_bytes(self) -> int:
        """Cut-layer bytes one prefill chunk ships (the sequence-grouped
        3-D payload: chunk_size positions x num_slots/R groups x D)."""
        c = self._current_codec()
        if c is None:
            return 0
        shape = codecs_lib.chunk_payload_shape(c, self.num_slots, self.chunk_size)
        return codecs_lib.payload_wire_bytes(c, shape)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError(f"request {req.uid}: empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} leaves "
                f"no decode positions in the engine's max_len={self.max_len} "
                f"cache (need prompt length <= max_len - 1); truncate the "
                f"prompt or build the engine with a larger max_len")
        if self.paged is not None and self._linear_backed:
            need = self.paged.pages_for(len(req.prompt) + req.max_new_tokens)
            if need > self.paged.num_pages:
                raise ValueError(
                    f"request {req.uid}: needs {need} cache pages but the "
                    f"pool only has {self.paged.num_pages}; shorten the "
                    f"request or build the engine with more num_pages")
        req.t_submit = time.monotonic()
        self.queue.append(req)
        self._dirty = True            # a later run() must re-check admission

    def withdraw(self, uid: int):
        raise _not_ported("withdraw", _SERVING_II)

    def pop_stream_events(self):
        raise _not_ported("stream events", _SERVING_II)

    def attach_sanitizer(self, sanitizer) -> None:
        raise _not_ported("the engine sanitizer", "ROADMAP.md slice 7 (tooling)")

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    @property
    def cache_bytes(self) -> int:
        """Resident device bytes held by the KV cache (pools + tables)."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.cache))

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while steps < max_steps:
            self._boundary()
            if not (self.queue or self.active):
                break
            steps += self._tick_body(max_steps - steps)
        self._boundary()
        return self.finished

    def tick(self) -> bool:
        """One admission/compute iteration, the incremental form of
        :meth:`run`: a boundary, at most one prefill pass / decode window,
        and a second boundary.  Returns False when the engine is idle."""
        self._boundary()
        if not (self.queue or self.active):
            return False
        self._tick_body(self.sync_every)
        self._boundary()
        return True

    def _tick_body(self, budget: int) -> int:
        """One scheduler iteration: prefill according to the interleave
        policy, then decode.  Returns executed decode steps."""
        if self._pending_prefill():
            self._prefill_one_chunk()
            if self.interleave != 0:
                # don't start a window that would stop at step 0
                if any(s.req is not None and s.ingested >= len(s.feed)
                       for s in self.slots):
                    return self._decode_window(min(self.interleave, budget))
                return 0
            while self._pending_prefill():
                self._prefill_one_chunk()
        return self._decode_window(min(self.sync_every, budget))

    # ------------------------------------------------------------------
    # fast path internals
    # ------------------------------------------------------------------

    def _decode_window(self, n: int) -> int:
        """Run one decode window of up to n steps; returns the steps the
        device actually executed before the batch drained."""
        if n <= 0:
            return 0
        n = min(n, self._window_len)
        bucket = self._bucket()
        stop_on_done = self._pool_starved()
        executed, self.state = self._programs[bucket]["window"](
            self.state, n, stop_on_done)
        self.stats["dispatches"] += 1
        self.stats["decode_steps"] += executed
        self._account_fwd_bytes(executed * self._step_wire_bytes())
        if stop_on_done and executed < n:
            # a slot finished while the page pool was starving the head of
            # the queue: retire it from this host sync and free its pages
            st = self._host_state()
            if bool(np.any(st["active"] & ~st["done"])):
                self.stats["eos_early_exits"] += 1
            if self._retire_done(st):
                self.state = {k: self._to_device(v) for k, v in st.items()}
        if bucket is not None:
            self.r_served[bucket] += executed
        if executed:
            self._dirty = True
        return executed

    def _pool_starved(self) -> bool:
        """True when the head-of-queue request is blocked on pages."""
        if self.paged is None or not self._linear_backed or not self.queue:
            return False
        head = self.queue[0]
        need = self.paged.pages_for(len(head.prompt) + head.max_new_tokens)
        return need > self.allocator.free_pages

    def pool_accounting(self) -> dict:
        """Page-pool occupancy: every page is either on the free list or
        owned by exactly one slot.  Zeros for the contiguous layout."""
        if self.paged is None:
            return {"free": 0, "in_use": 0, "total": 0}
        in_use = sum(len(s.pages) for s in self.slots)
        return {"free": self.allocator.free_pages, "in_use": in_use,
                "total": self.paged.num_pages}

    def _pending_prefill(self) -> bool:
        return any(s.req is not None and s.ingested < len(s.feed)
                   for s in self.slots)

    def _prefill_one_chunk(self):
        """One chunk of up to chunk_size prompt tokens for EVERY slot still
        prefilling, in a single call (ragged tails padded under the length
        mask; rows not prefilling are fully masked)."""
        B, C = self.num_slots, self.chunk_size
        tokens = np.zeros((B, C), np.int32)
        valid = np.zeros((B, C), bool)
        completes = np.zeros((B,), bool)
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.ingested >= len(slot.feed):
                continue
            seg = slot.feed[slot.ingested:slot.ingested + C]
            tokens[i, :len(seg)] = seg
            valid[i, :len(seg)] = True
            slot.ingested += len(seg)
            completes[i] = slot.ingested >= len(slot.feed)
        if not valid.any():
            return
        bucket = self._bucket()
        self.state = self._programs[bucket]["prefill"](
            self.state, self._to_device(tokens), self._to_device(valid),
            self._to_device(completes))
        self.stats["dispatches"] += 1
        self.stats["prefill_chunks"] += 1
        self._account_fwd_bytes(self._chunk_wire_bytes())
        if bucket is not None:
            self.r_served[bucket] += 1
        if completes.any():
            # the completing call commits the row's first token: stamp TTFT
            # once the token exists on the device, not when it was enqueued
            self._sync()
            now = time.monotonic()
            for i in np.flatnonzero(completes):
                if self.slots[i].req.t_first is None:
                    self.slots[i].req.t_first = now
            self._dirty = True

    def _retire_done(self, st, now: float | None = None) -> bool:
        """Retire every slot whose done flag is set in the host copy ``st``:
        capture its outputs at their actual length and free its pages."""
        if now is None:
            now = time.monotonic()
        touched = False
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if slot.req.t_first is None and st["out_len"][i] > 0:
                slot.req.t_first = now
            if st["done"][i]:
                n = int(st["out_len"][i])
                slot.req.out = [int(t) for t in st["out_buf"][i, :n]]
                slot.req.done = True
                self.finished.append(slot.req)
                slot.req = None
                slot.feed = []
                self._free_slot_pages(i)
                st["active"][i] = st["done"][i] = False
                st["pos"][i] = st["last_tok"][i] = st["out_len"][i] = 0
                st["out_buf"][i, :] = 0
                touched = True
        return touched

    def _boundary(self):
        """Admit/retire boundary: the only host sync outside the decode
        window's per-step flags.  Retire frees a slot's pages; admission is
        FIFO and waits until the head request's reservation fits the pool.
        Skipped while nothing can have changed since the last one."""
        if not self._dirty:
            return
        self._dirty = False
        st = self._host_state()
        touched = self._retire_done(st)
        admitted: list[int] = []
        while self.queue:
            head = self.queue[0]
            i = next((j for j, s in enumerate(self.slots) if s.req is None),
                     None)
            if i is None or not self._alloc_slot_pages(i, head):
                break                      # FIFO: wait for a slot / pages
            slot = self.slots[i]
            slot.req = self.queue.popleft()
            slot.ingested = 0
            slot.feed = list(slot.req.prompt)
            st["active"][i] = st["done"][i] = False
            st["pos"][i] = st["last_tok"][i] = st["out_len"][i] = 0
            st["max_new"][i] = slot.req.max_new_tokens
            st["out_buf"][i, :] = 0
            admitted.append(i)
            touched = True
        if touched:
            self.state = {k: self._to_device(v) for k, v in st.items()}
        if admitted:
            if self.paged is not None:
                self.cache["pages"] = self._to_device(self._table)
            self._reset_rows(admitted)

    def _reset_rows(self, rows: list[int]):
        """Zero the admitted slots' per-slot cache rows, as the reference's
        reset: the layout is known by key, never guessed from a shape
        ("stack" leaves carry (num_superblocks, B, ...), "first" leaves
        (B, ...)).  Paged attn and mla pools are left alone: reads past a
        slot's written positions are masked, so stale pages are
        invisible."""
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        for key, axis in (("stack", 1), ("first", 0)):
            for name, sub in self.cache.get(key, {}).items():
                if (self.paged is not None
                        and name.rsplit("_", 1)[-1] in ("attn", "mla")):
                    continue
                for leaf in tree_leaves(sub):
                    leaf.index_fill_(axis, idx, 0)

    # ------------------------------------------------------------------
    # page bookkeeping (host side; no-ops for the contiguous layout)
    # ------------------------------------------------------------------

    def _alloc_slot_pages(self, i: int, req: Request) -> bool:
        if self.paged is None or not self._linear_backed:
            return True
        need = self.paged.pages_for(len(req.prompt) + req.max_new_tokens)
        got = self.allocator.alloc(need)
        if got is None:
            return False
        self.slots[i].pages = got
        self._table[i, :] = 0
        self._table[i, :len(got)] = got
        return True

    def _free_slot_pages(self, i: int):
        if self.paged is None:
            return
        self.allocator.free(self.slots[i].pages)
        self.slots[i].pages = []
        self._table[i, :] = 0
