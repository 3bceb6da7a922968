"""Continuous-batching serving engine (vLLM-lite).

Port of ``repro/serving/engine.py``'s ``BatchedEngine``.  A fixed pool of
``num_slots`` decode slots shares one stacked KV cache; every slot advances
at its OWN position, and a finished slot is recycled for the next queued
request mid-flight.

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

Speculative decoding (``spec_decode``, a ``SpecConfig`` or True; a link
spec's ``draft:`` segment turns it on, see ``repro_torch.serving.spec``):
a speculative window is a Python loop of verify/commit rounds, each
advancing every live slot by 1..k tokens.  The round proposes k-1 drafts
from the draft channel's feedback, verifies them with ``lm.verify_chunk``
(the chunked prefill in its no-write mode: the reference discards the
cache its verify writes, the port writes caches in place, so its verify
writes nothing), accepts the longest matching prefix group-lockstep under
the codec, and commits it through ``lm.chunk_forward``'s masked write
path.  A round reads one flag on the host (any slot live) and the window
its counters once, at its end.  Greedy outputs equal vanilla decode's; a
verify round ships nothing on the forward channel and its feedback plus
draft ids on the draft channel (``wire_bytes_draft``).  A starved page
pool drops to vanilla windows.  Verify and commit read through the
chunked (gather) read, also under ``kv_read="kernel"``, which warns so.

Slot preemption (``preemption=True``, chunked prefill): a blocked
higher-priority head evicts lower-priority slots, least progress first;
an evicted request re-prefills its prompt plus the tokens it emitted and
resumes with equal greedy output.  ``withdraw`` pulls a request out the
same way; ``pop_stream_events`` drains the (uid, start, tokens) bursts the
boundaries collect (one stream watermark serves retire, evict and
withdraw).  The legacy ``prefill_mode="decode"`` is a per-token host loop
over ``decode_step`` (``step()``), slow by design: the baseline.

The runtime sanitizer (``attach_sanitizer``, an
``repro_torch.analysis.EngineSanitizer``): ``run()`` calls its ``on_tick``
after each scheduler iteration, ``tick()`` before its trailing boundary
(done-but-unretired slots still resident), and the legacy
``prefill_mode="decode"`` loop never, as in the reference.
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
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.spec import AdaptiveK, SpecConfig


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
    priority: int = 0       # higher preempts lower (engine preemption=True)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0   # set by submit()
    t_first: float | None = None  # first token observed (TTFT = t_first - t_submit)
    evictions: int = 0      # times this request was preempted or withdrawn
    # speculative counters (0 without spec_decode): tokens emitted through
    # verify rounds, draft positions rejected, rounds that truncated
    accepted: int = 0
    rejected: int = 0
    rollbacks: int = 0


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0             # next cache position to write (legacy mode)
    in_prompt: int = 0       # tokens of the feed already ingested (legacy)
    ingested: int = 0        # tokens of the feed already ingested (chunked)
    # what this residency ingests before decoding: the prompt plus, after
    # an eviction or a withdraw, the tokens already emitted
    feed: list = dataclasses.field(default_factory=list)
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
        # no codec.  A link spec's "draft:" segment is the speculative
        # feedback channel's codec, and turns speculation on.
        # A link OBJECT (like a codec object) leaves clamping and init to
        # its caller; caller-supplied params follow the LINK's tree.
        self.link_spec = None
        draft_codec = draft_params = None
        if isinstance(codec, str):
            if codec == "none":
                codec = codec_params = None
            else:
                if transport.is_link_spec(codec):
                    link = transport.build_link(codec, D=cfg.d_model)
                    self.link_spec = link.spec()
                    if link.draft is not None:
                        draft_codec = codecs_lib.clamp_R(link.draft.codec,
                                                         num_slots)
                    codec, codec_params = link.serving_codec(codec_params)
                codec = codecs_lib.clamp_R(
                    codecs_lib.build(codec, D=cfg.d_model)
                    if isinstance(codec, str) else codec, num_slots)
                if codec_params is None:
                    codec_params = codec.init(torch.Generator().manual_seed(seed),
                                              device=self.device)
        elif isinstance(codec, transport.SplitLink):
            self.link_spec = codec.spec()
            if codec.draft is not None:
                draft_codec = codec.draft.codec
                if codec_params is not None:
                    draft_params = codec.draft_params(codec_params)
            codec, codec_params = codec.serving_codec(codec_params)
        if prefill_mode not in ("chunked", "decode"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r} "
                             "(expected 'chunked' | 'decode')")
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
        if preemption and prefill_mode != "chunked":
            raise ValueError("preemption requires prefill_mode='chunked' "
                             "(eviction re-queues the request for chunked "
                             "re-prefill of its generated context)")
        # ---- speculative decoding (repro_torch.serving.spec) -------------
        if spec_decode is True:
            spec_decode = SpecConfig()
        if not spec_decode:
            spec_decode = SpecConfig() if draft_codec is not None else None
        self.spec_cfg: SpecConfig | None = spec_decode
        if spec_decode is not None:
            if prefill_mode != "chunked":
                raise ValueError(
                    "spec_decode requires prefill_mode='chunked': the verify "
                    "round is a k-position chunk dispatch")
            if not greedy:
                raise ValueError(
                    "spec_decode requires greedy=True: greedy verification "
                    "is what makes speculative output bit-identical to "
                    "vanilla decode (sampled verification would need the "
                    "rejection-sampling correction, which this engine does "
                    "not implement)")
            if cfg.sliding_window and spec_decode.ladder[-1] > cfg.sliding_window:
                raise ValueError(
                    f"spec_decode ladder max k={spec_decode.ladder[-1]} "
                    f"exceeds sliding_window={cfg.sliding_window}: a verify "
                    f"round must not write any ring slot twice; use a "
                    f"smaller ladder")
            if spec_decode.draft is not None:
                # SpecConfig's draft spec overrides a link's draft: segment
                draft_codec = codecs_lib.clamp_R(
                    codecs_lib.build(spec_decode.draft, D=cfg.d_model),
                    num_slots)
                draft_params = None
            if draft_codec is not None and draft_params is None:
                # a key of its own: the draft channel's superposition basis
                # must not collide with the forward channel's
                draft_params = draft_codec.init(
                    torch.Generator().manual_seed(seed + 1), device=self.device)
            self._k_ctl = AdaptiveK(spec_decode)
        else:
            draft_codec = draft_params = None
            self._k_ctl = None
        self.draft_codec = draft_codec
        self.draft_params = draft_params
        self.preemption = preemption
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
            if prefill_mode == "chunked":
                fallbacks.append("chunked-prefill reads")
            if self.spec_cfg is not None:
                fallbacks.append("speculative verify/commit reads")
            if fallbacks:
                warnings.warn(
                    "kv_read='kernel': " + ", ".join(fallbacks) + " stay on "
                    "the gather read path (kernel tier covers stacked GQA "
                    "decode only)", stacklevel=2)
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
        self._tokens_decoded = 0
        self._dirty = True            # force the first boundary to run
        # opt-in runtime invariant checks (repro_torch.analysis); None = off
        self._sanitizer = None
        # the reference's keys, so stats line up with it.  Serving ships the
        # forward direction only (wire_bytes_bwd stays 0); a verify round
        # ships nothing forward, and its feedback payload plus the draft
        # token ids go to wire_bytes_draft.  spec_accepted counts tokens
        # emitted through verify rounds, spec_rejected the draft positions
        # thrown away, spec_rollbacks the rounds that truncated.
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
        # the served k schedule under spec_decode, as {k: verify rounds}
        # (k=1 windows are vanilla decode, counted by decode_steps only)
        self.k_served: Counter[int] = Counter()
        # streamed-token harvest: (uid, start, [tokens]) bursts collected at
        # the host copies the engine already makes (boundaries, early
        # retires), drained by pop_stream_events()
        self.stream_events: list[tuple[int, int, list[int]]] = []
        self._stream_mark: dict[int, int] = {}
        self._adaptive = isinstance(self.codec, codecs_lib.AdaptiveC3SL)
        self.state = self._init_state()
        self._window_len = max(self.sync_every, self.interleave, 1)
        # one program set per R bucket, made here and never again; a
        # dispatch picks its set on the host (_bucket)
        self._programs = codecs_lib.build_program_table(
            self.codec, self.codec_params, self._make_programs)
        # speculative programs, one per (R bucket, draft R bucket, k > 1),
        # made here; k = 1 is the vanilla window and has no entry
        self._spec_programs: dict = {}
        if self.spec_cfg is not None:
            for dkey, dc, dp in self._draft_buckets():
                for key, c, cp in self._codec_buckets():
                    for k in self.spec_cfg.ladder:
                        if k > 1:
                            self._spec_programs[(key, dkey, k)] = \
                                self._make_spec_program(c, cp, dc, dp, k)

    # ------------------------------------------------------------------
    # device state and programs
    # ------------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # lint-ok: R3 host-built inputs uploaded at a host boundary (the legacy step's tokens, pos and live mask; the slot state and page table at admit and retire), not inside a window

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # lint-ok: R3 TTFT stamp: once a chunk that completes a prompt, so the first token exists before its time is taken

    def _init_state(self):
        """Device-resident slot state: advanced by the decode and prefill
        programs, read back only at admit/retire boundaries."""
        B = self.num_slots
        z = lambda dt: torch.zeros((B,), dtype=dt, device=self.device)  # noqa: E731
        st = {
            "pos": z(torch.int32),         # next cache position to write
            "last_tok": z(torch.int32),    # decode input for the next step
            "active": z(torch.bool),       # prompt fully ingested, generating
            "done": z(torch.bool),         # finished, awaiting retire
            "out_len": z(torch.int32),     # generated tokens so far
            "max_new": torch.ones((B,), dtype=torch.int32, device=self.device),
            "out_buf": torch.zeros((B, self.max_len + 1), dtype=torch.int32,
                                   device=self.device),
        }
        if self.spec_cfg is not None:
            # the draft head's feedback feature (the cut-layer feature at
            # each slot's last verified position) and the per-slot counters
            # that retire, evict and withdraw fold into the Request
            st["draft_feat"] = torch.zeros((B, self.cfg.d_model),
                                           dtype=torch.float32, device=self.device)
            st["accepted"] = z(torch.int32)
            st["rejected"] = z(torch.int32)
            st["rollbacks"] = z(torch.int32)
        return st

    def _host_state(self) -> dict:
        return {k: v.cpu().numpy().copy() for k, v in self.state.items()}  # lint-ok: R3 the boundary's one host copy of the slot state (admit, retire, stream), once a tick

    def _make_programs(self, codec, codec_params) -> dict:
        """One codec's program set: the decode window, the chunked-prefill
        call and the legacy prefill-as-decode step.  The first two update
        the slot state with masked writes only, so decoding can run while
        other slots are empty or mid-prefill."""
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
            out_buf = _append(state["out_buf"], state["out_len"], nxt, write)
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
                live_any, done_any = torch.stack(  # lint-ok: R3 the window's live/done flags, one read a step: the decode path's only per-step host read; B6 (a CUDA graph of the decode step) removes it
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

        def legacy_fn(tokens, pos, live):
            """One prefill-as-decode step: every row ingests or decodes one
            token; returns each row's pick."""
            logits, _ = lm_lib.decode_step(
                params, cache, tokens, pos, cfg, codec=codec,
                codec_params=codec_params, paged=paged, live=live,
                kv_read=kv_read)
            return pick(logits[:, -1])

        return {"window": window_fn, "prefill": prefill_fn, "legacy": legacy_fn}

    # ------------------------------------------------------------------
    # speculative verify/commit programs (repro_torch.serving.spec)
    # ------------------------------------------------------------------

    def _codec_buckets(self):
        """(program key, concrete codec, params) per engine R bucket, keyed
        as ``_bucket()`` dispatches."""
        if self._adaptive:
            return [(R, self.codec.buckets[R],
                     self.codec.params_for(self.codec_params, R))
                    for R in self.codec.ladder]
        return [(None, self.codec, self.codec_params)]

    def _draft_buckets(self):
        """The same for the draft channel's codec (one (None, None, None)
        entry when the feedback ships raw or the head needs none)."""
        dc = self.draft_codec
        if isinstance(dc, codecs_lib.AdaptiveC3SL):
            return [(R, dc.buckets[R], dc.params_for(self.draft_params, R))
                    for R in dc.ladder]
        return [(None, dc, self.draft_params)]

    def _make_spec_program(self, codec, codec_params, d_codec, d_params,
                           k: int):
        """One (codec bucket, draft bucket, k) speculative window: a loop of
        verify/commit rounds, each advancing every live slot 1..k tokens.

        A round (see ``repro_torch.serving.spec``): round-trip each slot's
        feedback feature through the DRAFT codec and propose k-1 drafts
        (what the client computes from the feedback payload; drafts are
        argmax, so simulating the client here is exact); VERIFY the
        k-position chunk [last_tok, drafts] on the committed cache without
        writing it (``lm.verify_chunk``); accept the longest matching
        prefix, group-lockstep under the batch-wise codec, capped at
        EOS/budget (``spec.accept_lengths``); COMMIT only the accepted
        tokens through the valid-masked ``lm.chunk_forward`` write path.
        Greedy verification makes the emitted stream equal the vanilla
        window's."""
        cfg, params, cache = self.cfg, self.params, self.cache
        eos_id, max_len, paged = self.eos_id, self.max_len, self.paged
        group = getattr(codec, "R", 1) if codec is not None else 1
        head_mode = self.spec_cfg.draft_head
        needs_feedback = self.spec_cfg.needs_feedback
        dev = self.device
        steps = torch.arange(k, device=dev)

        def round_fn(state):
            live = state["active"] & ~state["done"]
            B = live.shape[0]
            rows = torch.arange(B, device=dev)
            feat = state["draft_feat"]
            if needs_feedback and d_codec is not None:
                # the feedback payload crosses the draft channel: dead rows
                # add zeros to its superposition; the live rows' cross-talk
                # can only cost acceptance (the verify consumes raw tokens)
                feat = torch.where(live[:, None], feat,
                                   torch.zeros((), dtype=feat.dtype, device=dev))
                feat = d_codec.decode(d_params, d_codec.encode(d_params, feat))
            drafts = spec_lib.propose_drafts(params, feat, state["last_tok"],
                                             k, head_mode)
            toks_v = torch.cat([state["last_tok"][:, None], drafts], dim=1)
            logits, feat_seq = lm_lib.verify_chunk(
                params, cache, toks_v, state["pos"], cfg, codec=codec,
                codec_params=codec_params, valid=live[:, None].expand(B, k),
                paged=paged)
            g = torch.argmax(logits, dim=-1).to(torch.int32)
            e = spec_lib.accept_lengths(
                toks_v, g, live, group=group, eos_id=eos_id,
                rem_new=state["max_new"] - state["out_len"],
                rem_pos=max_len - state["pos"])
            out_buf = state["out_buf"]
            for j in range(k):
                out_buf = _append(out_buf, state["out_len"] + j, g[:, j],
                                  live & (j < e))
            e_live = torch.where(live, e, 0)
            out_len = state["out_len"] + e_live
            pos = state["pos"] + e_live
            toks_c = torch.cat([state["last_tok"][:, None], g[:, :k - 1]], dim=1)
            lm_lib.chunk_forward(params, cache, toks_c, state["pos"], cfg,
                                 codec=codec, codec_params=codec_params,
                                 valid=live[:, None] & (steps[None, :] < e[:, None]),
                                 paged=paged)
            last = (e - 1).long()
            last_emitted = g[rows, last]
            new_feat = torch.where(live[:, None],
                                   feat_seq[rows, last].to(torch.float32),
                                   state["draft_feat"])
            fin = (out_len >= state["max_new"]) | (pos >= max_len)
            if eos_id is not None:
                fin = fin | (last_emitted == eos_id)
            rej = torch.where(live, k - e, 0)
            roll = (live & (e < k)).to(torch.int32)
            state = {**state, "pos": pos, "out_len": out_len, "out_buf": out_buf,
                     "last_tok": torch.where(live, last_emitted, state["last_tok"]),
                     "done": state["done"] | (live & fin),
                     "draft_feat": new_feat,
                     "accepted": state["accepted"] + e_live,
                     "rejected": state["rejected"] + rej,
                     "rollbacks": state["rollbacks"] + roll}
            return state, torch.stack([e_live.sum(), rej.sum(), roll.sum()])

        def spec_window_fn(state, n_rounds: int):
            """Up to ``n_rounds`` rounds, stopping once no slot is live: one
            host read a round (any slot live) and one, at the end, for the
            counters.  Returns (rounds, accepted, rejected, rollbacks,
            state)."""
            i = 0
            totals = torch.zeros((3,), dtype=torch.int64, device=dev)
            while i < n_rounds:
                if not bool((state["active"] & ~state["done"]).any()):  # lint-ok: R3 any slot live, one read a round; B6 (a CUDA graph of the decode step) removes it
                    break
                state, counts = round_fn(state)
                totals = totals + counts
                i += 1
            acc, rej, rol = totals.tolist()  # lint-ok: R3 the window's totals, one read a window; B6 (a CUDA graph of the decode step) removes it
            return i, acc, rej, rol, state

        return spec_window_fn

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

    def _draft_round_wire_bytes(self, k: int) -> int:
        """Draft-channel bytes one verify round ships, both ways: the
        server->client feedback payload (the cut-layer feature batch at the
        draft codec's R; none for the "copy" head, raw float32 without a
        draft codec) plus the client->server draft token ids (k-1 a slot at
        the smallest dtype covering the vocab).  The FORWARD channel ships
        nothing in a verify round: the server knows every decode-time token
        id and replays the bottom stack itself."""
        tok_b = spec_lib.token_wire_bytes(self.cfg.vocab_size)
        ids = (k - 1) * self.num_slots * tok_b
        if not self.spec_cfg.needs_feedback:
            return ids
        dc = self.draft_codec
        if dc is None:
            return ids + self.num_slots * self.cfg.d_model * 4
        c = dc.current if isinstance(dc, codecs_lib.AdaptiveC3SL) else dc
        return ids + codecs_lib.payload_wire_bytes(c, c.payload_shape(self.num_slots))

    def wire_per_token(self) -> dict:
        """Wire bytes per GENERATED token across the serving channels,
        counting the tokens of retired requests; call after draining for
        exact totals."""
        n = self._tokens_decoded
        fwd = self.stats["wire_bytes_fwd"]
        draft = self.stats["wire_bytes_draft"]
        return {"generated_tokens": n, "wire_bytes_fwd": fwd,
                "wire_bytes_draft": draft,
                "wire_bytes_per_token": (fwd + draft) / max(n, 1)}

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
        """Pull a queued or running request OUT of the engine (a client
        disconnect): its slot and pages free at once and the returned
        ``Request`` carries the tokens emitted so far, so a later ``submit``
        of the same object re-prefills prompt + emitted tokens and greedy
        decode resumes identically (the machinery preemption uses).
        Returns None for a finished or unknown uid."""
        for j, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[j]
                self.stats["withdrawn"] += 1
                return req
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.req.uid != uid:
                continue
            req = slot.req
            self.stats["withdrawn"] += 1
            if self.prefill_mode == "chunked":
                st = self._host_state()
                n = int(st["out_len"][i])
                req.out = [int(t) for t in st["out_buf"][i, :n]]
                self._fold_spec_counters(i, req, st)
                _clear_row(st, i)
                self._put_state(st)
            self._stream_mark.pop(uid, None)
            req.evictions += 1
            req.done = False
            slot.req = None
            slot.feed = []
            slot.ingested = 0
            slot.pos = slot.in_prompt = 0
            self._free_slot_pages(i)
            self._dirty = True
            return req
        return None

    def pop_stream_events(self) -> list[tuple[int, int, list[int]]]:
        """Drain the (uid, start, tokens) bursts collected since the last
        call.  ``start`` is the burst's absolute offset in the request's
        output, so a receiver that missed a burst sees the gap."""
        ev, self.stream_events = self.stream_events, []
        return ev

    def attach_sanitizer(self, sanitizer) -> None:
        """Install per-tick invariant checks (an object with an
        ``on_tick(engine)`` method — see
        :class:`repro_torch.analysis.EngineSanitizer`).  A violated
        invariant raises out of tick()/run(); pass None to detach."""
        self._sanitizer = sanitizer

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    @property
    def cache_bytes(self) -> int:
        """Resident device bytes held by the KV cache (pools + tables)."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.cache))

    def run(self, max_steps: int = 10_000) -> list[Request]:
        if self.prefill_mode == "decode":
            return self._run_legacy(max_steps)
        steps = 0
        while steps < max_steps:
            self._boundary()
            if not (self.queue or self.active):
                break
            steps += self._tick_body(max_steps - steps)
            if self._sanitizer is not None:
                self._sanitizer.on_tick(self)
        self._boundary()
        return self.finished

    def tick(self) -> bool:
        """One admission/compute iteration, the incremental form of
        :meth:`run`: a boundary, at most one prefill pass / decode window,
        and a second boundary (one legacy ``step()`` in decode mode).
        Returns False when the engine is idle."""
        if self.prefill_mode == "decode":
            return bool(self.step())
        self._boundary()
        if not (self.queue or self.active):
            return False
        self._tick_body(self.sync_every)
        if self._sanitizer is not None:
            # before the trailing boundary: done-but-unretired slots are
            # still resident, so the dead/live cut probe sees the mix
            self._sanitizer.on_tick(self)
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

    def _spec_k(self) -> int:
        """The k the next decode window speculates at (1 = vanilla).  A
        starved page pool drops to vanilla windows: their per-token EOS
        early exit frees a finished slot's reservation mid-window."""
        if self.spec_cfg is None or self._pool_starved():
            return 1
        return self._k_ctl.current_k

    def _spec_window(self, n: int, k: int) -> int:
        """One speculative window: ceil(n/k) verify/commit rounds; returns
        the tokens emitted."""
        n_rounds = -(-min(n, self._window_len) // k)
        bucket = self._bucket()
        dkey = codecs_lib.program_key(self.draft_codec)
        rounds, acc, rej, rol, self.state = \
            self._spec_programs[(bucket, dkey, k)](self.state, n_rounds)
        self.stats["dispatches"] += 1
        self.stats["decode_steps"] += acc
        self.stats["spec_windows"] += 1
        self.stats["spec_rounds"] += rounds
        self.stats["spec_accepted"] += acc
        self.stats["spec_rejected"] += rej
        self.stats["spec_rollbacks"] += rol
        # the forward channel ships nothing; the draft channel carries each
        # round's feedback and draft ids
        self.stats["wire_bytes_draft"] += rounds * self._draft_round_wire_bytes(k)
        if bucket is not None:
            # one count per token served through the bucket's codec
            self.r_served[bucket] += acc
        self.k_served[k] += rounds
        if acc + rej:
            self._k_ctl.observe(acc / (acc + rej))
        if acc:
            self._dirty = True
        return acc

    def _decode_window(self, n: int) -> int:
        """Run one decode window of up to n steps; returns the steps the
        device actually executed before the batch drained.  Under
        spec_decode with a current k > 1 the window is a speculative one."""
        if n <= 0:
            return 0
        k = self._spec_k()
        if k > 1:
            return self._spec_window(n, k)
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
            if bool(np.any(st["active"] & ~st["done"])):  # lint-ok: R3 host copy of the slot state (numpy): no device read
                self.stats["eos_early_exits"] += 1
            self._collect_stream(st)
            if self._retire_done(st):
                self._put_state(st)
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
        if not valid.any():  # lint-ok: R3 the chunk's host-built mask (numpy): no device read
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
        if completes.any():  # lint-ok: R3 the chunk's host-built mask (numpy): no device read
            # the completing call commits the row's first token: stamp TTFT
            # once the token exists on the device, not when it was enqueued
            self._sync()
            now = time.monotonic()
            for i in np.flatnonzero(completes):
                if self.slots[i].req.t_first is None:
                    self.slots[i].req.t_first = now
            self._dirty = True

    def _put_state(self, st: dict):
        """Write a host copy of the slot state back to the device."""
        self.state = {k: self._to_device(v) for k, v in st.items()}

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
                n = int(st["out_len"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
                slot.req.out = [int(t) for t in st["out_buf"][i, :n]]  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
                slot.req.done = True
                self.finished.append(slot.req)
                self._tokens_decoded += n
                self._fold_spec_counters(i, slot.req, st)
                self._stream_mark.pop(slot.req.uid, None)
                slot.req = None
                slot.feed = []
                self._free_slot_pages(i)
                _clear_row(st, i)
                touched = True
        return touched

    def _fold_spec_counters(self, i: int, req: Request, st):
        """Fold slot i's speculative counters into the request (retire,
        evict and withdraw: totals survive preemption) and zero the slot's
        speculative state so the next resident starts clean."""
        if "accepted" not in st:
            return
        req.accepted += int(st["accepted"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
        req.rejected += int(st["rejected"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
        req.rollbacks += int(st["rollbacks"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
        st["accepted"][i] = st["rejected"][i] = st["rollbacks"][i] = 0
        st["draft_feat"][i, :] = 0

    def _collect_stream(self, st):
        """Harvest the tokens emitted since each resident request's stream
        watermark into ``stream_events``, from a host copy the engine makes
        anyway (boundaries, early retires): streaming costs no extra device
        round trip.  Drain with :meth:`pop_stream_events`."""
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            uid = slot.req.uid
            n = int(st["out_len"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
            mark = self._stream_mark.get(uid, 0)
            if n > mark:
                self.stream_events.append(
                    (uid, mark, [int(t) for t in st["out_buf"][i, mark:n]]))  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
                self._stream_mark[uid] = n

    def _evict(self, i: int, st):
        """Preempt slot ``i`` mid-flight: capture the tokens it emitted,
        free its pages, and re-queue the request right behind the
        preempting head (position 1, so one high-priority arrival cannot
        starve it).  On re-admission it re-prefills prompt + emitted tokens
        and greedy decode resumes identically."""
        slot = self.slots[i]
        req = slot.req
        n = int(st["out_len"][i])  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
        req.out = [int(t) for t in st["out_buf"][i, :n]]  # lint-ok: R3 host copy of the slot state (numpy, from _host_state): no device read
        req.evictions += 1
        self.stats["evictions"] += 1
        self._fold_spec_counters(i, req, st)
        slot.req = None
        slot.feed = []
        slot.ingested = 0
        self._free_slot_pages(i)
        _clear_row(st, i)
        self.queue.insert(1, req)

    def _preempt_for(self, st, head: Request) -> bool:
        """Make room for the blocked head-of-queue request by evicting
        strictly-lower-priority slots, least progress first.  Evicts nothing
        when even every victim together cannot cover the head's pages.
        Returns True when something was evicted (admission retries)."""
        if not self.preemption:
            return False
        victims = [i for i, s in enumerate(self.slots)
                   if s.req is not None and s.req.priority < head.priority]
        if not victims:
            return False
        victims.sort(key=lambda i: (self.slots[i].req.priority, int(st["pos"][i])))
        paged = self.paged is not None and self._linear_backed
        if paged:
            need = self.paged.pages_for(len(head.prompt) + head.max_new_tokens)
            if need > self.allocator.free_pages + sum(
                    len(self.slots[i].pages) for i in victims):
                return False       # hopeless: keep the victims running
        evicted = False
        for i in victims:
            have_slot = any(s.req is None for s in self.slots)
            have_pages = not paged or need <= self.allocator.free_pages
            if have_slot and have_pages:
                break
            self._evict(i, st)
            evicted = True
        return evicted

    def _boundary(self):
        """Admit/retire boundary: the one host copy of the slot state
        outside the decode windows' flags.  Retire frees a slot's pages;
        admission is FIFO and waits until the head request's reservation
        fits, unless ``preemption`` is on and the head outranks running
        slots, which are then evicted.  Skipped while nothing can have
        changed since the last one."""
        if not self._dirty:
            return
        self._dirty = False
        st = self._host_state()
        self._collect_stream(st)
        touched = self._retire_done(st)
        admitted: list[int] = []
        while self.queue:
            head = self.queue[0]
            i = next((j for j, s in enumerate(self.slots) if s.req is None),
                     None)
            if i is None or not self._alloc_slot_pages(i, head):
                if not self._preempt_for(st, head):
                    break                  # FIFO: wait for a slot / pages
                touched = True
                continue                   # room was made: retry the head
            slot = self.slots[i]
            slot.req = self.queue.popleft()
            slot.ingested = 0
            # a re-admitted request re-prefills its emitted tokens too and
            # resumes with out_len/out_buf seeded, so the completing prefill
            # commits its next token
            slot.feed = list(slot.req.prompt) + list(slot.req.out)
            k = len(slot.req.out)
            _clear_row(st, i)
            st["out_len"][i] = k
            st["max_new"][i] = slot.req.max_new_tokens
            if k:
                st["out_buf"][i, :k] = slot.req.out
            # stream watermark: the tokens in req.out were delivered already
            self._stream_mark.setdefault(slot.req.uid, k)
            admitted.append(i)
            touched = True
        if touched:
            self._put_state(st)
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
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)  # lint-ok: R3 the admitted rows' index, uploaded at admission (a boundary, not a step)
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

    # ------------------------------------------------------------------
    # legacy path (prefill as decode, one host sync a token): the baseline
    # ------------------------------------------------------------------

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                if not self._alloc_slot_pages(i, self.queue[0]):
                    break
                slot.req = self.queue.popleft()
                slot.pos = 0
                slot.in_prompt = 0
                slot.feed = list(slot.req.prompt) + list(slot.req.out)
                if self.paged is not None:
                    self.cache["pages"] = self._to_device(self._table)
                self._reset_rows([i])

    def step(self):
        """One legacy engine step: every occupied slot ingests or decodes
        one token ("prefill as decode"), then a host sync."""
        self._admit()
        if self.active == 0:
            return False
        tokens = np.zeros((self.num_slots, 1), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        occupied = np.zeros((self.num_slots,), bool)
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            occupied[i] = True
            tokens[i, 0] = (s.feed[s.in_prompt] if s.in_prompt < len(s.feed)
                            else s.req.out[-1])
            pos[i] = s.pos
        # contiguous: unmasked writes (an empty row writes its own zeroed
        # strip, as the reference); paged: empty rows hold no pages, so
        # their writes are masked
        live = self._to_device(occupied) if self.paged is not None else None
        bucket = self._bucket()
        nxt = self._programs[bucket]["legacy"](
            self._to_device(tokens), self._to_device(pos), live)
        self.stats["dispatches"] += 1
        # one batch step a dispatch: the chunked path's decode_steps unit
        self.stats["decode_steps"] += 1
        self._account_fwd_bytes(self._step_wire_bytes())
        if bucket is not None:
            self.r_served[bucket] += 1
        nxt = nxt.cpu().numpy()  # lint-ok: R3 the legacy mode's one read a step by design (prefill as decode, one host sync a token: the baseline the chunked path beats)
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            s.pos += 1
            fed_prompt = s.in_prompt < len(s.feed)
            if fed_prompt:
                s.in_prompt += 1
            # the last prompt token's logits give the first generated token
            if not fed_prompt or s.in_prompt == len(s.feed):
                tok = int(nxt[i])  # lint-ok: R3 the picks' host copy (numpy, after the one .cpu() a step): no device read
                s.req.out.append(tok)
                if s.req.t_first is None:
                    s.req.t_first = time.monotonic()
                self._tokens_decoded += 1
                if (self.eos_id is not None and tok == self.eos_id) \
                        or len(s.req.out) >= s.req.max_new_tokens \
                        or s.pos >= self.max_len:
                    s.req.done = True
            if s.req.done:
                self.finished.append(s.req)
                s.req = None
                self._free_slot_pages(i)
        return True

    def _run_legacy(self, max_steps: int) -> list[Request]:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


def _append(out_buf, out_len, tok, write):
    """``out_buf`` with ``tok`` at column ``out_len`` (clamped to the last
    column) on the rows ``write`` marks: the reference's scatter with
    mode="drop", as a masked select (no host read)."""
    B, cap = out_buf.shape
    col = torch.where(write, torch.clamp(out_len, max=cap - 1), cap)
    hit = torch.arange(cap, device=col.device)[None, :] == col[:, None]
    return torch.where(hit, tok[:, None], out_buf)


def _clear_row(st, i: int):
    """Zero slot ``i``'s position, flags, token and output in the host
    copy ``st`` (retire, evict, withdraw, admit)."""
    st["active"][i] = st["done"][i] = False
    st["pos"][i] = st["last_tok"][i] = st["out_len"][i] = 0
    st["out_buf"][i, :] = 0
