"""The multi-tenant split-serving front door server.

Port of ``repro/frontdoor/server.py`` over the port's engine.  Its frames,
handshake and STATS keys are the reference's, so clients of either package
connect to it; a spec string is canonicalized through ``repro_torch.codecs``
and ``repro_torch.transport`` to the same string the reference's server
makes.  The STATS body names how the engine's ops ran (its
``*_execution_mode`` fields: ``cuda-kernel`` where the CUDA kernels ran,
``torch-plain`` where their plain versions did), where the reference names
its Pallas modes; every integer field is the reference's for the same
requests.

Turns an in-process :class:`repro_torch.serving.engine.BatchedEngine` into a
networked server: N concurrent client connections stream length-prefixed
frames (``repro_torch.frontdoor.protocol``) over asyncio TCP/loopback through
the reliable :class:`~repro_torch.frontdoor.stream.FrameStream` layer
(sequencing + CRC + NACK/retransmit), a continuous batcher drains
accepted requests into engine slots, and per-tenant QoS accounting
(``repro_torch.frontdoor.qos``) is exposed through a ``STATS`` RPC.

Concurrency model: everything — connection handlers, admission, engine
stepping — runs on ONE event loop thread.  Handlers only run between
engine dispatches (``engine.tick()`` is synchronous), so no locks guard
the engine or the books; the engine must not be driven by anything else
while the server owns it.  On the card a tick holds the loop for a whole
decode window or prefill chunk (the window ends in one host read of the
done flags), so the heartbeat deadline (``heartbeat_s`` x ``max_misses``)
must stay above the longest tick.  ``auto_tick=False`` parks the compute
loop so tests can stage every submission first and then :meth:`drain`
deterministically — that is what makes the loopback-vs-direct
bit-identical equivalence tests possible under a batch-wise codec (slot
occupancy affects C3-SL superposition cross-talk, so the dispatch
schedule must match exactly).

The HELLO handshake pins the cut-layer codec contract: the client's spec
string is canonicalized exactly like the engine's (same registry build,
same D, same slot clamp) and must equal the engine's canonical spec — or,
for an adaptive engine, may name one of its R buckets (the server's
controller owns the schedule; a bucket client is pinned to a compatible
wire format).  Any other spec is refused with ``ERROR`` at connect time:
codec mismatch is a handshake failure, never silently decoded garbage.

Failure handling (see the reference's src/repro/frontdoor/README.md):

* **Deadlines** — the handshake must complete within
  ``handshake_timeout_s`` (a half-open client can no longer hold a
  connection slot forever), and the per-connection read loop wakes every
  ``heartbeat_s`` of silence to PING; ``max_misses`` silent heartbeat
  intervals in a row declare the peer dead.

* **Detach / resume** — every handshake mints (or resumes) a session
  token.  When a connection dies with work outstanding, the session
  DETACHES: live requests are pulled out of the engine
  (``engine.withdraw`` — same capture machinery as slot preemption),
  their admission units are released immediately (the inflight counter
  is correct the moment the connection ends, on every failure path), and
  finished-but-undelivered results are parked.  A client reconnecting
  with the token within ``resume_ttl_s`` gets its withdrawn requests
  re-admitted and re-submitted — the engine re-prefills prompt + emitted
  tokens, so greedy output is bit-identical to an uninterrupted run —
  and its parked results flushed.  Past the TTL the session is swept and
  its parked work dropped.

* **Shutdown** — :meth:`stop` cancels every in-flight connection task
  and tears down all sessions, so no orphaned asyncio tasks or unclosed
  transports survive the server.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time

import numpy as np

from repro_torch import codecs as codecs_lib
from repro_torch.faults import ChannelErasure
from repro_torch.frontdoor import protocol as proto
from repro_torch.frontdoor.admission import (ADMIT, BUSY_QUEUE, AdmissionController)
from repro_torch.frontdoor.protocol import MsgType, ProtocolError
from repro_torch.frontdoor.qos import QoSRegistry
from repro_torch.frontdoor.stream import FrameStream
from repro_torch.serving.engine import BatchedEngine, Request


def canonical_codec_spec(spec, D: int, num_slots: int) -> str:
    """The canonical form of a cut-layer codec spec as the ENGINE would
    serve it: link specs resolve to their forward channel, runtime dims
    filled (D), R clamped to the slot count, then the registry's
    round-trip spec string.  Two specs are wire-compatible iff their
    canonical forms are equal."""
    from repro_torch import transport
    if spec is None or spec == "none":
        return "none"
    if transport.is_link_spec(spec):
        spec = transport.build_link(spec, D=D).fwd.codec
    codec = codecs_lib.build(spec, D=D) if isinstance(spec, str) else spec
    return codecs_lib.clamp_R(codec, num_slots).spec()


def engine_codec_specs(engine: BatchedEngine) -> tuple[str, set[str]]:
    """The engine's canonical spec plus the set of additionally-compatible
    specs (an adaptive engine's per-bucket static specs)."""
    if engine.codec is None:
        return "none", set()
    spec = engine.codec.spec()
    compat = set()
    if isinstance(engine.codec, codecs_lib.AdaptiveC3SL):
        compat = {c.spec() for c in engine.codec.buckets.values()}
    return spec, compat


@dataclasses.dataclass
class _Conn:
    stream: FrameStream
    tenant: str
    open: bool = True


@dataclasses.dataclass
class _Session:
    """One client's server-side continuity across connections."""
    token: str
    tenant: str
    conn: _Conn | None                       # live connection, None detached
    rids: dict = dataclasses.field(default_factory=dict)   # rid -> uid
    # rids whose RESULT was already delivered (bounded, insertion-ordered).
    # A replayed SUBMIT can race the parked-result flush on resume: by the
    # time it arrives the rid is gone from ``rids``, and without this set
    # it would be admitted AGAIN — a ghost request burning a slot and,
    # under a batch-wise codec, perturbing other requests' outputs.
    done_rids: dict = dataclasses.field(default_factory=dict)
    # finished results that could not be delivered: (rid, header, payload)
    parked: list = dataclasses.field(default_factory=list)

    def mark_delivered(self, rid, keep: int = 256):
        self.rids.pop(rid, None)
        self.done_rids[rid] = None
        while len(self.done_rids) > keep:
            del self.done_rids[next(iter(self.done_rids))]
    # requests pulled out of the engine at detach, awaiting resume:
    # (rid, Request) — the Request carries prompt + emitted tokens
    withdrawn: list = dataclasses.field(default_factory=list)
    detached_at: float | None = None
    epochs: int = 0                          # connections this session saw


@dataclasses.dataclass
class _Route:
    """Where a submitted request's result goes, plus its QoS timestamps."""
    sess: _Session
    rid: int
    tenant: str
    bytes_in: int            # SUBMIT frame bytes (per-request wire cost)


class FrontDoorServer:
    def __init__(self, engine: BatchedEngine, *, host: str = "127.0.0.1",
                 port: int = 0, admission: AdmissionController | None = None,
                 qos: QoSRegistry | None = None, auto_tick: bool = True,
                 idle_sleep_s: float = 0.002, busy_retry_ms: int = 25,
                 faults=None, handshake_timeout_s: float = 10.0,
                 heartbeat_s: float = 5.0, max_misses: int = 3,
                 resume_ttl_s: float = 30.0):
        self.engine = engine
        self.host, self.port = host, port
        self.admission = admission or AdmissionController()
        self.qos = qos or QoSRegistry()
        self.auto_tick = auto_tick
        self.idle_sleep_s = idle_sleep_s
        self.busy_retry_ms = busy_retry_ms
        self.faults = faults                 # FaultPlan on the s2c direction
        self.handshake_timeout_s = handshake_timeout_s
        self.heartbeat_s = heartbeat_s
        self.max_misses = max_misses
        self.resume_ttl_s = resume_ttl_s
        self._spec, self._compat_specs = engine_codec_specs(engine)
        # speculative-decoding contract (None when the engine decodes
        # vanilla): the draft channel's canonical codec spec plus the
        # pinned k/head, advertised in HELLO_OK and validated against any
        # draft spec the client supplies — a draft-channel mismatch is a
        # handshake failure exactly like a cut-layer codec mismatch.
        self._draft_spec = None
        if engine.spec_cfg is not None:
            self._draft_spec = (engine.draft_codec.spec()
                                if engine.draft_codec is not None else "none")
        self._uids = itertools.count()
        self._tokens = itertools.count()
        self._epochs = itertools.count()     # s2c fault epoch per connection
        self._routes: dict[int, _Route] = {}
        self._sessions: dict[str, _Session] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        self._server: asyncio.base_events.Server | None = None
        self._tick_task: asyncio.Task | None = None
        self._tick_error: BaseException | None = None
        self._closing = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        if self.auto_tick:
            self._tick_task = asyncio.create_task(self._tick_loop())
        return self.host, self.port

    @property
    def tick_error(self) -> BaseException | None:
        """The exception that killed the tick loop, if any — checked by
        selfcheck (and surfaced by stop(), which re-raises it)."""
        return self._tick_error

    async def stop(self, *, drain: bool = True):
        """Clean shutdown: optionally finish all admitted work (results
        delivered), then stop ticking, cancel every in-flight connection
        task, tear down all sessions, and close the listener — no
        orphaned tasks or held admission units survive."""
        if drain:
            await self.drain()
        self._closing = True
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:  # lint-ok: R5 reaping the tick task WE just cancelled at shutdown
                pass
            self._tick_task = None
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        # any route still live (its connection task was cancelled before a
        # detach could run) holds one admission unit — release them all,
        # then drop the session books
        for route in self._routes.values():
            self.admission.release(route.tenant)
        self._routes.clear()
        self._sessions.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def drain(self):
        """Tick until the engine is idle and every finished request has
        been delivered (or its connection is gone)."""
        eng = self.engine
        if self._tick_error is not None:
            return            # engine crashed: nothing will drain; stop()
        while eng.queue or eng.active or eng.finished or self._routes:
            worked = await self._pump()
            if not worked:
                if not (eng.queue or eng.active or eng.finished):
                    break                      # routes of dead conns only
                await asyncio.sleep(0)

    async def _tick_loop(self):
        try:
            while not self._closing:
                worked = await self._pump()
                # yield even after useful work so handlers get to run between
                # dispatches; park on the idle sleep otherwise
                await asyncio.sleep(0 if worked else self.idle_sleep_s)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # An engine (or sanitizer-invariant) exception used to kill
            # this task SILENTLY: tenants hung forever on results that
            # would never come.  Record it and fail every connection fast
            # so callers (selfcheck, real clients) observe the crash.
            self._tick_error = e
            for task in list(self._conn_tasks):
                task.cancel()
            raise

    async def _pump(self) -> bool:
        """One engine tick plus result delivery; True if anything moved."""
        eng = self.engine
        worked = False
        if eng.queue or eng.active:
            worked = eng.tick()
        worked |= await self._stream_tokens()
        worked |= await self._deliver()
        self._sweep_expired()
        return worked

    async def _stream_tokens(self) -> bool:
        """Forward the engine's incremental token bursts as TOKENS frames.

        Each burst is the tokens one request emitted since its last burst
        (one per verify round under speculative decoding — that is what
        makes the client-visible latency profile show the k-token
        amortization).  Delivery is best-effort: RESULT still carries the
        FULL output, so a dead connection just drops the preview — the
        burst is NOT parked."""
        events = self.engine.pop_stream_events()
        if not events:
            return False
        for uid, start, tokens in events:
            route = self._routes.get(uid)
            if route is None:
                continue                      # not ours (direct submit)
            conn = route.sess.conn
            if conn is None or not conn.open:
                continue
            header = {"rid": route.rid, "off": start, "n": len(tokens)}
            arr_header, payload = proto.pack_array(
                np.asarray(tokens, dtype=np.int32))
            header.update(arr_header)
            try:
                sent = await conn.stream.send(MsgType.TOKENS, header,
                                              payload)
                self.qos.tenant(route.tenant).bytes_out += sent
            except (ConnectionError, RuntimeError, OSError):
                conn.open = False
        return True

    async def _deliver(self) -> bool:
        eng = self.engine
        if not eng.finished:
            return False
        finished, eng.finished = list(eng.finished), []
        now = time.monotonic()
        for req in finished:
            route = self._routes.pop(req.uid, None)
            if route is None:
                continue                      # not ours (direct submit)
            self.admission.release(route.tenant)
            tq = self.qos.tenant(route.tenant)
            ttft = (req.t_first - req.t_submit
                    if req.t_first is not None else None)
            decode_s = (now - req.t_first) if req.t_first is not None else 0.0
            ttlt = now - req.t_submit
            header = {"rid": route.rid, "ttft_s": ttft, "ttlt_s": ttlt,
                      "evictions": req.evictions,
                      "accepted": req.accepted, "rejected": req.rejected,
                      "rollbacks": req.rollbacks}
            arr_header, payload = proto.pack_array(
                np.asarray(req.out, dtype=np.int32))
            header.update(arr_header)
            sent = 0
            conn = route.sess.conn
            delivered = False
            if conn is not None and conn.open:
                try:
                    sent = await conn.stream.send(MsgType.RESULT, header,
                                                  payload)
                    tq.bytes_out += sent
                    delivered = True
                except (ConnectionError, RuntimeError, OSError):
                    conn.open = False
            if delivered:
                route.sess.mark_delivered(route.rid)
            else:
                # park for a reattach — the session keeps the result until
                # the client resumes or the resume TTL sweeps it
                route.sess.parked.append((route.rid, header, payload))
            tq.record_result(ttft_s=ttft, gen_tokens=len(req.out),
                             decode_s=decode_s,
                             wire_bytes=route.bytes_in + sent,
                             evictions=req.evictions, ttlt_s=ttlt)
        return True

    # ------------------------------------------------------------------
    # session continuity
    # ------------------------------------------------------------------

    def _detach(self, sess: _Session, reason: str):
        """The connection died with the session possibly holding work.
        Pull its live requests out of the engine and release their
        admission units RIGHT NOW — the inflight counter must be correct
        the moment the connection ends, whatever killed it — then park
        the session for ``resume_ttl_s``."""
        if sess.conn is not None:
            sess.conn.open = False
            sess.conn = None
        sess.detached_at = time.monotonic()
        self.qos.tenant(sess.tenant).disconnects += 1
        for uid, route in list(self._routes.items()):
            if route.sess is not sess:
                continue
            req = self.engine.withdraw(uid)
            if req is None:
                # finished but undelivered: _deliver will release its
                # admission unit and park the result on this session
                continue
            del self._routes[uid]
            self.admission.release(sess.tenant)
            sess.withdrawn.append((route.rid, req))

    async def _resume(self, sess: _Session, conn: _Conn):
        """Reattach a detached session: re-admit + re-submit everything
        that was withdrawn (the engine re-prefills prompt + emitted
        tokens, so greedy decode is bit-identical to an uninterrupted
        run), then flush parked results."""
        sess.conn = conn
        sess.detached_at = None
        sess.epochs += 1
        tq = self.qos.tenant(sess.tenant)
        tq.resumes += 1
        withdrawn, sess.withdrawn = sess.withdrawn, []
        for rid, req in withdrawn:
            verdict = self.admission.try_admit(sess.tenant)
            if verdict != ADMIT:
                # someone took the capacity while we were detached; the
                # client gets a typed refusal instead of a silent hang
                sess.rids.pop(rid, None)
                tq.errors += 1
                tq.bytes_out += await conn.stream.send(
                    MsgType.ERROR,
                    {"rid": rid, "reason": f"resume re-admission refused "
                                           f"({verdict})"})
                continue
            self.engine.submit(req)
            self._routes[req.uid] = _Route(sess=sess, rid=rid,
                                           tenant=sess.tenant, bytes_in=0)
        parked, sess.parked = sess.parked, []
        for rid, header, payload in parked:
            tq.bytes_out += await conn.stream.send(MsgType.RESULT, header,
                                                   payload)
            sess.mark_delivered(rid)

    def _sweep_expired(self):
        """Detached sessions past the resume TTL: drop their parked
        results and withdrawn requests (admission was already released at
        detach) and forget the token."""
        if self.resume_ttl_s is None:
            return
        now = time.monotonic()
        for token, sess in list(self._sessions.items()):
            if sess.detached_at is None:
                continue
            if now - sess.detached_at > self.resume_ttl_s:
                self.qos.tenant(sess.tenant).expired += 1
                del self._sessions[token]

    def _end_session(self, sess: _Session):
        """Clean BYE: anything still outstanding is abandoned by the
        client — withdraw it and release its admission units."""
        for uid, route in list(self._routes.items()):
            if route.sess is not sess:
                continue
            self.engine.withdraw(uid)
            del self._routes[uid]
            self.admission.release(sess.tenant)
        self._sessions.pop(sess.token, None)

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        stream = FrameStream(reader, writer, direction="s2c",
                             faults=self.faults, epoch=next(self._epochs))
        conn: _Conn | None = None
        sess: _Session | None = None
        clean = False
        try:
            try:
                conn, sess = await asyncio.wait_for(
                    self._handshake(stream), self.handshake_timeout_s)
            except asyncio.TimeoutError:
                return                        # half-open peer: free the slot
            if conn is None:
                return
            misses = 0
            while True:
                try:
                    got = await stream.recv(timeout=self.heartbeat_s)
                except asyncio.TimeoutError:
                    misses += 1
                    if misses > self.max_misses:
                        raise ConnectionError(
                            f"peer silent for {misses} heartbeat intervals")
                    await stream.ping()       # PONG carries the peer's
                    continue                  # send watermark -> gap NACKs
                misses = 0
                if got is None:
                    break                     # peer went away (EOF)
                mtype, header, payload, nbytes, _seq = got
                self.qos.tenant(conn.tenant).bytes_in += nbytes
                if mtype == MsgType.SUBMIT:
                    await self._submit(sess, conn, header, payload, nbytes)
                elif mtype == MsgType.STATS:
                    out = await conn.stream.send(MsgType.STATS_OK,
                                                 {"stats": self.stats()})
                    self.qos.tenant(conn.tenant).bytes_out += out
                elif mtype == MsgType.BYE:
                    await conn.stream.send(MsgType.BYE_OK, {})
                    clean = True
                    break
                else:
                    raise ProtocolError(f"unexpected {mtype.name} frame "
                                        "after handshake")
        except (ChannelErasure, ConnectionError, asyncio.TimeoutError):
            pass                              # abnormal end -> detach below
        except ProtocolError as e:
            # fail LOUDLY, then kill the connection: a framing/dtype error
            # means client and server no longer agree on the wire format
            try:
                await stream.send(MsgType.ERROR, {"reason": str(e)})
            except (ConnectionError, RuntimeError, OSError):
                pass
        except asyncio.CancelledError:
            # server shutdown: stop() releases the books after cancelling
            raise
        finally:
            self._conn_tasks.discard(task)
            if conn is not None:
                conn.open = False
                tq = self.qos.tenant(conn.tenant)
                tq.retransmits += stream.counters["retransmits"]
                tq.nacks += stream.counters["nacks"]
            if sess is not None:
                if clean:
                    self._end_session(sess)
                elif sess.conn is conn:       # not already resumed elsewhere
                    self._detach(sess, "connection lost")
            stream.close()
            try:
                await stream.wait_closed()
            except asyncio.CancelledError:  # lint-ok: R5 teardown path: this handler task is already being cancelled by stop(); the socket close must still finish
                pass

    async def _handshake(self, stream: FrameStream):
        # a dropped HELLO must not stall the full handshake deadline: ping
        # on silence — the peer's PONG carries its send watermark, the gap
        # NACK recovers the frame (the outer wait_for still bounds this)
        while True:
            try:
                got = await stream.recv(timeout=max(self.heartbeat_s, 0.05))
                break
            except asyncio.TimeoutError:
                await stream.ping()
        if got is None:
            return None, None
        mtype, header, _, nbytes, _seq = got
        if mtype != MsgType.HELLO:
            raise ProtocolError(f"expected HELLO, got {mtype.name}")
        tenant = header.get("tenant")
        if not isinstance(tenant, str) or not tenant:
            raise ProtocolError("HELLO carries no tenant id")
        spec = header.get("codec", "none")
        try:
            canon = canonical_codec_spec(spec, self.engine.cfg.d_model,
                                         self.engine.num_slots)
        except Exception as e:
            raise ProtocolError(f"unbuildable codec spec {spec!r}: {e}")
        if canon != self._spec and canon not in self._compat_specs:
            compat = sorted({self._spec, *self._compat_specs})
            raise ProtocolError(
                f"codec mismatch: client {spec!r} (canonical {canon!r}) vs "
                f"engine {self._spec!r}; compatible specs: {compat} — "
                "refusing the connection rather than decoding garbage")
        draft = header.get("draft")
        if draft is not None:
            # the client pins the draft channel too — same refusal rule
            if self._draft_spec is None:
                raise ProtocolError(
                    f"client pinned draft spec {draft!r} but the engine "
                    "does not speculate — refusing the connection")
            try:
                dcanon = canonical_codec_spec(draft, self.engine.cfg.d_model,
                                              self.engine.num_slots)
            except Exception as e:
                raise ProtocolError(f"unbuildable draft spec {draft!r}: {e}")
            if dcanon != self._draft_spec:
                raise ProtocolError(
                    f"draft-channel mismatch: client {draft!r} (canonical "
                    f"{dcanon!r}) vs engine {self._draft_spec!r} — refusing "
                    "the connection rather than decoding garbage")
        conn = _Conn(stream=stream, tenant=tenant)
        resume = header.get("resume")
        resumed = False
        if resume is not None:
            sess = self._sessions.get(resume)
            if sess is None:
                raise ProtocolError(
                    f"resume token {resume!r} unknown or expired (sessions "
                    f"detach for at most {self.resume_ttl_s}s)")
            if sess.tenant != tenant:
                raise ProtocolError(
                    f"resume token {resume!r} belongs to another tenant")
            if sess.conn is not None:
                sess.conn.open = False        # stale half-open predecessor
            resumed = True
        else:
            token = f"{tenant}#{next(self._tokens)}"
            sess = _Session(token=token, tenant=tenant, conn=conn)
            self._sessions[token] = sess
        tq = self.qos.tenant(tenant)
        tq.bytes_in += nbytes
        hello_ok = {"codec": self._spec, "num_slots": self.engine.num_slots,
                    "max_len": self.engine.max_len,
                    "kv_layout": self.engine.kv_layout,
                    "preemption": self.engine.preemption,
                    "session": sess.token, "resumed": resumed,
                    "heartbeat_s": self.heartbeat_s}
        if self._draft_spec is not None:
            scfg = self.engine.spec_cfg
            hello_ok.update({"draft": self._draft_spec,
                             "spec_k": scfg.k, "draft_head": scfg.draft_head,
                             "spec_adaptive": scfg.adaptive})
        tq.bytes_out += await stream.send(MsgType.HELLO_OK, hello_ok)
        if resumed:
            await self._resume(sess, conn)
        return conn, sess

    async def _submit(self, sess: _Session, conn: _Conn, header: dict,
                      payload: bytes, nbytes: int):
        tq = self.qos.tenant(conn.tenant)
        rid = header.get("rid")
        if not isinstance(rid, int):
            raise ProtocolError("SUBMIT carries no integer rid")
        if rid in sess.rids or rid in sess.done_rids:
            # idempotent re-SUBMIT after a reconnect: the request is
            # already in flight (or parked), or its result was already
            # delivered (the replay raced the parked-result flush) —
            # re-ACK instead of doubling it
            tq.bytes_out += await conn.stream.send(MsgType.ACCEPTED,
                                                   {"rid": rid})
            return
        tokens = proto.unpack_array(header, payload)
        if tokens.ndim != 1 or tokens.dtype.name != "int32":
            raise ProtocolError(f"SUBMIT payload must be a 1-D int32 token "
                                f"array, got {tokens.dtype.name}"
                                f"{tokens.shape}")
        verdict = self.admission.try_admit(conn.tenant)
        if verdict != ADMIT:
            tq.busy_rejections += 1
            retry = self.busy_retry_ms * (4 if verdict == BUSY_QUEUE else 1)
            tq.bytes_out += await conn.stream.send(
                MsgType.BUSY,
                {"rid": rid, "reason": verdict, "retry_after_ms": retry})
            return
        policy = self.admission.policy(conn.tenant)
        req = Request(uid=next(self._uids),
                      prompt=[int(t) for t in tokens],
                      max_new_tokens=int(header.get("max_new", 16)),
                      priority=int(header.get("priority", policy.priority)))
        try:
            self.engine.submit(req)
        except ValueError as e:
            # engine-level refusal (empty/overlong prompt, footprint above
            # the whole pool): an ERROR the client must not retry verbatim
            self.admission.release(conn.tenant)
            tq.errors += 1
            tq.bytes_out += await conn.stream.send(
                MsgType.ERROR, {"rid": rid, "reason": str(e)})
            return
        self._routes[req.uid] = _Route(sess=sess, rid=rid,
                                       tenant=conn.tenant, bytes_in=nbytes)
        sess.rids[rid] = req.uid
        tq.bytes_out += await conn.stream.send(MsgType.ACCEPTED,
                                               {"rid": rid})

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """The STATS RPC body: per-tenant QoS plus the engine's serving
        counters (cut-layer wire bytes, served-R schedule, eviction and
        early-exit counts, page-pool occupancy)."""
        eng = self.engine
        return {"tenants": self.qos.snapshot(),
                "engine": {**eng.stats,
                           "r_served": {str(k): v
                                        for k, v in sorted(
                                            eng.r_served.items())},
                           "k_served": {str(k): v
                                        for k, v in sorted(
                                            eng.k_served.items())},
                           "wire_per_token": eng.wire_per_token(),
                           "draft": self._draft_spec,
                           "codec": self._spec,
                           "active_slots": eng.active,
                           "queued": len(eng.queue),
                           "pool": eng.pool_accounting()},
                "admission": {"inflight_total": self.admission.inflight_total,
                              "inflight": dict(self.admission.inflight),
                              "max_queue_depth":
                                  self.admission.max_queue_depth},
                "sessions": {"open": sum(s.conn is not None
                                         for s in self._sessions.values()),
                             "detached": sum(s.conn is None
                                             for s in self._sessions.values())}}
