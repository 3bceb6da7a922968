"""Asyncio client for the split-serving front door.

Port of ``repro/frontdoor/client.py``; it talks to a server of either
package (the frames are the same bytes).

The edge-client side of the wire protocol: one TCP connection through
the reliable :class:`~repro_torch.frontdoor.stream.FrameStream` layer, a HELLO
handshake pinning the cut-layer codec spec, then any number of in-flight
``SUBMIT``s multiplexed by request id.  ``BUSY`` replies (admission
shedding) surface as :class:`BusyError` with the server's retry hint;
:meth:`generate` wraps submit+wait in the retry loop an edge client would
run — exponential backoff with deterministic jitter, bounded by both a
retry count and an optional wall-clock ``deadline_s`` (exhausting either
raises the typed :class:`DeadlineExceeded`).

Failure recovery: when the connection dies mid-session (server restart,
injected chaos disconnect, NACK budget exhausted) and ``reconnect`` is
on, the client reconnects and presents its session token; the server
re-admits the work it withdrew at detach (greedy output bit-identical to
an uninterrupted run) and flushes any parked results.  SUBMITs that were
never ACKed are re-sent on the new connection — the server treats a
repeated rid idempotently — so no request is lost or doubled across the
disconnect.

    client = await FrontDoorClient.open(host, port, tenant="edge-7",
                                        codec="c3sl:R=4|int8")
    out = await client.generate([1, 2, 3], max_new=16)
    print(out["tokens"], out["ttft_s"])
    await client.close()
"""
from __future__ import annotations

import asyncio
import itertools
import random
import time
import zlib

import numpy as np

from repro_torch.frontdoor import protocol as proto
from repro_torch.frontdoor.protocol import MsgType, ProtocolError
from repro_torch.frontdoor.stream import FrameStream


class FrontDoorError(Exception):
    """Server refused the connection or the request (not retriable)."""


class DeadlineExceeded(FrontDoorError):
    """The retry budget (attempts or wall-clock deadline) ran out."""


class BusyError(Exception):
    """Admission shed the request; retry after ``retry_after_ms``."""

    def __init__(self, reason: str, retry_after_ms: int):
        super().__init__(f"server busy ({reason}); "
                         f"retry in {retry_after_ms}ms")
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class FrontDoorClient:
    def __init__(self, host: str, port: int, *, tenant: str,
                 codec: str = "none", draft: str | None = None,
                 on_tokens=None, faults=None, reconnect: bool = True,
                 reconnect_tries: int = 4, reconnect_backoff_s: float = 0.05,
                 handshake_timeout_s: float = 10.0,
                 handshake_ping_s: float = 0.5):
        self.host, self.port = host, port
        self.tenant = tenant
        self.codec = codec
        self.draft = draft                   # pin the draft-channel spec too
        self.on_tokens = on_tokens           # (rid, [tokens]) per burst
        self.faults = faults                 # FaultPlan on the c2s direction
        self.reconnect = reconnect
        self.reconnect_tries = reconnect_tries
        self.reconnect_backoff_s = reconnect_backoff_s
        self.handshake_timeout_s = handshake_timeout_s
        self.handshake_ping_s = handshake_ping_s
        self.server_info: dict = {}          # last HELLO_OK header
        self.session: str | None = None      # server-minted resume token
        self._rids = itertools.count()
        self._epoch = 0                      # connection attempts (fault key)
        self._stream: FrameStream | None = None
        self._read_task: asyncio.Task | None = None
        self._acks: dict[int, asyncio.Future] = {}
        self._results: dict[int, asyncio.Future] = {}
        # incremental TOKENS bursts by rid — best-effort preview (a burst
        # riding a dying connection is dropped, not retransmitted), so
        # this may be a PROPER prefix of the RESULT after a reconnect
        self._streamed: dict[int, list[int]] = {}
        # un-ACKed SUBMITs by rid, re-sent verbatim after a reconnect
        self._unacked: dict[int, tuple[dict, bytes]] = {}
        self._stats: list[asyncio.Future] = []
        self._bye: asyncio.Future | None = None
        self._conn_error: Exception | None = None
        self._conn_lock = asyncio.Lock()
        self._closed = False
        # deterministic jitter: seeded per tenant, so a fleet of tenants
        # decorrelates its BUSY retries while any one run stays replayable
        self._rng = random.Random(zlib.crc32(tenant.encode("utf-8")))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @classmethod
    async def open(cls, host: str, port: int, *, tenant: str,
                   codec: str = "none", **kwargs) -> "FrontDoorClient":
        client = cls(host, port, tenant=tenant, codec=codec, **kwargs)
        await client._connect()
        return client

    async def _connect(self):
        """Dial + handshake once; raises on refusal or timeout."""
        reader, writer = await asyncio.open_connection(self.host, self.port)
        stream = FrameStream(reader, writer, direction="c2s",
                             faults=self.faults, epoch=self._epoch)
        self._epoch += 1
        hello = {"tenant": self.tenant, "codec": self.codec}
        if self.draft is not None:
            hello["draft"] = self.draft
        if self.session is not None:
            hello["resume"] = self.session
        try:
            await stream.send(MsgType.HELLO, hello)
            # ping on silence so a dropped HELLO / HELLO_OK is recovered
            # via the watermark gap-NACK instead of the whole deadline
            deadline = time.monotonic() + self.handshake_timeout_s
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise asyncio.TimeoutError("handshake deadline")
                try:
                    got = await stream.recv(
                        timeout=min(max(self.handshake_ping_s, 0.05), left))
                    break
                except asyncio.TimeoutError:
                    await stream.ping()
        except (ConnectionError, OSError, asyncio.TimeoutError):
            stream.close()
            raise
        if got is None:
            stream.close()
            raise FrontDoorError("server closed the connection mid-handshake")
        mtype, header, _, _, _seq = got
        if mtype == MsgType.ERROR:
            stream.close()
            raise FrontDoorError(header.get("reason", "handshake refused"))
        if mtype != MsgType.HELLO_OK:
            stream.close()
            raise FrontDoorError(f"expected HELLO_OK, got {mtype.name}")
        self.server_info = header
        self.session = header.get("session", self.session)
        self._stream = stream
        self._conn_error = None
        self._read_task = asyncio.create_task(self._read_loop(stream))

    async def close(self):
        """BYE handshake, then tear the connection down."""
        self._closed = True
        if (self._bye is None and self._conn_error is None
                and self._stream is not None):
            self._bye = asyncio.get_running_loop().create_future()
            try:
                await self._stream.send(MsgType.BYE, {})
                await asyncio.wait_for(asyncio.shield(self._bye), timeout=10)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    FrontDoorError):
                # best-effort: a lost BYE_OK (or a connection that died
                # under the BYE) must not block teardown
                pass
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):  # lint-ok: R5 reaping a task WE just cancelled: its CancelledError is the expected result, not our own cancellation
                pass
        if self._stream is not None:
            self._stream.close()
            await self._stream.wait_closed()

    # ------------------------------------------------------------------
    # reconnect-with-resume
    # ------------------------------------------------------------------

    async def _send_data(self, mtype: MsgType, header: dict,
                         payload: bytes = b""):
        """Send one data frame, transparently reconnecting (and resuming
        the session) when the connection is dead or dies underneath the
        send — e.g. an injected chaos disconnect fires ON the send."""
        for _ in range(self.reconnect_tries + 1):
            self._check_conn()
            stream = self._stream
            try:
                return await stream.send(mtype, header, payload)
            except (ConnectionError, OSError) as e:
                await self._ensure_conn(stream, e)
        raise FrontDoorError("connection kept failing mid-send")

    async def _ensure_conn(self, failed: FrameStream, err: Exception):
        """Reconnect once per FAILED stream: concurrent callers (the read
        loop, a mid-send failure) serialize on the lock and whoever loses
        the race finds the fresh stream already installed."""
        async with self._conn_lock:
            if self._stream is not failed:
                return                        # somebody else already fixed it
            if self._closed or not self.reconnect:
                self._fail_all(err)
                raise FrontDoorError(f"connection dead: {err}")
            if self._read_task is not None \
                    and self._read_task is not asyncio.current_task():
                self._read_task.cancel()
                try:
                    await self._read_task
                except (asyncio.CancelledError, Exception):  # lint-ok: R5 reaping a task WE just cancelled before reconnecting
                    pass
            failed.close()
            last: Exception = err
            for attempt in range(self.reconnect_tries):
                try:
                    await self._connect()
                    break
                except FrontDoorError:
                    # server REFUSED the resume (token expired / tenant
                    # mismatch): retrying cannot help
                    self._fail_all(err)
                    raise
                except (ConnectionError, OSError,
                        asyncio.TimeoutError) as e:
                    last = e
                    await asyncio.sleep(self.reconnect_backoff_s
                                        * (attempt + 1))
            else:
                self._fail_all(last)
                raise FrontDoorError(f"reconnect failed: {last}")
            # replay SUBMITs the server never ACKed; repeated rids are
            # idempotent server-side, so a lost-ACK (vs lost-SUBMIT) race
            # cannot double-submit
            for rid, (header, payload) in list(self._unacked.items()):
                await self._stream.send(MsgType.SUBMIT, header, payload)

    def _fail_all(self, err: Exception):
        self._conn_error = err
        for fut in (*self._acks.values(), *self._results.values(),
                    *self._stats, *((self._bye,) if self._bye else ())):
            if not fut.done():
                fut.set_exception(FrontDoorError(str(err)))

    # ------------------------------------------------------------------
    # RPCs
    # ------------------------------------------------------------------

    async def submit(self, prompt, *, max_new: int = 16,
                     priority: int | None = None) -> int:
        """One SUBMIT; returns the rid once ACCEPTED.  Raises BusyError on
        admission shedding, FrontDoorError on a server-side refusal."""
        self._check_conn()
        rid = next(self._rids)
        header = {"rid": rid, "max_new": max_new}
        if priority is not None:
            header["priority"] = priority
        arr_header, payload = proto.pack_array(
            np.asarray(list(prompt), dtype=np.int32))
        header.update(arr_header)
        loop = asyncio.get_running_loop()
        self._acks[rid] = loop.create_future()
        self._results[rid] = loop.create_future()
        self._unacked[rid] = (header, payload)
        try:
            await self._send_data(MsgType.SUBMIT, header, payload)
            await self._acks[rid]
        except BaseException:
            self._results.pop(rid, None)
            self._unacked.pop(rid, None)
            self._streamed.pop(rid, None)
            raise
        finally:
            self._acks.pop(rid, None)
        return rid

    async def result(self, rid: int) -> dict:
        """Await one rid's RESULT: {"tokens", "streamed", "ttft_s",
        "ttlt_s", "accepted", "rejected", "rollbacks", "evictions"}.
        ``streamed`` is the incremental TOKENS preview actually received —
        always a prefix of ``tokens`` (and a proper prefix if a burst rode
        a dying connection)."""
        fut = self._results[rid]
        try:
            return await fut
        finally:
            self._results.pop(rid, None)

    async def generate(self, prompt, *, max_new: int = 16,
                       priority: int | None = None, retries: int = 64,
                       backoff_s: float = 0.02, max_backoff_s: float = 0.5,
                       deadline_s: float | None = None) -> dict:
        """submit + result with the BUSY retry loop an edge client runs:
        exponential backoff (never below the server's retry hint) with
        deterministic per-tenant jitter, stopping with
        :class:`DeadlineExceeded` when the attempts or the wall-clock
        ``deadline_s`` budget runs out."""
        t0 = time.monotonic()
        for attempt in range(retries):
            try:
                rid = await self.submit(prompt, max_new=max_new,
                                        priority=priority)
                break
            except BusyError as e:
                delay = max(e.retry_after_ms / 1e3,
                            min(backoff_s * 2.0 ** attempt, max_backoff_s))
                delay *= 0.5 + self._rng.random()  # jitter in [0.5x, 1.5x)
                if deadline_s is not None:
                    left = deadline_s - (time.monotonic() - t0)
                    if left <= delay:
                        raise DeadlineExceeded(
                            f"server still busy after {attempt + 1} tries "
                            f"and {deadline_s}s deadline") from e
                await asyncio.sleep(delay)
        else:
            raise DeadlineExceeded(f"server still busy after {retries} tries")
        return await self.result(rid)

    async def stats(self) -> dict:
        """The server's per-tenant QoS + engine counters snapshot."""
        self._check_conn()
        fut = asyncio.get_running_loop().create_future()
        self._stats.append(fut)
        await self._send_data(MsgType.STATS, {})
        return await fut

    # ------------------------------------------------------------------
    # frame dispatch
    # ------------------------------------------------------------------

    def _check_conn(self):
        if self._conn_error is not None:
            raise FrontDoorError(f"connection dead: {self._conn_error}")

    async def _read_loop(self, stream: FrameStream):
        try:
            while True:
                got = await stream.recv()
                if got is None:
                    raise ConnectionError("server closed the connection")
                mtype, header, payload, _nbytes, _seq = got
                self._dispatch(mtype, header, payload)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if self._closed or not self.reconnect:
                self._fail_all(e)
                return
            # pending STATS are FIFO-matched to THIS connection's replies;
            # they cannot survive a reconnect (results/acks can — resume
            # restores them)
            for fut in self._stats:
                if not fut.done():
                    fut.set_exception(FrontDoorError(str(e)))
            self._stats.clear()
            try:
                await self._ensure_conn(stream, e)
            except FrontDoorError:
                pass                          # futures already failed

    def _dispatch(self, mtype: MsgType, header: dict, payload: bytes):
        rid = header.get("rid")
        if mtype == MsgType.ACCEPTED:
            self._unacked.pop(rid, None)
            fut = self._acks.get(rid)
            if fut and not fut.done():
                fut.set_result(rid)
        elif mtype == MsgType.BUSY:
            self._unacked.pop(rid, None)
            fut = self._acks.get(rid)
            self._results.pop(rid, None)
            self._streamed.pop(rid, None)
            if fut and not fut.done():
                fut.set_exception(BusyError(header.get("reason", "busy"),
                                            header.get("retry_after_ms", 50)))
        elif mtype == MsgType.TOKENS:
            burst = [int(t) for t in proto.unpack_array(header, payload)]
            have = self._streamed.setdefault(rid, [])
            off = header.get("off", len(have))
            # bursts carry their absolute offset: a burst that was lost on
            # a dying connection leaves a GAP — keep the contiguous prefix
            # instead of silently splicing tokens at the wrong positions
            if off <= len(have) and off + len(burst) > len(have):
                fresh = burst[len(have) - off:]
                have.extend(fresh)
                if self.on_tokens is not None:
                    self.on_tokens(rid, fresh)
        elif mtype == MsgType.RESULT:
            self._unacked.pop(rid, None)
            streamed = self._streamed.pop(rid, [])
            fut = self._results.get(rid)
            if fut and not fut.done():
                tokens = proto.unpack_array(header, payload)
                fut.set_result({"tokens": [int(t) for t in tokens],
                                "streamed": streamed,
                                "ttft_s": header.get("ttft_s"),
                                "ttlt_s": header.get("ttlt_s"),
                                "accepted": header.get("accepted", 0),
                                "rejected": header.get("rejected", 0),
                                "rollbacks": header.get("rollbacks", 0),
                                "evictions": header.get("evictions", 0)})
        elif mtype == MsgType.ERROR:
            err = FrontDoorError(header.get("reason", "server error"))
            if rid is not None:
                self._unacked.pop(rid, None)
                self._streamed.pop(rid, None)
                for book in (self._acks, self._results):
                    fut = book.get(rid)
                    if fut and not fut.done():
                        fut.set_exception(err)
                self._results.pop(rid, None)
            else:
                raise ProtocolError(str(err))   # connection-level failure
        elif mtype == MsgType.STATS_OK:
            if self._stats:
                fut = self._stats.pop(0)
                if not fut.done():
                    fut.set_result(header.get("stats", {}))
        elif mtype == MsgType.BYE_OK:
            if self._bye and not self._bye.done():
                self._bye.set_result(True)
        else:
            raise ProtocolError(f"unexpected {mtype.name} frame from server")
