"""Reliable framed stream: sequencing, replay, NACK/retransmit, liveness.

Port of ``repro/frontdoor/stream.py``, with the port's ``FaultPlan``.

``FrameStream`` wraps one asyncio reader/writer pair and gives the front
door an erasure-tolerant wire:

* **send** stamps each data frame with a per-connection sequence number
  and keeps the clean encoding in a bounded replay ring.  An installed
  :class:`~repro_torch.faults.FaultPlan` applies to the FIRST transmission
  only — drop (never written), corrupt (byte flip, caught by the frame
  CRC), truncate (length prefix fixed up so the stream stays in sync but
  the CRC fails), duplicate, delay, or a forced ``disconnect`` (transport
  abort, exercising reconnect-with-resume).  Retransmissions go out
  clean, so a NACK loop converges deterministically.

* **recv** delivers data frames strictly in sequence order.  A damaged
  frame (:class:`~repro_torch.frontdoor.protocol.FrameCorruption`) or a
  sequence gap triggers a ``NACK {seq, upto}`` asking the peer to
  retransmit the missing range from its ring; out-of-order arrivals are
  buffered.  Duplicates (from the duplicate fault or a redundant
  retransmit) are dropped silently.  Control frames (NACK / PING / PONG)
  are consumed internally and never surface to the caller.

* **liveness**: ``ping()`` sends ``PING {sent}`` carrying the sender's
  send-sequence watermark; the peer auto-replies ``PONG {sent}``.  Both
  carry the watermark so a receiver learns about frames it never saw —
  the dropped-LAST-frame case a pure gap detector cannot catch (no later
  frame ever arrives to reveal the gap).

Each missing sequence number gets a bounded NACK budget; exhausting it
raises :class:`~repro_torch.faults.ChannelErasure`, which callers treat as a
dead connection (the resume path takes over from there).
"""
from __future__ import annotations

import asyncio

from repro_torch.faults import ChannelErasure
from repro_torch.frontdoor.protocol import (CTRL_SEQ, CTRL_TYPES, FrameCorruption,
                                      MsgType, _LEN, encode_frame, read_frame)

#: upper bound on one injected ``delay`` fault (seconds) — keeps chaos
#: runs slow-ish, never hung
MAX_INJECTED_DELAY_S = 0.02


class FrameStream:
    """One direction-tagged reliable stream over (reader, writer).

    ``direction`` is the fault-plan tag (``"c2s"`` for the client's
    stream, ``"s2c"`` for the server's); ``epoch`` is the connection
    attempt (0 for the first connect), so scheduled faults fire once and
    rate-drawn faults redraw per reconnect.
    """

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, direction: str,
                 faults=None, epoch: int = 0, replay: int = 256,
                 retry_budget: int = 16):
        self.reader = reader
        self.writer = writer
        self.direction = direction
        self.faults = None if (faults is None or faults.is_zero()) else faults
        self.epoch = int(epoch)
        self.retry_budget = int(retry_budget)
        self._replay_cap = int(replay)
        self._replay: dict[int, bytes] = {}       # seq -> clean frame bytes
        self._send_seq = 0                        # next data seq to stamp
        self._recv_next = 0                       # next data seq to deliver
        self._pending: dict[int, tuple] = {}      # buffered out-of-order
        self._nacks_sent: dict[int, int] = {}     # seq -> NACK attempts
        self.peer_sent = 0                        # peer's send-seq watermark
        self._lock = asyncio.Lock()               # serializes writes
        self.counters = {"bytes_in": 0, "bytes_out": 0, "frames_in": 0,
                         "frames_out": 0, "retransmits": 0, "nacks": 0,
                         "corrupt_seen": 0, "dup_dropped": 0, "injected": {}}

    # ---- send path -------------------------------------------------------

    async def send(self, mtype: MsgType, header: dict,
                   payload: bytes = b"") -> int:
        """Send one frame.  Data frames are sequenced, replayable, and
        fault-injectable; control types bypass all three."""
        if mtype in CTRL_TYPES:
            return await self._write(encode_frame(mtype, header, payload))
        async with self._lock:
            seq = self._send_seq
            self._send_seq += 1
            frame = encode_frame(mtype, header, payload, seq=seq)
            self._replay[seq] = frame
            while len(self._replay) > self._replay_cap:
                self._replay.pop(min(self._replay))
        if self.faults is None:
            return await self._write(frame)
        return await self._send_faulty(frame, seq)

    async def _write(self, frame: bytes) -> int:
        self.writer.write(frame)
        await self.writer.drain()
        self.counters["bytes_out"] += len(frame)
        self.counters["frames_out"] += 1
        return len(frame)

    async def _send_faulty(self, frame: bytes, seq: int) -> int:
        events = self.faults.frame_events(self.direction, seq, self.epoch)
        writes, disconnect = 1, False
        for ev in events:
            self.counters["injected"][ev.kind] = \
                self.counters["injected"].get(ev.kind, 0) + 1
            if ev.kind == "drop":
                writes = 0
            elif ev.kind == "duplicate":
                writes = max(writes, 2)
            elif ev.kind == "delay":
                await asyncio.sleep(ev.arg * MAX_INJECTED_DELAY_S)
            elif ev.kind == "corrupt":
                body = bytearray(frame[_LEN.size:])
                body[int(ev.arg * len(body)) % len(body)] ^= 0xFF
                frame = frame[:_LEN.size] + bytes(body)
            elif ev.kind == "truncate":
                body = frame[_LEN.size:]
                keep = int(ev.arg * len(body))
                frame = _LEN.pack(keep) + body[:keep]
            elif ev.kind == "disconnect":
                disconnect = True
        sent = 0
        for _ in range(writes):
            sent += await self._write(frame)
        if disconnect:
            transport = self.writer.transport
            if transport is not None:
                transport.abort()
            raise ConnectionResetError(
                f"injected disconnect on {self.direction} at seq {seq}")
        return sent

    async def _retransmit(self, lo: int, hi: int) -> None:
        """Serve a peer NACK from the replay ring — always clean."""
        for seq in range(lo, hi):
            frame = self._replay.get(seq)
            if frame is not None:
                await self._write(frame)
                self.counters["retransmits"] += 1
            # evicted from the ring: nothing to serve; the peer's NACK
            # budget turns that into a ChannelErasure on its side

    # ---- liveness --------------------------------------------------------

    async def ping(self) -> None:
        await self.send(MsgType.PING, {"sent": self._send_seq})

    # ---- recv path -------------------------------------------------------

    async def _nack(self, lo: int, hi: int) -> None:
        budget_key = lo
        n = self._nacks_sent.get(budget_key, 0) + 1
        self._nacks_sent[budget_key] = n
        if n > self.retry_budget:
            raise ChannelErasure(
                f"frame seq {lo} on {self.direction!r} not recovered after "
                f"{self.retry_budget} NACKs — giving the connection up",
                direction=self.direction, step=lo, attempts=n)
        self.counters["nacks"] += 1
        await self.send(MsgType.NACK, {"seq": lo, "upto": hi})

    def _note_watermark(self) -> int | None:
        """After learning the peer's send watermark, the missing range (if
        any) is everything from our next expected seq up to it."""
        if self.peer_sent > self._recv_next:
            return self.peer_sent
        return None

    async def recv(self, timeout: float | None = None):
        """Next in-order DATA frame as (mtype, header, payload, nbytes,
        seq); None on clean EOF.  ``timeout`` bounds each socket read —
        a control frame arriving re-arms it (the peer is alive), so
        ``asyncio.TimeoutError`` here means genuine silence."""
        while True:
            if self._recv_next in self._pending:
                item = self._pending.pop(self._recv_next)
                self._nacks_sent.pop(self._recv_next, None)
                self._recv_next += 1
                return item
            try:
                got = await read_frame(self.reader, timeout=timeout)
            except FrameCorruption:
                # body fully consumed, stream still in sync: ask for the
                # next undelivered frame again (the damaged one is either
                # it or a later one the gap logic will re-request)
                self.counters["corrupt_seen"] += 1
                await self._nack(self._recv_next, self._recv_next + 1)
                continue
            if got is None:
                return None
            mtype, header, payload, nbytes, seq = got
            self.counters["bytes_in"] += nbytes
            self.counters["frames_in"] += 1
            if seq == CTRL_SEQ:
                if mtype == MsgType.NACK:
                    await self._retransmit(int(header.get("seq", 0)),
                                           int(header.get("upto", 0)))
                elif mtype == MsgType.PING:
                    self.peer_sent = max(self.peer_sent,
                                         int(header.get("sent", 0)))
                    await self.send(MsgType.PONG, {"sent": self._send_seq})
                    gap_hi = self._note_watermark()
                    if gap_hi is not None:
                        await self._nack(self._recv_next, gap_hi)
                elif mtype == MsgType.PONG:
                    self.peer_sent = max(self.peer_sent,
                                         int(header.get("sent", 0)))
                    gap_hi = self._note_watermark()
                    if gap_hi is not None:
                        await self._nack(self._recv_next, gap_hi)
                else:
                    # a data type carrying CTRL_SEQ: peer bug
                    from repro_torch.frontdoor.protocol import ProtocolError
                    raise ProtocolError(
                        f"data frame {mtype.name} carries the control "
                        "sequence sentinel")
                continue
            if seq < self._recv_next:
                self.counters["dup_dropped"] += 1
                continue
            if seq > self._recv_next:
                self._pending[seq] = (mtype, header, payload, nbytes, seq)
                await self._nack(self._recv_next, seq)
                continue
            self._nacks_sent.pop(seq, None)
            self._recv_next += 1
            return mtype, header, payload, nbytes, seq

    # ---- teardown --------------------------------------------------------

    def close(self) -> None:
        if not self.writer.is_closing():
            self.writer.close()

    async def wait_closed(self) -> None:
        try:
            await self.writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
