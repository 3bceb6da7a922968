"""Wire protocol for the split-serving front door.

Port of ``repro/frontdoor/protocol.py``: every frame is byte-identical to
the reference's, and :class:`FrameCorruption` is the port's
:class:`~repro_torch.faults.ChannelErasure`.

Length-prefixed frames over a byte stream (asyncio TCP / loopback):

    +---------+------+--------+--------+------+----------------+---------+
    | !I len  | !B t | !I seq | !I crc | !I h | header (JSON)  | payload |
    +---------+------+--------+--------+------+----------------+---------+

``len`` counts every byte after the length field itself; ``t`` is the
:class:`MsgType`; ``seq`` is the sender's per-connection data-frame
sequence number (control frames — NACK/PING/PONG — carry the sentinel
:data:`CTRL_SEQ` and bypass sequencing); ``crc`` is the CRC32 of the
frame body computed with the crc field zeroed; ``h`` is the JSON
header's byte length.  The header is a flat JSON object (tenant id,
codec spec string, request id, dtype, shape, ...); the payload is raw
little-endian array bytes described by the header's ``dtype``/``shape``
fields.

Integrity model (two failure classes, two behaviors):

* **wire damage** — a CRC mismatch, or a body shorter than the fixed
  header (a truncated-but-length-consistent frame).  The full body was
  consumed, so the stream is still in sync: these raise
  :class:`FrameCorruption` (a :class:`ChannelErasure`), and the
  reliability layer (``repro_torch.frontdoor.stream.FrameStream``) NACKs the
  expected sequence number and the sender retransmits from its replay
  ring.  A corrupted LENGTH prefix is indistinguishable from stream
  desync and is out of scope — that kills the connection and the
  reconnect-with-resume path takes over.

* **peer bugs** — a frame whose CRC is VALID but whose content is
  malformed (unknown type, header overrun, non-JSON header, dtype/shape
  vs payload-size mismatches).  The peer really sent that; these raise
  plain :class:`ProtocolError` and the connection dies LOUDLY instead of
  decoding garbage.

The handshake (``HELLO``) carries the client's cut-layer codec spec; the
server refuses (``ERROR`` + close) any client whose canonical spec does
not match the engine's, so a client/server codec mismatch is a connect
error, not silently mis-decoded activations.  A HELLO may also carry a
``resume`` session token (see ``repro_torch.frontdoor.server``) to reattach a
disconnected session.

Message flow::

    client                             server
      HELLO {tenant, codec[, resume]} ->
                                  <-   HELLO_OK {codec, session, ...}
                                       (or ERROR {reason} + close)
      SUBMIT {rid, max_new, ...}
             + int32 token payload ->
                                  <-   ACCEPTED {rid}
                                       | BUSY {rid, retry_after_ms}
                                       | ERROR {rid, reason}
                                  <-   TOKENS {rid, off, n}
                                       + int32 token payload  (0 or more:
                                       incremental bursts as the engine
                                       emits them — one per verify round
                                       under speculative decoding; ``off``
                                       is the burst's absolute offset in
                                       the output, so a receiver detects
                                       a lost burst as a gap)
                                  <-   RESULT {rid, ttft_s, ...}
                                       + int32 token payload  (the FULL
                                       output; TOKENS frames are a
                                       prefix of it, so a client may
                                       ignore either)
      STATS {}                    ->
                                  <-   STATS_OK {stats}
      BYE {}                      ->
                                  <-   BYE_OK {} + close

    control (either direction, CTRL_SEQ, handled inside FrameStream):
      NACK {seq, upto}   — retransmit data frames [seq, upto)
      PING {sent}        — liveness probe + sender's send-seq watermark
      PONG {sent}        — reply, same watermark semantics
"""
from __future__ import annotations

import asyncio
import enum
import json
import struct
import zlib

import numpy as np

from repro_torch.faults import ChannelErasure

# 64 MiB: far above any cut-layer payload this repo ships, small enough
# that a corrupted length prefix cannot make the reader buffer gigabytes.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_LEN = struct.Struct("!I")
_HDR = struct.Struct("!BIII")    # msg type, seq, crc32, header length

#: sequence sentinel for control frames (NACK/PING/PONG) — they bypass
#: sequencing, replay, and fault injection (an out-of-band signaling path)
CTRL_SEQ = 0xFFFFFFFF


class ProtocolError(Exception):
    """Malformed frame / header / payload — the connection must die."""


class FrameCorruption(ChannelErasure, ProtocolError):
    """A frame arrived damaged (CRC mismatch / truncated body) but the
    stream is still in sync — recoverable by NACK/retransmit."""

    def __init__(self, msg: str, seq: int | None = None):
        super().__init__(msg)
        self.seq = seq


class MsgType(enum.IntEnum):
    HELLO = 1
    HELLO_OK = 2
    SUBMIT = 3
    ACCEPTED = 4
    BUSY = 5
    RESULT = 6
    ERROR = 7
    STATS = 8
    STATS_OK = 9
    BYE = 10
    BYE_OK = 11
    NACK = 12
    PING = 13
    PONG = 14
    TOKENS = 15

#: message types that ride outside the data sequence space
CTRL_TYPES = frozenset({MsgType.NACK, MsgType.PING, MsgType.PONG})


def _body_crc(mtype: int, seq: int, hdr: bytes, payload: bytes) -> int:
    """CRC32 over the body with the crc field zeroed."""
    head = _HDR.pack(mtype, seq, 0, len(hdr))
    return zlib.crc32(payload, zlib.crc32(hdr, zlib.crc32(head))) & 0xFFFFFFFF


def encode_frame(mtype: MsgType, header: dict, payload: bytes = b"",
                 seq: int = CTRL_SEQ) -> bytes:
    """One wire frame: length prefix, type, seq, crc, JSON header, raw
    payload.  ``seq`` defaults to the control sentinel; the reliability
    layer stamps real sequence numbers on data frames."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body_len = _HDR.size + len(hdr) + len(payload)
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {body_len} bytes exceeds the "
                            f"{MAX_FRAME_BYTES}-byte frame limit")
    crc = _body_crc(int(mtype), seq, hdr, payload)
    return b"".join((_LEN.pack(body_len),
                     _HDR.pack(int(mtype), seq, crc, len(hdr)),
                     hdr, payload))


def decode_frame(body: bytes) -> tuple[MsgType, dict, bytes, int]:
    """Decode one frame body (everything after the length prefix) into
    ``(mtype, header, payload, seq)``.

    Wire damage (short body, CRC mismatch) raises
    :class:`FrameCorruption`; content the peer verifiably sent but that
    is malformed raises plain :class:`ProtocolError`.
    """
    if len(body) < _HDR.size:
        raise FrameCorruption(
            f"frame body of {len(body)} bytes is shorter than the "
            f"{_HDR.size}-byte fixed header — truncated on the wire")
    t, seq, crc, hlen = _HDR.unpack_from(body)
    hdr_payload = body[_HDR.size:]
    # crc covers the whole body with the crc field zeroed; verify before
    # trusting ANY field (type/seq/hlen are themselves covered)
    want = zlib.crc32(hdr_payload,
                      zlib.crc32(_HDR.pack(t, seq, 0, hlen))) & 0xFFFFFFFF
    if crc != want:
        raise FrameCorruption(
            f"frame crc mismatch (claimed {crc:#010x}, computed "
            f"{want:#010x}) — damaged on the wire", seq=seq)
    try:
        mtype = MsgType(t)
    except ValueError as e:
        raise ProtocolError(f"unknown message type {t}") from e
    if hlen > len(hdr_payload):
        raise ProtocolError(f"header length {hlen} overruns the "
                            f"{len(body)}-byte frame body")
    try:
        header = json.loads(hdr_payload[:hlen])
    except ValueError as e:
        raise ProtocolError(f"non-JSON header in {mtype.name} frame") from e
    if not isinstance(header, dict):
        raise ProtocolError(f"{mtype.name} header must be a JSON object, "
                            f"got {type(header).__name__}")
    return mtype, header, hdr_payload[hlen:], seq


async def read_frame(reader: asyncio.StreamReader, timeout: float | None = None):
    """Read one frame; returns (mtype, header, payload, wire_bytes, seq)
    or None on a clean EOF at a frame boundary.  ``timeout`` bounds the
    WHOLE read (deadline against half-open peers); expiry raises
    ``asyncio.TimeoutError`` with the stream still at a frame boundary
    only if no bytes were consumed — callers treat expiry mid-frame as a
    dead connection."""
    if timeout is not None:
        return await asyncio.wait_for(_read_frame(reader), timeout)
    return await _read_frame(reader)


async def _read_frame(reader: asyncio.StreamReader):
    try:
        raw_len = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None                          # peer closed between frames
    (body_len,) = _LEN.unpack(raw_len)
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(f"declared frame length {body_len} exceeds the "
                            f"{MAX_FRAME_BYTES}-byte frame limit")
    try:
        body = await reader.readexactly(body_len)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(f"connection died {len(e.partial)} bytes into a "
                            f"{body_len}-byte frame body") from e
    mtype, header, payload, seq = decode_frame(body)
    return mtype, header, payload, _LEN.size + body_len, seq


async def send_frame(writer: asyncio.StreamWriter, mtype: MsgType,
                     header: dict, payload: bytes = b"",
                     seq: int = CTRL_SEQ) -> int:
    """Write one frame and drain; returns the bytes put on the wire."""
    frame = encode_frame(mtype, header, payload, seq=seq)
    writer.write(frame)
    await writer.drain()
    return len(frame)


# ---------------------------------------------------------------------------
# array payloads: dtype + shape ride in the header, bytes in the payload
# ---------------------------------------------------------------------------

_WIRE_DTYPES = ("int32", "int8", "uint8", "float32", "float16")


def pack_array(arr) -> tuple[dict, bytes]:
    """Header fields + payload bytes for an ndarray (C-order, little-end)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _WIRE_DTYPES:
        raise ProtocolError(f"dtype {arr.dtype.name!r} is not a wire dtype "
                            f"(expected one of {_WIRE_DTYPES})")
    return ({"dtype": arr.dtype.name, "shape": list(arr.shape)},
            arr.tobytes())


def unpack_array(header: dict, payload: bytes) -> np.ndarray:
    """Rebuild the array a frame carries, failing LOUDLY on any mismatch
    between the declared dtype/shape and the actual payload size."""
    dtype, shape = header.get("dtype"), header.get("shape")
    if dtype not in _WIRE_DTYPES:
        raise ProtocolError(f"header dtype {dtype!r} is not a wire dtype "
                            f"(expected one of {_WIRE_DTYPES})")
    if (not isinstance(shape, list)
            or not all(isinstance(d, int) and d >= 0 for d in shape)):
        raise ProtocolError(f"header shape {shape!r} is not a list of "
                            "non-negative ints")
    dt = np.dtype(dtype)
    want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    if want != len(payload):
        raise ProtocolError(
            f"payload size mismatch: header {dtype}{tuple(shape)} needs "
            f"{want} bytes but the frame carries {len(payload)} — refusing "
            "to decode garbage (codec/dtype drift between client and server?)")
    return np.frombuffer(payload, dtype=dt).reshape(shape)
