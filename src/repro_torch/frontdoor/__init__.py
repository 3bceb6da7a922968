"""repro_torch.frontdoor — the multi-tenant split-serving front door.

Port of ``repro.frontdoor`` (pure Python over asyncio and numpy, kept as its
own copy: importing the reference's package pulls in JAX through its
``faults`` and ``serving`` imports).  Frames are byte-identical to the
reference's, so a client of either package talks to a server of the other;
:class:`ChannelErasure` and :class:`FaultPlan` come from
``repro_torch.faults``, and the server drives the port's engine, on the card
or the CPU, wherever its params are.

The networked tier over :class:`repro_torch.serving.engine.BatchedEngine`: many
edge clients stream cut-layer payloads (token prompts today; the frame
format carries dtype+shape so activation payloads ride the same frames)
over length-prefixed asyncio TCP frames to one server, which continuously
batches them into engine slots with admission control (per-tenant
concurrency caps, queue-depth shedding with retriable ``BUSY``),
per-tenant QoS accounting (TTFT / tokens-per-second / wire-byte
histograms via the ``STATS`` RPC), and — with engine ``preemption=True``
— priority eviction of low-priority slots under pool oversubscription.

The wire is fault-tolerant: every frame carries a CRC32 and a sequence
number, :class:`FrameStream` recovers damaged/dropped frames by
NACK/retransmit, connections have handshake and heartbeat deadlines, and
a dead connection detaches its session for ``resume_ttl_s`` — the client
reconnects with its session token and the server re-admits the withdrawn
work with greedy output bit-identical to an uninterrupted run.

The reference's ``src/repro/frontdoor/README.md`` sketches the
architecture (frame format, admission states, preemption policy, failure
handling); it holds for the port unchanged.
"""
from repro_torch.faults import ChannelErasure, FaultPlan
from repro_torch.frontdoor.admission import (ADMIT, BUSY_QUEUE, BUSY_TENANT,
                                       AdmissionController, TenantPolicy)
from repro_torch.frontdoor.client import (BusyError, DeadlineExceeded,
                                    FrontDoorClient, FrontDoorError)
from repro_torch.frontdoor.protocol import (CTRL_SEQ, FrameCorruption, MsgType,
                                      ProtocolError, decode_frame,
                                      encode_frame, pack_array, read_frame,
                                      send_frame, unpack_array)
from repro_torch.frontdoor.qos import LogHistogram, QoSRegistry, TenantQoS
from repro_torch.frontdoor.server import (FrontDoorServer, canonical_codec_spec,
                                    engine_codec_specs)
from repro_torch.frontdoor.stream import FrameStream

__all__ = [
    "MsgType", "ProtocolError", "FrameCorruption", "CTRL_SEQ",
    "encode_frame", "decode_frame",
    "read_frame", "send_frame", "pack_array", "unpack_array",
    "FrameStream",
    "TenantPolicy", "AdmissionController", "ADMIT", "BUSY_TENANT",
    "BUSY_QUEUE",
    "LogHistogram", "TenantQoS", "QoSRegistry",
    "FrontDoorServer", "canonical_codec_spec", "engine_codec_specs",
    "FrontDoorClient", "FrontDoorError", "BusyError", "DeadlineExceeded",
    "FaultPlan", "ChannelErasure",
]
