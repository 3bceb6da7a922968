"""The port's front-door wire layer held against the reference's: frames
byte-identical for the same (type, header, payload, seq), each package
decoding the other's frames, truncation and bit flips raising the same
``FrameCorruption`` (the port's is a ``repro_torch.faults.ChannelErasure``),
the array payload guards, the stream reader's framing errors, and
``FrameStream`` recovering a faulty wire across packages.  Admission
verdicts and the QoS histograms and snapshots equal the reference's for the
same sequences.  No engine here; the server and client are in
``test_torch_frontdoor.py``."""
import asyncio
import math
import struct
import zlib

import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the optional hypothesis package")
from hypothesis import given, strategies as st  # noqa: E402

from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.frontdoor import admission as jadm  # noqa: E402
from repro.frontdoor import protocol as jproto  # noqa: E402
from repro.frontdoor import qos as jqos  # noqa: E402
from repro.frontdoor.stream import FrameStream as JFrameStream  # noqa: E402
from repro_torch.faults import ChannelErasure, FaultPlan  # noqa: E402
from repro_torch.frontdoor import admission as tadm  # noqa: E402
from repro_torch.frontdoor import protocol as tproto  # noqa: E402
from repro_torch.frontdoor import qos as tqos  # noqa: E402
from repro_torch.frontdoor.stream import FrameStream  # noqa: E402

headers = st.dictionaries(
    st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=8),
    st.one_of(st.integers(-2**31, 2**31 - 1), st.text(max_size=12),
              st.booleans(), st.none()),
    max_size=4)
mtypes = st.sampled_from([int(m) for m in jproto.MsgType])
seqs = st.one_of(st.integers(0, 2**32 - 2), st.just(jproto.CTRL_SEQ))


def _outcome(fn, *args):
    """(exception type name, message) or ("ok", value)."""
    try:
        return "ok", fn(*args)
    except jproto.ProtocolError as e:
        return type(e).__name__, str(e)
    except tproto.ProtocolError as e:
        return type(e).__name__, str(e)


def test_constants_and_message_types_equal_reference():
    assert [(m.name, int(m)) for m in tproto.MsgType] == \
        [(m.name, int(m)) for m in jproto.MsgType]
    assert {int(m) for m in tproto.CTRL_TYPES} == {int(m) for m in jproto.CTRL_TYPES}
    assert (tproto.CTRL_SEQ, tproto.MAX_FRAME_BYTES, tproto._WIRE_DTYPES) == \
        (jproto.CTRL_SEQ, jproto.MAX_FRAME_BYTES, jproto._WIRE_DTYPES)
    assert issubclass(tproto.FrameCorruption, ChannelErasure)
    assert issubclass(tproto.FrameCorruption, tproto.ProtocolError)


@pytest.mark.property
@given(mtype=mtypes, header=headers, payload=st.binary(max_size=64), seq=seqs)
def test_frames_byte_identical_to_reference(mtype, header, payload, seq):
    got = tproto.encode_frame(tproto.MsgType(mtype), header, payload, seq=seq)
    want = jproto.encode_frame(jproto.MsgType(mtype), header, payload, seq=seq)
    assert got == want


@pytest.mark.property
@given(mtype=mtypes, header=headers, payload=st.binary(max_size=64), seq=seqs)
def test_each_package_decodes_the_others_frames(mtype, header, payload, seq):
    tframe = tproto.encode_frame(tproto.MsgType(mtype), header, payload, seq=seq)
    jframe = jproto.encode_frame(jproto.MsgType(mtype), header, payload, seq=seq)
    m1, h1, p1, s1 = jproto.decode_frame(tframe[4:])
    m2, h2, p2, s2 = tproto.decode_frame(jframe[4:])
    assert (int(m1), h1, p1, s1) == (mtype, header, payload, seq)
    assert (int(m2), h2, p2, s2) == (mtype, header, payload, seq)
    assert isinstance(m2, tproto.MsgType)


@pytest.mark.property
@given(header=headers, payload=st.binary(max_size=32))
def test_truncation_at_every_boundary_is_frame_corruption(header, payload):
    body = tproto.encode_frame(tproto.MsgType.SUBMIT, header, payload, seq=3)[4:]
    for cut in range(len(body)):
        with pytest.raises(tproto.FrameCorruption) as ei:
            tproto.decode_frame(body[:cut])
        assert isinstance(ei.value, ChannelErasure)
        assert _outcome(jproto.decode_frame, body[:cut]) == \
            ("FrameCorruption", str(ei.value))


@pytest.mark.property
@given(header=headers, payload=st.binary(max_size=32), data=st.data())
def test_any_single_bitflip_is_frame_corruption(header, payload, data):
    body = bytearray(tproto.encode_frame(tproto.MsgType.RESULT, header, payload,
                                         seq=1)[4:])
    i = data.draw(st.integers(0, len(body) - 1))
    body[i] ^= 1 << data.draw(st.integers(0, 7))
    with pytest.raises(tproto.FrameCorruption) as ei:
        tproto.decode_frame(bytes(body))
    assert isinstance(ei.value, ChannelErasure)
    assert _outcome(jproto.decode_frame, bytes(body)) == \
        ("FrameCorruption", str(ei.value))


@st.composite
def wire_arrays(draw):
    dtype = np.dtype(draw(st.sampled_from(jproto._WIRE_DTYPES)))
    shape = draw(st.lists(st.integers(0, 5), min_size=1, max_size=3))
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return np.frombuffer(draw(st.binary(min_size=n, max_size=n)),
                         dtype=dtype).reshape(shape)


@pytest.mark.property
@given(arr=wire_arrays(), rid=st.integers(0, 2**31 - 1))
def test_array_payloads_cross_packages_bit_exact(arr, rid):
    thdr, tpay = tproto.pack_array(arr)
    assert (thdr, tpay) == jproto.pack_array(arr)
    frame = tproto.encode_frame(tproto.MsgType.SUBMIT, {"rid": rid, **thdr},
                                tpay, seq=0)
    _, h2, p2, _ = jproto.decode_frame(frame[4:])
    out = tproto.unpack_array(h2, p2)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert out.tobytes() == arr.tobytes()


def _crafted(t, hdr=b"{}", payload=b"", hlen=None, seq=0):
    """A CRC-valid body with arbitrary (possibly malformed) content."""
    hlen = len(hdr) if hlen is None else hlen
    zero = struct.pack("!BIII", t, seq, 0, hlen)
    crc = zlib.crc32(payload, zlib.crc32(hdr, zlib.crc32(zero))) & 0xFFFFFFFF
    return struct.pack("!BIII", t, seq, crc, hlen) + hdr + payload


@pytest.mark.parametrize("body", [
    _crafted(0x99), _crafted(1, hlen=0xFFFF), _crafted(1, hdr=b"[["),
    _crafted(1, hdr=b"[]"), _crafted(6, hdr=b'{"rid":1}', payload=b"xy", seq=9),
    b"\x01\x00"], ids=["type", "overrun", "json", "object", "valid", "short"])
def test_decode_outcomes_equal_reference(body):
    got, want = _outcome(tproto.decode_frame, body), _outcome(jproto.decode_frame, body)
    if got[0] == "ok":
        got = ("ok", (int(got[1][0]), *got[1][1:]))
        want = ("ok", (int(want[1][0]), *want[1][1:]))
    assert got == want


_ARR = np.zeros(4, dtype=np.int32)
_HDR, _PAY = jproto.pack_array(_ARR)


@pytest.mark.parametrize("case", [
    ("pack", np.zeros(3, dtype=np.float64)),
    ("unpack", _HDR, _PAY[:-4]),
    ("unpack", {**_HDR, "dtype": "int8"}, _PAY),
    ("unpack", {**_HDR, "dtype": "float64"}, _PAY),
    ("unpack", {**_HDR, "shape": [4, -1]}, _PAY),
    ("unpack", {**_HDR, "shape": "4"}, _PAY),
    ("unpack", {"shape": [4]}, _PAY)],
    ids=["pack-float64", "short", "drift", "dtype", "negative", "shape-str",
         "no-dtype"])
def test_array_guards_raise_like_the_reference(case):
    kind, *args = case
    got = _outcome(getattr(tproto, f"{kind}_array"), *args)
    want = _outcome(getattr(jproto, f"{kind}_array"), *args)
    assert got[0] == want[0] == "ProtocolError"
    assert got == want


def test_stream_reader_framing_errors_equal_reference():
    frame = tproto.encode_frame(tproto.MsgType.STATS, {"x": 1})

    async def read_all(mod, data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        while True:
            try:
                got = await mod.read_frame(reader)
            except mod.ProtocolError as e:
                out.append((type(e).__name__, str(e)))
                return out
            if got is None:
                return out
            out.append((int(got[0]), got[1], got[2], got[3], got[4]))

    for data in (frame + frame, frame[:-2], b"\xff\xff\xff\xff", b"\x00\x00"):
        got = asyncio.run(read_all(tproto, data))
        assert got == asyncio.run(read_all(jproto, data)), data


_CHAOS = dict(seed=3, rates={"drop": 0.15, "corrupt": 0.1, "duplicate": 0.1,
                             "truncate": 0.05, "delay": 0.1})


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_frame_stream_recovers_a_faulty_wire_across_packages(sender):
    """One package's FrameStream sends 40 data frames, in bursts of 4,
    through drops, corruption, truncation, duplicates and delays (its own
    FaultPlan: the same draws in both packages); the other package's
    stream delivers all of them in order, by NACK/retransmit and the PING
    watermark (which is how a dropped last frame of a burst is found)."""
    n, burst = 40, 4
    streams = {"port": (FrameStream, tproto, FaultPlan),
               "reference": (JFrameStream, jproto, JFaultPlan)}
    tx_cls, tx_proto, plan_cls = streams[sender]
    rx_cls = streams["reference" if sender == "port" else "port"][0]

    async def go():
        got = []

        async def handle(reader, writer):
            rx = rx_cls(reader, writer, direction="s2c")
            try:
                while (item := await rx.recv()) is not None:
                    got.append((int(item[0]), item[1], item[2], item[4]))
            finally:
                rx.close()

        async def serve_nacks(tx):
            while await tx.recv() is not None:
                pass

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        host, port = server.sockets[0].getsockname()[:2]
        reader, writer = await asyncio.open_connection(host, port)
        tx = tx_cls(reader, writer, direction="c2s", faults=plan_cls(**_CHAOS))
        nacks = asyncio.create_task(serve_nacks(tx))
        for lo in range(0, n, burst):
            for i in range(lo, lo + burst):
                await tx.send(tx_proto.MsgType.SUBMIT, {"rid": i}, bytes([i]) * i)
            while len(got) < lo + burst:
                await tx.ping()
                await asyncio.sleep(0.01)
        nacks.cancel()
        await asyncio.gather(nacks, return_exceptions=True)
        tx.close()
        await tx.wait_closed()
        server.close()
        await server.wait_closed()
        return got, dict(tx.counters)

    got, counters = asyncio.run(asyncio.wait_for(go(), 60))
    assert got == [(int(tproto.MsgType.SUBMIT), {"rid": i}, bytes([i]) * i, i)
                   for i in range(n)]
    assert counters["retransmits"] > 0 and sum(counters["injected"].values()) > 0


ops = st.lists(st.tuples(st.sampled_from(["admit", "release"]),
                         st.sampled_from(["a", "b", "c"])), max_size=40)


@pytest.mark.property
@given(ops=ops, depth=st.integers(0, 6), cap=st.integers(0, 3))
def test_admission_verdicts_equal_reference(ops, depth, cap):
    pols = {"c": (tadm.TenantPolicy(max_inflight=cap + 1, priority=2),
                  jadm.TenantPolicy(max_inflight=cap + 1, priority=2))}
    t = tadm.AdmissionController(max_queue_depth=depth,
                                 default_policy=tadm.TenantPolicy(max_inflight=cap),
                                 policies={k: v[0] for k, v in pols.items()})
    j = jadm.AdmissionController(max_queue_depth=depth,
                                 default_policy=jadm.TenantPolicy(max_inflight=cap),
                                 policies={k: v[1] for k, v in pols.items()})
    assert (tadm.ADMIT, tadm.BUSY_TENANT, tadm.BUSY_QUEUE) == \
        (jadm.ADMIT, jadm.BUSY_TENANT, jadm.BUSY_QUEUE)
    for op, tenant in ops:
        if op == "admit":
            assert t.try_admit(tenant) == j.try_admit(tenant)
        else:
            outcomes = []
            for ctl in (t, j):
                try:
                    ctl.release(tenant)
                    outcomes.append("ok")
                except RuntimeError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]
        assert (t.inflight_total, t.inflight) == (j.inflight_total, j.inflight)
        assert t.policy(tenant).priority == j.policy(tenant).priority


values = st.lists(st.one_of(
    st.floats(1e-7, 1e9, allow_nan=False), st.sampled_from([0.0, 1e-4, 1.0, 1e5])),
    max_size=30)


@pytest.mark.property
@given(vals=values, p=st.floats(0, 100))
def test_log_histogram_equals_reference(vals, p):
    for kw in ({}, {"lo": 1e-2, "hi": 1e7}, {"lo": 1.0, "hi": 1e10}):
        t, j = tqos.LogHistogram(**kw), jqos.LogHistogram(**kw)
        for v in vals:
            t.record(v)
            j.record(v)
        assert t.counts == j.counts and t.n == j.n
        assert t.snapshot() == j.snapshot()
        got, want = t.percentile(p), j.percentile(p)
        assert got == want or (math.isnan(got) and math.isnan(want))


@pytest.mark.property
@given(results=st.lists(st.tuples(
    st.one_of(st.none(), st.floats(0, 10)), st.integers(0, 64),
    st.floats(0, 10), st.integers(0, 10**6), st.integers(0, 3),
    st.one_of(st.none(), st.floats(0, 20))), max_size=12),
    tenants=st.lists(st.sampled_from(["edge-b", "edge-a", "t"]), min_size=1,
                     max_size=12))
def test_qos_snapshots_equal_reference(results, tenants):
    t, j = tqos.QoSRegistry(), jqos.QoSRegistry()
    for i, (ttft, gen, dec, wire, ev, ttlt) in enumerate(results):
        name = tenants[i % len(tenants)]
        outcomes = []
        for reg in (t, j):
            q = reg.tenant(name)
            try:
                q.record_result(ttft_s=ttft, gen_tokens=gen, decode_s=dec,
                                wire_bytes=wire, evictions=ev, ttlt_s=ttlt)
                outcomes.append("ok")
            except OverflowError as e:     # a rate of inf (a subnormal decode_s)
                outcomes.append(str(e))
            q.bytes_in += wire
            q.busy_rejections += ev
        assert outcomes[0] == outcomes[1]
    for name in tenants:
        t.tenant(name)
        j.tenant(name)
    assert t.snapshot() == j.snapshot()
    assert list(t.snapshot()) == sorted(set(tenants))
