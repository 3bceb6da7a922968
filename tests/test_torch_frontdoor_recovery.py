"""The port's front door under failure, as ``tests/test_frontdoor_recovery.py``
holds the reference's: every way a connection can die leaves the books
correct (the admission counter drops back the moment a connection ends:
abrupt close, silent peer, handshake stall, shutdown), detach-with-resume
replays withdrawn work bit-identically to the reference engine's direct
run on the same weights, repeated SUBMITs after a reconnect are
idempotent, ``generate`` honors its wall-clock deadline with a typed
error, and ``stop()`` leaves no orphaned asyncio task.  The silent-peer,
resume and auto-reconnect scenarios run within the port and across
packages (a reference client or frame stream against the port's server,
the port's against the reference's), and an idle live client is detached
and resumed alike by both servers (ROADMAP C11).  Then the port's
selfcheck, in process on the CPU: its chaos run (seeded drops,
corruption and one forced disconnect per direction) bit-identical to its
fault-free twin and, on the reference's weights and codec keys, to the
reference selfcheck's fault-free run; its speculative run at k 2 and 4
bit-identical to vanilla decode.

Weights and codec keys are the reference's, drawn with ``jax.random``
and converted.  No pytest-asyncio here: every scenario runs under a plain
``asyncio.run``."""
import asyncio
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import frontdoor as jfd  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.frontdoor import selfcheck as jselfcheck  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import frontdoor as tfd  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.frontdoor import (AdmissionController,  # noqa: E402
                                   DeadlineExceeded, FrontDoorClient,
                                   FrontDoorServer, MsgType, TenantPolicy,
                                   pack_array, selfcheck)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)
PACKAGES = {"port": (tfd, tengine), "reference": (jfd, jengine)}
# (client package, server package): within the port, then across packages
PAIRS = [("port", "port"), ("reference", "port"), ("port", "reference")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Serving through the door is many small ops; under the suite's
    parallel workers torch's intra-op threads oversubscribe the cores (a
    run of a second alone took fifty), so this module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _convert(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **OVERRIDES)
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **OVERRIDES)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, _convert(pj)


def _engine(package="port", **kw):
    """An engine of ``package`` on the reference's weights, no codec."""
    jcfg, tcfg, pj, pt = _weights()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("chunk_size", 8)
    kw.setdefault("sync_every", 4)
    if package == "port":
        return tengine.BatchedEngine(pt, tcfg, codec=None, greedy=True,
                                     seed=0, **kw)
    return jengine.BatchedEngine(pj, jcfg, codec=None, greedy=True, seed=0,
                                 **kw)


def _prompts(n, rng):
    return [[int(t) for t in rng.randint(1, 128, 5 + i)] for i in range(n)]


@functools.lru_cache(maxsize=None)
def _direct(seed, max_new):
    """The reference engine's direct run of ``_prompts(2, seed)``."""
    eng = _engine("reference")
    for u, p in enumerate(_prompts(2, np.random.RandomState(seed))):
        eng.submit(jengine.Request(uid=u, prompt=list(p),
                                   max_new_tokens=max_new))
    return {r.uid: list(r.out) for r in eng.run()}


async def _until(cond, timeout=5.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# the admission counter-invariant, failure path by failure path
# ---------------------------------------------------------------------------

def test_abrupt_disconnect_releases_admission_and_withdraws():

    async def go():
        eng = _engine()
        server = FrontDoorServer(eng, auto_tick=False, heartbeat_s=0.2)
        host, port = await server.start()
        client = await FrontDoorClient.open(host, port, tenant="drop",
                                            reconnect=False)
        rids = [await client.submit(p, max_new=4)
                for p in _prompts(2, np.random.RandomState(0))]
        assert server.stats()["admission"]["inflight_total"] == 2
        assert len(eng.queue) == 2           # staged, auto_tick off
        client._stream.close()               # die without BYE
        await _until(
            lambda: server.stats()["admission"]["inflight_total"] == 0,
            what="admission release on disconnect")
        s = server.stats()
        assert s["sessions"] == {"open": 0, "detached": 1}
        assert s["tenants"]["drop"]["disconnects"] == 1
        # the work left the engine with the connection...
        assert not eng.queue and eng.active == 0
        # ...and is parked on the session, keyed by the original rids
        sess = next(iter(server._sessions.values()))
        assert sorted(rid for rid, _ in sess.withdrawn) == sorted(rids)
        await client.close()
        await server.stop(drain=False)

    asyncio.run(go())


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_silent_peer_is_detached_by_heartbeats(client_pkg, server_pkg):
    cfd, sfd = PACKAGES[client_pkg][0], PACKAGES[server_pkg][0]

    async def go():
        eng = _engine(server_pkg)
        server = sfd.FrontDoorServer(eng, auto_tick=False, heartbeat_s=0.05,
                                     max_misses=2)
        host, port = await server.start()
        reader, writer = await asyncio.open_connection(host, port)
        stream = cfd.FrameStream(reader, writer, direction="c2s")
        await stream.send(MsgType.HELLO, {"tenant": "mute", "codec": "none"})
        got = await stream.recv(timeout=2.0)
        assert got is not None and got[0] == MsgType.HELLO_OK
        hdr, payload = cfd.pack_array(np.asarray([1, 2, 3], dtype=np.int32))
        await stream.send(MsgType.SUBMIT, {"rid": 0, "max_new": 2, **hdr},
                          payload)
        await _until(
            lambda: server.stats()["admission"]["inflight_total"] == 1,
            what="the SUBMIT to be admitted")
        # now go silent: recv() is never called again, so the server's
        # PINGs are never answered — max_misses intervals later the peer
        # is declared dead and its admission unit comes back
        await _until(
            lambda: server.stats()["admission"]["inflight_total"] == 0,
            what="heartbeat death detection")
        assert server.stats()["sessions"]["detached"] == 1
        assert not eng.queue and eng.active == 0
        stream.close()
        await stream.wait_closed()
        await server.stop(drain=False)

    asyncio.run(go())


def test_idle_live_client_is_detached_and_resumed_alike():
    """ROADMAP C11's smallest input: heartbeat_s 0.05, max_misses 2, one
    idle client for 1 s, on each package's server with its own client,
    both on one loop.  A PONG does not reset the server's miss count, so
    both detach the live client every (max_misses + 1) heartbeats and
    resume it when it reconnects on its own.  The counts are read half a
    cycle after a detach, so that neither run is mid-reconnect."""
    period = 3 * 0.05

    async def go():
        servers = {}
        for pkg in PACKAGES:
            fd = PACKAGES[pkg][0]
            servers[pkg] = fd.FrontDoorServer(
                _engine(pkg), auto_tick=False, heartbeat_s=0.05,
                max_misses=2, resume_ttl_s=10.0)
        addrs = {pkg: await s.start() for pkg, s in servers.items()}
        clients = dict(zip(PACKAGES, await asyncio.gather(*(
            PACKAGES[pkg][0].FrontDoorClient.open(*addrs[pkg], tenant="idle")
            for pkg in PACKAGES))))
        tokens = {pkg: c.session for pkg, c in clients.items()}

        def count(pkg, key):
            return servers[pkg].stats()["tenants"]["idle"][key]

        await asyncio.sleep(1.0)
        seen = count("port", "disconnects")
        await _until(lambda: count("port", "disconnects") > seen,
                     what="the next detach")
        await asyncio.sleep(period / 2)
        books = {pkg: (count(pkg, "disconnects"), count(pkg, "resumes"),
                       servers[pkg].stats()["sessions"])
                 for pkg in PACKAGES}
        for pkg, c in clients.items():
            assert c.session == tokens[pkg]   # the same session, resumed
            await c.close()
            await servers[pkg].stop(drain=False)
        return books

    books = asyncio.run(go())
    assert books["port"] == books["reference"], books
    disconnects, resumes, sessions = books["port"]
    assert 6 <= disconnects <= 1.5 / period and resumes == disconnects
    assert sessions == {"open": 1, "detached": 0}


def test_handshake_stall_frees_the_connection_slot():

    async def go():
        eng = _engine()
        server = FrontDoorServer(eng, auto_tick=False,
                                 handshake_timeout_s=0.15, heartbeat_s=0.05)
        host, port = await server.start()
        reader, writer = await asyncio.open_connection(host, port)
        await _until(lambda: len(server._conn_tasks) == 1,
                     what="the handler to pick the connection up")
        # say nothing: the server must hang up on its own (the bytes we
        # do receive are its handshake PINGs probing for a lost HELLO)
        await asyncio.wait_for(reader.read(-1), timeout=5.0)
        assert reader.at_eof()
        await _until(lambda: not server._conn_tasks,
                     what="the handler to finish")
        s = server.stats()
        assert s["sessions"] == {"open": 0, "detached": 0}
        assert s["admission"]["inflight_total"] == 0
        writer.close()
        await server.stop(drain=False)

    asyncio.run(go())


def test_stop_cancels_inflight_and_leaves_no_orphan_tasks():

    async def go():
        eng = _engine()
        server = FrontDoorServer(eng, auto_tick=True)
        host, port = await server.start()
        rng = np.random.RandomState(1)
        clients = [await FrontDoorClient.open(host, port, tenant=f"t{i}",
                                              reconnect=False)
                   for i in range(2)]
        rids = [await c.submit(p, max_new=3)
                for c, p in zip(clients, _prompts(2, rng))]
        # stop() drains first: the admitted work completes and is
        # delivered before the connections are torn down
        await server.stop()
        outs = [await c.result(r) for c, r in zip(clients, rids)]
        assert all(len(o["tokens"]) == 3 for o in outs)
        assert server._conn_tasks == set() and server._tick_task is None
        assert server._routes == {} and server._sessions == {}
        assert server.admission.inflight_total == 0
        for c in clients:
            await c.close()
        # nothing survives on the loop but this coroutine itself
        leftover = [t for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()]
        assert not leftover, leftover

    asyncio.run(go())


# ---------------------------------------------------------------------------
# detach -> resume: bit-identical continuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_resume_after_disconnect_is_bit_identical(client_pkg, server_pkg):
    cfd, sfd = PACKAGES[client_pkg][0], PACKAGES[server_pkg][0]
    prompts = _prompts(2, np.random.RandomState(2))
    ref = _direct(2, 12)

    async def go():
        eng = _engine(server_pkg)
        server = sfd.FrontDoorServer(eng, auto_tick=False, resume_ttl_s=10.0)
        host, port = await server.start()
        a = await cfd.FrontDoorClient.open(host, port, tenant="ph",
                                           reconnect=False)
        rids = [await a.submit(p, max_new=12) for p in prompts]
        eng.tick()                           # decode PART of the answer...
        assert eng.active == 2               # ...both genuinely mid-flight
        a._stream.close()                    # ...then die mid-decode
        await _until(
            lambda: server.stats()["admission"]["inflight_total"] == 0,
            what="detach after the mid-decode disconnect")
        token = a.session
        await a.close()

        # a new connection presenting the session token gets the
        # withdrawn work re-admitted; the engine re-prefills prompt +
        # emitted tokens, so the continuation is bit-identical
        b = cfd.FrontDoorClient(host, port, tenant="ph", reconnect=False)
        b.session = token
        await b._connect()
        assert b.server_info["resumed"] is True
        loop = asyncio.get_running_loop()
        for rid in rids:                     # adopt the orphaned rids
            b._results[rid] = loop.create_future()
        await _until(lambda: len(server._routes) == 2,
                     what="resume re-submission")
        await server.drain()
        outs = [await b.result(rid) for rid in rids]
        s = server.stats()
        assert s["tenants"]["ph"]["resumes"] == 1
        assert s["admission"]["inflight_total"] == 0
        await b.close()
        await server.stop(drain=False)
        return outs

    outs = asyncio.run(go())
    for uid, out in enumerate(outs):
        assert out["tokens"] == ref[uid], uid


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_client_auto_reconnect_resumes_transparently(client_pkg, server_pkg):
    cfd, sfd = PACKAGES[client_pkg][0], PACKAGES[server_pkg][0]
    prompts = _prompts(2, np.random.RandomState(7))
    ref = _direct(7, 12)

    async def go():
        eng = _engine(server_pkg)
        server = sfd.FrontDoorServer(eng, auto_tick=False, resume_ttl_s=10.0)
        host, port = await server.start()
        client = await cfd.FrontDoorClient.open(host, port, tenant="auto")
        rids = [await client.submit(p, max_new=12) for p in prompts]
        eng.tick()
        assert eng.active == 2               # disconnect lands mid-decode
        # the network dies under the client (RST, not a clean FIN); its
        # read loop reconnects with the session token on its own
        sess = next(iter(server._sessions.values()))
        sess.conn.stream.writer.transport.abort()
        await _until(lambda: client.server_info.get("resumed") is True,
                     what="the client's automatic resume")
        await _until(lambda: len(server._routes) == 2,
                     what="the resumed work to be back in flight")
        await server.drain()
        outs = [await client.result(rid) for rid in rids]
        s = server.stats()
        assert s["tenants"]["auto"]["resumes"] == 1
        assert s["admission"]["inflight_total"] == 0
        await client.close()
        await server.stop(drain=False)
        return outs

    outs = asyncio.run(go())
    for uid, out in enumerate(outs):
        assert out["tokens"] == ref[uid], uid


# ---------------------------------------------------------------------------
# protocol-level recovery details
# ---------------------------------------------------------------------------

def test_repeated_submit_is_idempotent():

    async def go():
        eng = _engine()
        server = FrontDoorServer(eng, auto_tick=False)
        host, port = await server.start()
        client = await FrontDoorClient.open(host, port, tenant="dup")
        prompt = [1, 2, 3, 4]
        rid = await client.submit(prompt, max_new=3)
        # replay the SUBMIT verbatim — the lost-ACK half of the reconnect
        # race: the request must be re-ACKed, never doubled
        hdr, payload = pack_array(np.asarray(prompt, dtype=np.int32))
        await client._stream.send(MsgType.SUBMIT,
                                  {"rid": rid, "max_new": 3, **hdr}, payload)
        # frames are ordered: once STATS_OK returns, the dup was handled
        stats = await client.stats()
        assert stats["admission"]["inflight_total"] == 1
        assert len(eng.queue) == 1
        await server.drain()
        out = await client.result(rid)
        assert len(out["tokens"]) == 3
        await client.close()
        await server.stop(drain=False)

    asyncio.run(go())


def test_generate_deadline_raises_typed_error():

    async def go():
        eng = _engine()
        # auto_tick=False and max_inflight=1: the first submit is admitted
        # but never completes, so generate() can only ever see BUSY
        server = FrontDoorServer(
            eng, auto_tick=False,
            admission=AdmissionController(
                default_policy=TenantPolicy(max_inflight=1)))
        host, port = await server.start()
        client = await FrontDoorClient.open(host, port, tenant="late")
        await client.submit([1, 2, 3], max_new=4)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="deadline"):
            await client.generate([4, 5], max_new=4, retries=10_000,
                                  backoff_s=0.005, deadline_s=0.15)
        assert time.monotonic() - t0 < 2.0   # the deadline actually bounded it
        await server.drain()                 # let the admitted one finish
        await client.close()
        await server.stop(drain=False)

    asyncio.run(go())


# ---------------------------------------------------------------------------
# the selfcheck's chaos and speculative runs, in process on the CPU
# ---------------------------------------------------------------------------

def test_selfcheck_chaos_run_is_bit_identical_to_fault_free():
    """amain_chaos exits non-zero on any mismatch and asserts that the
    plan recovered something; here its chaos run's books are read too."""
    got = asyncio.run(selfcheck.amain_chaos(3, device="cpu"))
    tenants = got["_stats"]["tenants"]
    assert sum(t["retransmits"] + t["nacks"] + t["resumes"]
               for t in tenants.values()) > 0
    assert sum(t["resumes"] for t in tenants.values()) >= 1
    assert all(len(got[name]) == 3 for name, _ in selfcheck.CHAOS_TENANTS)


def test_selfcheck_chaos_run_equals_the_reference_fault_free_run():
    """The port's sequential run under the chaos plan, on an engine with
    the reference selfcheck's weights and codec keys, serves the tokens of
    the reference selfcheck's fault-free sequential run."""
    ref = asyncio.run(jselfcheck._sequential_run(2, faults=None))
    jeng = jselfcheck.build_engine(spec=jselfcheck.BUCKET_SPEC)
    eng = tengine.BatchedEngine(
        _convert(jeng.params),
        tconfigs.reduced(tconfigs.get_config("deepseek-7b"), num_layers=2,
                         d_model=128, d_ff=256, vocab_size=256, num_heads=4,
                         num_kv_heads=2, head_dim=32),
        num_slots=4, max_len=64, codec=selfcheck.BUCKET_SPEC,
        codec_params=_convert(jeng.codec_params),
        greedy=True, seed=0, kv_layout="paged", page_size=8, num_pages=32,
        sync_every=8, preemption=True)
    got, server = asyncio.run(selfcheck._sequential_run(
        eng, 2, selfcheck.chaos_plan()))
    assert server.admission.inflight_total == 0
    assert sum(t["resumes"] for t in got["_stats"]["tenants"].values()) >= 1
    for name, _ in selfcheck.CHAOS_TENANTS:
        assert got[name] == ref[name], name


def test_selfcheck_spec_run_is_bit_identical_to_vanilla():
    runs = asyncio.run(selfcheck.amain_spec(3, device="cpu"))
    for k, got in runs.items():
        est = got["_stats"]["engine"]
        assert est["spec_rounds"] > 0 and est["k_served"] == {
            str(k): est["spec_rounds"]}
        assert est["draft"] == "c3sl:R=2,D=128|int8"
        assert got["_streamed"] > 0
