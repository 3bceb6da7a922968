"""The port's front door over loopback, held against the reference: the
port's server on the port's engine serves greedy tokens equal to a direct
run of the port's engine and of the reference's engine (same weights, same
codec keys), with and without ``c3sl:R=4|int8``; across packages, a
reference client against a port server and a port client against a
reference server serve the reference's tokens, and the two servers' STATS
bodies after the same script agree on every integer field.  Spec strings
canonicalize to the reference's, a codec or draft mismatch is a handshake
failure, and admission sheds with BUSY (retried), refuses with ERROR and
serves several tenants at once, as the reference's tests
(``tests/test_frontdoor.py``) hold the reference.

Under a batch-wise codec the tokens depend on slot occupancy, so the
equivalence runs stage every submission with ``auto_tick=False`` and then
``drain()``, as the reference's tests do.  No pytest-asyncio here: every
scenario runs under a plain ``asyncio.run``."""
import asyncio
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro import frontdoor as jfd  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import frontdoor as tfd  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)
ENGINE_KW = dict(num_slots=2, max_len=32, chunk_size=8, sync_every=4,
                 greedy=True, seed=0)
SPECS = ["none", "c3sl:R=4|int8"]
MAX_NEW = 6
PACKAGES = {"port": (tfd, tengine), "reference": (jfd, jengine)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Serving through the door is many small ops; under the suite's
    parallel workers torch's intra-op threads oversubscribe the cores (a
    run of a second alone took fifty), so this module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **OVERRIDES)
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **OVERRIDES)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


@functools.lru_cache(maxsize=None)
def _codec_params(spec, num_slots):
    """The reference's keys for the codec as an engine of ``num_slots``
    serves it (R clamped), for both packages' engines."""
    if spec == "none":
        return None, None
    jcfg = _weights()[0]
    codec = jcodecs.clamp_R(jcodecs.build(spec, D=jcfg.d_model), num_slots)
    pj = codec.init(jax.random.PRNGKey(3))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _engine(package, spec="none", **over):
    jcfg, tcfg, pj, pt = _weights()
    kw = dict(ENGINE_KW, **over)
    cpj, cpt = _codec_params(spec, kw["num_slots"])
    if package == "port":
        return tengine.BatchedEngine(pt, tcfg, codec=spec, codec_params=cpt, **kw)
    return jengine.BatchedEngine(pj, jcfg, codec=spec, codec_params=cpj, **kw)


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 128, 5 + i)] for i in range(n)]


PROMPTS = _prompts(3, 2)


@functools.lru_cache(maxsize=None)
def _direct(package, spec):
    """3 requests through 2 slots (recycling changes occupancy, which
    changes C3-SL cross-talk: exactly what must still match)."""
    eng = _engine(package, spec)
    req_cls = PACKAGES[package][1].Request
    for u, p in enumerate(PROMPTS):
        eng.submit(req_cls(uid=u, prompt=list(p), max_new_tokens=MAX_NEW))
    return {r.uid: list(r.out) for r in eng.run()}


@functools.lru_cache(maxsize=None)
def _script(client_pkg, server_pkg, spec):
    """The equivalence script: one tenant's overlong prompt is refused
    with ERROR, then it stages the three prompts (a fourth SUBMIT is shed
    with BUSY at max_inflight 3), the server drains, the client reads
    every RESULT and a STATS.  Returns (results, STATS body)."""
    cfd = PACKAGES[client_pkg][0]
    sfd = PACKAGES[server_pkg][0]

    async def go():
        eng = _engine(server_pkg, spec)
        server = sfd.FrontDoorServer(
            eng, auto_tick=False,
            admission=sfd.AdmissionController(
                max_queue_depth=8, default_policy=sfd.TenantPolicy(max_inflight=3)))
        host, port = await server.start()
        client = await cfd.FrontDoorClient.open(host, port, tenant="t0",
                                                codec=spec)
        with pytest.raises(cfd.FrontDoorError, match="prompt length"):
            await client.submit(list(range(1, 40)), max_new=4)
        rids = [await client.submit(p, max_new=MAX_NEW) for p in PROMPTS]
        with pytest.raises(cfd.BusyError):
            await client.submit(PROMPTS[0], max_new=MAX_NEW)
        await server.drain()
        outs = [await client.result(rid) for rid in rids]
        stats = await client.stats()
        await client.close()
        await server.stop(drain=False)
        assert server.tick_error is None
        return outs, stats

    return asyncio.run(go())


@pytest.mark.parametrize("spec", SPECS)
def test_port_loopback_equals_direct_runs_of_both_engines(spec):
    ref = _direct("reference", spec)
    assert _direct("port", spec) == ref
    outs, stats = _script("port", "port", spec)
    for uid, out in enumerate(outs):
        assert out["tokens"] == ref[uid], (spec, uid)
        # the TOKENS bursts, joined, are the whole output: no gap
        assert out["streamed"] == out["tokens"]
        assert out["ttft_s"] is not None and out["ttft_s"] >= 0
    assert stats["engine"]["codec"] == tfd.engine_codec_specs(
        _engine("port", spec))[0]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("client_pkg,server_pkg", [("reference", "port"),
                                                   ("port", "reference")])
def test_clients_and_servers_interoperate_across_packages(client_pkg,
                                                          server_pkg, spec):
    ref = _direct("reference", spec)
    outs, _ = _script(client_pkg, server_pkg, spec)
    for uid, out in enumerate(outs):
        assert out["tokens"] == ref[uid], (client_pkg, server_pkg, spec, uid)
        assert out["streamed"] == out["tokens"]


def _integer_fields(tree, path=()):
    """{path: value} for every int (not bool) leaf of a STATS body."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_integer_fields(v, path + (k,)))
    elif isinstance(tree, int) and not isinstance(tree, bool):
        out[path] = tree
    return out


def _keys(tree, path=()):
    if not isinstance(tree, dict):
        return {path}
    return set().union(*(_keys(v, path + (k,)) for k, v in tree.items())) or {path}


@pytest.mark.parametrize("spec", SPECS)
def test_stats_bodies_of_both_servers_agree(spec):
    """The same script against a port server and a reference server: the
    STATS bodies have the same keys and every integer field is equal, but
    ``bytes_out`` (its RESULT and STATS_OK frames carry float seconds as
    JSON text, whose length varies) and the per-request ``wire_bytes``
    histogram built from it; the execution modes name how each engine
    ran."""
    _, port = _script("reference", "port", spec)
    _, ref = _script("port", "reference", spec)
    assert _keys(port) == _keys(ref)
    got, want = _integer_fields(port), _integer_fields(ref)
    skip = {k for k in got if "bytes_out" in k or k[:3] == ("tenants", "t0",
                                                           "wire_bytes")}
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert port["tenants"]["t0"]["wire_bytes"]["count"] == 3
    t0 = port["tenants"]["t0"]
    assert (t0["requests"], t0["busy_rejections"], t0["errors"]) == (3, 1, 1)
    assert port["admission"]["inflight_total"] == 0
    eng = port["engine"]
    modes = ("codec_execution_mode", "kv_read_execution_mode")
    # the default c3sl backend is the FFT one in both packages
    assert [eng[k] for k in modes] == [ref["engine"][k] for k in modes] == \
        ["none" if spec == "none" else "fft", "gather"]
    if spec != "none":
        assert eng["wire_bytes_fwd"] > 0


@pytest.mark.parametrize("spec", [
    "none", "c3sl:R=4|int8", "c3sl:R=2|int8", "adaptive:c3sl:R=4,min_R=2|int8",
    "c3sl:R=4|int8 >> bwd:c3sl:R=2",
    "c3sl:R=4,backend=pallas >> draft:c3sl:R=8,backend=pallas",
    "c3sl:R=8,backend=pallas", "c3sl:R=8,backend=pallas|int8", "identity"])
@pytest.mark.parametrize("D,slots", [(128, 2), (4096, 8)])
def test_canonical_specs_equal_reference(spec, D, slots):
    assert tfd.canonical_codec_spec(spec, D, slots) == \
        jfd.canonical_codec_spec(spec, D, slots)


def test_adaptive_engine_specs_equal_reference():
    spec = "adaptive:c3sl:R=4,min_R=2|int8"
    got = tfd.engine_codec_specs(_engine("port", spec, num_slots=4))
    want = jfd.engine_codec_specs(_engine("reference", spec, num_slots=4))
    assert got == want and len(got[1]) == 2


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_codec_mismatch_is_a_handshake_failure(client_pkg):
    cfd = PACKAGES[client_pkg][0]

    async def go():
        # 4 slots so the engine serves R=4 unclamped: R=2 really mismatches
        eng = _engine("port", "c3sl:R=4|int8", num_slots=4)
        server = tfd.FrontDoorServer(eng, auto_tick=False)
        host, port = await server.start()
        try:
            for bad in ("none", "c3sl:R=2|int8", "c3sl:R=4"):
                with pytest.raises(cfd.FrontDoorError, match="codec mismatch"):
                    await cfd.FrontDoorClient.open(host, port, tenant="t0",
                                                   codec=bad)
            with pytest.raises(cfd.FrontDoorError, match="unbuildable"):
                await cfd.FrontDoorClient.open(host, port, tenant="t0",
                                               codec="no-such-codec:R=1")
            with pytest.raises(cfd.FrontDoorError, match="does not speculate"):
                await cfd.FrontDoorClient.open(host, port, tenant="t0",
                                               codec="c3sl:R=4|int8",
                                               draft="c3sl:R=2")
            # the matching spec (canonicalized: D filled in) still connects
            ok = await cfd.FrontDoorClient.open(host, port, tenant="t0",
                                                codec="c3sl:R=4|int8")
            assert ok.server_info["codec"] == "c3sl:R=4,D=128|int8"
            await ok.close()
        finally:
            await server.stop(drain=False)
        assert server.stats()["sessions"] == {"open": 0, "detached": 0}

    asyncio.run(go())


def test_busy_shedding_then_retry_completes():
    async def go():
        eng = _engine("port")
        server = tfd.FrontDoorServer(
            eng, auto_tick=True,
            admission=tfd.AdmissionController(
                max_queue_depth=8,
                default_policy=tfd.TenantPolicy(max_inflight=1)))
        host, port = await server.start()
        client = await tfd.FrontDoorClient.open(host, port, tenant="shed")
        # concurrent generates with max_inflight=1: the extras are shed
        # with BUSY and complete through the client's retry loop
        outs = await asyncio.gather(*(
            client.generate(p, max_new=4) for p in _prompts(3, 3)))
        stats = await client.stats()
        await client.close()
        await server.stop()
        assert server.tick_error is None
        return outs, stats

    outs, stats = asyncio.run(go())
    assert len(outs) == 3 and all(len(o["tokens"]) == 4 for o in outs)
    t = stats["tenants"]["shed"]
    assert t["requests"] == 3
    assert t["busy_rejections"] >= 1          # shedding actually happened
    assert stats["admission"]["inflight_total"] == 0


def test_hard_busy_raises_after_retries():
    async def go():
        eng = _engine("port")
        # auto_tick=False and max_inflight=1: the first submit is admitted
        # but never completes, so the second can only ever see BUSY
        server = tfd.FrontDoorServer(
            eng, auto_tick=False,
            admission=tfd.AdmissionController(
                default_policy=tfd.TenantPolicy(max_inflight=1)))
        host, port = await server.start()
        client = await tfd.FrontDoorClient.open(host, port, tenant="stuck")
        await client.submit([1, 2, 3], max_new=4)
        with pytest.raises(tfd.BusyError):
            await client.submit([4, 5, 6], max_new=4)
        with pytest.raises(tfd.FrontDoorError, match="still busy"):
            await client.generate([4, 5, 6], max_new=4, retries=2,
                                  backoff_s=0.001)
        await server.drain()                   # let the admitted one finish
        await client.close()
        await server.stop(drain=False)

    asyncio.run(go())


def test_engine_refusal_is_error_not_busy():
    async def go():
        eng = _engine("port")
        server = tfd.FrontDoorServer(eng, auto_tick=False)
        host, port = await server.start()
        client = await tfd.FrontDoorClient.open(host, port, tenant="bad")
        with pytest.raises(tfd.FrontDoorError, match="prompt length"):
            await client.submit(list(range(1, 40)), max_new=4)  # > max_len
        # the refusal released its admission slot: a good submit still works
        rid = await client.submit([1, 2, 3], max_new=2)
        await server.drain()
        out = await client.result(rid)
        assert len(out["tokens"]) == 2
        await client.close()
        await server.stop(drain=False)
        return server.stats()

    stats = asyncio.run(go())
    assert stats["tenants"]["bad"]["errors"] == 1
    assert stats["admission"]["inflight_total"] == 0


def test_multi_tenant_concurrent_clients():
    async def tenant(host, port, name, prompts):
        client = await tfd.FrontDoorClient.open(host, port, tenant=name)
        outs = await asyncio.gather(*(
            client.generate(p, max_new=3) for p in prompts))
        await client.close()
        return outs

    async def go():
        eng = _engine("port")
        server = tfd.FrontDoorServer(eng, auto_tick=True)
        host, port = await server.start()
        names = ["edge-a", "edge-b", "edge-c"]
        outs = await asyncio.gather(*(
            tenant(host, port, n, _prompts(2, 4 + i))
            for i, n in enumerate(names)))
        stats = server.stats()
        await server.stop()
        assert server.tick_error is None
        return outs, stats, eng

    outs, stats, eng = asyncio.run(go())
    assert all(len(o) == 2 for o in outs)
    for name in ("edge-a", "edge-b", "edge-c"):
        t = stats["tenants"][name]
        assert t["requests"] == 2 and t["tokens_out"] == 6
        assert t["ttft_s"]["count"] == 2 and t["bytes_in"] > 0
    assert stats["engine"]["decode_steps"] > 0
    assert stats["engine"]["pool"] == eng.pool_accounting()
    assert not eng.queue and eng.active == 0           # clean shutdown
