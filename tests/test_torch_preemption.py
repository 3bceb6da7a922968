"""The port's slot preemption, withdraw, stream events and legacy
``prefill_mode="decode"`` held against the reference engine on the same
weights (reduced ``deepseek-7b``, as tests/test_preemption.py builds it):
the cases of tests/test_preemption.py, each run on both engines, with
greedy outputs, finish order, every integer stat, per-request eviction
counts and the pool accounting (after every tick where the case ticks)
equal; a withdrawn request resubmitted resumes identically; the stream
events of both engines are the same bursts and, concatenated per uid, each
final output with no gap; the legacy loop gives the reference's legacy
outputs and stats and the chunked engine's tokens."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)
ENGINE_KW = dict(num_slots=2, max_len=32, chunk_size=8, sync_every=4,
                 greedy=True, seed=0)
STAT_KEYS = ("dispatches", "decode_steps", "prefill_chunks",
             "payload_wire_bytes", "wire_bytes_fwd", "eos_early_exits",
             "evictions", "withdrawn")
PAGED = dict(kv_layout="paged", page_size=8, num_pages=6)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **OVERRIDES)
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **OVERRIDES)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _prompt(rng, n, vocab=128):
    return [int(t) for t in rng.randint(1, vocab, n)]


def _pair(drive, **kw):
    """``drive(mod, engine)`` on the reference engine and on the port's, on
    the same weights and codec keys; returns (reference result, port
    result)."""
    jcfg, tcfg, pj, pt = _weights()
    kw = dict(ENGINE_KW, **kw)
    jkw, tkw = dict(kw), dict(kw)
    if "codec" in kw:
        cpj = jbuild(kw["codec"], D=jcfg.d_model).init(jax.random.PRNGKey(3))
        jkw["codec_params"] = cpj
        tkw["codec_params"] = params_from_numpy(jax.tree.map(np.asarray, cpj), "cpu")
    return (drive(jengine, jengine.BatchedEngine(pj, jcfg, **jkw)),
            drive(tengine, tengine.BatchedEngine(pt, tcfg, **tkw)))


def _port_engine(**kw):
    """The port's engine alone, with the reference's codec keys."""
    jcfg, tcfg, _, pt = _weights()
    kw = dict(ENGINE_KW, **kw)
    if "codec" in kw:
        cpj = jbuild(kw["codec"], D=jcfg.d_model).init(jax.random.PRNGKey(3))
        kw["codec_params"] = params_from_numpy(jax.tree.map(np.asarray, cpj), "cpu")
    return tengine.BatchedEngine(pt, tcfg, **kw)


def _summary(eng, done):
    return ([(r.uid, r.out, r.evictions, r.priority) for r in done],
            {k: eng.stats[k] for k in STAT_KEYS}, eng.pool_accounting())


def _oversubscribed(mod, eng, *, premium_priority=1, seed=3):
    """2 slots, a 6-page pool (page 8): two low-priority shorts hold 2
    pages each, the premium request needs 3; it arrives after one tick."""
    rng = np.random.RandomState(seed)
    for i in range(2):
        eng.submit(mod.Request(uid=i, prompt=_prompt(rng, 4), max_new_tokens=8))
    eng.tick()
    assert eng.active == 2 and eng.stats["evictions"] == 0
    eng.submit(mod.Request(uid=9, prompt=_prompt(rng, 20), max_new_tokens=4,
                           priority=premium_priority))
    return _summary(eng, eng.run())


@functools.lru_cache(maxsize=None)
def _oversubscribed_pair(preemption):
    return _pair(_oversubscribed, preemption=preemption, **PAGED)


def test_evicted_request_resumes_like_the_reference():
    want, got = _oversubscribed_pair(True)
    assert got == want
    done, stats, _ = got
    assert stats["evictions"] >= 1
    assert [u for u, *_ in done][0] == 9          # the premium finishes first
    assert all(ev == 0 for u, _, ev, _ in done if u == 9)
    assert all(len(out) == (4 if u == 9 else 8) for u, out, _, _ in done)


@pytest.mark.parametrize("preemption", [False, True])
def test_premium_overtakes_fifo_only_with_preemption(preemption):
    want, got = _oversubscribed_pair(preemption)
    assert got == want
    order = [u for u, *_ in got[0]]
    assert order[0 if preemption else -1] == 9
    assert (got[1]["evictions"] > 0) == preemption


def test_pool_accounting_whole_after_every_tick_like_the_reference():
    def drive(mod, eng):
        rng = np.random.RandomState(3)
        for i in range(2):
            eng.submit(mod.Request(uid=i, prompt=_prompt(rng, 4),
                                   max_new_tokens=8))
        eng.tick()
        eng.submit(mod.Request(uid=9, prompt=_prompt(rng, 20),
                               max_new_tokens=4, priority=1))
        trail = []
        while eng.tick():
            acct = eng.pool_accounting()
            assert acct["free"] + acct["in_use"] == acct["total"]
            assert sum(len(s.pages) for s in eng.slots) == acct["in_use"]
            trail.append((acct["free"], eng.active, len(eng.queue)))
            assert len(trail) < 500, "engine failed to drain"
        return trail, _summary(eng, eng.finished)

    want, got = _pair(drive, preemption=True, **PAGED)
    assert got == want
    assert got[1][1]["evictions"] >= 1 and got[1][2]["free"] == 6


def test_equal_priority_never_preempted():
    want, got = _pair(functools.partial(_oversubscribed, premium_priority=0,
                                        seed=5), preemption=True, **PAGED)
    assert got == want
    assert got[1]["evictions"] == 0 and [u for u, *_ in got[0]][-1] == 9


def test_slots_only_preemption_contiguous():
    def drive(mod, eng):
        rng = np.random.RandomState(7)
        eng.submit(mod.Request(uid=0, prompt=_prompt(rng, 4), max_new_tokens=12))
        eng.tick()
        eng.submit(mod.Request(uid=1, prompt=_prompt(rng, 4), max_new_tokens=4,
                               priority=2))
        return _summary(eng, eng.run())

    want, got = _pair(drive, num_slots=1, preemption=True)
    assert got == want
    assert got[1]["evictions"] == 1


def test_eviction_is_feasibility_checked():
    def drive(mod, eng):
        rng = np.random.RandomState(11)
        eng.submit(mod.Request(uid=0, prompt=_prompt(rng, 16), max_new_tokens=8,
                               priority=1))
        eng.submit(mod.Request(uid=1, prompt=_prompt(rng, 4), max_new_tokens=8))
        eng.tick()
        assert eng.active == 2
        eng.submit(mod.Request(uid=9, prompt=_prompt(rng, 16), max_new_tokens=8,
                               priority=1))
        return _summary(eng, eng.run())

    want, got = _pair(drive, preemption=True, **dict(PAGED, num_pages=5))
    assert got == want
    assert got[1]["evictions"] == 0


def test_eos_early_exit_frees_pages_before_boundary():
    """A (2 pages) and B (5) fill a 7-page pool; C (5) starves.  A finishes
    mid-window, the window exits and A retires at that host sync, its pages
    back on the free list before any boundary; then the drain."""
    def drive(mod, eng):
        rng = np.random.RandomState(13)
        for uid, n, m in ((0, 6, 2), (1, 4, 16)):
            eng.submit(mod.Request(uid=uid, prompt=_prompt(rng, n),
                                   max_new_tokens=m))
        c = mod.Request(uid=2, prompt=_prompt(rng, 10), max_new_tokens=10)
        eng._boundary()
        while eng._pending_prefill():
            eng._prefill_one_chunk()
        full = eng.pool_accounting()
        eng.submit(c)
        executed = eng._decode_window(8)
        early = ([(r.uid, r.out) for r in eng.finished], eng.pool_accounting(),
                 eng.stats["eos_early_exits"])
        return full, executed, early, _summary(eng, eng.run())

    want, got = _pair(drive, **dict(PAGED, page_size=4, num_pages=7,
                                    sync_every=8))
    assert got == want
    full, executed, early, _ = got
    assert full == {"free": 0, "in_use": 7, "total": 7}
    assert executed < 8 and early[2] == 1
    assert [u for u, _ in early[0]] == [0] and len(early[0][0][1]) == 2
    assert early[1] == {"free": 2, "in_use": 5, "total": 7}


def test_preemption_requires_chunked_prefill():
    jcfg, tcfg, pj, pt = _weights()
    for mod, p, cfg in ((jengine, pj, jcfg), (tengine, pt, tcfg)):
        with pytest.raises(ValueError, match="preemption"):
            mod.BatchedEngine(p, cfg, num_slots=2, max_len=32,
                              prefill_mode="decode", preemption=True)


# ---------------------------------------------------------------------------
# withdraw and stream events
# ---------------------------------------------------------------------------

def test_withdraw_and_resubmit_resume_like_the_reference():
    """A queued request withdrawn comes back untouched; a running one
    mid-decode comes back with its emitted tokens, frees its slot and
    pages, and resubmitted resumes to the uninterrupted output; an unknown
    uid gives None."""
    def drive(mod, eng):
        rng = np.random.RandomState(21)
        reqs = [mod.Request(uid=u, prompt=_prompt(rng, 5 + u), max_new_tokens=10)
                for u in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.tick()
        queued = eng.withdraw(2)
        running = eng.withdraw(1)
        mid = (len(running.out), running.evictions, eng.active,
               eng.pool_accounting(), queued is reqs[2], queued.out)
        assert eng.withdraw(77) is None
        eng.submit(running)
        eng.submit(queued)
        return mid, _summary(eng, eng.run())

    want, got = _pair(drive, **dict(PAGED, num_pages=8))
    assert got == want
    (emitted, evictions, active, acct, same, out2), (done, stats, _) = got
    assert 0 < emitted < 10 and evictions == 1 and active == 1 and same
    assert out2 == [] and stats["withdrawn"] == 2
    assert acct["in_use"] == 2
    # the resumed output is the uninterrupted one
    solo = _port_engine(**dict(PAGED, num_pages=8))
    rng = np.random.RandomState(21)
    prompts = [_prompt(rng, 5 + u) for u in range(3)]
    solo.submit(tengine.Request(uid=1, prompt=prompts[1], max_new_tokens=10))
    assert [r.out for r in solo.run()] == [o for u, o, *_ in done if u == 1]


def test_stream_events_like_the_reference():
    """Ticks through an oversubscribed pool with preemption and a withdraw:
    both engines stream the same (uid, start, tokens) bursts, and each
    uid's bursts join, with no gap, into its final output."""
    def drive(mod, eng):
        rng = np.random.RandomState(31)
        for u in range(4):
            eng.submit(mod.Request(uid=u, prompt=_prompt(rng, 4 + u),
                                   max_new_tokens=6 + u))
        events = []
        ticks = 0
        while eng.tick():
            events += eng.pop_stream_events()
            ticks += 1
            if ticks == 1:
                eng.submit(mod.Request(uid=9, prompt=_prompt(rng, 12),
                                       max_new_tokens=5, priority=1))
            if ticks == 3:
                r = eng.withdraw(1)
                if r is not None:
                    eng.submit(r)
        events += eng.pop_stream_events()
        assert eng.pop_stream_events() == []
        return events, _summary(eng, eng.finished)

    want, got = _pair(drive, preemption=True, **PAGED)
    assert got == want
    events, (done, stats, _) = got
    assert stats["evictions"] > 0
    for uid, out, *_ in done:
        joined = []
        for u, start, toks in events:
            if u == uid:
                assert start == len(joined), (uid, start, len(joined))
                joined += toks
        assert joined == out


# ---------------------------------------------------------------------------
# the legacy prefill_mode="decode"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(PAGED, num_pages=8), dict(codec="c3sl:R=2"),
    dict(PAGED, num_pages=8, kv_read="kernel", eos_id=5)])
def test_legacy_decode_mode_matches_reference(kw):
    """The per-token host loop: outputs, finish order and stats equal the
    reference's legacy engine's (ragged prompts over 2 slots, so slots
    recycle), driven by run() and by tick()."""
    def drive(mod, eng, ticked=False):
        rng = np.random.RandomState(41)
        for u, n in enumerate((3, 7, 5, 4)):
            eng.submit(mod.Request(uid=u, prompt=_prompt(rng, n),
                                   max_new_tokens=5))
        if ticked:
            while eng.tick():
                pass
            return _summary(eng, eng.finished)
        return _summary(eng, eng.run())

    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = _pair(drive, prefill_mode="decode", **kw)
        ticked = drive(tengine, _port_engine(prefill_mode="decode", **kw),
                       ticked=True)
    assert got == want == ticked
    if "codec" not in kw and "eos_id" not in kw:
        # without a codec the legacy loop gives the chunked engine's tokens
        chunked = drive(tengine, _port_engine(**kw))
        assert sorted(o for _, o, *_ in got[0]) == \
            sorted(o for _, o, *_ in chunked[0])
