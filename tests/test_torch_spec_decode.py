"""The port's speculative decoding held against the reference's, on the same
weights, codec keys and draft keys (reduced ``deepseek-7b``, as
tests/test_spec_decode.py builds it): greedy outputs token for token, and
every integer stat (decode steps, spec rounds, accepted, rejected,
rollbacks, the forward and draft wire bytes, the served k schedule) and
the per-request counters exactly, over no codec with ragged prompts, a
codec in lockstep, ring-SWA, int8 KV and the paged layout under both reads;
eviction during speculation; ``accept_lengths``, ``propose_drafts``,
``token_wire_bytes``, ``SpecConfig`` and ``AdaptiveK`` on the same inputs.

Within the port: ``lm.verify_chunk`` leaves every cache leaf bitwise as it
was (attn linear, ring-SWA, int8, paged; MLA with the first-dense
superblock; Mamba; RWKV-6) and gives the write path's logits; speculative
output equals vanilla output on reduced rwkv6-1.6b and
deepseek-v2-lite-16b; the rollback property (hypothesis, port spec against
port vanilla: equal outputs, caches within float noise); a speculative
round reads at most one value on the host."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import transport as jtransport  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import spec as jspec  # noqa: E402
from repro_torch import transport as ttransport  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.paging import PagedLayout  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import spec as tspec  # noqa: E402

OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)
ENGINE_KW = dict(num_slots=2, max_len=32, chunk_size=8, sync_every=4,
                 greedy=True, seed=0, prefill_mode="chunked")
STAT_KEYS = ("dispatches", "decode_steps", "prefill_chunks",
             "payload_wire_bytes", "wire_bytes_fwd", "wire_bytes_bwd",
             "wire_bytes_draft", "eos_early_exits", "evictions", "withdrawn",
             "spec_windows", "spec_rounds", "spec_accepted", "spec_rejected",
             "spec_rollbacks")
REQ_KEYS = ("out", "accepted", "rejected", "rollbacks", "evictions")


def _cfgs(variant="plain"):
    over = dict(OVERRIDES)
    if variant == "ring_swa":
        over["sliding_window"] = 8
    elif variant == "int8_kv":
        over["kv_cache_quant"] = True
    return (jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **over),
            tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **over))


@functools.lru_cache(maxsize=None)
def _weights(variant="plain"):
    jcfg, tcfg = _cfgs(variant)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _prompt(rng, n, vocab=128):
    return [int(t) for t in rng.randint(1, vocab, n)]


def _link(spec, d_model):
    """The reference's link with its keys (draft channel included), and the
    port's link over the same keys."""
    jl = jtransport.build_link(spec, D=d_model)
    pj = jl.init(jax.random.PRNGKey(3))
    return ((jl, pj), (ttransport.build_link(spec, D=d_model),
                       params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")))


def _engines(variant="plain", link=None, spec=None, **kw):
    """(reference engine, port engine) on the same weights and keys; ``spec``
    is a dict of SpecConfig arguments (None: vanilla)."""
    jcfg, tcfg, pj, pt = _weights(variant)
    jkw, tkw = dict(ENGINE_KW, **kw), dict(ENGINE_KW, **kw)
    if link is not None:
        (jl, jlp), (tl, tlp) = _link(link, jcfg.d_model)
        jkw.update(codec=jl, codec_params=jlp)
        tkw.update(codec=tl, codec_params=tlp)
    if spec is not None:
        jkw["spec_decode"] = jspec.SpecConfig(**spec)
        tkw["spec_decode"] = tspec.SpecConfig(**spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the kernel read warns by design
        return (jengine.BatchedEngine(pj, jcfg, **jkw),
                tengine.BatchedEngine(pt, tcfg, **tkw))


def _run(eng, mod, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(uid=i, prompt=list(p), max_new_tokens=max_new[i]))
    return _summary(eng, eng.run())


def _summary(eng, done):
    reqs = {r.uid: tuple(getattr(r, k) for k in REQ_KEYS) for r in done}
    return (reqs, {k: eng.stats[k] for k in STAT_KEYS}, dict(eng.k_served),
            eng.pool_accounting())


def _both(prompts, max_new, **kw):
    jeng, teng = _engines(**kw)
    want = _run(jeng, jengine, prompts, max_new)
    got = _run(teng, tengine, prompts, max_new)
    return want, got, teng


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,head", [(8, "copy"), (4, "tied")])
def test_spec_engine_matches_reference_no_codec_ragged(k, head):
    rng = np.random.RandomState(1)
    prompts = [_prompt(rng, n) for n in (3, 9, 5)]
    want, got, eng = _both(prompts, (7, 4, 8),
                           spec=dict(k=k, draft_head=head))
    assert got == want
    assert eng.stats["spec_rounds"] > 0 and eng.stats["wire_bytes_fwd"] == 0


@pytest.mark.parametrize("k", [2])
def test_spec_engine_matches_reference_codec_lockstep(k):
    """A batch-wise codec with the draft channel at its own keys (a link's
    draft: segment): group-lockstep acceptance, zero forward bytes in the
    verify rounds, the draft channel's bytes (k 4: the wire accounting
    test)."""
    rng = np.random.RandomState(2)
    prompts = [_prompt(rng, 6), _prompt(rng, 6)]
    want, got, eng = _both(prompts, (6, 6),
                           link="c3sl:R=2|int8 >> draft:c3sl:R=2|int8",
                           spec=dict(k=k, draft_head="tied"))
    assert got == want
    assert eng.stats["spec_rounds"] > 0 and eng.stats["wire_bytes_draft"] > 0


@pytest.mark.parametrize("layout", ["ring_swa", "int8_kv", "paged_gather",
                                    "paged_kernel"])
def test_spec_engine_matches_reference_kv_layouts(layout):
    kw = {}
    if layout.startswith("paged"):
        kw = dict(kv_layout="paged", page_size=8, num_pages=8,
                  kv_read=layout.split("_")[1])
    rng = np.random.RandomState(3)
    prompts = [_prompt(rng, 4), _prompt(rng, 7)]
    want, got, eng = _both(prompts, (6, 6),
                           variant=layout if "_kv" in layout or "swa" in layout
                           else "plain",
                           spec=dict(k=4, draft_head="copy"), **kw)
    assert got == want
    assert eng.stats["spec_rounds"] > 0


def test_wire_accounting_matches_reference():
    """Verify rounds ship nothing forward: the forward bytes are the prefill
    chunks' alone, the draft channel's total is rounds x the round's bytes,
    and ``wire_per_token`` equals the reference's."""
    rng = np.random.RandomState(8)
    prompts = [_prompt(rng, 6), _prompt(rng, 6)]
    jeng, teng = _engines(link="c3sl:R=2|int8 >> draft:c3sl:R=2|int8",
                          spec=dict(k=4, draft_head="tied"))
    want = _run(jeng, jengine, prompts, (8, 8))
    got = _run(teng, tengine, prompts, (8, 8))
    assert got == want
    assert teng.wire_per_token() == jeng.wire_per_token()
    assert teng.stats["wire_bytes_fwd"] == \
        teng.stats["prefill_chunks"] * teng._chunk_wire_bytes()
    assert teng.stats["wire_bytes_draft"] == sum(
        rounds * teng._draft_round_wire_bytes(k)
        for k, rounds in teng.k_served.items())
    for k in (2, 4, 8):
        assert teng._draft_round_wire_bytes(k) == jeng._draft_round_wire_bytes(k)


def test_eviction_during_speculation_matches_reference():
    """A slot evicted between speculative windows re-prefills prompt +
    emitted tokens and resumes; its folded counters survive, as in the
    reference."""
    rng = np.random.RandomState(4)
    shorts = [(_prompt(rng, 4), 8) for _ in range(2)]
    premium = (_prompt(rng, 20), 4)
    out = []
    for mod, eng in zip((jengine, tengine), _engines(
            kv_layout="paged", page_size=8, num_pages=6, preemption=True,
            spec=dict(k=2, draft_head="tied"))):
        for i, (p, m) in enumerate(shorts):
            eng.submit(mod.Request(uid=i, prompt=list(p), max_new_tokens=m))
        eng.tick()
        eng.submit(mod.Request(uid=9, prompt=list(premium[0]),
                               max_new_tokens=premium[1], priority=1))
        out.append(_summary(eng, eng.run()))
    assert out[1] == out[0]
    reqs, stats = out[1][0], out[1][1]
    assert stats["evictions"] >= 1
    assert sum(r[1] for r in reqs.values()) == stats["spec_accepted"]


def test_spec_validation_matches_reference():
    """The engine's refusals, in both packages: spec needs greedy and
    chunked prefill, the ladder must not pass the sliding window, and a
    link's draft: segment turns speculation on."""
    jcfg, tcfg, pj, pt = _weights()
    jswa, tswa, pjs, pts = _weights("ring_swa")
    drafts = []
    for mod, sp, cfg, p, swa, ps in (
            (jengine, jspec, jcfg, pj, jswa, pjs),
            (tengine, tspec, tcfg, pt, tswa, pts)):
        kw = dict(num_slots=2, max_len=32)
        with pytest.raises(ValueError, match="greedy"):
            mod.BatchedEngine(p, cfg, greedy=False, spec_decode=sp.SpecConfig(), **kw)
        with pytest.raises(ValueError, match="chunked"):
            mod.BatchedEngine(p, cfg, prefill_mode="decode",
                              spec_decode=sp.SpecConfig(), **kw)
        with pytest.raises(ValueError, match="sliding_window"):
            mod.BatchedEngine(ps, swa, **kw,
                              spec_decode=sp.SpecConfig(k=8, ladder=(1, 16, 8)))
        eng = mod.BatchedEngine(p, cfg, codec="c3sl:R=2|int8 >> draft:c3sl:R=4|int8",
                                **kw)
        assert eng.spec_cfg == sp.SpecConfig()
        drafts.append(eng.draft_codec.spec())
    assert drafts[0] == drafts[1] and "R=2" in drafts[1]     # clamped to 2 slots


# ---------------------------------------------------------------------------
# the helpers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,eos_id,caps", [
    (1, None, False), (2, None, False), (4, 5, False), (2, 5, True),
    (1, 0, True)])
def test_accept_lengths_matches_reference(group, eos_id, caps):
    rng = np.random.RandomState(group * 10 + (eos_id or 0))
    B, k = 8, 4
    # small vocab so drafts often match their targets and EOS shows up
    fed = rng.randint(0, 6, (B, k)).astype(np.int32)
    targets = np.where(rng.rand(B, k) < 0.6, np.roll(fed, -1, axis=1),
                       rng.randint(0, 6, (B, k))).astype(np.int32)
    live = rng.rand(B) < 0.75
    rem_new = (rng.randint(0, 5, B) if caps else np.full(B, 99)).astype(np.int32)
    rem_pos = (rng.randint(0, 5, B) if caps else np.full(B, 99)).astype(np.int32)
    want = np.asarray(jspec.accept_lengths(
        jnp.asarray(fed), jnp.asarray(targets), jnp.asarray(live), group=group,
        eos_id=eos_id, rem_new=jnp.asarray(rem_new), rem_pos=jnp.asarray(rem_pos)))
    got = tspec.accept_lengths(
        torch.from_numpy(fed), torch.from_numpy(targets), torch.from_numpy(live),
        group=group, eos_id=eos_id, rem_new=torch.from_numpy(rem_new),
        rem_pos=torch.from_numpy(rem_pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,mode", [(1, "tied"), (2, "copy"), (4, "copy"),
                                    (4, "tied"), (8, "tied")])
def test_propose_drafts_matches_reference(k, mode):
    _, _, pj, pt = _weights()
    rng = np.random.RandomState(k)
    feat = rng.randn(4, OVERRIDES["d_model"]).astype(np.float32)
    last = rng.randint(0, OVERRIDES["vocab_size"], 4).astype(np.int32)
    want = np.asarray(jspec.propose_drafts(pj, jnp.asarray(feat),
                                           jnp.asarray(last), k, mode))
    got = tspec.propose_drafts(pt, torch.from_numpy(feat),
                               torch.from_numpy(last), k, mode)
    assert got.dtype == torch.int32 and got.shape == (4, k - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="draft head"):
        tspec.propose_drafts(pt, torch.from_numpy(feat), torch.from_numpy(last),
                             4, "oracle")


@pytest.mark.parametrize("vocab", [2, 256, 257, 1 << 16, (1 << 16) + 1, 102400])
def test_token_wire_bytes_matches_reference(vocab):
    assert tspec.token_wire_bytes(vocab) == jspec.token_wire_bytes(vocab)


@pytest.mark.parametrize("kw,match", [
    (dict(k=3, ladder=(1, 3)), "powers of two"),
    (dict(k=8, ladder=(1, 2, 4)), "not in ladder"),
    (dict(draft_head="oracle"), "draft_head"),
    (dict(ema=1.0), "ema"),
    (dict(hysteresis=-0.1), "hysteresis"),
    (dict(target_accept=0.0), "target_accept"),
    (dict(ladder=(0, 1), k=1), "ladder must be")])
def test_spec_config_validation_matches_reference(kw, match):
    for sp in (jspec, tspec):
        with pytest.raises(ValueError, match=match):
            sp.SpecConfig(**kw)
    assert tspec.SpecConfig(draft_head="copy").needs_feedback is False
    assert tspec.SpecConfig(k=2, ladder=(8, 2, 2, 1)).ladder == (1, 2, 8)


def test_adaptive_k_matches_reference():
    """The same acceptance stream through both controllers, with pins and
    unpins in it: the same k schedule and EMA."""
    rng = np.random.RandomState(0)
    rates = list(rng.rand(40)) + [None, 0.95, 0.95, 0.05, None]
    for cfg_kw in (dict(k=2, adaptive=True, ema=0.5),
                   dict(k=4, adaptive=True, ema=0.0, hysteresis=0.2),
                   dict(k=4)):
        j = jspec.AdaptiveK(jspec.SpecConfig(**cfg_kw))
        t = tspec.AdaptiveK(tspec.SpecConfig(**cfg_kw))
        for i, a in enumerate(rates):
            if i == 20:
                j.pin(8), t.pin(8)
            if i == 25:
                j.unpin(), t.unpin()
            assert t.observe(a) == j.observe(a)
            assert t.ema_accept == pytest.approx(j.ema_accept)
        with pytest.raises(ValueError, match="not in ladder"):
            t.pin(16)


# ---------------------------------------------------------------------------
# verify_chunk writes nothing
# ---------------------------------------------------------------------------

B, T, PS = 2, 32, 8
VERIFY_CASES = {
    "attn": ("deepseek-7b", dict(OVERRIDES), None),
    "ring_swa": ("deepseek-7b", dict(OVERRIDES, sliding_window=8), None),
    "int8": ("deepseek-7b", dict(OVERRIDES, kv_cache_quant=True), None),
    "paged": ("deepseek-7b", dict(OVERRIDES), "paged"),
    "mla_first_dense": ("deepseek-v2-lite-16b", {}, "paged"),
    "mamba": ("jamba-1.5-large-398b", {"num_layers": 8}, None),  # 1 superblock
    "rwkv6": ("rwkv6-1.6b", {}, None),
}


@functools.lru_cache(maxsize=None)
def _verify_model(case):
    arch, over, _ = VERIFY_CASES[case]
    cfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    return cfg, tlm.init_lm_params(0, cfg, device="cpu")


@pytest.mark.parametrize("case,codec", [
    ("attn", None), ("attn", "c3sl:R=2"), ("ring_swa", None),
    ("ring_swa", "c3sl:R=2"), ("int8", "c3sl:R=2"), ("paged", None),
    ("paged", "c3sl:R=2"), ("mla_first_dense", "c3sl:R=2"), ("mamba", None),
    ("rwkv6", "c3sl:R=2")])
def test_verify_chunk_leaves_the_cache_bitwise_unchanged(case, codec):
    """After a ragged prefill (to positions 12 and 10 on the ring, past its
    window of 8, so a verify write would overwrite live ring slots), a
    4-position verify leaves every cache leaf bitwise as it was, and its
    logits and cut features equal those of the write path on a copy of
    the cache (the reads are the same)."""
    from repro_torch import codecs
    cfg, params = _verify_model(case)
    paged = (PagedLayout(PS, T, B * T // PS) if VERIFY_CASES[case][2]
             else None)
    cache = tlm.init_decode_cache(params, cfg, B, T, paged=paged)
    if paged is not None:
        # a shuffled table: each slot's pages spread over the pool
        cache["pages"] = torch.from_numpy(np.random.RandomState(0).permutation(
            B * T // PS).astype(np.int32).reshape(B, -1))
    c = cp = None
    if codec is not None:
        c = codecs.build(codec, D=cfg.d_model)
        cp = c.init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.RandomState(5)
    pos = torch.zeros(B, dtype=torch.int32)
    # past the ring's window where there is one (two chunks within it);
    # slot 1 ragged
    for n in ((6, 4) if case == "ring_swa" else (3,)):
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 6)))
        valid = torch.tensor([[True] * 6, [True] * n + [False] * (6 - n)])
        tlm.prefill_chunk(params, cache, toks, pos, cfg, codec=c,
                          codec_params=cp, valid=valid, paged=paged)
        pos = pos + valid.sum(-1).to(torch.int32)
    before = tree_map(lambda t: t.clone(), cache)
    draft = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 4)))
    live = torch.ones((B, 4), dtype=torch.bool)
    logits, feat = tlm.verify_chunk(params, cache, draft, pos, cfg, codec=c,
                                    codec_params=cp, valid=live, paged=paged)
    leaves, want = tree_leaves(cache), tree_leaves(before)
    assert len(leaves) == len(want)
    for got, was in zip(leaves, want):
        assert torch.equal(got, was)
    h, _, cut = tlm.chunk_forward(params, before, draft, pos, cfg, codec=c,
                                  codec_params=cp, valid=live, paged=paged)
    hn = tlm._apply_norm(cfg, params["final_norm"], h)
    assert torch.equal(logits, tlm.matmul(hn, params["head"]))
    assert torch.equal(feat, cut if c is not None else h)
    assert logits.shape == (B, 4, cfg.vocab_size)


# ---------------------------------------------------------------------------
# within the port: spec == vanilla, the rollback property, host reads
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _family(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    return cfg, tlm.init_lm_params(0, cfg, device="cpu")


@pytest.mark.parametrize("arch,codec", [
    ("rwkv6-1.6b", None), ("deepseek-v2-lite-16b", "c3sl:R=2")])
def test_spec_equals_vanilla_on_the_stateful_and_mla_families(arch, codec):
    """RWKV-6's state and MLA's latents (behind the first-dense superblock),
    paged: the verify writes nothing, so speculative output equals
    vanilla's (a state advanced k positions by the verify would change
    every later token).  Without a codec over ragged prompts that recycle
    slots; with one in lockstep (equal prompts and budgets in pairs), as
    batch-wise compression needs the same dispatch schedule."""
    cfg, params = _family(arch)
    rng = np.random.RandomState(6)
    lens, max_new = ((5, 9, 3), (6, 4, 5)) if codec is None else \
        ((6, 6), (6, 6))
    prompts = [_prompt(rng, n, cfg.vocab_size) for n in lens]
    outs = []
    for spec in (None, tspec.SpecConfig(k=4, draft_head="tied")):
        eng = tengine.BatchedEngine(params, cfg, num_slots=2, max_len=32,
                                    chunk_size=8, sync_every=4, seed=0,
                                    kv_layout="paged", codec=codec or "none",
                                    spec_decode=spec)
        done = _run(eng, tengine, prompts, max_new)
        outs.append({u: r[0] for u, r in done[0].items()})
    assert outs[1] == outs[0]
    assert eng.stats["spec_rounds"] > 0 and eng.stats["spec_rollbacks"] > 0


@pytest.mark.property
def test_rollback_cache_property():
    """Hypothesis property, port spec against port vanilla: after any
    workload (ragged prompts, budgets drawn adversarially) with rejections
    in it, the emitted streams are equal and the caches match position for
    position: integer leaves exactly, float leaves within 1e-4 (the commit
    path's chunked writes against the vanilla per-token writes; a leaked
    rejected draft would leave an O(1) difference)."""
    pytest.importorskip("hypothesis",
                        reason="property tests need the optional hypothesis package")
    from hypothesis import given, settings, strategies as st
    _, tcfg, _, pt = _weights()
    # contiguous, as the reference's property: on the paged layout the two
    # engines' retire orders, and so their page tables, may differ
    vanilla = tengine.BatchedEngine(pt, tcfg, **ENGINE_KW)
    spec = tengine.BatchedEngine(pt, tcfg, spec_decode=tspec.SpecConfig(k=4),
                                 **ENGINE_KW)
    seen = [0]

    @settings(max_examples=6, deadline=None)
    @given(st.lists(st.tuples(st.integers(2, 10), st.integers(1, 8)),
                    min_size=1, max_size=2),
           st.integers(0, 2 ** 31 - 1))
    def prop(shapes, seed):
        rng = np.random.RandomState(seed)
        prompts = [_prompt(rng, n) for n, _ in shapes]
        max_new = [m for _, m in shapes]
        ref = _run(vanilla, tengine, prompts, max_new)
        got = _run(spec, tengine, prompts, max_new)
        vanilla.finished.clear()
        spec.finished.clear()
        assert {u: r[0] for u, r in got[0].items()} == \
               {u: r[0] for u, r in ref[0].items()}
        for a, b in zip(tree_leaves(vanilla.cache), tree_leaves(spec.cache)):
            if a.dtype.is_floating_point:
                assert float((a - b).abs().max()) < 1e-4
            else:
                assert torch.equal(a, b)
        seen[0] += sum(r[3] for r in got[0].values())

    prop()
    assert seen[0] > 0, "no workload rejected a draft: the property is vacuous"


class _HostReads(TorchDispatchMode):
    """Counts ``aten._local_scalar_dense``: every read of a device value on
    the host through ``.item()``, a 0-dim index or ``bool()``."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("codec", [None, "c3sl:R=2|int8 >> draft:c3sl:R=2"])
def test_spec_round_reads_one_value_on_the_host(codec):
    """A speculative window of 2 rounds (tied head, paged): at most one
    ``_local_scalar_dense`` a round (its any-slot-live flag); the counters
    are read once, at the window's end, as one copy."""
    _, tcfg, _, pt = _weights()
    kw = dict(ENGINE_KW, kv_layout="paged", page_size=8)
    eng = tengine.BatchedEngine(pt, tcfg, codec=codec or "none",
                                spec_decode=tspec.SpecConfig(k=2), **kw)
    rng = np.random.RandomState(9)
    for u in range(2):
        eng.submit(tengine.Request(uid=u, prompt=_prompt(rng, 5),
                                   max_new_tokens=20))
    eng._boundary()
    while eng._pending_prefill():
        eng._prefill_one_chunk()
    with _HostReads() as reads:
        emitted = eng._spec_window(6, 2)
    assert eng.stats["spec_rounds"] == 2 and emitted >= 4
    assert reads.n <= eng.stats["spec_rounds"]


def test_spec_program_table_is_made_once():
    """One program per (R bucket, draft bucket, k > 1), made at
    construction; bouncing the R and k pins serves from that table."""
    _, tcfg, _, pt = _weights()
    eng = tengine.BatchedEngine(
        pt, tcfg, **dict(ENGINE_KW, num_slots=4),
        codec="adaptive:c3sl:R=4,min_R=2|int8",
        spec_decode=tspec.SpecConfig(k=2, ladder=(1, 2, 4),
                                     draft="c3sl:R=2|int8"))
    assert set(eng._spec_programs) == {(R, None, k) for R in (2, 4)
                                       for k in (2, 4)}
    progs = dict(eng._spec_programs)
    rng = np.random.RandomState(5)
    for R, k in ((2, 4), (4, 2)):
        eng.codec.pin(R)
        eng._k_ctl.pin(k)
        for u in range(2):
            eng.submit(tengine.Request(uid=100 * R + 10 * k + u,
                                       prompt=_prompt(rng, 4), max_new_tokens=4))
        eng.run()
    assert eng._spec_programs == progs
    assert set(eng.k_served) == {2, 4}
    assert sum(eng.r_served.values()) == (eng.stats["decode_steps"]
                                          + eng.stats["prefill_chunks"])


# ---------------------------------------------------------------------------
# the serve CLI against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,line", [
    (["--draft-k", "4", "--draft-head", "copy"], "speculative:"),
    (["--preemption", "--kv-layout", "paged", "--codec", "c3sl:R=2"],
     "cut-layer wire:")])
def test_serve_cli_wire_lines_match_reference(flags, line, monkeypatch, capsys):
    """``serve --engine --greedy`` with the speculative flags or
    ``--preemption`` on reduced deepseek-7b, the port on the CPU: its
    speculative line (rounds, accepted, rejected, rollbacks, the forward
    and draft wire bytes) or its cut-layer wire line (forward bytes, decode
    steps, prefill chunks) equals the reference CLI's.  Both CLIs get the
    reference's weights and prompts; the speculative runs ship no codec
    payload (the tied head's feedback raw), and the forward channel's
    integers do not depend on the codec keys."""
    import sys
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "deepseek-7b", "--reduced", "--engine", "--greedy",
            "--batch", "2", "--requests", "2", "--prompt-len", "5",
            "--max-new", "6", "--cache-len", "16", "--chunk-size", "4", *flags]
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"))
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 5), 0,
                                 jcfg.vocab_size).tolist()
    monkeypatch.setattr(tlm, "init_lm_params", lambda *a, device, **k:
                        params_from_numpy(jax.tree.map(np.asarray, pj), device))
    monkeypatch.setattr(tserve, "_prompts", lambda args, vocab: prompts)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(line)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tserve.main([*argv, "--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(line)]
    assert len(want) == 1 and got == want
