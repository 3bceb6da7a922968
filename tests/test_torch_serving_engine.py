"""The port's continuous-batching engine held against the reference engine on
the same weights and codec keys: greedy outputs token for token, and the
integer stats (dispatches, decode_steps, prefill_chunks, wire_bytes_fwd)
and pool accounting exactly, over the kv_layout x kv_read combinations.
Also the loud gating of the kernel read, the option checks the reference
makes, what is not ported yet, and the serve CLI on the CPU."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro import transport as jtransport  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced engines are many small ops; under the suite's parallel
    workers torch's intra-op threads oversubscribe the cores, so this
    module runs on one (its comparisons hold there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)
STAT_KEYS = ("dispatches", "decode_steps", "prefill_chunks",
             "payload_wire_bytes", "wire_bytes_fwd", "wire_bytes_bwd")
# prompt lengths straddle the page boundary (8); 6 requests on 4 slots, so
# slots recycle mid-flight and a freed page set is reallocated
LENS = [7, 8, 9, 3, 12, 5]
ENGINE_KW = dict(num_slots=4, max_len=32, chunk_size=8, sync_every=4,
                 page_size=8, greedy=True, seed=0)
# bfloat16 weights: greedy tokens equal up to an argmax flip
BF16_PREFIX = 3       # leading tokens every request must share
BF16_SHARE = 0.75     # share of all generated tokens that must be equal


def _cfgs(variant):
    over = dict(OVERRIDES)
    if variant == "swa":
        over["sliding_window"] = 8
    elif variant in ("int8", "bf16-int8"):
        over["kv_cache_quant"] = True
    return (jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **over),
            tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **over))


@functools.lru_cache(maxsize=None)
def _weights(variant):
    """Float32 weights, or bfloat16 ones for "bf16-int8" (served, in both
    engines, over an int8 KV cache)."""
    jcfg, tcfg = _cfgs(variant)
    dtype = jax.numpy.bfloat16 if variant.startswith("bf16") else jax.numpy.float32
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    return jcfg, tcfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [[int(t) for t in rng.randint(1, vocab, n)] for n in LENS]


def _codec_params(spec, d_model):
    """The reference's codec keys, for both engines."""
    if spec is None:
        return None, None
    pj = jbuild(spec, D=d_model).init(jax.random.PRNGKey(3))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _drive(eng, req_cls, vocab, max_new=6):
    for uid, p in enumerate(_prompts(vocab)):
        eng.submit(req_cls(uid=uid, prompt=list(p), max_new_tokens=max_new))
    outs = {r.uid: r.out for r in eng.run()}
    return outs, {k: eng.stats[k] for k in STAT_KEYS}, eng.pool_accounting()


@functools.lru_cache(maxsize=None)
def _reference_run(variant, kv_layout, codec):
    jcfg, _, pj, _ = _weights(variant)
    cpj, _ = _codec_params(codec, jcfg.d_model)
    eng = jengine.BatchedEngine(pj, jcfg, kv_layout=kv_layout,
                                codec=codec or "none", codec_params=cpj,
                                **ENGINE_KW)
    return _drive(eng, jengine.Request, jcfg.vocab_size)


def _port_engine(variant, kv_layout, kv_read, codec, **over):
    jcfg, tcfg, _, pt = _weights(variant)
    _, cpt = _codec_params(codec, jcfg.d_model)
    kw = dict(ENGINE_KW, **over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the kernel read warns by design
        return tengine.BatchedEngine(pt, tcfg, kv_layout=kv_layout,
                                     kv_read=kv_read, codec=codec or "none",
                                     codec_params=cpt, **kw)


@pytest.mark.parametrize("variant,codec", [
    ("plain", None), ("plain", "c3sl:R=2"), ("swa", "c3sl:R=2"),
    ("int8", "c3sl:R=2"), ("plain", "c3sl:R=4|int8")])
@pytest.mark.parametrize("kv_layout,kv_read", [
    ("contiguous", "gather"), ("paged", "gather"), ("paged", "kernel")])
def test_engine_matches_reference_engine(variant, codec, kv_layout, kv_read):
    """The reference's kernel read is bit-identical to its gather read
    (tests/test_paged_kernel.py), so the port's kernel read is held against
    the reference's paged gather run."""
    want_out, want_stats, want_pool = _reference_run(variant, kv_layout, codec)
    eng = _port_engine(variant, kv_layout, kv_read, codec)
    out, stats, pool = _drive(eng, tengine.Request, eng.cfg.vocab_size)
    assert out == want_out
    assert stats == want_stats
    assert pool == want_pool
    assert len(out) == len(LENS) and all(len(o) == 6 for o in out.values())


@pytest.mark.parametrize("kv_layout,kv_read", [
    ("contiguous", "gather"), ("paged", "gather"), ("paged", "kernel")])
def test_bf16_engine_matches_reference_engine(kv_layout, kv_read):
    """bfloat16 weights over an int8 KV cache, as the reference serves them.
    In bfloat16 the two sides' logits differ by about 1% of max|logit| (the
    roundings of XLA:CPU and PyTorch fall differently), which can flip a
    greedy argmax, and the sequences part from there.  So the integer stats
    and the pool are exact, every request's first BF16_PREFIX tokens equal,
    and at least BF16_SHARE of all tokens equal."""
    want_out, want_stats, want_pool = _reference_run("bf16-int8", kv_layout,
                                                     "c3sl:R=2")
    eng = _port_engine("bf16-int8", kv_layout, kv_read, "c3sl:R=2")
    assert eng.cache["stack"]["l0_0_attn"]["k"].dtype == torch.int8
    out, stats, pool = _drive(eng, tengine.Request, eng.cfg.vocab_size)
    assert stats == want_stats
    assert pool == want_pool
    assert all(len(out[u]) == len(want_out[u]) == 6 for u in want_out)
    assert all(out[u][:BF16_PREFIX] == want_out[u][:BF16_PREFIX] for u in want_out)
    same = sum(a == b for u in want_out for a, b in zip(out[u], want_out[u]))
    assert same >= BF16_SHARE * 6 * len(LENS), same


def test_bf16_model_over_float_cache_raises_like_the_reference():
    """The float KV cache is float32 in both engines; a bfloat16 model over
    it promotes the residual stream mid-stack, which the reference's scan
    rejects on the first prefill, and the port's serving stack with the
    same TypeError at the same call."""
    jcfg, _, pj, pt = _weights("bf16-int8")
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=False)
    tcfg = _cfgs("plain")[1]
    for mod, p, cfg in ((jengine, pj, jcfg), (tengine, pt, tcfg)):
        eng = mod.BatchedEngine(p, cfg, kv_layout="paged", **ENGINE_KW)
        eng.submit(mod.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        with pytest.raises(TypeError, match="carry"):
            eng.run()


def test_engine_interleave_and_eos_match_reference():
    """interleave > 0 (a prefill chunk, then a short decode window) and an
    eos_id that ends some requests early."""
    jcfg, tcfg, pj, pt = _weights("plain")
    want = _drive(jengine.BatchedEngine(pj, jcfg, kv_layout="paged",
                                        interleave=2, eos_id=5, **ENGINE_KW),
                  jengine.Request, jcfg.vocab_size, max_new=10)
    got = _drive(_port_engine("plain", "paged", "kernel", None, interleave=2,
                              eos_id=5),
                 tengine.Request, tcfg.vocab_size, max_new=10)
    assert got == want


def test_starved_pool_exits_windows_early_like_the_reference():
    """An oversubscribed pool: admission waits (FIFO) for pages, and decode
    windows stop at the first finished slot so its pages free at once.  A
    (3 pages) finishes after 2 tokens while C (7 pages) decodes on; B needs
    12 of the 4 free pages, so A's finish must cut the window short."""
    jcfg, tcfg, pj, pt = _weights("plain")
    kw = dict(ENGINE_KW, num_slots=2, max_len=64, page_size=4, num_pages=14,
              sync_every=32)
    reqs = [(0, [1] * 8, 2), (1, [2] * 4, 24), (2, [3] * 8, 40)]

    def drive(eng, req_cls):
        for uid, prompt, max_new in reqs:
            eng.submit(req_cls(uid=uid, prompt=prompt, max_new_tokens=max_new))
        outs = {r.uid: r.out for r in eng.run()}
        return outs, {k: eng.stats[k] for k in STAT_KEYS}, eng.pool_accounting()

    jeng = jengine.BatchedEngine(pj, jcfg, kv_layout="paged", **kw)
    want = drive(jeng, jengine.Request)
    teng = _port_engine("plain", "paged", "kernel", None, **kw)
    got = drive(teng, tengine.Request)
    assert got == want
    assert teng.stats["eos_early_exits"] == jeng.stats["eos_early_exits"] > 0


# ---------------------------------------------------------------------------
# loud gating and execution modes
# ---------------------------------------------------------------------------

def test_kernel_requires_paged_layout():
    _, tcfg, _, pt = _weights("plain")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        tengine.BatchedEngine(pt, tcfg, kv_layout="contiguous", kv_read="kernel")


def test_kernel_requires_attn_layers():
    _, tcfg, _, pt = _weights("plain")
    cfg = dataclasses.replace(tcfg, block_pattern=(("mamba", "mlp"),))
    with pytest.raises(ValueError, match="no attn sublayer"):
        tengine.BatchedEngine(pt, cfg, kv_layout="paged", kv_read="kernel")


def test_uncovered_reads_warn_loudly():
    _, tcfg, _, pt = _weights("plain")
    with pytest.warns(UserWarning, match="stay on the gather read path"):
        tengine.BatchedEngine(pt, tcfg, kv_layout="paged", kv_read="kernel")


def test_execution_modes_in_stats():
    eng = _port_engine("plain", "paged", "kernel", None)
    assert eng.stats["kv_read"] == "kernel"
    assert eng.stats["kv_read_execution_mode"] == "torch-plain"
    assert eng.stats["codec_execution_mode"] == "none"
    eng = _port_engine("plain", "paged", "gather", "c3sl:R=2")
    assert eng.stats["kv_read_execution_mode"] == "gather"
    assert eng.stats["codec_execution_mode"] == "fft"
    eng = _port_engine("plain", "paged", "gather", "c3sl:R=2,backend=pallas")
    assert eng.stats["codec_execution_mode"] == "torch-plain"


@pytest.mark.parametrize("kw,match", [
    (dict(greedy=False, spec_decode=True), "requires greedy"),
    (dict(prefill_mode="decode", spec_decode=True), "requires prefill_mode='chunked'"),
    (dict(spec_decode="ladder past the window"), "exceeds sliding_window"),
    (dict(prefill_mode="decode", preemption=True), "preemption requires"),
    (dict(codec="c3sl:R=4 >> draft:c3sl:R=2", greedy=False), "requires greedy"),
    (dict(codec="c3sl:R=4 >> bwd:c3sl:R=2 >> draft:c3sl:R=2",
          prefill_mode="decode"), "requires prefill_mode='chunked'")])
def test_unported_options_raise(kw, match):
    """What these options refused before they were ported, they now check
    as the reference does, with its errors in both packages: speculative
    decoding needs greedy decoding and chunked prefill, its ladder must not
    pass the sliding window, preemption needs chunked prefill, and a link's
    draft: segment turns speculation on (so its checks apply)."""
    from repro.serving.spec import SpecConfig as JSpec
    from repro_torch.serving.spec import SpecConfig as TSpec
    jcfg, tcfg, pj, pt = _weights("plain")
    for mod, p, cfg, spec in ((jengine, pj, jcfg, JSpec), (tengine, pt, tcfg, TSpec)):
        over = dict(kw)
        if over.get("spec_decode") == "ladder past the window":
            cfg = dataclasses.replace(cfg, sliding_window=4)
            over["spec_decode"] = spec(k=8)
        with pytest.raises(ValueError, match=match):
            mod.BatchedEngine(p, cfg, **over)


# the SNR stream both engines' controllers see, one value per tick
SNRS = [9.0, 9.0, 9.0, -9.0, 9.0, -9.0, -9.0, 9.0, 9.0, 9.0, -9.0, 9.0] * 4


def _drive_ticks(eng, req_cls, vocab):
    """Submit the prompts, then tick to the end, feeding the controller one
    SNR per tick between dispatches."""
    for uid, p in enumerate(_prompts(vocab)):
        eng.submit(req_cls(uid=uid, prompt=list(p), max_new_tokens=6))
    ticks = 0
    while eng.tick():
        eng.observe_snr(SNRS[ticks % len(SNRS)])
        ticks += 1
    outs = {r.uid: r.out for r in eng.finished}
    return outs, {k: eng.stats[k] for k in STAT_KEYS}, dict(eng.r_served), ticks


@pytest.mark.parametrize("codec,kv_read", [
    ("adaptive:c3sl:R=4,min_R=1,target_snr=0.0,ema=0.0", "gather"),
    ("adaptive:c3sl:R=4,min_R=2,ema=0.0|int8", "kernel"),
    ("c3sl:R=2|int8 >> bwd:c3sl:R=4", "gather"),
    ("adaptive:c3sl:R=4,min_R=2,ema=0.0 >> bwd:c3sl:R=2", "kernel")])
def test_control_plane_engine_matches_reference_engine(codec, kv_read):
    """Adaptive and link specs on the reference's keys: greedy tokens, every
    integer stat (the wire bytes of the buckets each dispatch really
    served), the served R schedule and the tick count equal the reference
    engine's under the same observe_snr calls; a link serves its forward
    channel (bwd 0); the program sets are made once per bucket."""
    jcfg, tcfg, pj, pt = _weights("plain")
    if ">>" in codec:
        cpj = jtransport.build_link(codec, D=jcfg.d_model).init(jax.random.PRNGKey(3))
    else:
        cpj = jbuild(codec, D=jcfg.d_model).init(jax.random.PRNGKey(3))
    want = _drive_ticks(jengine.BatchedEngine(pj, jcfg, kv_layout="paged",
                                              codec=codec, codec_params=cpj,
                                              **ENGINE_KW),
                        jengine.Request, jcfg.vocab_size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = tengine.BatchedEngine(
            pt, tcfg, kv_layout="paged", kv_read=kv_read, codec=codec,
            codec_params=params_from_numpy(jax.tree.map(np.asarray, cpj), "cpu"),
            **ENGINE_KW)
    programs = dict(eng._programs)
    got = _drive_ticks(eng, tengine.Request, tcfg.vocab_size)
    assert got == want
    assert eng._programs == programs
    ladder = getattr(eng.codec, "ladder", (None,))
    assert sorted(programs, key=str) == sorted(ladder, key=str)
    assert sum(got[2].values()) == (got[1]["decode_steps"] + got[1]["prefill_chunks"]
                                    if eng._adaptive else 0)
    assert got[1]["wire_bytes_bwd"] == 0 and got[1]["wire_bytes_fwd"] > 0
    if ">>" in codec:
        assert eng.link_spec == jtransport.build_link(codec, D=tcfg.d_model).spec()
    else:
        assert len(got[2]) > 1          # the schedule really moved


def test_unported_methods_raise():
    """What this test pinned as refused is ported now: ``attach_sanitizer``
    arms the engine sanitizer (``repro_torch.analysis``), whose checks run
    each tick and leave the tokens as they were, and None detaches it
    (tests/test_torch_sanitize.py holds it against the reference's).
    Withdraw and the stream events answer an idle engine as the
    reference's do."""
    from repro_torch.analysis import EngineSanitizer
    outs = {}
    for armed in (False, True):
        eng = _port_engine("plain", "paged", "gather", "c3sl:R=2|int8")
        san = EngineSanitizer(eng)
        if armed:
            eng.attach_sanitizer(san)
        for u, n in enumerate(LENS):
            eng.submit(tengine.Request(uid=u, prompt=list(range(1, n + 1)),
                                       max_new_tokens=6))
        outs[armed] = {r.uid: r.out for r in eng.run()}
        assert (san.ticks > 0 and min(san.counts.values()) > 0) == armed, \
            san.counts
    assert outs[True] == outs[False]
    eng.attach_sanitizer(None)
    assert eng._sanitizer is None
    idle = _port_engine("plain", "paged", "gather", None)
    assert idle.withdraw(0) is None and idle.pop_stream_events() == []


def test_submit_rejects_what_the_reference_rejects():
    eng = _port_engine("plain", "paged", "gather", None, num_pages=2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(tengine.Request(uid=0, prompt=[]))
    with pytest.raises(ValueError, match="no decode positions"):
        eng.submit(tengine.Request(uid=1, prompt=[1] * 32))
    with pytest.raises(ValueError, match="cache pages"):
        eng.submit(tengine.Request(uid=2, prompt=[1] * 20, max_new_tokens=4))


def test_cache_bytes_match_reference():
    jcfg, tcfg, pj, pt = _weights("int8")
    for layout in ("contiguous", "paged"):
        jeng = jengine.BatchedEngine(pj, jcfg, kv_layout=layout, **ENGINE_KW)
        teng = _port_engine("int8", layout, "gather", None)
        assert teng.cache_bytes == jeng.cache_bytes


# ---------------------------------------------------------------------------
# the serve CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--engine", "--kv-layout", "paged", "--kv-read", "kernel",
     "--requests", "3", "--prompt-len", "6", "--max-new", "3",
     "--chunk-size", "4", "--cache-len", "32", "--codec", "c3sl:R=2"],
    ["--steps", "3", "--cache-len", "16", "--codec", "c3sl:R=2,backend=pallas",
     "--quant-kv"],
    ["--engine", "--requests", "2", "--prompt-len", "5", "--max-new", "2",
     "--chunk-size", "4", "--cache-len", "32", "--codec",
     "adaptive:c3sl:R=2,min_R=1", "--pin-R", "2"],
    ["--steps", "2", "--cache-len", "16", "--codec",
     "adaptive:c3sl:R=2,min_R=1 >> bwd:c3sl:R=2", "--pin-R", "1"]])
def test_serve_cli_runs_on_the_cpu(argv, capsys):
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serve.main(["--arch", "deepseek-7b", "--reduced", "--batch", "2",
                    "--greedy", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "arch=deepseek-7b" in out and "cut-layer wire" in out
    if "--pin-R" in argv and "--engine" in argv:
        assert "served R schedule {2: " in out


def test_serve_cli_pin_R_needs_an_adaptive_codec():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--pin-R needs"):
        serve.main(["--arch", "deepseek-7b", "--reduced", "--batch", "2",
                    "--device", "cpu", "--steps", "1", "--codec", "c3sl:R=2",
                    "--pin-R", "2"])
