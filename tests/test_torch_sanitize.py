"""The port's runtime sanitizer tier (``repro_torch.analysis.sanitize``)
held against the reference's (``repro.analysis.sanitize``) on the CPU.

Both engines run at the reference's ``tiny_engine_factory`` size
(``tests/test_analysis.py``) from the same weights and codec keys: an
armed engine checks the same ticks and counts the same checks as the
reference's, serves the tokens and stats of an unarmed one, and each
planted fault trips in both packages with the reference's message.
``decode_step(..., write=False)`` leaves every cache and state leaf
bitwise as it was, on the attention (paged and contiguous, ring and int8),
MLA, Mamba and RWKV-6 caches, and so does the probe's ``decode_cut``,
whose cut is bitwise the step's.  ``TrainSanitizer`` trips as the
reference's; ``finite_outputs`` (the port of ``checkify_jit``) passes
finite outputs through and names a non-finite one; the train loops leave
autograd's anomaly mode off after an armed run returns and after one
raises; a crash in the front door's tick loop surfaces through
``server.stop()``, as the reference's test holds the reference.

None of these is marked ``sanitize``: the port's checks run on tiny
engines in seconds, and the tier-1 run counts them."""
import asyncio
import functools
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro.analysis import sanitize as jsan  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import codecs as tcodecs  # noqa: E402
from repro_torch import frontdoor as tfd  # noqa: E402
from repro_torch.analysis import sanitize as tsan  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.paging import PagedLayout  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

# the reference's tiny_engine_factory (tests/test_analysis.py)
OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=256,
                 num_heads=4, num_kv_heads=2, head_dim=32)
ENGINE_KW = dict(num_slots=4, max_len=64, kv_layout="paged", page_size=8,
                 num_pages=32, sync_every=2, preemption=True, greedy=True,
                 seed=0)
CODEC = "c3sl:R=2|int8"
PACKAGES = {"port": (tsan, tengine), "reference": (jsan, jengine)}
# the reference's messages, whole (the unmasked probe's with its sum's repr
# left open): both packages must raise exactly these
FAULT_MESSAGES = {
    "dirty_slot": re.escape(
        "[sanitize] empty slot 1 is not inert: active=True done=False pos=0 "
        "out_len=0 — stale device state survived a retire/evict"),
    "leaky_allocator": re.escape(
        "[sanitize] page-pool accounting broken: free 1 + in_use 0 != total "
        "32 — a page leaked or is double-owned"),
    "unmasked_probe": (
        re.escape("[sanitize] live-slot zeroing violated: dead rows "
                  "contribute |cut| sum = ") + r"[0-9.e+-]+" + re.escape(
            " (expected exactly 0.0) to the C3-SL superposition — stale slot "
            "state is leaking into live rows through HRR cross-talk")),
}
# the unmasked probe's dead-row |cut| sum, port against reference: the cut
# is the first superblock's output, float32 in a different order of sums
DEAD_MAG_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, as tests/test_torch_frontdoor.py
    (the suite's parallel workers would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **OVERRIDES)
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **OVERRIDES)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    codec = jcodecs.clamp_R(jcodecs.build(CODEC, D=jcfg.d_model),
                            ENGINE_KW["num_slots"])
    cpj = codec.init(jax.random.PRNGKey(0))
    conv = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jcfg, tcfg, pj, conv(pj), cpj, conv(cpj)


def _engine(package, **over):
    jcfg, tcfg, pj, pt, cpj, cpt = _weights()
    kw = dict(ENGINE_KW, codec=CODEC, **over)
    if package == "port":
        return tengine.BatchedEngine(pt, tcfg, codec_params=cpt, **kw)
    return jengine.BatchedEngine(pj, jcfg, codec_params=cpj, **kw)


def _submit_staggered(eng, package, n=3):
    """The reference's clean run: staggered lengths on 3 of 4 slots, so
    ticks see a dead/live mix and the cut probe runs."""
    req = PACKAGES[package][1].Request
    for i in range(n):
        eng.submit(req(uid=i, prompt=[1 + i, 2, 3, 4], max_new_tokens=4 + 4 * i))


def _drive(eng, how):
    if how == "run":
        return eng.run()
    while eng.tick():
        pass
    return eng.finished


def _bits(t):
    return t.view(torch.uint8) if t.dtype != torch.bool else t


def _bitwise_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y))
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the engine sanitizer against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["run", "tick"])
def test_armed_engine_checks_what_the_reference_checks(how):
    """Ticks and every count equal the reference's on the same requests
    and weights; the armed port engine serves the tokens and stats of an
    unarmed one (the probe writes nothing), and the reference's tokens."""
    got = {}
    for package, (san_lib, _) in PACKAGES.items():
        eng = _engine(package)
        san = san_lib.EngineSanitizer(eng)
        eng.attach_sanitizer(san)
        _submit_staggered(eng, package)
        done = _drive(eng, how)
        got[package] = (san.ticks, dict(san.counts),
                        {r.uid: list(r.out) for r in done})
    assert got["port"] == got["reference"]
    ticks, counts, outs = got["port"]
    assert len(outs) == 3 and all(v > 0 for v in counts.values()), counts
    plain = _engine("port")
    _submit_staggered(plain, "port")
    assert {r.uid: list(r.out) for r in _drive(plain, how)} == outs
    armed = _engine("port")
    armed.attach_sanitizer(tsan.EngineSanitizer(armed))
    _submit_staggered(armed, "port")
    _drive(armed, how)
    keys = ("dispatches", "decode_steps", "prefill_chunks", "wire_bytes_fwd")
    assert {k: armed.stats[k] for k in keys} == {k: plain.stats[k] for k in keys}
    assert armed.pool_accounting() == plain.pool_accounting()


def _mid_decode(package):
    """An armed engine with 2 of its 4 slots decoding (two ticks in)."""
    eng = _engine(package)
    san = PACKAGES[package][0].EngineSanitizer(eng)
    eng.attach_sanitizer(san)
    req = PACKAGES[package][1].Request
    eng.submit(req(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=8))
    eng.submit(req(uid=1, prompt=[5, 6, 7, 8], max_new_tokens=8))
    eng.tick()
    eng.tick()
    return eng, san


def _unmasked_probe(package, eng):
    """The probe built WITHOUT the live mask (the encode before the
    live-slot fix): dead rows reach the cut.  The reference's runs its
    whole decode step, the port's its front half (``decode_cut``)."""
    if package == "reference":
        def probe(params, cache, state):
            liv = state["active"] & ~state["done"]
            _, _, cut = jlm.decode_step(
                params, cache, state["last_tok"][:, None], state["pos"],
                eng.cfg, codec=eng.codec, codec_params=eng.codec_params,
                paged=eng.paged, live=None, return_cut=True)
            dead = (~liv).astype(cut.dtype)[:, None]
            return jnp.sum(jnp.abs(cut) * dead), liv.sum()
        return jax.jit(probe)

    def probe(params, cache, state):
        liv = state["active"] & ~state["done"]
        cut = tlm.decode_cut(params, cache, state["last_tok"][:, None],
                             state["pos"], eng.cfg, paged=eng.paged, live=None)
        dead = (~liv).to(cut.dtype)[:, None]
        return torch.sum(torch.abs(cut) * dead), liv.sum()
    return probe


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("fault", ["dirty_slot", "leaky_allocator",
                                   "unmasked_probe"])
def test_planted_faults_trip_with_the_reference_message(package, fault):
    """The reference's three negative controls, in each package: a dirty
    empty slot, a leaky allocator, and a cut probe built without the live
    mask (which writes nothing either, and the real probe passes on the
    same state); each check passes first where it can."""
    san_lib, mod = PACKAGES[package]
    if fault == "dirty_slot":
        eng = _engine(package)
        san = san_lib.EngineSanitizer(eng)
        eng.submit(mod.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        eng.run()
        san.check_slot_state(eng)              # inert after the drain
        if package == "port":
            eng.state["active"][1] = True       # a broken retire
        else:
            eng.state["active"] = eng.state["active"].at[1].set(True)
        with pytest.raises(san_lib.SanitizerError,
                           match=f"^{FAULT_MESSAGES[fault]}$"):
            san.check_slot_state(eng)
    elif fault == "leaky_allocator":
        eng = _engine(package)
        san = san_lib.EngineSanitizer(eng)
        san.check_pool(eng)

        class LeakyAllocator:
            free_pages = 1               # pages vanished: free+in_use < total

        eng.allocator = LeakyAllocator()
        with pytest.raises(san_lib.SanitizerError,
                           match=f"^{FAULT_MESSAGES[fault]}$"):
            san.check_pool(eng)
    else:
        eng, san = _mid_decode(package)
        before = (tree_map(lambda t: t.clone(), eng.cache)
                  if package == "port" else None)
        if package == "port":
            san._probe = _unmasked_probe(package, eng)
        else:
            san._probes = {None: _unmasked_probe(package, eng)}
        with pytest.raises(san_lib.SanitizerError,
                           match=f"^{FAULT_MESSAGES[fault]}$"):
            san.check_cut_zeroing(eng)
        # and the real probe passes the same check on the same state
        fixed = san_lib.EngineSanitizer(eng)
        fixed.check_cut_zeroing(eng)
        assert fixed.counts["cut_zeroing"] == 1
        if package == "port":
            assert _bitwise_equal(before, eng.cache)


def test_unmasked_probe_dead_rows_agree_with_the_reference():
    """The negative control's dead-row magnitude: nonzero in both packages
    and equal within DEAD_MAG_RTOL."""
    mags = {}
    for package in PACKAGES:
        eng, _ = _mid_decode(package)
        mag, live = _unmasked_probe(package, eng)(eng.params, eng.cache,
                                                  eng.state)
        assert int(live) == 2
        mags[package] = float(mag)
    assert mags["port"] > 0 and mags["reference"] > 0
    assert math.isclose(mags["port"], mags["reference"], rel_tol=DEAD_MAG_RTOL), mags


def test_cut_probe_writes_nothing():
    """One probe on a mid-decode engine: every cache and state leaf is
    bitwise as it was, and the next ticks serve what an unprobed engine
    serves."""
    eng, san = _mid_decode("port")
    cache = tree_map(lambda t: t.clone(), eng.cache)
    state = {k: v.clone() for k, v in eng.state.items()}
    san.check_cut_zeroing(eng)
    assert san.counts["cut_zeroing"] == 3      # the two ticks' and this one
    assert _bitwise_equal(cache, eng.cache) and _bitwise_equal(state, eng.state)
    eng.attach_sanitizer(None)
    plain = _engine("port")
    plain.submit(tengine.Request(uid=0, prompt=[1, 2, 3, 4], max_new_tokens=8))
    plain.submit(tengine.Request(uid=1, prompt=[5, 6, 7, 8], max_new_tokens=8))
    want = {r.uid: r.out for r in _drive(plain, "tick")}
    assert {r.uid: r.out for r in _drive(eng, "tick")} == want


# ---------------------------------------------------------------------------
# decode_step(write=False), port against port
# ---------------------------------------------------------------------------

B, T, PS = 4, 32, 8
NO_WRITE_CASES = {
    "attn-contiguous": ("deepseek-7b", False, {}),
    "attn-paged": ("deepseek-7b", True, {}),
    "attn-ring-paged": ("deepseek-7b", True, {"sliding_window": 8}),
    "attn-int8-contiguous": ("deepseek-7b", False, {"kv_cache_quant": True}),
    "mla-contiguous": ("deepseek-v2-lite-16b", False, {}),
    "mla-paged": ("deepseek-v2-lite-16b", True, {}),
    "mamba-paged": ("jamba-1.5-large-398b", True, {}),
    "rwkv6-contiguous": ("rwkv6-1.6b", False, {}),
}


def _no_write_setup(arch, paged, over):
    cfg = tconfigs.reduced(tconfigs.get_config(arch), d_model=64, num_heads=2,
                           head_dim=32, d_ff=128, vocab_size=64, **over)
    params = tlm.init_lm_params(0, cfg, device="cpu")
    layout = None
    if paged:
        swa = min(T, cfg.sliding_window) if cfg.sliding_window else 0
        layout = PagedLayout(PS, T, B * (T // PS), swa,
                             B * (-(-swa // PS)) if swa else 0)
    cache = tlm.init_decode_cache(params, cfg, B, T, paged=layout)
    if paged:
        table = torch.randperm(B * (T // PS), generator=torch.Generator()
                               .manual_seed(1)).reshape(B, -1).to(torch.int32)
        # slot 0 writes position 11 into page 0; slot 2 holds no pages, so
        # its table reads page 0 too: the no-write read must see the row
        table[table == 0] = table[0, 1]
        table[0, 1] = 0
        table[2] = 0
        cache["pages"] = table
        if layout.len_swa:
            cache["pages_swa"] = torch.arange(
                B * layout.pages_per_slot_swa,
                dtype=torch.int32).reshape(B, -1)
    return cfg, params, layout, cache


@pytest.mark.parametrize("case", list(NO_WRITE_CASES))
def test_decode_step_without_write(case):
    """After 11 steps that fill the cache, one step with ``write=False``
    leaves every cache and state leaf bitwise as it was and gives the
    logits and cut of the same step with ``write=True``, bitwise; so does
    ``decode_cut`` (the probe's front half) for the cut."""
    arch, paged, over = NO_WRITE_CASES[case]
    cfg, params, layout, cache = _no_write_setup(arch, paged, over)
    codec = tcodecs.build("c3sl:R=2", D=cfg.d_model)
    cp = codec.init(torch.Generator().manual_seed(3), device="cpu")
    kw = dict(codec=codec, codec_params=cp, paged=layout)
    gen = torch.Generator().manual_seed(5)
    pos = torch.zeros(B, dtype=torch.int32)
    filling = torch.tensor([True, True, False, True])
    for _ in range(11):
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
        tlm.decode_step(params, cache, tok, pos, cfg, live=filling, **kw)
        pos = pos + filling.to(torch.int32)
    live = torch.tensor([True, False, False, True])
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    before = tree_map(lambda t: t.clone(), cache)
    got = tlm.decode_step(params, cache, tok, pos, cfg, live=live,
                          return_cut=True, write=False, **kw)
    assert _bitwise_equal(before, cache)
    front = tlm.decode_cut(params, cache, tok, pos, cfg, paged=layout, live=live)
    assert _bitwise_equal(before, cache)
    want = tlm.decode_step(params, cache, tok, pos, cfg, live=live,
                           return_cut=True, **kw)
    assert not _bitwise_equal(before, cache)      # the write path writes
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(front, want[2])


def test_decode_step_without_write_refuses_the_kernel_read():
    cfg, params, layout, cache = _no_write_setup("deepseek-7b", True, {})
    tok = torch.zeros((B, 1), dtype=torch.long)
    pos = torch.full((B,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="write=False reads through"):
        tlm.decode_step(params, cache, tok, pos, cfg, paged=layout,
                        kv_read="kernel", write=False)


# ---------------------------------------------------------------------------
# the train-side sanitizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_train_sanitizer_trips_as_the_reference(bad):
    msgs = {}
    for package, (san_lib, _) in PACKAGES.items():
        ts = san_lib.TrainSanitizer()
        ts.check_step(0, loss=1.25, gnorm=0.5)
        assert ts.steps_checked == 1
        with pytest.raises(san_lib.SanitizerError, match="loss") as err:
            ts.check_step(1, loss=bad, gnorm=0.5)
        assert ts.steps_checked == 1
        msgs[package] = str(err.value)
    assert msgs["port"] == msgs["reference"]


def test_finite_outputs_passes_through_and_names_the_leaf():
    x = {"w": torch.ones(3), "n": torch.arange(3)}

    def step(params, scale):
        return {"params": params, "grads": [params["w"] * scale]}, scale

    checked = tsan.finite_outputs(step)
    out, scale = checked(x, 2.0)
    assert out["params"] is x and scale == 2.0
    assert torch.equal(out["grads"][0], torch.full((3,), 2.0))
    for bad in (float("nan"), float("inf")):
        with pytest.raises(tsan.SanitizerError,
                           match=r"step\(\) output\[0\]\['grads'\]\[0\] holds NaN or inf"):
            checked(x, bad)


def test_finite_outputs_trips_where_checkify_jit_trips():
    """The reference's checkify_jit test function: log(-1) is NaN."""
    from jax.experimental import checkify
    jfn = jsan.checkify_jit(lambda x: jnp.log(x))
    tfn = tsan.finite_outputs(lambda x: torch.log(x))
    assert float(jfn(jnp.float32(1.0))) == float(tfn(torch.tensor(1.0))) == 0.0
    with pytest.raises(checkify.JaxRuntimeError):
        jfn(jnp.float32(-1.0))
    with pytest.raises(tsan.SanitizerError, match="output holds NaN"):
        tfn(torch.tensor(-1.0))


def test_finite_outputs_names_the_input_under_anomaly_mode():
    def step(params):
        # sqrt(-1): NaN in the forward and in SqrtBackward0's output
        loss = (params["a"] * params["b"]).sqrt().sum()
        return torch.autograd.grad(loss, [params["a"]])[0]

    params = {"a": torch.ones(4, requires_grad=True),
              "b": torch.tensor([1.0, -1.0, 2.0, 3.0])}
    with pytest.raises(tsan.SanitizerError,
                       match=r"step 7: step\(\) inputs are finite — "
                             r"autograd's anomaly check tripped: "
                             r"SqrtBackward0 returned nan"):
        with tsan.TrainSanitizer().step_scope(7):
            tsan.finite_outputs(step)(params)
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# the front door surfaces a sanitizer trip in its tick loop
# ---------------------------------------------------------------------------

def test_frontdoor_surfaces_tick_loop_crash():
    """The reference's test against the port's server: an engine
    exception inside the auto-tick loop is recorded, cancels the
    connections and surfaces through ``server.stop()``.  The pending call
    fails: in both packages the client reconnects after the cancel and
    waits out the call's timeout (the reference's test gives it 30 s; 5
    here)."""
    eng = _engine("port")

    class TrippingSanitizer:
        def on_tick(self, engine):
            raise tsan.SanitizerError("injected invariant trip")

    eng.attach_sanitizer(TrippingSanitizer())
    server = tfd.FrontDoorServer(
        eng, admission=tfd.AdmissionController(
            max_queue_depth=8, default_policy=tfd.TenantPolicy(max_inflight=2)))

    async def go():
        host, port = await server.start()
        client = await tfd.FrontDoorClient.open(host, port, tenant="t",
                                                codec=CODEC)
        try:
            with pytest.raises(Exception):
                await asyncio.wait_for(client.generate([1, 2, 3], max_new=4),
                                       timeout=5)
        finally:
            try:
                await client.close()
            except Exception:
                pass
        assert isinstance(server.tick_error, tsan.SanitizerError)
        with pytest.raises(tsan.SanitizerError, match="injected"):
            await server.stop()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# the train loops under --sanitize
# ---------------------------------------------------------------------------

def _train_args(pipeline, sanitize):
    argv = ["--reduced", "--steps", "2", "--batch", "8", "--seq", "16",
            "--device", "cpu", "--codec", "c3sl:R=2", "--log-every", "1"]
    if pipeline:
        argv += ["--pipeline", "--microbatches", "2"]
    if sanitize:
        argv.append("--sanitize")
    return ttrain.build_parser().parse_args(argv)


@pytest.mark.parametrize("pipeline", [False, True])
def test_nan_parameter_trips_naming_step_and_leaf(pipeline, capsys):
    """A parameter set to NaN: the armed step raises ``SanitizerError``
    naming step 0 and the leaf, and anomaly mode is off again after it;
    an armed run from the same seed gives the unarmed run's losses,
    bitwise, with every step checked."""
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    run = ttrain.run_pipeline if pipeline else ttrain.run_standard
    losses, out = {}, {}
    for armed in (False, True):
        losses[armed] = run(_train_args(pipeline, armed), cfg,
                            out=out if armed else None)
        assert not torch.is_anomaly_enabled()
    assert losses[True] == losses[False]
    assert out["train_sanitizer"].steps_checked == 2
    params = tlm.init_lm_params(0, cfg, device="cpu")
    params["stack"]["l0_0_attn"]["w_q"][0, 0, 0] = float("nan")
    leaf = "blocks" if pipeline else "stack"
    with pytest.raises(tsan.SanitizerError,
                       match=rf"\[sanitize\] step 0: step\(\) input "
                             rf"params\['{leaf}'\]\['l0_0_attn'\]\['w_q'\] "
                             r"is not finite"):
        run(_train_args(pipeline, True), cfg, params=params)
    assert not torch.is_anomaly_enabled()
    assert "[sanitize] autograd anomaly mode" in capsys.readouterr().out


def test_serve_cli_engine_sanitize_checks_every_tick(capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", "deepseek-7b", "--reduced", "--engine", "--device",
                 "cpu", "--kv-layout", "paged", "--codec", "c3sl:R=2|int8",
                 "--requests", "3", "--prompt-len", "8", "--max-new", "6",
                 "--batch", "4", "--sync-every", "2", "--greedy",
                 "--sanitize"])
    out = capsys.readouterr().out
    assert "[sanitize] per-tick engine invariant checks armed" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("[sanitize] ") and "cut-zeroing 0)" not in last, last
