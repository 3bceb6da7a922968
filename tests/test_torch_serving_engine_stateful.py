"""The port's continuous-batching engine on the recurrent families, held
against the reference engine on the same weights and codec keys: reduced
``jamba-1.5-large-398b`` (hybrid: Mamba + one attn layer a superblock + MoE;
contiguous, paged gather and paged kernel read) and reduced ``rwkv6-1.6b``
(SSM: no attn, no pages), with and without the codec, over ragged prompts
that recycle slots mid-flight.  Greedy outputs token for token, the integer
stats and the pool accounting exactly.

Also: a recycled slot's Mamba and RWKV state is zeroed as the reference's
reset zeroes it; an RWKV-6 engine draws no page on either layout, as the
reference's draws none; a bfloat16 model over the float32 state is refused
by both engines at the first dispatch with the same ``TypeError``;
``cache_bytes``; and the serve CLI's engine on the CPU."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the suite's parallel workers torch's intra-op threads
    oversubscribe the cores, so this module runs on one (on an 8-core
    CPU, this file and `test_torch_lm_train_families.py` on six
    workers took 371 s at the default thread count, 85 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-1.6b"
STAT_KEYS = ("dispatches", "decode_steps", "prefill_chunks",
             "payload_wire_bytes", "wire_bytes_fwd", "wire_bytes_bwd")
# prompt lengths straddle the page boundary (8); 6 requests on 4 slots, so
# slots recycle mid-flight (their recurrent state must start from zero)
LENS = [7, 8, 9, 3, 12, 5]
MAX_NEW = 6
ENGINE_KW = dict(num_slots=4, max_len=32, chunk_size=8, sync_every=4,
                 page_size=8, greedy=True, seed=0)


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32"):
    """The reduced arch's reference params and the port's copy, built once
    for the module."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg, dtype=getattr(jnp, dtype))
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


def _drive(eng, req_cls, vocab):
    for uid, p in enumerate(_prompts(vocab)):
        eng.submit(req_cls(uid=uid, prompt=list(p), max_new_tokens=MAX_NEW))
    outs = {r.uid: r.out for r in eng.run()}
    return outs, {k: eng.stats[k] for k in STAT_KEYS}, eng.pool_accounting()


@functools.lru_cache(maxsize=None)
def _reference_run(arch, kv_layout, codec):
    """The reference engine's run.  Its paged and contiguous runs give the
    same tokens and stats (tests/test_paged_cache.py pins that for attn;
    a recurrent state is the same on both layouts), so the contiguous one
    is read from the paged run, with the contiguous layout's empty pool
    accounting."""
    if kv_layout == "contiguous":
        outs, stats, _ = _reference_run(arch, "paged", codec)
        return outs, stats, {"free": 0, "in_use": 0, "total": 0}
    jcfg, _, pj, _ = _weights(arch)
    cpj, _ = _codec_params(codec, jcfg.d_model)
    eng = jengine.BatchedEngine(pj, jcfg, kv_layout=kv_layout,
                                codec=codec or "none", codec_params=cpj,
                                **ENGINE_KW)
    return _drive(eng, jengine.Request, jcfg.vocab_size)


def _port_engine(arch, kv_layout, kv_read, codec, **over):
    jcfg, tcfg, _, pt = _weights(arch)
    _, cpt = _codec_params(codec, jcfg.d_model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the kernel read warns by design
        return tengine.BatchedEngine(pt, tcfg, kv_layout=kv_layout,
                                     kv_read=kv_read, codec=codec or "none",
                                     codec_params=cpt, **dict(ENGINE_KW, **over))


@pytest.mark.parametrize("arch,kv_layout,kv_read", [
    (JAMBA, "contiguous", "gather"), (JAMBA, "paged", "gather"),
    (JAMBA, "paged", "kernel"), (RWKV, "contiguous", "gather"),
    (RWKV, "paged", "gather")])
@pytest.mark.parametrize("codec", [None, "c3sl:R=2"])
def test_engine_matches_reference_engine(arch, kv_layout, kv_read, codec):
    """The reference's kernel read is bit-identical to its gather read, so
    the port's kernel read (its plain version here) is held against the
    reference's paged gather run.  A paged jamba engine ends with every
    page back in its pool; a paged rwkv6 engine never draws one."""
    want = _reference_run(arch, kv_layout, codec)
    eng = _port_engine(arch, kv_layout, kv_read, codec)
    got = _drive(eng, tengine.Request, eng.cfg.vocab_size)
    assert got == want
    outs, _, pool = got
    assert len(outs) == len(LENS) and all(len(o) == MAX_NEW for o in outs.values())
    if kv_layout == "paged":
        assert pool == {"free": ENGINE_KW["num_slots"] * 4, "in_use": 0,
                        "total": ENGINE_KW["num_slots"] * 4}


def test_rwkv_draws_no_pages_like_the_reference():
    """RWKV-6 has no attn or mla sublayer, so no cache leaf is backed by
    the full-length pool: with every slot admitted, the page tables stay
    zero and the pool full, in both engines."""
    jcfg, tcfg, pj, pt = _weights(RWKV)
    jeng = jengine.BatchedEngine(pj, jcfg, kv_layout="paged", **ENGINE_KW)
    teng = _port_engine(RWKV, "paged", "gather", None)
    assert not jeng._linear_backed and not teng._linear_backed
    for eng, req in ((jeng, jengine.Request), (teng, tengine.Request)):
        for uid, p in enumerate(_prompts(jcfg.vocab_size)):
            eng.submit(req(uid=uid, prompt=list(p), max_new_tokens=MAX_NEW))
    jeng._boundary()
    teng._boundary()
    assert teng.active == jeng.active == ENGINE_KW["num_slots"]
    assert not teng._table.any() and not np.asarray(jeng._table).any()
    assert teng.pool_accounting() == jeng.pool_accounting() == {
        "free": 16, "in_use": 0, "total": 16}
    assert all(s.pages == [] for s in teng.slots)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_recycled_slot_state_is_zeroed_like_the_reference(arch, kv_layout):
    """The reference's reset zeroes a recycled slot's per-slot rows of the
    stack (axis 1), the Mamba and RWKV state among them, and leaves paged
    pools alone; the port's reset leaves exactly the same cache."""
    jcfg, tcfg, pj, pt = _weights(arch)
    kw = dict(num_slots=4, max_len=16, page_size=4, kv_layout=kv_layout)
    jeng = jengine.BatchedEngine(pj, jcfg, **kw)
    teng = tengine.BatchedEngine(pt, tcfg, **kw)
    jeng.cache = jax.tree.map(jnp.ones_like, jeng.cache)
    for leaf in tree_leaves(teng.cache):
        leaf.fill_(1)
    mask = np.array([False, True, False, True])
    jeng.cache = jeng._reset(jeng.cache, jnp.asarray(mask))
    teng._reset_rows([1, 3])
    for g, w in zip(tree_leaves(teng.cache), jax.tree.leaves(jeng.cache)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    state = [t for k, sub in teng.cache["stack"].items()
             if not k.endswith("attn") for t in tree_leaves(sub)]
    assert state and all(t[:, mask].max() == 0 and t[:, ~mask].min() == 1
                         for t in state)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_bf16_model_over_float_state_raises_like_the_reference(arch):
    """Both engines keep the recurrent state (and the attn cache) in
    float32 whatever the weights' dtype.  Reading it promotes a bfloat16
    model's residual stream to float32 inside the first superblock, which
    the reference's scan over superblocks rejects at the first dispatch;
    the port's serving stack raises the same ``TypeError`` there.  The
    port raises after superblock 0 has written its state in place (the
    reference before any write), so its cache is partly advanced; neither
    engine can go on: a second ``run()`` raises the same error again."""
    jcfg, tcfg, pj, pt = _weights(arch, "bfloat16")
    kw = dict(num_slots=2, max_len=16, chunk_size=4)
    for mod, p, cfg in ((jengine, pj, jcfg), (tengine, pt, tcfg)):
        eng = mod.BatchedEngine(p, cfg, **kw)
        eng.submit(mod.Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
        for _ in range(2):
            with pytest.raises(TypeError, match="carry input and carry output "
                                                "must have equal types"):
                eng.run()
        if mod is tengine:
            assert any(bool(leaf.ne(0).any())
                       for leaf in tree_leaves(eng.cache["stack"]))
    assert pt["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_cache_bytes_match_reference(arch):
    """The resident cache bytes: the recurrent state, the attn cache and
    the page tables."""
    jcfg, _, pj, _ = _weights(arch)
    for layout in ("contiguous", "paged"):
        jeng = jengine.BatchedEngine(pj, jcfg, kv_layout=layout, **ENGINE_KW)
        teng = _port_engine(arch, layout, "gather", None)
        assert teng.cache_bytes == jeng.cache_bytes


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--greedy",
                "--device", "cpu", "--engine", "--kv-layout", "paged",
                "--requests", "3", "--prompt-len", "6", "--max-new", "3",
                "--chunk-size", "4", "--cache-len", "32", "--codec", "c3sl:R=2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "kv=paged" in out
    assert "cut-layer wire" in out and "3 requests" in out
