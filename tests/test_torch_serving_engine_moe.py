"""The port's continuous-batching engine on the attention-cache families,
held against the reference engine on the same weights and codec keys:
reduced ``phi3.5-moe-42b-a6.6b`` (GQA + MoE; contiguous, paged gather and
paged kernel read, with and without the codec) and reduced
``deepseek-v2-lite-16b`` (MLA + MoE + a dense first superblock; contiguous
and paged gather).  Greedy outputs token for token, the integer stats and
the pool accounting exactly.

Also the four engine paths an MLA or first-dense model takes: the
full-length page pool backs MLA latents (``_linear_backed``), the reset of
a recycled slot is layout-aware by key (``first`` has no superblock axis),
the kernel read's warning names what the reference names, and a bfloat16
MLA model is served, or refused, as the reference serves or refuses it;
``cache_bytes`` and the serve CLI on the CPU."""
import dataclasses
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

PHI, DSV2 = "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"
STAT_KEYS = ("dispatches", "decode_steps", "prefill_chunks",
             "payload_wire_bytes", "wire_bytes_fwd", "wire_bytes_bwd")
# prompt lengths straddle the page boundary (8); 6 requests on 4 slots, so
# slots recycle mid-flight and a freed page set is reallocated
LENS = [7, 8, 9, 3, 12, 5]
MAX_NEW = 6
ENGINE_KW = dict(num_slots=4, max_len=32, chunk_size=8, sync_every=4,
                 page_size=8, greedy=True, seed=0)
# bfloat16 weights: greedy tokens equal up to an argmax flip (the rule of
# tests/test_torch_serving_engine.py)
BF16_PREFIX = 3       # leading tokens every request must share
BF16_SHARE = 0.75     # share of all generated tokens that must be equal


def _cfgs(arch, **over):
    return (jconfigs.reduced(jconfigs.get_config(arch), **over),
            tconfigs.reduced(tconfigs.get_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32"):
    """The reference's params of the reduced arch and the port's copy,
    built once for the module."""
    jcfg, tcfg = _cfgs(arch)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg,
                            dtype=getattr(jnp, dtype))
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
def _reference_run(arch, kv_layout, codec, dtype="float32"):
    """The reference engine's run.  Its paged and contiguous runs give the
    same tokens and stats (tests/test_paged_cache.py pins that), so the
    contiguous one is read from the paged run, with the contiguous
    layout's empty pool accounting."""
    if kv_layout == "contiguous":
        outs, stats, _ = _reference_run(arch, "paged", codec, dtype)
        return outs, stats, {"free": 0, "in_use": 0, "total": 0}
    jcfg, _, pj, _ = _weights(arch, dtype)
    cpj, _ = _codec_params(codec, jcfg.d_model)
    eng = jengine.BatchedEngine(pj, jcfg, kv_layout=kv_layout,
                                codec=codec or "none", codec_params=cpj,
                                **ENGINE_KW)
    return _drive(eng, jengine.Request, jcfg.vocab_size)


def _port_engine(arch, kv_layout, kv_read, codec, dtype="float32", **over):
    jcfg, tcfg, _, pt = _weights(arch, dtype)
    _, cpt = _codec_params(codec, jcfg.d_model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the kernel read warns by design
        return tengine.BatchedEngine(pt, tcfg, kv_layout=kv_layout,
                                     kv_read=kv_read, codec=codec or "none",
                                     codec_params=cpt, **dict(ENGINE_KW, **over))


@pytest.mark.parametrize("arch,kv_layout,kv_read", [
    (PHI, "contiguous", "gather"), (PHI, "paged", "gather"),
    (PHI, "paged", "kernel"), (DSV2, "contiguous", "gather"),
    (DSV2, "paged", "gather")])
@pytest.mark.parametrize("codec", [None, "c3sl:R=2"])
def test_engine_matches_reference_engine(arch, kv_layout, kv_read, codec):
    """The reference's kernel read is bit-identical to its gather read, so
    the port's kernel read is held against the reference's paged gather
    run.  deepseek-v2-lite-16b has no attn sublayer: its paged run reads
    the latents by the gather, with pages drawn from the pool."""
    want = _reference_run(arch, kv_layout, codec)
    eng = _port_engine(arch, kv_layout, kv_read, codec)
    got = _drive(eng, tengine.Request, eng.cfg.vocab_size)
    assert got == want
    outs, _, pool = got
    assert len(outs) == len(LENS) and all(len(o) == MAX_NEW for o in outs.values())
    if kv_layout == "paged":
        assert pool["total"] == ENGINE_KW["num_slots"] * 4 == pool["free"]


# ---------------------------------------------------------------------------
# the engine paths an MLA or first-dense model takes
# ---------------------------------------------------------------------------

def test_mla_draws_pages_from_the_pool_like_the_reference():
    """MLA latents live in the full-length pool, so admission allocates each
    slot's pages (the reference's ``_linear_backed`` counts ``mla``):
    after the first boundary the page tables and the pool equal the
    reference's, and no two slots share a page."""
    jcfg, tcfg, pj, pt = _weights(DSV2)
    jeng = jengine.BatchedEngine(pj, jcfg, kv_layout="paged", **ENGINE_KW)
    teng = _port_engine(DSV2, "paged", "gather", None)
    assert jeng._linear_backed and teng._linear_backed
    for eng, req in ((jeng, jengine.Request), (teng, tengine.Request)):
        for uid, p in enumerate(_prompts(jcfg.vocab_size)):
            eng.submit(req(uid=uid, prompt=list(p), max_new_tokens=MAX_NEW))
    jeng._boundary()
    teng._boundary()
    np.testing.assert_array_equal(teng._table, jeng._table)
    assert teng.pool_accounting() == jeng.pool_accounting()
    owned = [p for s in teng.slots for p in s.pages]
    assert owned and len(owned) == len(set(owned))
    np.testing.assert_array_equal(teng.cache["pages"].numpy(), teng._table)


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_reset_rows_is_layout_aware_like_the_reference(kv_layout):
    """The reference's regression (tests/test_serving_engine.py,
    test_reset_slot_cache_is_layout_aware): with max_len == num_slots the
    unstacked first-dense leaf (B, T, ...) has shape[1] == num_slots, and a
    reset guessed from the shape would clear cache POSITION 0 across every
    slot.  The port's reset clears slot 0's rows of "first" and of the
    stack, leaves the others, and leaves paged pools alone, as the
    reference's does."""
    jcfg, tcfg, pj, pt = _weights(DSV2)
    n = 8
    kw = dict(num_slots=n, max_len=n, page_size=4, kv_layout=kv_layout)
    jeng = jengine.BatchedEngine(pj, jcfg, **kw)
    teng = tengine.BatchedEngine(pt, tcfg, **kw)
    jeng.cache = jax.tree.map(jnp.ones_like, jeng.cache)
    for leaf in tree_leaves(teng.cache):
        leaf.fill_(1)
    jeng._reset_slot_cache(0)
    teng._reset_rows([0])
    for g, w in zip(tree_leaves(teng.cache), jax.tree.leaves(jeng.cache)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    first = teng.cache["first"]["l0_0_mla"]["c_kv"]
    stacked = teng.cache["stack"]["l0_0_mla"]["c_kv"]
    if kv_layout == "contiguous":
        assert first.shape[:2] == (n, n)                    # (B, T, L), T == B
        assert first[0].max() == 0 and first[1:].min() == 1
        assert stacked[:, 0].max() == 0 and stacked[:, 1:].min() == 1
    else:
        assert first.min() == stacked.min() == 1


def _warning_cfgs():
    """Configs whose kv_read='kernel' warning names each fallback: attn with
    a first-dense superblock (phi3.5-moe-42b-a6.6b's pattern), and attn
    beside mla with one (deepseek-v2-lite-16b's, with an attn layer)."""
    both = (("attn", "moe"), ("mla", "moe"))
    return [_cfgs(PHI, first_dense_layers=1, num_layers=3),
            _cfgs(DSV2, block_pattern=both, num_layers=5)]


@pytest.mark.parametrize("which", [0, 1])
def test_kernel_read_warning_names_what_the_reference_names(which):
    jcfg, tcfg = _warning_cfgs()[which]
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    kw = dict(ENGINE_KW, kv_layout="paged", kv_read="kernel")
    with pytest.warns(UserWarning) as want:
        jengine.BatchedEngine(pj, jcfg, **kw)
    with pytest.warns(UserWarning) as got:
        tengine.BatchedEngine(pt, tcfg, **kw)
    want = [str(w.message) for w in want if "kv_read" in str(w.message)]
    got = [str(w.message) for w in got]
    assert got == want and len(got) == 1
    assert "the unstacked first-dense superblock" in got[0]
    assert ("MLA latent reads" in got[0]) == (which == 1)


def test_kernel_read_without_attn_raises_in_both():
    """deepseek-v2-lite-16b has no attn sublayer: the kernel would read
    nothing, so both engines refuse kv_read='kernel'."""
    jcfg, tcfg, pj, pt = _weights(DSV2)
    kw = dict(ENGINE_KW, kv_layout="paged", kv_read="kernel")
    with pytest.raises(ValueError, match="no attn sublayer"):
        jengine.BatchedEngine(pj, jcfg, **kw)
    with pytest.raises(ValueError, match="no attn sublayer"):
        tengine.BatchedEngine(pt, tcfg, **kw)


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_bf16_mla_model_serves_like_the_reference(kv_layout):
    """bfloat16 deepseek-v2-lite-16b over the float32 latent cache: the
    reference serves it (the first-dense superblock's MLA read promotes the
    residual stream to float32 ahead of the scan over superblocks), so the
    port serves it too, promoting as JAX does.  Integer stats and the pool
    exact, tokens under the bfloat16 rule."""
    want_out, want_stats, want_pool = _reference_run(DSV2, kv_layout, None,
                                                     "bfloat16")
    eng = _port_engine(DSV2, kv_layout, "gather", None, "bfloat16")
    assert eng.params["embed"].dtype == torch.bfloat16
    assert eng.cache["first"]["l0_0_mla"]["c_kv"].dtype == torch.float32
    out, stats, pool = _drive(eng, tengine.Request, eng.cfg.vocab_size)
    assert stats == want_stats and pool == want_pool
    assert all(len(out[u]) == len(want_out[u]) == MAX_NEW for u in want_out)
    assert all(out[u][:BF16_PREFIX] == want_out[u][:BF16_PREFIX] for u in want_out)
    same = sum(a == b for u in want_out for a, b in zip(out[u], want_out[u]))
    assert same >= BF16_SHARE * MAX_NEW * len(LENS), same


def test_bf16_mla_model_without_first_dense_raises_like_the_reference():
    """Without the first-dense superblock the stacked MLA read changes the
    stream's dtype inside the reference's scan, which it rejects on the
    first prefill; the port's serving stack raises the same TypeError at
    the same call."""
    jcfg, tcfg, pj, pt = _weights(DSV2, "bfloat16")
    over = dict(first_dense_layers=0, num_layers=2)
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
    pj = {k: v for k, v in pj.items() if k != "first"}
    pt = {k: v for k, v in pt.items() if k != "first"}
    for mod, p, cfg in ((jengine, pj, jcfg), (tengine, pt, tcfg)):
        eng = mod.BatchedEngine(p, cfg, kv_layout="paged", **ENGINE_KW)
        eng.submit(mod.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        with pytest.raises(TypeError, match="carry"):
            eng.run()


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_cache_bytes_match_reference(arch):
    """The resident cache bytes, "first" and the page tables included."""
    jcfg, _, pj, _ = _weights(arch)
    for layout in ("contiguous", "paged"):
        jeng = jengine.BatchedEngine(pj, jcfg, kv_layout=layout, **ENGINE_KW)
        teng = _port_engine(arch, layout, "gather", None)
        assert teng.cache_bytes == jeng.cache_bytes


# ---------------------------------------------------------------------------
# the serve CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [PHI, DSV2])
@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_serve_cli_runs_on_the_cpu(arch, kv_layout, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--greedy",
                "--device", "cpu", "--engine", "--kv-layout", kv_layout,
                "--requests", "3", "--prompt-len", "6", "--max-new", "3",
                "--chunk-size", "4", "--cache-len", "32", "--codec", "c3sl:R=2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and f"kv={kv_layout}" in out
    assert "cut-layer wire" in out and "3 requests" in out
    assert ("paged pool" in out) == (kv_layout == "paged")
