"""The port's serving model (configs, layers, GQA decode/prefill on both cache
layouts, decode_step / prefill_chunk with and without the C3-SL codec) held
against the JAX reference on the same weights, codec keys and inputs.
Weights come from the reference's ``init_lm_params`` through numpy; inputs
from numpy seeds.  Sizes are ``reduced(get_config("deepseek-7b"))`` with the
overrides of tests/test_paged_kernel.py."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro_torch.codecs import build as tbuild  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402

# float32 on both sides; the sums run in another order on XLA:CPU and in
# PyTorch, so activations agree to a few ulps per layer
LOGIT_TOL = 2e-5         # max |logit difference| / max |logit|
LEAF_TOL = 1e-5          # float cache leaves, absolute + relative
INT8_FLIP_SHARE = 0.002  # int8 cache entries allowed to differ (by 1 only)

OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                 num_heads=4, num_kv_heads=2, head_dim=32)


# the other dense archs the port serves, as variants of their own: qkv
# bias; qkv bias with partial rotary 0.5; GQA with rope theta 1e6
DENSE_ARCHS = ("qwen2.5-32b", "chatglm3-6b", "mistral-large-123b")


def _cfgs(variant, **more):
    """(reference config, port config) of one variant."""
    over = dict(OVERRIDES, **more)
    arch = variant if variant in DENSE_ARCHS else "deepseek-7b"
    if variant == "swa":
        over["sliding_window"] = 8
    elif variant == "int8":
        over["kv_cache_quant"] = True
    j = jconfigs.reduced(jconfigs.get_config(arch), **over)
    t = tconfigs.reduced(tconfigs.get_config(arch), **over)
    return j, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(variant):
    """Reference params (qkv biases, where the arch has them, set to
    nonzero numpy draws so that they count) and the port's copy."""
    jcfg, tcfg = _cfgs(variant)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    pj = jax.tree_util.tree_map_with_path(
        lambda k, v: jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
        if jax.tree_util.keystr(k).endswith(("'b_q']", "'b_k']", "'b_v']")) else v,
        pj)
    return jcfg, tcfg, pj, params_from_numpy(_np_tree(pj), device="cpu")


# ---------------------------------------------------------------------------
# configs, params and cache trees
# ---------------------------------------------------------------------------

def test_arch_registry_matches_reference():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    for name in jconfigs.list_configs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert dataclasses.asdict(tconfigs.reduced(t)) == \
            dataclasses.asdict(jconfigs.reduced(j))
        assert (t.num_superblocks, t.rotary_dim, t.head_dim_) == \
            (j.num_superblocks, j.rotary_dim, j.head_dim_)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("variant", ["plain", "int8"])
def test_params_and_cache_trees_carry_across(variant):
    """The reference's params and paged decode cache (with its int8 leaves
    and page tables) convert key path for key path, and the port's own
    init builds the same tree, shapes and dtypes."""
    jcfg, tcfg, pj, pt = _params(variant)
    own = tlm.init_lm_params(0, tcfg, device="cpu")
    flat = lambda tr: sorted(  # noqa: E731
        (jax.tree_util.keystr(k), tuple(np.shape(v)), str(np.asarray(v).dtype))
        for k, v in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x), tr)))
    assert flat(own) == flat(_np_tree(pj)) == flat(pt)
    layout = (jpaging.PagedLayout(8, 32, 16), tpaging.PagedLayout(8, 32, 16))
    cj = jlm.init_decode_cache(pj, jcfg, 4, 32, paged=layout[0])
    ct = tlm.init_decode_cache(own, tcfg, 4, 32, paged=layout[1])
    assert flat(ct) == flat(_np_tree(cj)) == \
        flat(params_from_numpy(_np_tree(cj), device="cpu"))
    assert own["stack"]["l0_0_attn"]["w_q"].device.type == "cpu"


def test_unported_features_raise():
    for arch in ("jamba-1.5-large-398b", "deepseek-v2-lite-16b",
                 "seamless-m4t-large-v2", "pixtral-12b"):
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        with pytest.raises(NotImplementedError, match="ROADMAP.md slice"):
            tlm.init_lm_params(0, cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_mlp_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    s, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        tlayers.rms_norm(T(x), T(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.layer_norm(T(x), T(s), T(b)).numpy(),
        np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                      jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    xb = T(x).bfloat16()
    assert tlayers.rms_norm(xb, T(s)).dtype == torch.bfloat16
    for gated in (True, False):
        p = jlayers.init_mlp(jax.random.PRNGKey(1), 64, 96, gated)
        want = jlayers.apply_mlp(p, jnp.asarray(x))
        got = tlayers.apply_mlp(params_from_numpy(_np_tree(p), "cpu"), T(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5])
def test_rope_matches_reference(rotary_frac):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 32).astype(np.float32)
    pos = rng.randint(0, 512, (2, 6)).astype(np.int32)
    rd = int(32 * rotary_frac)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rd)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), rd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if rotary_frac < 1:   # the pass-through half is untouched
        np.testing.assert_array_equal(got[..., rd:].numpy(), x[..., rd:])


# ---------------------------------------------------------------------------
# GQA decode / prefill on both cache layouts
# ---------------------------------------------------------------------------

def _assert_cache(got, want, what):
    """Float leaves within LEAF_TOL; int8 leaves differ by at most 1, on at
    most INT8_FLIP_SHARE of the entries (a rounding can flip when the float
    inputs differ by one ulp)."""
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= INT8_FLIP_SHARE, \
                (what, d.max(), (d > 0).mean())
        else:
            np.testing.assert_allclose(g, w, rtol=LEAF_TOL, atol=LEAF_TOL,
                                       err_msg=what)


def _layouts(cfg_j, B, T, ps, rng):
    """None (contiguous) or a paged layout with shuffled tables, as numpy."""
    len_swa = min(T, cfg_j.sliding_window) if cfg_j.sliding_window else 0
    pps, pps_swa = -(-T // ps), -(-len_swa // ps) if len_swa else 0
    args = (ps, T, B * pps, len_swa, B * pps_swa if len_swa else 0)
    tables = {"pages": rng.permutation(B * pps).astype(np.int32).reshape(B, pps)}
    if len_swa:
        tables["pages_swa"] = (rng.permutation(B * pps_swa).astype(np.int32)
                               .reshape(B, pps_swa))
    return jpaging.PagedLayout(*args), tpaging.PagedLayout(*args), tables


@pytest.mark.parametrize("variant", ["plain", "swa", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_gqa_prefill_then_decode_match_reference(variant, layout):
    jcfg, tcfg, pj, pt = _params(variant)
    key = "l0_0_attn"
    p_j = jax.tree.map(lambda a: a[0], pj["stack"][key])
    p_t = {k: (v[0] if not isinstance(v, dict) else {n: x[0] for n, x in v.items()})
           for k, v in pt["stack"][key].items()}
    B, T, ps, C, d = 4, 32, 8, 8, jcfg.d_model
    rng = np.random.RandomState(2)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=32, rotary_dim=32,
              sliding_window=jcfg.sliding_window)
    if layout == "paged":
        lj, _, tables = _layouts(jcfg, B, T, ps, rng)
        name = "pages_swa" if jcfg.sliding_window else "pages"
        n_pages = lj.num_pages_swa if jcfg.sliding_window else lj.num_pages
        length = lj.len_swa if jcfg.sliding_window else lj.len_linear
        cj = jattn.init_gqa_cache(n_pages, ps, 2, 32, quant=jcfg.kv_cache_quant)
        pages = {"pages": tables[name], "length": length}
    else:
        cj = jattn.init_gqa_cache(B, min(T, jcfg.sliding_window or T), 2, 32,
                                  quant=jcfg.kv_cache_quant)
        pages = {"pages": None, "length": None}
    ct = params_from_numpy(_np_tree(cj), "cpu")
    pj_kw = dict(kw, pages=None if pages["pages"] is None
                 else jnp.asarray(pages["pages"]), length=pages["length"])
    pt_kw = dict(kw, pages=None if pages["pages"] is None
                 else torch.from_numpy(pages["pages"]), length=pages["length"])

    length = pj_kw.pop("length")
    prefill_j = jax.jit(functools.partial(jattn.apply_gqa_prefill,
                                          length=length, **kw))
    decode_j = jax.jit(functools.partial(jattn.apply_gqa_decode,
                                         length=length, **kw))
    x = rng.randn(B, C, d).astype(np.float32)
    valid = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 8], bool)
    pos = np.zeros(B, np.int32)
    yj, cj = prefill_j(p_j, jnp.asarray(x), cj, jnp.asarray(pos),
                       jnp.asarray(valid), pages=pj_kw["pages"])
    yt, ct = tattn.apply_gqa_prefill(p_t, torch.from_numpy(x), ct,
                                     torch.from_numpy(pos),
                                     torch.from_numpy(valid), **pt_kw)
    m = valid[:, :, None]
    np.testing.assert_allclose(yt.numpy() * m, np.asarray(yj) * m,
                               rtol=LEAF_TOL, atol=LEAF_TOL)
    _assert_cache(ct, cj, "prefill")
    pos = valid.sum(-1).astype(np.int32)
    live = np.array([True, True, False, True])
    for step in range(3):
        x1 = rng.randn(B, 1, d).astype(np.float32)
        yj, cj = decode_j(p_j, jnp.asarray(x1), cj, jnp.asarray(pos),
                          live=jnp.asarray(live), pages=pj_kw["pages"])
        yt, ct = tattn.apply_gqa_decode(p_t, torch.from_numpy(x1), ct,
                                        torch.from_numpy(pos),
                                        live=torch.from_numpy(live), **pt_kw)
        np.testing.assert_allclose(yt.numpy()[live], np.asarray(yj)[live],
                                   rtol=LEAF_TOL, atol=LEAF_TOL)
        _assert_cache(ct, cj, f"decode {step}")
        pos = pos + live


def test_kernel_read_requires_pages():
    with pytest.raises(ValueError, match="requires the paged cache layout"):
        tattn.apply_gqa_decode(
            {}, torch.zeros((2, 1, 128)), {}, torch.zeros((2,), dtype=torch.int32),
            num_heads=4, num_kv_heads=2, head_dim=32, rotary_dim=32,
            kv_read="kernel")


# ---------------------------------------------------------------------------
# the whole model: prefill_chunk then decode_step, with and without a codec
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_programs(variant, paged_args, codec_spec):
    """Jitted reference prefill/decode for one configuration."""
    jcfg = _cfgs(variant)[0]
    paged = jpaging.PagedLayout(*paged_args) if paged_args else None
    codec = jbuild(codec_spec, D=jcfg.d_model) if codec_spec else None

    def prefill(params, cache, tokens, pos, valid, cp):
        return jlm.prefill_chunk(params, cache, tokens, pos, jcfg, codec=codec,
                                 codec_params=cp, valid=valid, paged=paged)

    def decode(params, cache, tokens, pos, live, cp):
        return jlm.decode_step(params, cache, tokens, pos, jcfg, codec=codec,
                               codec_params=cp, paged=paged, live=live)

    return jax.jit(prefill), jax.jit(decode)


def _assert_logits(got, want, rows, what):
    got, want = got.numpy()[rows], np.asarray(want)[rows]
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= LOGIT_TOL, (what, gap)


@pytest.mark.parametrize("variant,layout,codec", [
    ("plain", "contiguous", None), ("plain", "paged", None),
    ("plain", "contiguous", "c3sl:R=2"), ("plain", "paged", "c3sl:R=2"),
    ("swa", "paged", "c3sl:R=2"), ("swa", "contiguous", None),
    ("int8", "paged", "c3sl:R=2"), ("int8", "contiguous", None),
    ("qwen2.5-32b", "paged", "c3sl:R=2"), ("qwen2.5-32b", "contiguous", None),
    ("chatglm3-6b", "paged", "c3sl:R=2"), ("chatglm3-6b", "contiguous", None),
    ("mistral-large-123b", "paged", "c3sl:R=2"),
    ("mistral-large-123b", "contiguous", None)])
def test_prefill_and_decode_steps_match_reference(variant, layout, codec):
    jcfg, tcfg, pj, pt = _params(variant)
    B, T, ps, C = 4, 32, 8, 8
    rng = np.random.RandomState(5)
    if layout == "paged":
        lj, lt, tables = _layouts(jcfg, B, T, ps, rng)
        paged_args = dataclasses.astuple(lj)
    else:
        lj = lt = tables = None
        paged_args = None
    cj = jlm.init_decode_cache(pj, jcfg, B, T, paged=lj)
    for n, tab in (tables or {}).items():
        cj[n] = jnp.asarray(tab)
    ct = params_from_numpy(_np_tree(cj), device="cpu")
    cpj = cpt = tcodec = None
    if codec:
        cpj = jbuild(codec, D=jcfg.d_model).init(jax.random.PRNGKey(1))
        cpt = params_from_numpy(_np_tree(cpj), device="cpu")
        tcodec = tbuild(codec, D=tcfg.d_model)
    prefill_j, decode_j = _ref_programs(variant, paged_args, codec)

    tokens = rng.randint(0, 128, (B, C)).astype(np.int32)
    valid = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 8], bool)
    pos = np.zeros(B, np.int32)
    lgj, cj = prefill_j(pj, cj, jnp.asarray(tokens), jnp.asarray(pos),
                        jnp.asarray(valid), cpj)
    lgt, ct = tlm.prefill_chunk(pt, ct, torch.from_numpy(tokens),
                                torch.from_numpy(pos), tcfg, codec=tcodec,
                                codec_params=cpt, valid=torch.from_numpy(valid),
                                paged=lt)
    rows = valid.any(-1)
    _assert_logits(lgt, lgj, rows, "prefill")
    _assert_cache(ct, cj, "prefill")
    pos = valid.sum(-1).astype(np.int32)
    live = np.array([True, True, False, True])
    tok = np.asarray(lgj).argmax(-1).astype(np.int32)[:, None]
    for step in range(3):
        lgj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(live), cpj)
        lgt, ct = tlm.decode_step(pt, ct, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg, codec=tcodec,
                                  codec_params=cpt, paged=lt,
                                  live=torch.from_numpy(live))
        _assert_logits(lgt[:, 0], lgj[:, 0], live, f"decode {step}")
        _assert_cache(ct, cj, f"decode {step}")
        tok = np.asarray(lgj[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = pos + live


def test_kernel_read_equals_plain_gather_read_on_the_cpu():
    """On CPU tensors kv_read="kernel" runs the kernel's plain version:
    the same op sequence as the gather read, so equal logits."""
    _, tcfg, _, pt = _params("plain")
    B, T, ps = 4, 32, 8
    layout = tpaging.PagedLayout(ps, T, B * T // ps)
    out = {}
    for kv_read in ("gather", "kernel"):
        cache = tlm.init_decode_cache(pt, tcfg, B, T, paged=layout)
        cache["pages"] = torch.arange(B * T // ps, dtype=torch.int32).reshape(B, -1)
        toks = torch.tensor([[3], [5], [7], [9]])
        logits, _ = tlm.decode_step(pt, cache, toks, torch.tensor([0, 1, 2, 3]),
                                    tcfg, paged=layout, kv_read=kv_read)
        out[kv_read] = logits
    assert torch.equal(out["gather"], out["kernel"])
