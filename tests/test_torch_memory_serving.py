"""Serving the memory families in the port, held against the JAX reference:
the ``cross`` sublayer's decode and prefill over an encoder memory; reduced
``seamless-m4t-large-v2`` (encoder-decoder) through
``init_decode_cache(frontend_emb=)``, ``prefill_chunk`` and ``decode_step``
on the same frames; reduced ``pixtral-12b`` (VLM) served text-only, as the
reference serves it; the engines of both packages refusing an
encoder-decoder model; and the serve CLI's lockstep loop on seamless.

The reference recomputes the memory's K and V at every call (there is no
cross-attention cache), and so does the port.  Weights come from the
reference's initialisers through numpy; frames, tokens and inputs from
numpy seeds; codec keys from the reference."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro.models import stack as jstack  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.codecs import build as tbuild  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402
from repro_torch.models import stack as tstack  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

# float32 on both sides; XLA:CPU and PyTorch sum in other orders
STEP_TOL = 1e-5          # one sublayer's outputs, abs + rel
LOGIT_TOL = 2e-5         # max |logit difference| / max |logit|
LEAF_TOL = 2e-5          # cache leaves (the memory among them), abs + rel

SEAMLESS, PIXTRAL = "seamless-m4t-large-v2", "pixtral-12b"
B, T, PS, C = 4, 32, 8, 8
VALID = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 3 + [0] * 5], bool)
LIVE = np.array([True, False, True, True])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


def _flat(tree):
    """Sorted (key path, shape, dtype) of a tree of numpy/jax/torch leaves."""
    tree = jax.tree.map(lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x),
                        tree)
    return sorted((jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
                  for k, v in jax.tree_util.tree_leaves_with_path(tree))


def _assert_leaves(got, want, what):
    assert _flat(got) == _flat(want), what
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LEAF_TOL,
                                   atol=LEAF_TOL, err_msg=what)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reduced arch's reference params and the port's copy, built once
    for the module."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, _to_torch(pj)


def _frames(cfg, batch=B, seed=9):
    """The same frames for both packages, as numpy."""
    return np.random.RandomState(seed).randn(
        batch, cfg.frontend_seq, cfg.frontend_dim).astype(np.float32)


# ---------------------------------------------------------------------------
# the cross sublayer over a memory
# ---------------------------------------------------------------------------

def test_cross_decode_and_prefill_match_reference():
    """``cross`` reads the memory (a prefill chunk with a ragged ``valid``,
    then a decode step); its cache is empty and stays so."""
    jcfg, tcfg, _, _ = _params(SEAMLESS)
    pj = jstack.init_sublayer(jax.random.PRNGKey(4), "cross", jcfg, jnp.float32)
    pt = _to_torch(pj)
    assert jstack.init_sublayer_cache("cross", jcfg, B, T, jnp.float32) == {}
    assert tstack.init_sublayer_cache("cross", tcfg, B, T, torch.float32,
                                      device="cpu") == {}
    rng = np.random.RandomState(1)
    mem = rng.randn(B, jcfg.frontend_seq, jcfg.d_model).astype(np.float32)
    h = rng.randn(B, C, jcfg.d_model).astype(np.float32)
    pos = np.array([0, 3, 10, 20], np.int32)
    yj, cj = jstack.apply_sublayer_prefill(
        "cross", pj, {}, jcfg, jnp.asarray(h), jnp.asarray(pos),
        jnp.asarray(VALID), memory=jnp.asarray(mem))
    yt, ct = tstack.apply_sublayer_prefill(
        "cross", pt, {}, tcfg, torch.from_numpy(h), torch.from_numpy(pos),
        torch.from_numpy(VALID), memory=torch.from_numpy(mem))
    assert cj == {} and ct == {}
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=STEP_TOL,
                               atol=STEP_TOL)
    h1 = h[:, :1]
    yj, _ = jstack.apply_sublayer_decode(
        "cross", pj, {}, jcfg, jnp.asarray(h1), jnp.asarray(pos),
        memory=jnp.asarray(mem), live=jnp.asarray(LIVE))
    yt, _ = tstack.apply_sublayer_decode(
        "cross", pt, {}, tcfg, torch.from_numpy(h1), torch.from_numpy(pos),
        memory=torch.from_numpy(mem), live=torch.from_numpy(LIVE))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=STEP_TOL,
                               atol=STEP_TOL)


# ---------------------------------------------------------------------------
# reduced seamless-m4t-large-v2 and pixtral-12b: prefill, then decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_programs(arch, paged_args, codec_spec):
    jcfg = _params(arch)[0]
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


@pytest.mark.parametrize("arch,layout,codec", [
    (SEAMLESS, "contiguous", None), (SEAMLESS, "paged", "c3sl:R=2"),
    (PIXTRAL, "contiguous", "c3sl:R=2"), (PIXTRAL, "paged", None)])
def test_prefill_chunk_and_decode_steps_match_reference(arch, layout, codec):
    """The cache from the same frames (an encoder-decoder model's memory is
    its encoder over them; a VLM ignores them and is served text-only), a
    ragged prefill chunk, then two decode steps with a dead row: logits
    within LOGIT_TOL, every cache leaf within LEAF_TOL after each call,
    the memory never written."""
    jcfg, tcfg, pj, pt = _params(arch)
    rng = np.random.RandomState(5)
    fe = _frames(jcfg)
    lj = lt = paged_args = None
    if layout == "paged":
        paged_args = (PS, T, B * T // PS)
        lj, lt = jpaging.PagedLayout(*paged_args), tpaging.PagedLayout(*paged_args)
    cj = jlm.init_decode_cache(pj, jcfg, B, T, frontend_emb=jnp.asarray(fe),
                               paged=lj)
    ct = tlm.init_decode_cache(pt, tcfg, B, T, frontend_emb=torch.from_numpy(fe),
                               paged=lt)
    assert ("memory" in ct) == ("memory" in cj) == (arch == SEAMLESS)
    _assert_leaves(ct, cj, "init")
    memory = ct.get("memory", torch.zeros(0)).clone()
    if lj is not None:
        cj["pages"] = jnp.asarray(
            rng.permutation(B * T // PS).astype(np.int32).reshape(B, -1))
        ct["pages"] = torch.from_numpy(np.array(cj["pages"]))
    cpj = cpt = tcodec = None
    if codec:
        cpj = jbuild(codec, D=jcfg.d_model).init(jax.random.PRNGKey(1))
        cpt = _to_torch(cpj)
        tcodec = tbuild(codec, D=tcfg.d_model)
    prefill_j, decode_j = _ref_programs(arch, paged_args, codec)
    tokens = rng.randint(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    pos = np.zeros(B, np.int32)
    lgj, cj = prefill_j(pj, cj, jnp.asarray(tokens), jnp.asarray(pos),
                        jnp.asarray(VALID), cpj)
    lgt, ct = tlm.prefill_chunk(pt, ct, torch.from_numpy(tokens),
                                torch.from_numpy(pos), tcfg, codec=tcodec,
                                codec_params=cpt, valid=torch.from_numpy(VALID),
                                paged=lt)
    _assert_logits(lgt, lgj, VALID.any(-1), "prefill")
    _assert_leaves(ct, cj, "prefill")
    pos = VALID.sum(-1).astype(np.int32)
    tok = np.asarray(lgj).argmax(-1).astype(np.int32)[:, None]
    for step in range(2):
        lgj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(LIVE), cpj)
        lgt, ct = tlm.decode_step(pt, ct, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg, codec=tcodec,
                                  codec_params=cpt, paged=lt,
                                  live=torch.from_numpy(LIVE))
        _assert_logits(lgt[:, 0], lgj[:, 0], LIVE, f"decode {step}")
        _assert_leaves(ct, cj, f"decode {step}")
        tok = np.asarray(lgj[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = pos + LIVE
    assert torch.equal(ct.get("memory", torch.zeros(0)), memory)


def test_encoder_decoder_cache_needs_frames_in_both_packages():
    """Without ``frontend_emb`` the reference asserts; the port raises
    ``ValueError`` saying what is missing."""
    jcfg, tcfg, pj, pt = _params(SEAMLESS)
    with pytest.raises(AssertionError):
        jlm.init_decode_cache(pj, jcfg, 2, 16)
    with pytest.raises(ValueError, match="needs frontend_emb"):
        tlm.init_decode_cache(pt, tcfg, 2, 16)


def test_engines_refuse_an_encoder_decoder_model_in_both_packages():
    """The reference's engine builds its cache without frames and trips the
    cache's assert at construction; the port's refuses the model there with
    a ``ValueError`` that names the lockstep loop.  A VLM's engine serves,
    text-only, in both."""
    jcfg, tcfg, pj, pt = _params(SEAMLESS)
    kw = dict(num_slots=2, max_len=16, chunk_size=4)
    with pytest.raises(AssertionError):
        jengine.BatchedEngine(pj, jcfg, **kw)
    with pytest.raises(ValueError, match="encoder-decoder.*lockstep"):
        tengine.BatchedEngine(pt, tcfg, **kw)
    jcfg, tcfg, pj, pt = _params(PIXTRAL)
    outs = []
    for mod, p, cfg in ((jengine, pj, jcfg), (tengine, pt, tcfg)):
        eng = mod.BatchedEngine(p, cfg, **kw)
        eng.submit(mod.Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
        outs.append([r.out for r in eng.run()])
    assert outs[0] == outs[1] and len(outs[0][0]) == 3


def test_serve_cli_lockstep_serves_an_encoder_decoder_model(capsys):
    """The lockstep loop draws frames for the frontend from ``--seed`` and
    builds the memory from them; ``--engine`` refuses the model."""
    from repro_torch.launch import serve
    serve.main(["--arch", SEAMLESS, "--reduced", "--batch", "2", "--greedy",
                "--device", "cpu", "--steps", "3", "--cache-len", "16",
                "--codec", "c3sl:R=2"])
    out = capsys.readouterr().out
    assert f"arch={SEAMLESS}" in out and "cut-layer wire bytes: 3072" in out
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", SEAMLESS, "--reduced", "--engine", "--device",
                    "cpu", "--requests", "1"])
