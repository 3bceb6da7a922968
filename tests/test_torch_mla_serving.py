"""MLA serving in the port held against the JAX reference: the latent cache
(``init_mla_cache``), the absorbed-matrix decode (``apply_mla_decode``) and
the chunked prefill (``apply_mla_prefill``) on both cache layouts, with
``live`` and ragged ``valid``; paged against contiguous within the port;
and reduced ``deepseek-v2-lite-16b`` (MLA + MoE + one dense first layer)
through ``prefill_chunk`` / ``decode_step``, with and without the codec.

Weights come from the reference's initialisers through numpy, inputs and
cache contents from numpy seeds, and the codec keys are the reference's.
The absorbed decode sums in another order than the training form
``apply_mla``, so it is held against the reference's decode, never against
``lm_forward``."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro_torch.codecs import build as tbuild  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402

# float32 on both sides; XLA:CPU and PyTorch sum in other orders
LOGIT_TOL = 2e-5         # max |logit difference| / max |logit|
LEAF_TOL = 1e-5          # float outputs and cache leaves, absolute + relative

ARCH = "deepseek-v2-lite-16b"
D = 64
MLA = dict(num_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
           v_head_dim=16)
B, T, PS, C = 4, 32, 8, 8
# ragged chunk tails, a row that is not prefilling, and staggered starts
VALID = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 8], bool)
LIVE = np.array([True, True, False, True])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


# ---------------------------------------------------------------------------
# the MLA sublayer: cache, decode, prefill
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mla_params():
    pj = jattn.init_mla(jax.random.PRNGKey(0), D, **MLA)
    return pj, params_from_numpy(_np_tree(pj), "cpu")


def _mla_caches(layout, rng):
    """(reference cache, port cache, table or None, length): both built by
    their own ``init_mla_cache`` (checked equal), then filled with the same
    random latents, so every stale row a mask lets through would show."""
    rows = (B * T // PS, PS) if layout == "paged" else (B, T)
    cj = jattn.init_mla_cache(*rows, MLA["kv_lora_rank"], MLA["qk_rope_dim"])
    ct = tattn.init_mla_cache(*rows, MLA["kv_lora_rank"], MLA["qk_rope_dim"],
                              device="cpu")
    assert _flat(ct) == _flat(cj)
    assert all(not t.any() for t in ct.values())
    cj = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
          for k, v in cj.items()}
    ct = params_from_numpy(_np_tree(cj), "cpu")
    if layout == "contiguous":
        return cj, ct, None, None
    table = rng.permutation(B * T // PS).astype(np.int32).reshape(B, -1)
    return cj, ct, table, T


@functools.lru_cache(maxsize=None)
def _ref_mla(length):
    kw = dict(MLA, length=length)
    return (jax.jit(functools.partial(jattn.apply_mla_prefill, **kw)),
            jax.jit(functools.partial(jattn.apply_mla_decode, **kw)))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mla_prefill_then_decode_match_reference(layout):
    """A prefill chunk at staggered start positions over random earlier
    latents, then two decode steps with a dead row (``live``) and one
    without ``live`` (the contiguous layout's clamped write)."""
    pj, pt = _mla_params()
    rng = np.random.RandomState(1)
    cj, ct, table, length = _mla_caches(layout, rng)
    tj = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    prefill_j, decode_j = _ref_mla(length)
    x = rng.randn(B, C, D).astype(np.float32)
    pos = np.array([0, 3, 10, 20], np.int32)
    yj, cj = prefill_j(pj, jnp.asarray(x), cj, jnp.asarray(pos),
                       jnp.asarray(VALID), pages=tj)
    yt, ct = tattn.apply_mla_prefill(pt, torch.from_numpy(x), ct,
                                     torch.from_numpy(pos),
                                     torch.from_numpy(VALID), pages=tt,
                                     length=length, **MLA)
    m = VALID[:, :, None]
    np.testing.assert_allclose(yt.numpy() * m, np.asarray(yj) * m,
                               rtol=LEAF_TOL, atol=LEAF_TOL)
    _assert_leaves(ct, cj, "prefill")
    pos = pos + VALID.sum(-1).astype(np.int32)
    for step, live in enumerate((LIVE, LIVE, None)):
        x1 = rng.randn(B, 1, D).astype(np.float32)
        lj = None if live is None else jnp.asarray(live)
        lt = None if live is None else torch.from_numpy(live)
        yj, cj = decode_j(pj, jnp.asarray(x1), cj, jnp.asarray(pos), live=lj,
                          pages=tj)
        yt, ct = tattn.apply_mla_decode(pt, torch.from_numpy(x1), ct,
                                        torch.from_numpy(pos), live=lt,
                                        pages=tt, length=length, **MLA)
        rows = np.ones(B, bool) if live is None else live
        np.testing.assert_allclose(yt.numpy()[rows], np.asarray(yj)[rows],
                                   rtol=LEAF_TOL, atol=LEAF_TOL)
        _assert_leaves(ct, cj, f"decode {step}")
        pos = pos + rows


def test_mla_paged_equals_contiguous():
    """Within the port: a paged cache holding the same logical latents as a
    contiguous one gives the same outputs bit for bit (the gather builds
    the contiguous view), and its pools read back as the contiguous
    cache."""
    _, pt = _mla_params()
    rng = np.random.RandomState(2)
    table = torch.from_numpy(
        rng.permutation(B * T // PS).astype(np.int32).reshape(B, -1))
    contiguous = {k: torch.from_numpy(rng.randn(B, T, n).astype(np.float32))
                  for k, n in (("c_kv", MLA["kv_lora_rank"]),
                               ("k_pe", MLA["qk_rope_dim"]))}
    paged = tattn.init_mla_cache(B * T // PS, PS, MLA["kv_lora_rank"],
                                 MLA["qk_rope_dim"], device="cpu")
    for k, v in contiguous.items():
        paged[k].view(-1, v.shape[-1])[
            (table.long()[:, :, None] * PS + torch.arange(PS)).reshape(-1)] = \
            v.reshape(-1, v.shape[-1])
    x = torch.from_numpy(rng.randn(B, C, D).astype(np.float32))
    pos = torch.tensor([0, 3, 10, 20], dtype=torch.int32)
    valid = torch.from_numpy(VALID)
    yc, _ = tattn.apply_mla_prefill(pt, x, contiguous, pos, valid, **MLA)
    yp, _ = tattn.apply_mla_prefill(pt, x, paged, pos, valid, pages=table,
                                    length=T, **MLA)
    assert torch.equal(yc, yp)
    pos = pos + valid.sum(-1).to(torch.int32)
    x1 = x[:, :1]
    live = torch.from_numpy(LIVE)
    yc, _ = tattn.apply_mla_decode(pt, x1, contiguous, pos, live=live, **MLA)
    yp, _ = tattn.apply_mla_decode(pt, x1, paged, pos, live=live, pages=table,
                                   length=T, **MLA)
    assert torch.equal(yc, yp)
    for k, v in contiguous.items():
        assert torch.equal(tpaging.gather_pages(paged[k], table, T), v)


# ---------------------------------------------------------------------------
# reduced deepseek-v2-lite-16b: prefill_chunk then decode_step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    """Reduced deepseek-v2-lite-16b (one dense first superblock, then 2
    superblocks of mla + moe): the reference's params and the port's copy,
    built once for the module."""
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    assert jcfg.first_dense_layers == tcfg.first_dense_layers == 1
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(_np_tree(pj), "cpu")


@functools.lru_cache(maxsize=None)
def _ref_programs(paged_args, codec_spec):
    jcfg = _params()[0]
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


@pytest.mark.parametrize("layout,codec", [
    ("contiguous", None), ("paged", None), ("contiguous", "c3sl:R=2"),
    ("paged", "c3sl:R=2")])
def test_decode_step_and_prefill_chunk_match_reference(layout, codec):
    """The cache trees match by key path, shape and dtype ("first", with no
    superblock axis, included) at init and after every call; logits within
    LOGIT_TOL and cache leaves within LEAF_TOL after a ragged prefill chunk
    and three decode steps with a dead row."""
    jcfg, tcfg, pj, pt = _params()
    rng = np.random.RandomState(5)
    lj = lt = None
    paged_args = None
    if layout == "paged":
        paged_args = (PS, T, B * T // PS)
        lj, lt = jpaging.PagedLayout(*paged_args), tpaging.PagedLayout(*paged_args)
    cj = jlm.init_decode_cache(pj, jcfg, B, T, paged=lj)
    ct = tlm.init_decode_cache(pt, tcfg, B, T, paged=lt)
    assert _flat(ct) == _flat(cj) and "first" in ct
    assert ct["first"]["l0_0_mla"]["c_kv"].shape[0] == (lt.num_pages if lt else B)
    if lj is not None:
        cj["pages"] = jnp.asarray(
            rng.permutation(B * T // PS).astype(np.int32).reshape(B, -1))
        ct["pages"] = torch.from_numpy(np.array(cj["pages"]))
    cpj = cpt = tcodec = None
    if codec:
        cpj = jbuild(codec, D=jcfg.d_model).init(jax.random.PRNGKey(1))
        cpt = params_from_numpy(_np_tree(cpj), "cpu")
        tcodec = tbuild(codec, D=tcfg.d_model)
    prefill_j, decode_j = _ref_programs(paged_args, codec)

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
    for step in range(3):
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


def test_serve_cli_lockstep_runs_on_the_cpu(capsys):
    """The serve CLI's lockstep loop (contiguous cache) on reduced
    deepseek-v2-lite-16b, with the codec."""
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--greedy",
                    "--device", "cpu", "--steps", "3", "--cache-len", "16",
                    "--codec", "c3sl:R=2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "cut-layer wire bytes" in out
