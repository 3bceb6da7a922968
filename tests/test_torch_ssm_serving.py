"""Serving the recurrent families in the port, held against the JAX
reference: the Mamba and RWKV-6 decode states (``init_mamba_state``,
``init_rwkv_state`` and the stack's per-sublayer caches on both layouts),
their one-token decode steps over two consecutive steps, and reduced
``rwkv6-1.6b`` (SSM) and ``jamba-1.5-large-398b`` (Mamba + attn + MoE)
through ``prefill_chunk`` (a ragged chunk, a row not prefilling) and
``decode_step`` (two steps, a dead row), with and without the codec.

Also, port against port: the recurrent state of a row that is not live (or
not valid) stays bit for bit as it was; decoding S tokens one at a time
equals ``lm_forward`` (the reference's own identity,
tests/test_arch_smoke.py); and a decode step reads nothing on the host
(no ``aten._local_scalar_dense``; ROADMAP.md C9).

Weights come from the reference's initialisers through numpy, inputs and
states from numpy seeds, the codec keys from the reference."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.codecs import build as tbuild  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import (params_from_numpy, tree_leaves,  # noqa: E402
                                 tree_map)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import stack as tstack  # noqa: E402

# float32 on both sides; XLA:CPU and PyTorch sum in other orders
STEP_TOL = 1e-5          # one module step's outputs and state, abs + rel
LOGIT_TOL = 2e-5         # max |logit difference| / max |logit|
# cache leaves after a whole model's calls, abs + rel: reduced jamba's 16
# layers hand each Mamba state the stream's few-ulp differences of every
# layer below it (its worst leaf reads 2.7e-5 off, on h values near 0.2)
LEAF_TOL = {"rwkv6-1.6b": 2e-5, "jamba-1.5-large-398b": 1e-4}
FORWARD_TOL = 2e-3       # decode one token at a time vs lm_forward (absolute)

RWKV, JAMBA = "rwkv6-1.6b", "jamba-1.5-large-398b"
D, DI, DS, DC, H, FF = 64, 128, 16, 4, 4, 128
B, T, PS, C = 4, 32, 8, 8
# ragged chunk tails, a row that is not prefilling, and a dead decode row
VALID = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 3 + [0] * 5], bool)
LIVE = np.array([True, False, True, True])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


def _sig(x):
    """(shape, dtype name) of a numpy, jax or torch array."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    x = np.asarray(x)
    return tuple(x.shape), str(x.dtype)


def _flat(tree):
    """Sorted (key path, shape, dtype) of a tree of numpy/jax/torch leaves."""
    return sorted((jax.tree_util.keystr(k), *_sig(v))
                  for k, v in jax.tree_util.tree_leaves_with_path(tree))


def _assert_leaves(got, want, what, tol=STEP_TOL):
    assert _flat(got) == _flat(want), what
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=what)


def _random_state(state, rng):
    """The same random values in a reference state and the port's copy."""
    sj = jax.tree.map(lambda v: jnp.asarray(
        rng.randn(*v.shape).astype(np.asarray(v).dtype)), state)
    return sj, _to_torch(sj)


# ---------------------------------------------------------------------------
# the states
# ---------------------------------------------------------------------------

def test_mamba_and_rwkv_states_match_reference():
    """Zeros of the reference's shapes and dtypes: Mamba's float32 ``h``
    and ``conv`` in the cache dtype; RWKV's float32 wkv and token shifts."""
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jmamba.init_mamba_state(B, DI, d_state=DS, d_conv=DC, dtype=jdt)
        got = tmamba.init_mamba_state(B, DI, d_state=DS, d_conv=DC, dtype=dtype,
                                      device="cpu")
        assert _flat(got) == _flat(want)
        want = jrwkv.init_rwkv_state(B, D, H, dtype=jdt)
        got = trwkv.init_rwkv_state(B, D, H, dtype=dtype, device="cpu")
        assert _flat(got) == _flat(want)
        assert not any(t.any() for t in tree_leaves(got))


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_stack_caches_match_reference_on_both_layouts(arch):
    """The decode cache's key paths, shapes and dtypes, stacked, on both
    layouts: a recurrent sublayer's per-slot state is the same on each,
    and a paged layout pages only attn (and mla)."""
    jcfg, tcfg, pj, pt = _params(arch)
    layout = (PS, T, B * T // PS)
    flats = []
    for jl, tl in ((None, None), (jpaging.PagedLayout(*layout),
                                  tpaging.PagedLayout(*layout))):
        cj = jlm.init_decode_cache(pj, jcfg, B, T, paged=jl)
        ct = tlm.init_decode_cache(pt, tcfg, B, T, paged=tl)
        assert _flat(ct) == _flat(cj)
        flats.append([f for f in _flat(ct)
                      if "attn" not in f[0] and "pages" not in f[0]])
    assert flats[0] == flats[1]


# ---------------------------------------------------------------------------
# the one-token steps, two in a row
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _module_params(kind):
    k = jax.random.PRNGKey(2)
    if kind == "mamba":
        pj = jmamba.init_mamba(k, D, DI, d_state=DS, d_conv=DC)
    elif kind == "rwkv_tm":
        pj = jrwkv.init_rwkv_timemix(k, D, H)
        # nonzero mixes, decay and norm scale, so that every input counts
        rng = np.random.RandomState(3)
        pj = {n: (jnp.asarray(rng.uniform(0.1, 0.9, v.shape).astype(np.float32))
                  if n.startswith("mix_") or n in ("w0", "ln_scale") else v)
              for n, v in pj.items()}
    else:
        pj = jrwkv.init_rwkv_channelmix(k, D, FF)
    return pj, _to_torch(pj)


def _step_fns(kind):
    if kind == "mamba":
        return (jax.jit(functools.partial(jmamba.apply_mamba_decode, d_state=DS)),
                functools.partial(tmamba.apply_mamba_decode, d_state=DS),
                jmamba.init_mamba_state(B, DI, d_state=DS, d_conv=DC))
    state = jrwkv.init_rwkv_state(B, D, H)
    if kind == "rwkv_tm":
        return (jax.jit(functools.partial(jrwkv.apply_rwkv_timemix_decode,
                                          num_heads=H)),
                functools.partial(trwkv.apply_rwkv_timemix_decode, num_heads=H),
                state)
    return (jax.jit(jrwkv.apply_rwkv_channelmix_decode),
            trwkv.apply_rwkv_channelmix_decode, state)


@pytest.mark.parametrize("kind", ["mamba", "rwkv_tm", "rwkv_cm"])
def test_decode_steps_match_reference(kind):
    """Two consecutive steps from a random state, each step's output and
    new state against the reference's; the state the port is given is
    not written."""
    pj, pt = _module_params(kind)
    step_j, step_t, state = _step_fns(kind)
    rng = np.random.RandomState(4)
    sj, st = _random_state(state, rng)
    for step in range(2):
        x = rng.randn(B, 1, D).astype(np.float32)
        before = tree_map(lambda t: t.clone(), st)
        yj, sj = step_j(pj, jnp.asarray(x), sj)
        yt, st_new = step_t(pt, torch.from_numpy(x), st)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st),
                                                     tree_leaves(before)))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=f"{kind} y {step}")
        _assert_leaves(st_new, sj, f"{kind} state {step}")
        st = st_new


def test_rwkv_head_norm_is_the_biased_variance():
    """The per-head norm divides by the biased variance (``jnp.var``), not
    ``torch.var``'s default: a head whose outputs are spread gives other
    values under the unbiased one."""
    pj, pt = _module_params("rwkv_tm")
    _, _, state = _step_fns("rwkv_tm")
    rng = np.random.RandomState(6)
    sj, st = _random_state(state, rng)
    x = rng.randn(B, 1, D).astype(np.float32)
    yj, _ = jrwkv.apply_rwkv_timemix_decode(pj, jnp.asarray(x), sj, num_heads=H)
    yt, _ = trwkv.apply_rwkv_timemix_decode(pt, torch.from_numpy(x), st,
                                            num_heads=H)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=STEP_TOL,
                               atol=STEP_TOL)
    real_var = torch.Tensor.var
    try:
        torch.Tensor.var = lambda t, *a, **kw: real_var(  # the trap
            t, *a, **{**kw, "unbiased": True})
        wrong, _ = trwkv.apply_rwkv_timemix_decode(pt, torch.from_numpy(x), st,
                                                   num_heads=H)
    finally:
        torch.Tensor.var = real_var
    assert np.abs(wrong.numpy() - np.asarray(yj)).max() > 100 * STEP_TOL


# ---------------------------------------------------------------------------
# reduced rwkv6-1.6b and jamba-1.5-large-398b: prefill_chunk, decode_step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The reduced arch's reference params and the port's copy, built once
    for the module."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg, dtype=getattr(jnp, dtype))
    return jcfg, tcfg, pj, _to_torch(pj)


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


def _recurrent_leaves(cache):
    """(name, leaf) of every recurrent state leaf of a stack cache."""
    return [(f"{k}/{n}", t) for k, sub in cache["stack"].items()
            if k.endswith(tstack.RECURRENT_KINDS) for n, t in sub.items()]


def _assert_logits(got, want, rows, what):
    got, want = got.numpy()[rows], np.asarray(want)[rows]
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert gap <= LOGIT_TOL, (what, gap)


@pytest.mark.parametrize("arch,layout,codec", [
    (RWKV, "contiguous", None), (RWKV, "paged", None),
    (RWKV, "contiguous", "c3sl:R=2"), (RWKV, "paged", "c3sl:R=2"),
    (JAMBA, "contiguous", None), (JAMBA, "paged", "c3sl:R=2")])
def test_prefill_chunk_and_decode_steps_match_reference(arch, layout, codec):
    """A ragged prefill chunk from a random recurrent state, then two decode
    steps with a dead row: logits within LOGIT_TOL, every cache leaf
    within LEAF_TOL after each call, and the recurrent state of a row that
    is not valid (prefill) or not live (decode) unchanged bit for bit."""
    jcfg, tcfg, pj, pt = _params(arch)
    rng = np.random.RandomState(5)
    lj = lt = paged_args = None
    if layout == "paged":
        paged_args = (PS, T, B * T // PS)
        lj, lt = jpaging.PagedLayout(*paged_args), tpaging.PagedLayout(*paged_args)
    cj = jlm.init_decode_cache(pj, jcfg, B, T, paged=lj)
    # a random recurrent state (as after earlier chunks), the same in both
    cj["stack"] = {k: (_random_state(v, rng)[0]
                       if k.endswith(tstack.RECURRENT_KINDS) else v)
                   for k, v in cj["stack"].items()}
    ct = _to_torch(cj)
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

    def unchanged(before, rows, what):
        for (name, t), (_, b) in zip(_recurrent_leaves(ct), before):
            assert torch.equal(t[:, rows], b[:, rows]), (what, name)

    tokens = rng.randint(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    pos = np.zeros(B, np.int32)
    before = [(n, t.clone()) for n, t in _recurrent_leaves(ct)]
    lgj, cj = prefill_j(pj, cj, jnp.asarray(tokens), jnp.asarray(pos),
                        jnp.asarray(VALID), cpj)
    lgt, ct_out = tlm.prefill_chunk(pt, ct, torch.from_numpy(tokens),
                                    torch.from_numpy(pos), tcfg, codec=tcodec,
                                    codec_params=cpt,
                                    valid=torch.from_numpy(VALID), paged=lt)
    assert ct_out is ct
    _assert_logits(lgt, lgj, VALID.any(-1), "prefill")
    _assert_leaves(ct, cj, "prefill", LEAF_TOL[arch])
    unchanged(before, ~VALID.any(-1), "prefill")
    pos = VALID.sum(-1).astype(np.int32)
    tok = np.asarray(lgj).argmax(-1).astype(np.int32)[:, None]
    for step in range(2):
        before = [(n, t.clone()) for n, t in _recurrent_leaves(ct)]
        lgj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(LIVE), cpj)
        lgt, _ = tlm.decode_step(pt, ct, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tcfg, codec=tcodec,
                                 codec_params=cpt, paged=lt,
                                 live=torch.from_numpy(LIVE))
        _assert_logits(lgt[:, 0], lgj[:, 0], LIVE, f"decode {step}")
        _assert_leaves(ct, cj, f"decode {step}", LEAF_TOL[arch])
        unchanged(before, ~LIVE, f"decode {step}")
        tok = np.asarray(lgj[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = pos + LIVE


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_sequential_decode_equals_lm_forward(arch):
    """Port against port, the reference's own identity: decoding S tokens
    one at a time (the recurrent forms, the KV cache) gives ``lm_forward``'s
    logits (the chunked scans, the causal attention) within 2e-3, MoE at
    the serving capacity on both sides."""
    _, tcfg, _, pt = _params(arch)
    if tcfg.num_experts:
        tcfg = dataclasses.replace(tcfg, capacity_factor=float(tcfg.num_experts))
    S = 12
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, tcfg.vocab_size, (2, S)))
    want, _ = tlm.lm_forward(pt, {"tokens": tokens}, tcfg, remat=False)
    cache = tlm.init_decode_cache(pt, tcfg, 2, S)
    outs = []
    for t in range(S):
        lg, cache = tlm.decode_step(pt, cache, tokens[:, t:t + 1], t, tcfg)
        outs.append(lg[:, 0])
    err = float((want - torch.stack(outs, 1)).abs().max())
    assert err < FORWARD_TOL, err


# ---------------------------------------------------------------------------
# no host sync a decode step (ROADMAP.md C9)
# ---------------------------------------------------------------------------

class _HostReads(TorchDispatchMode):
    """Counts ``aten._local_scalar_dense``: every read of a device value on
    the host (``.item()``, a 0-dim tensor index, ``bool()`` of a tensor)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["deepseek-7b", RWKV, JAMBA])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_step_and_prefill_read_nothing_on_the_host(arch, layout):
    """A ``decode_step`` with a dead row and a ragged ``prefill_chunk``
    dispatch no ``_local_scalar_dense``: the cache writes
    (``paging.masked_write``, 8 a deepseek-7b step before the fix) and the
    recurrent commits read nothing on the host."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    params = tlm.init_lm_params(0, cfg, device="cpu")
    paged = tpaging.PagedLayout(PS, T, B * T // PS) if layout == "paged" else None
    cache = tlm.init_decode_cache(params, cfg, B, T, paged=paged)
    if paged is not None:
        cache["pages"] = torch.arange(B * T // PS, dtype=torch.int32).reshape(B, -1)
    toks = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab_size,
                                                             (B, C)))
    with _HostReads() as reads:
        tlm.prefill_chunk(params, cache, toks, torch.zeros(B, dtype=torch.int32),
                          cfg, valid=torch.from_numpy(VALID), paged=paged)
        tlm.decode_step(params, cache, toks[:, :1],
                        torch.from_numpy(VALID.sum(-1).astype(np.int32)), cfg,
                        paged=paged, live=torch.from_numpy(LIVE))
    assert reads.n == 0


def test_masked_write_reads_nothing_on_the_host():
    """``masked_write`` alone, with kept and dropped entries, and with none
    kept: the reference's scatter result, no host read."""
    rows = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    want = rows.clone()
    idx = torch.tensor([5, 1, 6, 2])
    vals = -torch.arange(12, dtype=torch.float32).reshape(4, 3) - 1
    keep = torch.tensor([False, True, False, True])
    want[1], want[2] = vals[1], vals[3]
    with _HostReads() as reads:
        tpaging.masked_write(rows, idx, vals, keep)
        none = rows.clone()
        tpaging.masked_write(none, idx, vals, torch.zeros(4, dtype=torch.bool))
    assert reads.n == 0
    assert torch.equal(rows, want) and torch.equal(none, want)
