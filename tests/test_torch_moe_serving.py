"""MoE serving in the port held against the JAX reference: a ``moe``
sublayer's decode and chunked prefill at the serving capacity
(``capacity_factor = num_experts``, so cap = top_k * N and no token copy is
dropped), with the routing compared as integers; and reduced
``phi3.5-moe-42b-a6.6b`` (GQA, 4 heads over 2 KV heads, + MoE) through
``prefill_chunk`` / ``decode_step`` on both cache layouts, with the kernel
read (its plain version on the CPU) against the gather read.

Weights come from the reference's ``init_lm_params`` through numpy, inputs
from numpy seeds, and the codec keys are the reference's."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import build as jbuild  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro.models import stack as jstack  # noqa: E402
from repro_torch.codecs import build as tbuild  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402
from repro_torch.models import stack as tstack  # noqa: E402

# float32 on both sides; XLA:CPU and PyTorch sum in other orders
LOGIT_TOL = 2e-5         # max |logit difference| / max |logit|
LEAF_TOL = 1e-5          # float outputs and cache leaves, absolute + relative

ARCH = "phi3.5-moe-42b-a6.6b"
B, T, PS, C = 4, 32, 8, 8
VALID = np.array([[1] * 8, [1] * 5 + [0] * 3, [0] * 8, [1] * 8], bool)
LIVE = np.array([True, True, False, True])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(shared=0):
    """Reduced phi3.5-moe-42b-a6.6b (4 experts, top-2; with ``shared``
    shared experts as deepseek-v2-lite-16b has): the reference's params and
    the port's copy, built once for the module."""
    over = dict(num_shared_experts=shared)
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH), **over)
    pj = jlm.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, pj, params_from_numpy(_np_tree(pj), "cpu")


def _ref_routing(p, xf, top_k, capacity_factor):
    """The reference apply_moe's routing lines (src/repro/models/moe.py),
    returning its integers."""
    N = xf.shape[0]
    E = p["router"].shape[-1]
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    cap = max(int(top_k * N * capacity_factor / E), 1)
    e_flat = expert_idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(e_flat, E, dtype=jnp.int32), axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
    keep = pos_in_e < cap
    dest = jnp.where(keep, e_flat * cap + pos_in_e, E * cap)
    return np.asarray(expert_idx), np.asarray(keep), np.asarray(dest), cap


# ---------------------------------------------------------------------------
# the moe sublayer at the serving capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_sublayer_serves_at_full_capacity(phase, shared):
    """The stack's moe decode / prefill against the reference's: the output
    within LEAF_TOL, the routing (each token's experts, kept copies, slots)
    equal as integers at cap = top_k * N, every copy kept, and the port's
    ROUTING_LOG reporting no drop."""
    jcfg, tcfg, pj, pt = _params(shared)
    key = "l0_1_moe"
    p_j = jax.tree.map(lambda a: a[0], pj["stack"][key])
    p_t = {k: (v[0] if not isinstance(v, dict) else {n: x[0] for n, x in v.items()})
           for k, v in pt["stack"][key].items()}
    rng = np.random.RandomState(3)
    S = 1 if phase == "decode" else C
    h = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    pos = np.array([0, 3, 10, 20], np.int32)
    tmoe.ROUTING_LOG = []
    try:
        if phase == "decode":
            yj, _ = jstack.apply_sublayer_decode("moe", p_j, {}, jcfg,
                                                 jnp.asarray(h), jnp.asarray(pos))
            yt, _ = tstack.apply_sublayer_decode("moe", p_t, {}, tcfg,
                                                 torch.from_numpy(h),
                                                 torch.from_numpy(pos))
        else:
            args = (jnp.asarray(pos), jnp.asarray(VALID))
            yj, _ = jstack.apply_sublayer_prefill("moe", p_j, {}, jcfg,
                                                  jnp.asarray(h), *args)
            yt, _ = tstack.apply_sublayer_prefill("moe", p_t, {}, tcfg,
                                                  torch.from_numpy(h),
                                                  torch.from_numpy(pos),
                                                  torch.from_numpy(VALID))
        (kept, total, _), = tmoe.ROUTING_LOG
    finally:
        tmoe.ROUTING_LOG = None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=LEAF_TOL,
                               atol=LEAF_TOL)
    N, k, E = B * S, tcfg.experts_per_token, tcfg.num_experts
    assert int(kept) == total == N * k
    x = jlayers.rms_norm(jnp.asarray(h), p_j["norm"]["scale"]).reshape(N, -1)
    e_j, keep_j, dest_j, cap = _ref_routing(p_j, x, k, float(E))
    r = tmoe.route(p_t, torch.from_numpy(np.array(x)), top_k=k,
                   capacity_factor=float(tcfg.num_experts))
    assert cap == r["cap"] == k * N
    np.testing.assert_array_equal(r["expert_idx"].numpy(), e_j)
    np.testing.assert_array_equal(r["keep"].numpy(), keep_j)
    np.testing.assert_array_equal(r["dest"].numpy(), dest_j)
    assert keep_j.all()


# ---------------------------------------------------------------------------
# reduced phi3.5-moe-42b-a6.6b: prefill_chunk then decode_step
# ---------------------------------------------------------------------------

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


def _assert_leaves(got, want, what):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LEAF_TOL,
                                   atol=LEAF_TOL, err_msg=what)


@pytest.mark.parametrize("layout,kv_read,codec", [
    ("contiguous", "gather", None), ("contiguous", "gather", "c3sl:R=2"),
    ("paged", "gather", "c3sl:R=2"), ("paged", "kernel", "c3sl:R=2"),
    ("paged", "kernel", None)])
def test_decode_step_and_prefill_chunk_match_reference(layout, kv_read, codec):
    """A ragged prefill chunk, then three decode steps with a dead row:
    logits within LOGIT_TOL and cache leaves within LEAF_TOL of the
    reference's gather read (its Pallas kernel read is bit-identical to
    it), GQA 4 heads over 2 KV heads."""
    jcfg, tcfg, pj, pt = _params()
    assert tcfg.num_heads // tcfg.num_kv_heads == 2
    rng = np.random.RandomState(5)
    lj = lt = None
    paged_args = None
    if layout == "paged":
        paged_args = (PS, T, B * T // PS)
        lj, lt = jpaging.PagedLayout(*paged_args), tpaging.PagedLayout(*paged_args)
    cj = jlm.init_decode_cache(pj, jcfg, B, T, paged=lj)
    ct = tlm.init_decode_cache(pt, tcfg, B, T, paged=lt)
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
                                  live=torch.from_numpy(LIVE), kv_read=kv_read)
        _assert_logits(lgt[:, 0], lgj[:, 0], LIVE, f"decode {step}")
        _assert_leaves(ct, cj, f"decode {step}")
        tok = np.asarray(lgj[:, -1]).argmax(-1).astype(np.int32)[:, None]
        pos = pos + LIVE


def test_kernel_read_equals_gather_read_on_the_cpu():
    """Within the port, on CPU tensors: the kernel read's plain version
    gives the gather read's logits exactly at the GQA ratio 2, with the
    same MoE routing on both sides."""
    _, tcfg, _, pt = _params()
    layout = tpaging.PagedLayout(PS, T, B * T // PS)
    out = {}
    for kv_read in ("gather", "kernel"):
        cache = tlm.init_decode_cache(pt, tcfg, B, T, paged=layout)
        cache["pages"] = torch.arange(B * T // PS, dtype=torch.int32).reshape(B, -1)
        toks = torch.tensor([[3], [5], [7], [9]])
        logits, _ = tlm.decode_step(pt, cache, toks, torch.tensor([0, 1, 2, 3]),
                                    tcfg, paged=layout, kv_read=kv_read)
        out[kv_read] = logits
    assert torch.equal(out["gather"], out["kernel"])


def test_training_capacity_would_drop_where_serving_does_not():
    """Why serving overrides the capacity: at the training value 1.25 a
    prefill chunk's routing drops copies on this model; at num_experts it
    keeps every one."""
    _, tcfg, _, pt = _params()
    p = {k: (v[0] if not isinstance(v, dict) else {n: x[0] for n, x in v.items()})
         for k, v in pt["stack"]["l0_1_moe"].items()}
    xf = torch.from_numpy(np.random.RandomState(4).randn(B * C, tcfg.d_model)
                          .astype(np.float32))
    k = tcfg.experts_per_token
    train = tmoe.route(p, xf, top_k=k, capacity_factor=tcfg.capacity_factor)
    serve = tmoe.route(p, xf, top_k=k,
                       capacity_factor=float(tcfg.num_experts))
    assert not bool(train["keep"].all()) and bool(serve["keep"].all())
    assert tcfg.capacity_factor == 1.25


def test_serve_cli_engine_kernel_read_runs_on_the_cpu(capsys):
    """The serve CLI's engine on reduced phi3.5-moe-42b-a6.6b, paged, with
    the kernel read (its plain version here) and the codec."""
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--greedy",
                    "--device", "cpu", "--engine", "--kv-layout", "paged",
                    "--kv-read", "kernel", "--requests", "3", "--prompt-len",
                    "6", "--max-new", "3", "--chunk-size", "4", "--cache-len",
                    "32", "--codec", "c3sl:R=2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "kv_read=kernel (torch-plain)" in out
    assert "3 requests" in out
