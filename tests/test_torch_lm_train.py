"""The port's LM training path (``lm_forward`` / ``lm_loss`` with the codec
at the superblock midpoint, the training-time GQA, ``apply_stack``, the
token cross-entropy) held against the JAX reference on the same weights,
codec keys and batches.

Weights come from the reference's ``init_lm_params`` through numpy, with
the qkv biases (``qwen2.5-32b``, ``chatglm3-6b``) set to nonzero numpy
draws so that they count; tokens and labels (some masked to -1) from numpy
seeds.  Sizes are ``reduced()`` configs at S = 8, so the cut's D = S *
d_model = 2048 and the reference's Pallas kernel runs in interpret mode in
seconds.  The port's ``backend=pallas`` runs its kernels' plain versions on
CPU tensors."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import transport as jtransport  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import transport as ttransport  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import stack as tstack  # noqa: E402

B, S = 4, 8
# float32 on both sides; XLA:CPU and PyTorch sum in other orders, so the
# loss agrees to a few ulps and each gradient leaf within a few 1e-6 of its
# max (measured: loss 1.4e-7 relative, gradients 3.0e-6 of the leaf max).
LOSS_TOL = 1e-6          # |loss difference| / |loss|
GRAD_TOL = 2e-5          # max |grad difference| / max |grad|, per leaf
SNR_TOL = 1e-4           # dB, the cut SNR and the probe's gradient SNR
# through the int8 wire stage an ulp of difference can flip a rounding, which
# moves that element by one quantization step (measured: loss 1.2e-5,
# gradients 6.6e-4 of the leaf max)
INT8_LOSS_TOL = 5e-5
INT8_GRAD_TOL = 3e-3


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference config, port config, reference params as numpy, port
    params), qkv biases nonzero."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    rng = np.random.default_rng(3)
    pj = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(0), jcfg))
    pj = jax.tree_util.tree_map_with_path(
        lambda k, v: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if jax.tree_util.keystr(k).endswith(("'b_q']", "'b_k']", "'b_v']")) else v,
        pj)
    return jcfg, tcfg, pj, params_from_numpy(pj, device="cpu")


def _batch(vocab, seed=5, frontend=None):
    """Tokens and labels (some masked), and with ``frontend`` = (seq, dim)
    a random frontend batch (patch or frame embeddings)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S))
    labels = rng.integers(0, vocab, (B, S))
    labels[0, :3] = -1          # masked positions
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if frontend is not None:
        fe = rng.normal(size=(B, *frontend)).astype(np.float32)
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.from_numpy(fe)
    return jb, tb


def _cut_len(cfg):
    """The cut activation's length: a VLM's patches sit in front of the
    text."""
    return S + (cfg.frontend_seq if cfg.frontend and not cfg.is_encdec else 0)


def _codecs(spec, D):
    if spec is None:
        return None, None, None, None
    jc = jtransport.build_link_or_codec(spec, D=D)
    tc = ttransport.build_link_or_codec(spec, D=D)
    cpj = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(1)))
    return jc, tc, cpj, params_from_numpy(cpj, device="cpu")


def _erasure(spec, D):
    """Keep masks for both directions of the link (about 1 in 8 erased)."""
    rng = np.random.default_rng(11)
    keep = lambda rows: (rng.random((rows, D)) > 0.125).astype(np.float32)  # noqa: E731
    return {"fwd": keep(B // 2), "bwd": keep(B // 2)}


def _grads(arch, spec, erasure=False):
    """Loss, metrics and gradients (params, probe) through both packages."""
    jcfg, tcfg, pj, pt = _model(arch)
    jb, tb = _batch(jcfg.vocab_size, frontend=(jcfg.frontend_seq, jcfg.frontend_dim)
                    if jcfg.frontend else None)
    D = _cut_len(jcfg) * jcfg.d_model
    jc, tc, cpj, cpt = _codecs(spec, D)
    er = _erasure(spec, D) if erasure else None

    def jloss(p, pr):
        return jlm.lm_loss(p, jb, jcfg, codec=jc, codec_params=cpj,
                           with_metrics=True, bwd_probe=pr,
                           erasure=None if er is None else
                           {k: jnp.asarray(v) for k, v in er.items()})
    (lj, mj), (gj, sj) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(pj, jnp.float32(0.0))

    tp = tree_map(lambda t: t.clone().requires_grad_(), pt)
    pr = torch.zeros((), requires_grad=True)
    lt, mt = tlm.lm_loss(tp, tb, tcfg, codec=tc, codec_params=cpt,
                         with_metrics=True, bwd_probe=pr,
                         erasure=None if er is None else
                         {k: torch.from_numpy(v) for k, v in er.items()})
    got = torch.autograd.grad(lt, tree_leaves(tp) + [pr], allow_unused=True)
    st = 0.0 if got[-1] is None else float(got[-1])
    return (float(lj), mj, jax.tree.leaves(gj), float(sj)), \
        (float(lt.detach()), mt, list(got[:-1]), st)


def _assert_parity(ref, port, spec, grad_tol=None):
    """``grad_tol`` overrides the float32 gradient tolerance (a model whose
    float32 gradients are further from exact states its own)."""
    (lj, mj, gj, sj), (lt, mt, gt, st) = ref, port
    int8 = spec is not None and "int8" in spec
    loss_tol, grad_tol = (INT8_LOSS_TOL, INT8_GRAD_TOL) if int8 else \
        (LOSS_TOL, grad_tol or GRAD_TOL)
    assert abs(lt - lj) <= loss_tol * abs(lj), (lt, lj)
    assert len(gt) == len(gj)
    for g, w in zip(gt, gj):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= grad_tol * np.abs(w).max(), \
            (g.shape, np.abs(g.numpy() - w).max(), np.abs(w).max())
    assert set(mt) == set(mj)
    if spec is not None:
        assert abs(float(mt["cut_snr"].detach()) - float(mj["cut_snr"])) <= SNR_TOL
    assert abs(st - sj) <= SNR_TOL, (st, sj)


@pytest.mark.parametrize("arch,spec", [
    ("deepseek-7b", None),
    ("deepseek-7b", "c3sl:R=2,backend=pallas"),
    ("deepseek-7b", "c3sl:R=2|int8"),
    ("deepseek-7b", "c3sl:R=2 >> bwd:c3sl:R=1"),
    # the dense archs the port accepts beside deepseek-7b: qkv bias,
    # qkv bias with partial rotary 0.5, and GQA with 8 kv heads
    ("qwen2.5-32b", None), ("qwen2.5-32b", "c3sl:R=2,backend=pallas"),
    ("chatglm3-6b", None), ("chatglm3-6b", "c3sl:R=2,backend=pallas"),
    ("mistral-large-123b", None),
    ("mistral-large-123b", "c3sl:R=2,backend=pallas")])
def test_lm_loss_and_grads_match_reference(arch, spec):
    """Loss, every gradient leaf, the cut SNR (``with_metrics``) and the
    probe's gradient (the gradient-retrieval SNR of the asymmetric link, 0
    otherwise)."""
    ref, port = _grads(arch, spec)
    _assert_parity(ref, port, spec)
    if spec is not None and ">>" in spec:
        assert port[3] != 0.0        # the seam measured something


def test_lm_loss_with_an_erasure_mask_matches_reference():
    """Payload loss on both directions of an asymmetric link: the decode
    renormalises over survivors and the SNRs degrade, in both packages."""
    spec = "c3sl:R=2 >> bwd:c3sl:R=1"
    ref, port = _grads("deepseek-7b", spec, erasure=True)
    _assert_parity(ref, port, spec)
    clean = _grads("deepseek-7b", spec)[1]
    assert float(port[1]["cut_snr"]) < float(clean[1]["cut_snr"])


def test_lm_forward_variants_agree():
    """Without metrics the loss is the same; ``last_only`` slices the last
    position before the head; remat changes no number."""
    _, tcfg, _, pt = _model("deepseek-7b")
    _, tb = _batch(tcfg.vocab_size)
    codec = ttransport.build_link_or_codec("c3sl:R=2", D=S * tcfg.d_model)
    cp = codec.init(torch.Generator().manual_seed(0), device="cpu")
    kw = dict(codec=codec, codec_params=cp)
    loss_m, metrics = tlm.lm_loss(pt, tb, tcfg, with_metrics=True, **kw)
    assert torch.equal(tlm.lm_loss(pt, tb, tcfg, **kw), loss_m)
    assert set(metrics) == {"cut_snr"}
    logits, aux = tlm.lm_forward(pt, tb, tcfg, **kw)
    last, _ = tlm.lm_forward(pt, tb, tcfg, last_only=True, **kw)
    assert logits.shape == (B, S, tcfg.vocab_size) and aux == 0.0
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=0, atol=0)
    grads = {}
    for remat in (True, False):
        tp = tree_map(lambda t: t.clone().requires_grad_(), pt)
        loss = tlm.lm_loss(tp, tb, tcfg, remat=remat, **kw)
        grads[remat] = (loss, torch.autograd.grad(loss, tree_leaves(tp)))
    assert torch.equal(grads[True][0], grads[False][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[True][1], grads[False][1]))


def test_softmax_cross_entropy_matches_reference():
    """The gather of the picked logit against the reference's one-hot
    einsum, with and without a mask; float32, within 1e-6 relative."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5))
    mask = rng.random((3, 5)) > 0.3
    for m in (None, mask):
        want = jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = tlayers.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-masked batch divides by 1, not 0
    zero = tlayers.softmax_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels),
                                         torch.zeros(3, 5, dtype=torch.bool))
    assert float(zero) == 0.0


@pytest.mark.parametrize("window", [None, 6])
def test_sdpa_causal_chunked_matches_unchunked(monkeypatch, window):
    """The q-chunked path (per-chunk recomputation) against the one-shot
    causal SDPA, port against port, with the threshold lowered: forward
    and gradients within 1e-5 (float32: a chunk's matmuls run over fewer
    keys, so their sums round differently; measured 1.1e-6)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, 4, 8)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()   # GQA, 2 groups
    outs = {}
    for chunked in (False, True):
        if chunked:
            monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 4)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        y = tattn._sdpa_causal(*xs, window, q_chunk=4)
        outs[chunked] = (y, torch.autograd.grad((y * y).sum(), xs))
    torch.testing.assert_close(outs[True][0], outs[False][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[True][1], outs[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_causal_mask_matches_reference():
    for args in ((4, 4, None, 0, 0), (4, 8, 3, 4, 0), (3, 6, None, 6, 3)):
        want = np.asarray(jattn.causal_mask(*args))
        got = tattn.causal_mask(*args).numpy()
        np.testing.assert_array_equal(got, want)


NEW_FAMILIES = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b",
                "jamba-1.5-large-398b", "rwkv6-1.6b", "seamless-m4t-large-v2",
                "pixtral-12b"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_unported_kinds_and_features_raise(arch):
    """Every arch trains and serves (the attention-cache families since
    ROADMAP.md A10a, the stateful and memory ones since A10b): every kind
    is one the config knows (``ModelConfig`` rejects any other, and the
    serving dispatch raises ``ValueError(kind)`` for one), each sublayer
    kind's own decode cache, the model's decode cache ("first" with a
    first-dense superblock, "memory" for an encoder-decoder model), one
    ``prefill_chunk``, one ``decode_step``, and an engine run, which an
    encoder-decoder model is refused, as in the reference, in both prefill
    modes.  The legacy ``prefill_mode="decode"`` engine (ported since
    ROADMAP.md A18) gives the chunked engine's tokens."""
    from repro_torch.serving.engine import BatchedEngine, Request
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    params = tlm.init_lm_params(0, cfg, device="cpu")
    kinds = {k for layer in cfg.block_pattern for k in layer}
    assert kinds <= set(tconfigs.SUBLAYER_KINDS)
    with pytest.raises(AssertionError):
        dataclasses.replace(cfg, block_pattern=(("bogus",),))
    x = torch.zeros((2, 1, cfg.d_model))
    with pytest.raises(ValueError, match="bogus"):
        tstack.apply_sublayer_decode("bogus", {"norm": params["final_norm"]},
                                     {}, cfg, x, 0)
    with pytest.raises(ValueError, match="bogus"):
        tstack.apply_sublayer_prefill("bogus", {"norm": params["final_norm"]},
                                      {}, cfg, x, torch.zeros(2, dtype=torch.int32),
                                      torch.ones((2, 1), dtype=torch.bool))
    for kind in sorted(kinds):
        c = tstack.init_sublayer_cache(kind, cfg, 2, 16, torch.float32,
                                       device="cpu")
        assert (c == {}) == (kind in ("mlp", "moe", "cross"))
    fe = (torch.randn((2, cfg.frontend_seq, cfg.frontend_dim))
          if cfg.frontend else None)
    cache = tlm.init_decode_cache(params, cfg, 2, 16, frontend_emb=fe)
    assert ("first" in cache) == bool(cfg.first_dense_layers)
    assert ("memory" in cache) == cfg.is_encdec
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10]])
    logits, cache = tlm.prefill_chunk(params, cache, toks,
                                      torch.zeros(2, dtype=torch.int32), cfg)
    assert logits.shape == (2, cfg.vocab_size)
    logits, _ = tlm.decode_step(params, cache, toks[:, :1],
                                torch.full((2,), 4, dtype=torch.int32), cfg)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    kw = dict(num_slots=2, max_len=16, chunk_size=4)
    if cfg.is_encdec:
        for mode in ("chunked", "decode"):
            with pytest.raises(ValueError, match="encoder-decoder"):
                BatchedEngine(params, cfg, prefill_mode=mode, **kw)
        return
    outs = []
    for mode in ("chunked", "decode"):
        eng = BatchedEngine(params, cfg, prefill_mode=mode, **kw)
        eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2))
        outs.append([r.out for r in eng.run()])
    assert [len(o) for o in outs[0]] == [2]
    assert outs[1] == outs[0]
