"""The port's transport layer (repro_torch.transport: Channel, SplitLink, the
gradient seam, link-aware split loss) against the reference's
(repro.transport): link grammar, errors, spec strings, per-direction wire
bytes and step-table keys exactly equal; the seam's forward is the identity
and its backward and probe SNR match the reference's ``jax.vjp``; the
mirrored and asymmetric split loss and gradients on the bench_comm split
MLP (D_in 32 -> 128 -> cut 256 -> 8 classes, batch 32), clean and under
given erasure masks, match the reference's on the same weights and keys.

Tolerances: float32 on both sides with the codec's FFTs in between, so
each float is held to 2e-4 of its largest entry (the codec tolerance of
tests/test_torch_codecs.py); SNRs in dB to 1e-3 dB.  With an int8 wire
stage a last-bit difference can move a value across a rounding edge, one
quantisation step of that row: those specs hold each gradient leaf to
2e-3 in relative L2 instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro import transport as jtransport  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch import transport  # noqa: E402
from repro_torch.interop import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 tree_leaves)
from repro_torch.optim import optimizers  # noqa: E402

TOL = 2e-4
INT8_L2 = 2e-3
SNR_TOL_DB = 1e-3
W = {"D_in": 32, "D_hidden": 128, "D_cut": 256, "n_cls": 8, "batch": 32}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# link grammar
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "c3sl:R=8 >> bwd:c3sl:R=4", "c3sl:R=8|int8", "c3sl:R=8",
    "c3sl:R=16|int8 >> bwd:c3sl:R=8 >> draft:c3sl:R=32|int8",
    "c3sl:R=8 >> draft:c3sl:R=4", "c3sl:R=8 >> draft:c3sl:R=4 >> bwd:c3sl:R=2",
    "  c3sl:R=8  >>  bwd:c3sl:R=4 ",
])
def test_parse_link_spec_equals_reference(spec):
    assert transport.is_link_spec(spec) == jtransport.is_link_spec(spec)
    assert transport.parse_link_spec(spec) == jtransport.parse_link_spec(spec)


@pytest.mark.parametrize("bad", [
    "c3sl:R=8 >> c3sl:R=4", "a >> bwd:b >> bwd:c",
    "a >> bwd:b >> draft:c >> draft:d", "a >> draft:b >> draft:c",
    "c3sl:R=8 >> bwd:", "c3sl:R=8 >> draft:", " >> bwd:c3sl:R=2"])
def test_link_spec_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        jtransport.parse_link_spec(bad)
    with pytest.raises(ValueError) as got:
        transport.parse_link_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "c3sl:R=8,D=64 >> bwd:dense:R=4,D=64",
    "c3sl:R=8,D=64 >> bwd:dense:R=4,D=64|int8",
    "c3sl:R=8,D=64 >> draft:dense:R=4,D=64",
    "bnpp:R=4,C=8,H=4,W=4 >> bwd:c3sl:R=2,D=64",
    "c3sl:R=4,D=128 >> draft:bnpp:R=4,C=8,H=4,W=4"])
def test_refused_links_raise_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jtransport.build_link(spec)
    with pytest.raises(ValueError) as got:
        transport.build_link(spec)
    assert str(got.value) == str(want.value)


LINKS = [
    "c3sl:R=4,D=64|int8",
    "c3sl:R=8,D=64 >> bwd:c3sl:R=4,D=64",
    "c3sl:R=16,D=64|int8 >> bwd:c3sl:R=8,D=64",
    "c3sl:R=8,D=64|int8 >> bwd:c3sl:R=2,D=64|int8",
    "adaptive:c3sl:R=8,D=64,min_R=2 >> bwd:adaptive:c3sl:R=4,D=64,min_R=2",
    "adaptive:c3sl:R=8,D=256,min_R=2|topk:k=16 >> bwd:c3sl:R=2,D=256|int8",
    "c3sl:R=16,D=64|int8 >> bwd:c3sl:R=8,D=64 >> draft:c3sl:R=32,D=64|int8",
    "adaptive:c3sl:R=16,D=64,min_R=2 >> bwd:adaptive:c3sl:R=4,D=64,min_R=1",
    "dense:R=4,D=64 >> bwd:c3sl:R=2,D=64",
    "bnpp:R=4,C=8,H=4,W=4",
]


@pytest.mark.parametrize("spec", LINKS)
def test_link_spec_wire_bytes_and_tables_equal_reference(spec):
    """Spec strings, per-direction wire bytes (while the controllers move),
    the clamp to a batch, step-table keys and ``make`` counts, pin_link."""
    t, j = transport.build_link(spec), jtransport.build_link(spec)
    assert t.spec() == j.spec() and t.mirrored == j.mirrored
    assert transport.build_link(t.spec()).spec() == t.spec()
    assert transport.build_link_or_codec(spec).spec() == \
        jtransport.build_link_or_codec(spec).spec()
    for B in (32, 64):
        ct, cj = codecs.clamp_R(t, B), jcodecs.clamp_R(j, B)
        assert ct.spec() == cj.spec()
        for snr in (9.0, 9.0, -9.0, 9.0, 9.0, 9.0):
            assert ct.observe(snr, -snr) == cj.observe(snr, -snr)
            assert transport.link_program_key(ct) == jtransport.link_program_key(cj)
            for b in (B, B // 2):
                assert ct.wire_bytes_fwd(b) == cj.wire_bytes_fwd(b)
                assert ct.wire_bytes_bwd(b) == cj.wire_bytes_bwd(b)
                assert ct.wire_bytes_draft(b) == cj.wire_bytes_draft(b)
                assert ct.total_wire_bytes(b) == cj.total_wire_bytes(b)
                for d in (1, 2):
                    assert transport.split_comm_bytes(ct, b, d) == \
                        jtransport.split_comm_bytes(cj, b, d)
            assert transport.pin_link(ct).spec() == jtransport.pin_link(cj).spec()
        made = []
        table = transport.build_link_program_table(
            ct, None, lambda s, p: made.append(s.spec()) or s.spec())
        want = jtransport.build_link_program_table(cj, None, lambda s, p: s.spec())
        assert table == want and len(made) == len(want)


def test_link_params_trees_and_channels():
    """Mirrored: the forward codec's own tree; asymmetric: {"fwd", "bwd"},
    each channel from its own copy of the generator, so equal specs get
    bitwise equal keys; the tree's layout is the reference's."""
    spec = "c3sl:R=4,D=64 >> bwd:c3sl:R=4,D=64 >> draft:c3sl:R=2,D=64"
    t, j = transport.build_link(spec), jtransport.build_link(spec)
    pt = t.init(torch.Generator().manual_seed(3), device="cpu")
    pj = j.init(jax.random.PRNGKey(3))
    assert sorted(pt) == sorted(pj) == ["bwd", "draft", "fwd"]
    assert torch.equal(pt["fwd"]["keys"], pt["bwd"]["keys"])
    assert t.fwd_params(pt) is pt["fwd"] and t.bwd_params(pt) is pt["bwd"]
    assert t.draft_params(pt) is pt["draft"]
    m = transport.build_link("c3sl:R=4,D=64|int8")
    pm = m.init(device="cpu")
    assert sorted(pm) == ["keys", "keys_fft"] and m.bwd_params(pm) is pm
    with pytest.raises(ValueError, match="no draft channel"):
        m.draft_params(pm)
    assert repr(m) == repr(jtransport.build_link("c3sl:R=4,D=64|int8"))
    assert transport.as_link(m) is m
    assert transport.as_link(codecs.build("c3sl:R=2,D=64")).mirrored
    ch = t.fwd
    assert repr(ch) == repr(j.fwd) and not ch.adaptive and ch.current_R == 4
    assert ch.observe(3.0) == 4 and ch.params_for(pt["fwd"]) is pt["fwd"]
    assert ch.next_erasure(rows=8) == (None, None)
    with pytest.raises(ValueError, match="rows or an explicit"):
        ch.install_faults(transport.FaultPlan(rates={"drop": 0.5})).next_erasure()
    with pytest.raises(ValueError, match="quant flag"):
        transport.build_link_or_codec("c3sl:R=4 >> bwd:c3sl:R=2", quant_bits=8)
    assert transport.build_link_or_codec("c3sl:R=4,D=64", quant_bits=8).spec() == \
        "c3sl:R=4,D=64|int8"


# --------------------------------------------------------------------------
# the gradient seam
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["c3sl:R=2,D=64", "c3sl:R=4,D=64|int8",
                                  "c3sl:R=2,D=64,backend=pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_grad_roundtrip_matches_reference_vjp(spec, masked):
    """Forward: the identity.  Backward: the cotangent through the bwd codec
    (and its keep mask) and the probe's gradient, the retrieval SNR in dB,
    raw: a scaled cotangent changes the compressed gradient, not the SNR's
    definition."""
    jc, tc = jcodecs.build(spec), codecs.build(spec)
    pj = jc.init(jax.random.PRNGKey(5))
    pt = params_from_numpy(_np_tree(pj), "cpu")
    rng = np.random.default_rng(0)
    P = rng.normal(size=(8, 64)).astype(np.float32)
    G = rng.normal(size=(8, 64)).astype(np.float32)
    keep = None
    if masked:
        keep = (rng.random(tc.payload_shape(8)) > 0.25).astype(np.float32)

    def jfn(p, probe):
        return jtransport.grad_roundtrip(jc, p, pj, probe,
                                         keep=None if keep is None else jnp.asarray(keep))
    out_j, vjp = jax.vjp(jfn, jnp.asarray(P), jnp.float32(0.0))
    ghat_j, snr_j = vjp(jnp.asarray(G))

    tP = torch.from_numpy(P).requires_grad_()
    probe = torch.zeros((), requires_grad=True)
    out_t = transport.grad_roundtrip(tc, tP, pt, probe,
                                     keep=None if keep is None else torch.from_numpy(keep))
    assert torch.equal(out_t, tP.detach())
    ghat_t, snr_t = torch.autograd.grad(out_t, [tP, probe], torch.from_numpy(G))
    assert snr_t.shape == () and snr_t.dtype == torch.float32
    np.testing.assert_allclose(float(snr_t), float(snr_j), atol=SNR_TOL_DB)
    err = np.abs(ghat_t.numpy() - np.asarray(ghat_j)).max()
    scale = np.abs(np.asarray(ghat_j)).max()
    if "int8" in spec:
        assert np.linalg.norm(ghat_t.numpy() - np.asarray(ghat_j)) <= \
            INT8_L2 * np.linalg.norm(np.asarray(ghat_j))
    else:
        assert err <= TOL * scale
    # the probe is not scaled by what flows above it
    _, snr2 = torch.autograd.grad(transport.grad_roundtrip(tc, tP, pt, probe),
                                  [tP, probe], 7.0 * torch.from_numpy(G))
    if keep is None:
        np.testing.assert_allclose(float(snr2), float(snr_t), atol=SNR_TOL_DB)


def test_grad_seam_takes_an_expanded_cotangent():
    """``out.sum()``'s backward hands the seam an expanded (stride-0) view:
    the seam makes it contiguous, and the result equals a dense one."""
    tc = codecs.build("c3sl:R=2,D=64,backend=pallas")
    pt = tc.init(device="cpu")
    P = torch.randn(4, 64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    probe = torch.zeros((), requires_grad=True)
    g_exp, s_exp = torch.autograd.grad(
        transport.grad_roundtrip(tc, P, pt, probe).sum(), [P, probe])
    g_den, s_den = torch.autograd.grad(
        transport.grad_roundtrip(tc, P, pt, probe), [P, probe], torch.ones(4, 64))
    assert torch.equal(g_exp, g_den) and torch.equal(s_exp, s_den)
    assert transport.channel._grad_seam(tc) is transport.channel._grad_seam(
        codecs.build("c3sl:R=2,D=64,backend=pallas"))


# --------------------------------------------------------------------------
# the split loss over links, against the reference
# --------------------------------------------------------------------------

def _workload(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    net = {"front": {"w1": f32(W["D_in"], W["D_hidden"]) * W["D_in"] ** -0.5,
                     "w2": f32(W["D_hidden"], W["D_cut"]) * W["D_hidden"] ** -0.5},
           "back": {"w": f32(W["D_cut"], W["n_cls"]) * W["D_cut"] ** -0.5}}
    batch = {"x": f32(W["batch"], W["D_in"]),
             "y": rng.integers(0, W["n_cls"], W["batch"])}
    return net, batch


def _jfront(p, x):
    return jax.nn.relu(jax.nn.relu(x @ p["w1"]) @ p["w2"])


def _jback(p, z):
    return z @ p["w"]


def _jce(logits, y):
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y])


def _tfront(net, x):
    return torch.relu(torch.relu(x @ net["front"]["w1"]) @ net["front"]["w2"])


def _tback(net, z):
    return z @ net["back"]["w"]


SPLIT_SPECS = [
    "c3sl:R=4",
    "c3sl:R=4|int8",
    "c3sl:R=8 >> bwd:c3sl:R=4",
    "c3sl:R=4,backend=pallas >> bwd:c3sl:R=2,backend=pallas",
    "c3sl:R=4|int8 >> bwd:c3sl:R=2|int8",
    "dense:R=4 >> bwd:c3sl:R=2,D=64",
]


def _split_pair(spec, erasure_seed=None):
    """One step of the reference and of the port on the same weights,
    keys, batch and (optionally) erasure masks."""
    net, batch = _workload()
    jl = jtransport.build_link(spec, D=W["D_cut"])
    lp = _np_tree(jl.init(jax.random.PRNGKey(7)))
    erasure_j = erasure_t = None
    if erasure_seed is not None:
        rng = np.random.default_rng(erasure_seed)
        shapes = {"fwd": jl.fwd.codec.payload_shape(W["batch"])}
        if not jl.mirrored:
            rows = jl.fwd.codec.payload_shape(W["batch"])[0]
            shapes["bwd"] = jl.bwd.codec.payload_shape(rows)
        masks = {k: (rng.random(s) > 0.2).astype(np.float32) for k, s in shapes.items()}
        erasure_j = {k: jnp.asarray(v) for k, v in masks.items()}
        erasure_t = {k: torch.from_numpy(v) for k, v in masks.items()}
    loss_j = jtransport.make_split_loss_fn(_jfront, _jback, jl, _jce,
                                           with_metrics=True)
    (lj, mj), (gj, snr_bwd_j) = jax.jit(jax.value_and_grad(
        lambda p, b, probe: loss_j(p, b, probe, erasure_j),
        argnums=(0, 2), has_aux=True))(
        {**net, "codec": lp}, batch, jnp.float32(0.0))

    tl = transport.build_link(spec, D=W["D_cut"])
    loss_t = transport.make_split_loss_fn(_tfront, _tback, tl,
                                          torch.nn.functional.cross_entropy,
                                          with_metrics=True)
    params = {"net": params_from_numpy(net, "cpu"),
              "codec": params_from_numpy(lp, "cpu")}
    tbatch = {"x": torch.from_numpy(batch["x"]), "y": torch.from_numpy(batch["y"])}
    lt, gt, mt = transport.split_value_and_grad(loss_t, params, tbatch,
                                                bwd_probe=True, erasure=erasure_t)
    return (lj, mj, gj, snr_bwd_j), (lt, mt, gt), tl, params, loss_t, tbatch


def _assert_grads(spec, got, want):
    for g, w in zip(tree_leaves(params_to_numpy(got)), jax.tree.leaves(_np_tree(want))):
        assert g.shape == w.shape
        if "int8" in spec:
            assert np.linalg.norm(g - w) <= INT8_L2 * np.linalg.norm(w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("spec", SPLIT_SPECS)
@pytest.mark.parametrize("erasure_seed", [None, 1])
def test_split_loss_grads_and_snrs_match_reference(spec, erasure_seed):
    (lj, mj, gj, snr_bwd_j), (lt, mt, gt), tl, *_ = _split_pair(spec, erasure_seed)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    np.testing.assert_allclose(float(mt["cut_snr"]), float(mj["cut_snr"]),
                               atol=SNR_TOL_DB)
    np.testing.assert_allclose(float(mt["bwd_snr"]), float(snr_bwd_j),
                               atol=SNR_TOL_DB)
    assert (float(mt["bwd_snr"]) == 0.0) == tl.mirrored
    _assert_grads(spec, gt["net"], {"back": gj["back"], "front": gj["front"]})
    if "dense" in spec:
        # the trainable forward codec's params take their gradients too
        assert sorted(gt) == ["codec", "net"]
        _assert_grads(spec, gt["codec"], gj["codec"]["fwd"])
    else:
        assert sorted(gt) == ["net"]


def test_mirrored_link_is_bitwise_the_bare_codec():
    net, batch = _workload()
    tbatch = {"x": torch.from_numpy(batch["x"]), "y": torch.from_numpy(batch["y"])}
    out = []
    for codec in (codecs.build("c3sl:R=4|int8", D=256),
                  transport.build_link("c3sl:R=4|int8", D=256)):
        loss = transport.make_split_loss_fn(_tfront, _tback, codec,
                                            torch.nn.functional.cross_entropy)
        params = {"net": params_from_numpy(net, "cpu"), "codec": codec.init(device="cpu")}
        out.append(transport.split_value_and_grad(loss, params, tbatch))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out[0][1]),
                                                 tree_leaves(out[1][1])))


def test_asymmetric_forward_equals_mirrored_and_all_ones_erasure_is_exact():
    """The seam changes the backward pass only; an all-ones mask on both
    directions is bitwise the clean step."""
    net, batch = _workload()
    tbatch = {"x": torch.from_numpy(batch["x"]), "y": torch.from_numpy(batch["y"])}
    asym = transport.build_link("c3sl:R=4 >> bwd:c3sl:R=2", D=256)
    mirr = transport.build_link("c3sl:R=4", D=256)
    pa = asym.init(device="cpu")
    res = {}
    for name, link, cp in (("asym", asym, pa), ("mirr", mirr, pa["fwd"])):
        loss = transport.make_split_loss_fn(_tfront, _tback, link,
                                            torch.nn.functional.cross_entropy)
        params = {"net": params_from_numpy(net, "cpu"), "codec": cp}
        res[name] = transport.split_value_and_grad(loss, params, tbatch, bwd_probe=True)
        if name == "asym":
            ones = {"fwd": torch.ones(8, 256), "bwd": torch.ones(4, 256)}
            res["ones"] = transport.split_value_and_grad(loss, params, tbatch,
                                                         bwd_probe=True, erasure=ones)
    assert torch.equal(res["asym"][0], res["mirr"][0])
    assert not torch.equal(res["asym"][1]["net"]["front"]["w1"],
                           res["mirr"][1]["net"]["front"]["w1"])
    assert torch.equal(res["asym"][0], res["ones"][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(res["asym"][1]),
                                                 tree_leaves(res["ones"][1])))
    assert torch.equal(res["asym"][2]["bwd_snr"], res["ones"][2]["bwd_snr"])


def test_train_step_updates_a_trainable_forward_codec_and_keeps_keys():
    (_, _, _, _), _, tl, params, loss_t, tbatch = _split_pair("dense:R=4 >> bwd:c3sl:R=2,D=64")
    opt = optimizers.adam(1e-3)
    train = transport.trainable_params(loss_t, params)
    assert sorted(train) == ["codec", "net"] and train["codec"] is params["codec"]["fwd"]
    step = transport.make_split_train_step(loss_t, opt)
    new, state, loss, metrics = step(params, opt.init(train), tbatch, bwd_probe=True)
    assert int(state["count"]) == 1 and "bwd_snr" in metrics
    assert new["codec"]["bwd"] is params["codec"]["bwd"]
    for k in ("w_enc", "w_dec", "b_dec"):
        assert not torch.equal(new["codec"]["fwd"][k], params["codec"]["fwd"][k])
    c3 = transport.make_split_loss_fn(_tfront, _tback, codecs.build("c3sl:R=4", D=256),
                                      torch.nn.functional.cross_entropy)
    assert sorted(transport.trainable_params(c3, params)) == ["net"]
