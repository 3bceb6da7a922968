"""The port's trainable baselines (repro_torch.codecs.bottleneck: dense and
BottleNet++) against the reference's on the same weights, drawn from a
numpy seed: encode, decode, and the gradient of every codec leaf (and of
the input) against jax.grad, in float32; the paper's Table 1 and Table 2
accounting rows, the comm report and the shims exactly.

Tolerances: float32 on both sides, each result within 2e-5 of its largest
entry (``_close``).  The conv biases in front of a BatchNorm are the
exception: their exact gradient is 0 (the normalisation subtracts the batch
mean), so both sides return float32 noise, held to 2e-5 of the largest
gradient of the same conv's weight.  The weights are asymmetric random
draws, so a transposed conv that flipped its kernel the other way would be
off by the size of the output itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_table1, bench_table2  # noqa: E402
from repro import codecs as jcodecs  # noqa: E402
from repro.core import bottlenet as jbottlenet  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.transport import split as jsplit  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.configs.paper import (PAPER_RS, RESNET50_CIFAR100,  # noqa: E402
                                       VGG16_CIFAR10)
from repro_torch.core import bottlenet, metrics  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.transport import split  # noqa: E402

REL_TOL = 2e-5


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _random_params(codec, seed):
    """Weights of the reference's tree, random everywhere (BatchNorm scales
    around 1, biases around 0), asymmetric in every conv tap."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(codec.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        base = 1.0 if "scale" in name else 0.0
        sd = 0.2 if leaf.ndim == 1 else float(np.prod(leaf.shape[1:])) ** -0.5
        return (base + sd * rng.normal(size=leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# pre-BatchNorm biases (exact gradient 0) -> the weight whose gradient scales them
_ZERO_GRAD = {"db_enc": "dw_enc", "db_dec": "dw_dec"}


def _close_grads(got, want, spec):
    for k in want:
        if spec.startswith("bnpp") and k in _ZERO_GRAD:
            scale = float(np.abs(want[_ZERO_GRAD[k]]).max())
            assert np.abs(got[k]).max() <= REL_TOL * scale
            assert np.abs(want[k]).max() <= REL_TOL * scale
        else:
            _close(got[k], want[k])


def _roundtrip_and_grads(spec, B, seed):
    """Encode, decode and every gradient of ``sum(decode(encode(Z)) * W)``
    on both sides; returns (port, reference) dicts of numpy arrays."""
    jc, tc = jcodecs.build(spec), codecs.build(spec)
    p = _random_params(jc, seed)
    rng = np.random.default_rng(seed + 1)
    in_shape = (B, tc.C, tc.H, tc.W) if tc.feature_layout == "nchw" else (B, tc.D)
    Z = rng.normal(size=in_shape).astype(np.float32)
    W = rng.normal(size=in_shape).astype(np.float32)

    @jax.jit
    def jref(p, Z):
        def loss(p, Z):
            pay = jc.encode(p, Z)
            out = jc.decode(p, pay)
            return jnp.sum(out * W), (pay, out)
        (_, (pay, out)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, Z)
        return pay, out, grads
    pay_j, out_j, (gp_j, gz_j) = jref(p, jnp.asarray(Z))
    want = {"payload": pay_j, "out": out_j, "dZ": gz_j,
            **{f"d{k}": v for k, v in gp_j.items()}}

    tp = {k: v.requires_grad_() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, p), "cpu").items()}
    tZ = torch.from_numpy(Z).requires_grad_()
    pay_t = tc.encode(tp, tZ)
    out_t = tc.decode(tp, pay_t)
    grads = torch.autograd.grad((out_t * torch.from_numpy(W)).sum(),
                                [tZ] + [tp[k] for k in sorted(tp)])
    got = {"payload": pay_t.detach(), "out": out_t.detach(), "dZ": grads[0],
           **{f"d{k}": g for k, g in zip(sorted(tp), grads[1:])}}
    assert tuple(pay_t.shape) == tuple(tc.payload_shape(B)) == pay_j.shape
    assert set(got) == set(want)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("spec", ["bnpp:R={R},C=8,H=4,W=4",
                                  "dense:R={R},D=128"])
def test_encode_decode_and_grads_match_reference_small(spec, R):
    spec = spec.format(R=R)
    got, want = _roundtrip_and_grads(spec, B=6, seed=R)
    _close_grads(got, want, spec)


@pytest.mark.parametrize("C,R", [(512, 4), (1024, 16)])
def test_bnpp_matches_reference_at_the_paper_cut(C, R):
    """The paper's cuts (512 or 1024, 2, 2): the encoded map is 1x1, so the
    encoder's BatchNorm takes its statistics from the batch axis alone."""
    spec = f"bnpp:R={R},C={C},H=2,W=2"
    got, want = _roundtrip_and_grads(spec, B=8, seed=C)
    _close_grads(got, want, spec)


def test_transposed_conv_kernel_orientation():
    """The decoder's weight is IOHW, as the reference's; torch's transposed
    conv flips the kernel where jax.lax.conv_transpose does not, so the
    port flips it back: unflipped it misses by the size of the output."""
    c = codecs.build("bnpp:R=8,C=4,H=4,W=4")
    rng = np.random.default_rng(0)
    payload = torch.from_numpy(rng.normal(size=(2, 2, 2, 2)).astype(np.float32))
    w = rng.normal(size=(2, 4, 2, 2)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(payload.numpy()), jnp.asarray(w),
                                  strides=(2, 2), padding="VALID",
                                  dimension_numbers=("NCHW", "IOHW", "NCHW"))
    flipped = torch.nn.functional.conv_transpose2d(
        payload, torch.from_numpy(w).flip(2, 3), stride=2)
    unflipped = torch.nn.functional.conv_transpose2d(
        payload, torch.from_numpy(w), stride=2)
    _close(flipped.numpy(), np.asarray(want), tol=1e-6)
    assert np.abs(unflipped.numpy() - np.asarray(want)).max() > 0.1
    assert c.c_code == 2 and c.payload_shape(2) == (2, 2, 2, 2)


def test_batchnorm_uses_the_population_variance():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 2, 2)).astype(np.float32) * 2 + 1
    s, b = rng.normal(size=4).astype(np.float32), rng.normal(size=4).astype(np.float32)
    got = bottlenet._batchnorm(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(b))
    want = jbottlenet._batchnorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _close(got.numpy(), np.asarray(want), tol=1e-6)


@pytest.mark.parametrize("spec", ["bnpp:R=4,C=8,H=4,W=4", "dense:R=4,D=64"])
def test_init_shapes_scales_and_spec(spec):
    """Same leaves, shapes and dtypes as the reference's init, vectors equal;
    the weights' spread is the reference's fan-in scale (jax.random cannot
    be reproduced; 0.15 is over three standard errors of a 256-draw
    estimate); the same generator state gives the same weights."""
    tc, jc = codecs.build(spec), jcodecs.build(spec)
    tp = tc.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jc.init(jax.random.PRNGKey(0))
    assert sorted(tp) == sorted(jp)
    # fan-ins: bnpp's convs take C*k*k and C'*k*k, dense's matmuls D and D/R
    fan = ({"w_enc": tc.C * tc.k ** 2, "w_dec": tc.c_code * tc.k ** 2}
           if tc.feature_layout == "nchw" else {"w_enc": tc.D, "w_dec": tc.d_code})
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
        if jp[k].ndim == 1:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        else:
            for leaf in (float(tp[k].std()), float(jp[k].std())):
                np.testing.assert_allclose(leaf, fan[k] ** -0.5, rtol=0.15)
    again = tc.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)
    assert tc.trainable is jc.trainable is True
    assert tc.spec() == jc.spec() == spec
    assert codecs.build(tc.spec()).spec() == spec


@pytest.mark.parametrize("spec", ["bnpp:R=4,C=8,H=4,W=4", "dense:R=4,D=128",
                                  "bnpp:R=8,C=512,H=2,W=2", "dense:R=16,D=4096",
                                  "bottlenetpp:R=2,C=16,H=4,W=4,k=2",
                                  "dense-bottleneck:R=2,D=64"])
def test_accounting_equals_reference(spec):
    tc, jc = codecs.build(spec), jcodecs.build(spec)
    for B in (1, 16, 64):
        assert tc.param_count() == jc.param_count()
        assert tc.flops(B) == jc.flops(B)
        assert tc.wire_bytes(B) == jc.wire_bytes(B)
        assert tuple(tc.payload_shape(B)) == tuple(jc.payload_shape(B))
        assert metrics.comm_report(tc, B, tc.D) == \
            metrics.CommReport(**vars(jmetrics.comm_report(jc, B, jc.D)))
        assert metrics.comm_report(tc, B, tc.D).row() == \
            jmetrics.comm_report(jc, B, jc.D).row()
    assert tc.feature_layout == jc.feature_layout
    assert tc.D == jc.D


def test_validation_errors_match_reference():
    for spec, match in (("bnpp:R=3,C=8,H=4,W=4", "4C must be divisible"),
                        ("dense:R=3,D=64", "D must be divisible")):
        with pytest.raises(ValueError, match=match):
            jcodecs.build(spec)
        with pytest.raises(ValueError, match=match):
            codecs.build(spec)


def _table1_rows(C3SLCodec, BottleNetPPCodec):
    """bench_table1.check_rows(), over the given codec classes."""
    from repro_torch.configs.paper import TABLE1, TABLE1_BOTTLENET
    rows = []
    for cfg in (VGG16_CIFAR10, RESNET50_CIFAR100):
        C, H, W = cfg.cut_shape
        B = cfg.batch_size
        for R in PAPER_RS:
            for method, codec, table in (
                    ("c3sl", C3SLCodec(R=R, D=cfg.D), TABLE1),
                    ("bottlenet++", BottleNetPPCodec(R=R, C=C, H=H, W=W),
                     TABLE1_BOTTLENET)):
                _, want_p, want_f = table[(cfg.name, R)]
                got_p = codec.param_count() / 1e3
                got_f = codec.flops(B) / 1e9
                rows.append({
                    "config": cfg.name, "method": method, "R": R,
                    "params_k": got_p, "paper_params_k": want_p,
                    "params_match": abs(got_p - want_p) / want_p < 0.02,
                    "flops_g": got_f, "paper_flops_g": want_f,
                    "flops_match": abs(got_f - want_f) / want_f < 0.02,
                })
    return rows


def test_table1_rows_equal_reference_bench():
    got = _table1_rows(codecs.C3SLCodec, codecs.BottleNetPPCodec)
    assert got == bench_table1.check_rows()
    # the paper's own BottleNet++ R=2 rows contradict its Table 2 formula
    assert [(r["config"], r["method"], r["R"]) for r in got
            if not (r["params_match"] and r["flops_match"])] == \
        [("vgg16-cifar10", "bottlenet++", 2),
         ("resnet50-cifar100", "bottlenet++", 2)]


def test_table2_rows_equal_reference_bench():
    rows = []
    for cfg in (VGG16_CIFAR10, RESNET50_CIFAR100):
        C, H, W = cfg.cut_shape
        B = cfg.batch_size
        for R in PAPER_RS:
            c3 = codecs.C3SLCodec(R=R, D=cfg.D)
            bn = codecs.BottleNetPPCodec(R=R, C=C, H=H, W=W)
            rows.append({
                "config": cfg.name, "R": R,
                "c3sl_params": c3.param_count(), "c3sl_flops": c3.flops(B),
                "bnpp_params": bn.param_count(), "bnpp_flops": bn.flops(B),
                "mem_ratio": bn.param_count() / c3.param_count(),
                "flop_ratio": bn.flops(B) / c3.flops(B),
            })
    assert rows == bench_table2.rows()


def test_shims_reexport_like_the_reference():
    assert bottlenet.BottleNetPPCodec is codecs.BottleNetPPCodec
    assert tcodec.DenseBottleneckCodec is codecs.DenseBottleneckCodec
    assert tcodec.IdentityCodec is codecs.IdentityCodec
    q = tcodec.C3SLCodec(R=4, D=64, quant_bits=8)
    assert isinstance(q, codecs.Chain)
    assert isinstance(q.stages[0], codecs.Int8STEQuant)
    assert q.spec() == jcodec.C3SLCodec(R=4, D=64, quant_bits=8).spec()
    assert tcodec.C3SLCodec(R=4, D=64).spec() == "c3sl:R=4,D=64"
    with pytest.raises(ValueError, match="only int8"):
        tcodec.C3SLCodec(R=4, D=64, quant_bits=4)
    with pytest.raises(AttributeError):
        tcodec.nope  # noqa: B018
    from repro_torch.core import split as tsplit_shim
    assert tsplit_shim.apply_codec is split.apply_codec
    from repro_torch import transport
    assert tsplit_shim.make_pod_pipeline_loss_fn is \
        transport.make_pod_pipeline_loss_fn


def test_apply_codec_nchw_dispatch_and_snr_match_reference():
    jc = jcodecs.build("bnpp:R=4,C=8,H=4,W=4")
    p = _random_params(jc, 3)
    Z = np.random.default_rng(4).normal(size=(4, 8, 4, 4)).astype(np.float32)
    want, wsnr = jsplit.apply_codec(jc, p, jnp.asarray(Z), with_snr=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    got, gsnr = split.apply_codec(codecs.build(jc.spec()), tp,
                                  torch.from_numpy(Z), with_snr=True)
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(gsnr), float(wsnr), rtol=1e-4)
    with pytest.raises(ValueError, match="flat codecs"):
        split.apply_codec(codecs.build(jc.spec()), tp, torch.from_numpy(Z),
                          erasure={"fwd": torch.ones(4, 8, 2, 2)})
    assert params_to_numpy(tp).keys() == p.keys()
