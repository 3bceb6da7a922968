"""The port's codec registry, spec grammar, accounting and wire stages
(repro_torch.codecs) against the JAX reference (repro.codecs): spec strings
and every integer (param_count, flops, wire_bytes, payload_shape) exactly
equal, the codec math on the same keys within a stated tolerance."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

# the spec sweep of tests/test_codec_registry.py (the adaptive specs are in
# tests/test_torch_adaptive.py)
SPECS = [
    "dense:R=4,D=128",
    "bnpp:R=4,C=64,H=8,W=8",
    "identity:D=64",
    "c3sl:R=4,D=256",
    "c3sl:R=8,D=256,backend=direct",
    "c3sl:R=4,D=256,unitary=true",
    "c3sl:R=4,D=256,backend=pallas,key_seed=3",
    "c3sl:R=4,D=256|int8",
    "c3sl:R=4,D=512|topk:ratio=0.1",
    "c3sl:R=2,D=128|topk:k=16|int8",
    "identity:D=32|noop",
    "hrr:R=2,D=64",
    "c3sl:R=16,D=4096,backend=pallas|int8",
]
# payload shapes of tests/test_wire_accounting.py (rank 1 to 3)
WIRE_SHAPES = [(5, 4, 64), (20, 64), (3, 4, 64), (12, 64), (64,), (6, 2, 32)]
# fft/direct codec math: the reference's backend tolerance (test_kernels.py:59)
TOL = 2e-4


def _np(x):
    return np.array(x)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_roundtrip_matches_reference(spec):
    got = codecs.build(spec).spec()
    assert got == jcodecs.build(spec).spec()
    assert codecs.build(got).spec() == got


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("B", [16, 64])
def test_accounting_equals_reference(spec, B):
    c, j = codecs.build(spec), jcodecs.build(spec)
    assert c.param_count() == j.param_count()
    assert c.flops(B) == j.flops(B)
    assert c.wire_bytes(B) == j.wire_bytes(B)
    assert tuple(c.payload_shape(B)) == tuple(j.payload_shape(B))
    assert c.feature_layout == j.feature_layout
    for shape in ((5, B // getattr(c, "R", 1), c.D), c.payload_shape(B)):
        assert codecs.payload_wire_bytes(c, shape) == jcodecs.payload_wire_bytes(j, shape)


@pytest.mark.parametrize("stage", ["int8", "topk:k=8", "topk:ratio=0.1", "noop"])
@pytest.mark.parametrize("shape", WIRE_SHAPES)
def test_wire_stage_accounting_equals_reference(stage, shape):
    c = codecs.build(f"identity:D={shape[-1]}|{stage}").stages[0]
    j = jcodecs.build(f"identity:D={shape[-1]}|{stage}").stages[0]
    assert c.wire_bytes(shape) == j.wire_bytes(shape)
    assert c.flops(shape) == j.flops(shape) == 0
    assert c.spec() == j.spec()


def test_build_defaults_and_registry_surface():
    c = codecs.build("c3sl:R=8,backend=fft|int8", D=4096)
    assert c.R == 8 and c.D == 4096
    c = codecs.build("c3sl:R=8,D=64", D=4096, R=2)
    assert c.R == 8 and c.D == 64
    codecs.build("identity", D=64, R=4, unitary=False)
    assert codecs.available() == jcodecs.available() == {
        "transform": ["bnpp", "bottlenetpp", "c3sl", "dense", "dense-bottleneck",
                      "hrr", "identity"],
        "wire": ["int8", "noop", "topk"]}
    for name in codecs.available()["transform"]:
        c = codecs.build(name, D=64, R=2, C=16, H=4, W=4)
        assert c.spec() == jcodecs.build(name, D=64, R=2, C=16, H=4, W=4).spec()
    spec = codecs.CodecSpec.parse("c3sl:R=4,unitary=true,backend=direct")
    assert spec.args == {"R": 4, "unitary": True, "backend": "direct"}
    assert codecs.CodecSpec.parse(str(spec)) == spec
    assert str(spec) == str(jcodecs.CodecSpec.parse(str(spec)))


@pytest.mark.parametrize("bad,match", [
    ("nope:R=4", "unknown transform"),
    ("c3sl:R=4,D=64,bogus=1", "bogus"),
    ("c3sl:R=4", "missing required"),
    ("c3sl:R=4,D=64|whatever", "unknown wire stage"),
    ("int8", "unknown transform"),
    ("c3sl:R4,D=64", "malformed"),
    ("c3sl:R=4,D=64,backend=cuda", "unknown HRR backend"),
    ("c3sl:R=0,D=64", "R must be >= 1"),
    ("adaptive:c3sl:R=6,D=64,min_R=2", "power of two"),
    ("", "empty codec spec"),
])
def test_bad_specs_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        codecs.build(bad)


@pytest.mark.parametrize("spec,max_R", [
    ("c3sl:R=8,D=64", 2), ("c3sl:R=8,D=64|int8", 2),
    ("c3sl:R=8,D=64,backend=direct,unitary=true|topk:k=8|int8", 4),
    ("identity:D=64|noop", 1), ("c3sl:R=2,D=64", 4)])
def test_clamp_R_matches_reference(spec, max_R):
    got = codecs.clamp_R(codecs.build(spec), max_R)
    assert got.spec() == jcodecs.clamp_R(jcodecs.build(spec), max_R).spec()
    assert codecs.build(got.spec()).spec() == got.spec()


def test_apply_quant_bits_matches_reference():
    for spec, bits in (("c3sl:R=4", None), ("c3sl:R=4", 8), ("c3sl:R=4|int8", 8)):
        assert codecs.apply_quant_bits(spec, bits) == jcodecs.apply_quant_bits(spec, bits)
    with pytest.raises(ValueError, match="only int8"):
        codecs.apply_quant_bits("c3sl:R=4", 4)


# --------------------------------------------------------------------------
# wire stages: values
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 64), (3, 4, 64)])
def test_int8_matches_reference(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 10, size=shape[:-1] + (1,))
         ).astype(np.float32)
    got = codecs.Int8STEQuant().apply(torch.from_numpy(x)).numpy()
    want = _np(jax.jit(jcodecs.Int8STEQuant().apply)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # every row hits its absmax grid point exactly, as the reference's runtime
    np.testing.assert_allclose(np.abs(got).max(-1), np.abs(x).max(-1), rtol=1e-6)


def test_int8_rounds_half_to_even_and_is_straight_through():
    # absmax 127 -> scale 1.0: x/scale lands on the .5 ties exactly
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], requires_grad=True)
    y = codecs.Int8STEQuant().apply(x)
    assert y.detach().tolist() == [[0.0, 2.0, 2.0, -0.0, -2.0, 127.0]]
    np.testing.assert_array_equal(
        y.detach().numpy(), _np(jcodecs.Int8STEQuant().apply(jnp.asarray(x.detach().numpy()))))
    (g,) = torch.autograd.grad((y * torch.arange(6.0)).sum(), [x])
    assert g.tolist() == [[0.0, 1.0, 2.0, 3.0, 4.0, 5.0]]


@pytest.mark.parametrize("shape,k", [((6, 64), 8), ((3, 4, 64), 5)])
def test_topk_matches_reference_on_tie_free_input(shape, k):
    # torch.topk and lax.top_k order ties differently: all magnitudes distinct
    rng = np.random.default_rng(1)
    n = math.prod(shape)
    mags = (rng.permutation(n) + 1).astype(np.float32) / n
    x = (mags * rng.choice([-1.0, 1.0], n)).astype(np.float32).reshape(shape)
    got = codecs.TopKSparsify(k=k).apply(torch.from_numpy(x)).numpy()
    want = _np(jax.jit(jcodecs.TopKSparsify(k=k).apply)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert ((got != 0).sum(-1) == k).all()


def test_topk_exact_k_under_ties_and_straight_through():
    x = torch.tensor([[3.0, 3.0, 3.0, 1.0], [2.0, -2.0, 2.0, -2.0]], requires_grad=True)
    y = codecs.TopKSparsify(k=2).apply(x)
    assert ((y != 0).sum(-1) == 2).all()
    (g,) = torch.autograd.grad(y.sum(), [x])
    assert (g == 1).all()
    assert codecs.TopKSparsify(ratio=0.25).wire_bytes((4, 64)) == 4 * (8 + 4 * 16)
    with pytest.raises(ValueError):
        codecs.TopKSparsify(ratio=0.0)
    with pytest.raises(ValueError):
        codecs.TopKSparsify(k=-1)


# --------------------------------------------------------------------------
# C3-SL codec math on the reference's keys
# --------------------------------------------------------------------------

def _pair(spec, D):
    j = jcodecs.build(spec, D=D)
    jp = j.init(jax.random.PRNGKey(0))
    c = codecs.build(spec, D=D)
    cp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return j, jp, c, cp


@pytest.mark.parametrize("spec", ["c3sl:R=4", "c3sl:R=4,backend=direct",
                                  "c3sl:R=4,backend=pallas", "c3sl:R=4|int8",
                                  "c3sl:R=2,unitary=true|topk:k=32"])
def test_c3sl_encode_decode_matches_reference(spec):
    D = 128
    j, jp, c, cp = _pair(spec, D)
    Z = np.random.default_rng(2).normal(size=(8, D)).astype(np.float32)
    payload = c.encode(cp, torch.from_numpy(Z))
    jpayload = jax.jit(j.encode)(jp, jnp.asarray(Z))
    assert tuple(payload.shape) == tuple(jpayload.shape) == c.payload_shape(8)
    np.testing.assert_allclose(payload.numpy(), _np(jpayload), rtol=TOL, atol=TOL)
    Zh = c.decode(cp, torch.from_numpy(_np(jpayload)))
    np.testing.assert_allclose(Zh.numpy(), _np(jax.jit(j.decode)(jp, jpayload)),
                               rtol=TOL, atol=TOL)
    assert Zh.shape == (8, D)


def test_c3sl_params_carry_the_key_spectrum():
    c = codecs.build("c3sl:R=4,D=64")
    p = c.init(device="cpu")
    assert set(p) == {"keys", "keys_fft"} and p["keys_fft"].dtype == torch.complex64
    assert set(codecs.build("c3sl:R=4,D=64,backend=pallas").init(device="cpu")) == {"keys"}
    # the default generator is seeded by key_seed
    assert torch.equal(p["keys"], c.init(device="cpu")["keys"])
    other = codecs.build("c3sl:R=4,D=64,key_seed=1").init(device="cpu")["keys"]
    assert not torch.equal(p["keys"], other)


@pytest.mark.parametrize("backend", ["fft", "pallas"])
def test_sequence_grouped_layout_matches_reference(backend):
    C, B, D, R = 6, 8, 32, 4
    j, jp, c, cp = _pair(f"c3sl:R={R},backend={backend}|int8", D)
    Z = np.random.default_rng(3).normal(size=(C, B, D)).astype(np.float32)
    payload = codecs.sequence_group_encode(c, cp, torch.from_numpy(Z))
    jpay = jax.jit(lambda p, z: jcodecs.sequence_group_encode(j, p, z))(jp, jnp.asarray(Z))
    assert tuple(payload.shape) == tuple(jpay.shape) == (C, B // R, D)
    np.testing.assert_allclose(payload.numpy(), _np(jpay), rtol=TOL, atol=TOL)
    # the 3-D layout is a reshape of the flat one (port against port)
    flat = c.encode(cp, torch.from_numpy(Z).reshape(C * B, D))
    assert torch.equal(payload.reshape(C * B // R, D), flat)
    assert codecs.payload_wire_bytes(c, tuple(payload.shape)) == c.wire_bytes(C * B)
    Zh = codecs.sequence_group_decode(c, cp, payload, C, B)
    assert torch.equal(Zh, c.decode(cp, flat).reshape(C, B, D))
    with pytest.raises(ValueError, match="not divisible by R=4"):
        codecs.sequence_group_encode(c, cp, torch.zeros(1, 63, D))
    assert codecs.sequence_group_encode(c, cp, torch.zeros(2, 6, D)).shape == (3, D)


@pytest.mark.parametrize("backend", ["fft", "direct", "pallas"])
def test_decode_masked_matches_reference_and_all_ones_is_decode(backend):
    D = 64
    j, jp, c, cp = _pair(f"c3sl:R=4,backend={backend}", D)
    Z = np.random.default_rng(4).normal(size=(8, D)).astype(np.float32)
    payload = c.encode(cp, torch.from_numpy(Z))
    keep = (np.random.default_rng(5).random(tuple(payload.shape)) > 0.25).astype(np.float32)
    got = c.decode_masked(cp, payload, torch.from_numpy(keep))
    want = jax.jit(j.decode_masked)(jp, jnp.asarray(payload.numpy()), jnp.asarray(keep))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert torch.equal(c.decode_masked(cp, payload, torch.ones_like(payload)),
                       c.decode(cp, payload))


def test_execution_mode_and_bad_input():
    c = codecs.build("c3sl:R=2,backend=pallas", D=256)
    assert "backend=pallas" in c.spec()
    assert c.execution_mode("cpu") == "torch-plain"
    assert c.execution_mode("cuda") == "cuda-kernel"
    # any D: no alignment rule and no fft reroute, unlike the TPU kernel
    assert codecs.build("c3sl:R=2,backend=pallas", D=4097).execution_mode() == "cuda-kernel"
    assert codecs.build("c3sl:R=2,backend=fft", D=256).execution_mode() == "fft"
    assert codecs.build("c3sl:R=2,backend=direct", D=256).execution_mode() == "direct"
    p = c.init(device="cpu")
    with pytest.raises(ValueError, match="feature dim"):
        c.encode(p, torch.zeros(4, 128))
    with pytest.raises(ValueError, match="not divisible by R=2"):
        c.encode(p, torch.zeros(3, 256))


def test_chain_surface_and_ste_gradient():
    c = codecs.build("c3sl:R=4,D=256|int8")
    assert isinstance(c, codecs.Chain) and c.R == 4 and c.D == 256
    assert c.wire_bytes(8) == (8 // 4) * 256 + 4 * (8 // 4)
    assert c.flops(8) == 2 * 8 * 256 * 256 and c.param_count() == 4 * 256
    p = c.init(device="cpu")
    Z = torch.randn(8, 256, generator=torch.Generator().manual_seed(0), requires_grad=True)
    (g,) = torch.autograd.grad((c.decode(p, c.encode(p, Z)) ** 2).sum(), [Z])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert codecs.build("c3sl:R=2,D=64|noop").wire_bytes(8) == \
        codecs.build("c3sl:R=2,D=64").wire_bytes(8)
    with pytest.raises(TypeError, match="not a wire stage"):
        codecs.Chain(codecs.build("identity:D=4"), (object(),))
