"""The port's Adaptive-R scheduler (repro_torch.codecs.adaptive) against the
reference's: spec strings, ladders, clamping, validation errors and every
accounting integer exactly equal; the same observations give the same R
and EMA trajectory exactly (the controller's float arithmetic is the
reference's); a pinned bucket is bitwise the static codec initialised from
the same generator (port against port); the step table calls ``make``
once per bucket and dispatch never again; the encode/decode of the current
bucket on the reference's keys within the codec tolerance of
tests/test_torch_codecs.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.transport import split  # noqa: E402

# the reference's spec sweep (tests/test_adaptive_codec.py), and more
SPECS = [
    "adaptive:c3sl:R=8,D=64,min_R=2",
    "adaptive:c3sl:R=16,D=64,min_R=2,target_snr=12.0",
    "adaptive:c3sl:R=4,D=64,min_R=2,ema=0.8,hysteresis=2.0",
    "adaptive:c3sl:R=8,D=64,backend=direct,min_R=2|int8",
    "adaptive:c3sl:R=8,D=256,min_R=2|topk:k=16|int8",
    "adaptive:c3sl:R=4,D=64",
    "adaptive:c3sl:R=16,D=2048,backend=pallas,min_R=2",
    "adaptive:dense:R=4,D=64,min_R=2",
    "adaptive:identity:D=64",
]
TOL = 2e-4   # codec math on the same keys, as tests/test_torch_codecs.py


def _both(spec, **kw):
    return codecs.build(spec, **kw), jcodecs.build(spec, **kw)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_ladder_and_buckets_equal_reference(spec):
    t, j = _both(spec)
    assert t.spec() == j.spec() == spec
    assert codecs.build(t.spec()).spec() == spec
    assert t.ladder == j.ladder and t.current_R == j.current_R == t.min_R
    assert {R: b.spec() for R, b in t.buckets.items()} == \
        {R: b.spec() for R, b in j.buckets.items()}
    assert (t.min_R, t.max_R, t.target_snr, t.ema, t.hysteresis) == \
        (j.min_R, j.max_R, j.target_snr, j.ema, j.hysteresis)
    assert t.param_count() == j.param_count()
    assert t.feature_layout == j.feature_layout and t.D == j.D
    assert repr(t) == repr(j)


@pytest.mark.parametrize("spec", SPECS[:6])
def test_accounting_follows_the_current_bucket_like_reference(spec):
    t, j = _both(spec)
    for R in t.ladder:
        t.pin(R)
        j.pin(R)
        assert t.R == j.R == R
        assert codecs.program_key(t) == jcodecs.program_key(j) == R
        for B in (16, 64):
            assert t.wire_bytes(B) == j.wire_bytes(B)
            assert t.flops(B) == j.flops(B)
            assert tuple(t.payload_shape(B)) == tuple(j.payload_shape(B))
            for shape in ((B // R, t.D), (3, B // R, t.D)):
                assert codecs.payload_wire_bytes(t, shape) == \
                    jcodecs.payload_wire_bytes(j, shape)
            assert codecs.chunk_payload_shape(t, B, 5) == \
                jcodecs.chunk_payload_shape(j, B, 5)
        for directions in (1, 2):
            assert split.split_comm_bytes(t, 64, directions) == \
                jcodecs.build(spec).pin(R).wire_bytes(64) * directions


def test_defaults_flow_like_reference():
    for spec, kw in (("adaptive:c3sl:R=8", dict(D=64, min_R=4, target_snr=-3.0)),
                     ("adaptive:c3sl:R=8,min_R=2", dict(D=64, min_R=4)),
                     ("adaptive:c3sl:R=8,min_R=2|int8", dict(D=64, R=2))):
        t, j = _both(spec, **kw)
        assert t.spec() == j.spec()
        assert (t.min_R, t.target_snr, t.D) == (j.min_R, j.target_snr, j.D)


@pytest.mark.parametrize("bad,kw", [
    ("adaptive:c3sl:R=6,D=64,min_R=2", {}),
    ("adaptive:c3sl:R=4,D=64,min_R=8", {}),
    ("adaptive", dict(D=64)),
    ("adaptive:", dict(D=64)),
    ("adaptive:c3sl:R=4,D=64,ema=1.0", {}),
    ("adaptive:c3sl:R=4,D=64,hysteresis=-1.0", {}),
    ("adaptive:c3sl:R=4,D=64,bogus=1", {}),
    ("adaptive:c3sl:R=4,D=64|nope", {}),
])
def test_validation_errors_equal_reference(bad, kw):
    with pytest.raises(ValueError) as want:
        jcodecs.build(bad, **kw)
    with pytest.raises(ValueError) as got:
        codecs.build(bad, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not an adaptive spec"):
        codecs.build_adaptive("c3sl:R=4,D=64")


@pytest.mark.parametrize("spec,max_R", [
    ("adaptive:c3sl:R=16,D=64,min_R=2,target_snr=5|int8", 8),
    ("adaptive:c3sl:R=16,D=64,min_R=2", 16),
    ("adaptive:c3sl:R=16,D=64,min_R=2", 1),
    ("adaptive:c3sl:R=8,D=64,min_R=2", 12),
    ("adaptive:c3sl:R=8,D=64,min_R=2", 6),
    ("adaptive:c3sl:R=8,D=64,min_R=2", 7),
    ("adaptive:c3sl:R=16,D=64,min_R=2,target_snr=-6.0|int8", 4),
])
def test_clamp_R_equals_reference(spec, max_R):
    t, j = _both(spec)
    ct, cj = codecs.clamp_R(t, max_R), jcodecs.clamp_R(j, max_R)
    assert ct.spec() == cj.spec() and ct.ladder == cj.ladder
    assert codecs.build(ct.spec()).spec() == ct.spec()
    assert (ct is t) == (cj is j)
    assert ct.target_snr == t.target_snr


def test_controller_trajectory_equals_reference_exactly():
    """A long random stream of SNRs and loss slacks (some None), with pins
    and unpins: the same R after every observation and the same EMA to the
    last bit."""
    rng = np.random.default_rng(0)
    for spec in ("adaptive:c3sl:R=16,D=64,min_R=1,target_snr=3.0,ema=0.7",
                 "adaptive:c3sl:R=8,D=64,min_R=2,ema=0.0,hysteresis=0.5",
                 "adaptive:c3sl:R=8,D=64,min_R=2,target_snr=-1.5|int8"):
        t, j = _both(spec)
        for i in range(300):
            snr = None if i % 17 == 5 else float(rng.normal(2.0, 6.0))
            slack = (None if i % 3 else float(rng.normal(0.0, 1.0)))
            if i == 120:
                t.pin(4), j.pin(4)
            if i == 160:
                t.unpin(), j.unpin()
            assert t.observe(snr, slack) == j.observe(snr, slack)
            assert t.current_R == j.current_R
            assert t.ema_snr == j.ema_snr
    with pytest.raises(ValueError, match="not in bucket ladder"):
        codecs.build("adaptive:c3sl:R=8,D=64,min_R=2").pin(3)


def test_init_buckets_bitwise_equal_static_codecs_from_one_generator():
    """Every bucket inits from a copy of the caller's generator, so bucket
    k is bitwise the static c3sl:R=k codec initialised with a generator in
    the same state, and the caller's generator does not advance."""
    a = codecs.build("adaptive:c3sl:R=8,D=64,min_R=2")
    g = torch.Generator().manual_seed(11)
    before = g.get_state()
    pa = a.init(g, device="cpu")
    assert torch.equal(g.get_state(), before)
    assert sorted(pa) == sorted(codecs.bucket_key(R) for R in a.ladder)
    for R in a.ladder:
        ps = codecs.build(f"c3sl:R={R},D=64").init(
            torch.Generator().manual_seed(11), device="cpu")
        assert torch.equal(a.params_for(pa, R)["keys"], ps["keys"])
        assert torch.equal(a.params_for(pa, R)["keys_fft"], ps["keys_fft"])
    # with no generator every bucket draws from its key_seed
    p0 = a.init(device="cpu")
    assert torch.equal(p0["R4"]["keys"],
                       codecs.build("c3sl:R=4,D=64").init(device="cpu")["keys"])


@pytest.mark.parametrize("spec,static", [
    ("adaptive:c3sl:R=8,min_R=2", "c3sl:R=4,D=64"),
    ("adaptive:c3sl:R=8,min_R=2|int8", "c3sl:R=4,D=64|int8"),
    ("adaptive:c3sl:R=8,min_R=2,backend=pallas", "c3sl:R=4,D=64,backend=pallas")])
def test_pinned_is_bitwise_the_static_bucket(spec, static):
    a = codecs.build(spec, D=64).pin(4)
    s = codecs.build(static)
    pa = a.init(torch.Generator().manual_seed(7), device="cpu")
    ps = s.init(torch.Generator().manual_seed(7), device="cpu")
    Z = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 64)).astype(np.float32))
    pay = a.encode(pa, Z)
    assert torch.equal(pay, s.encode(ps, Z))
    assert torch.equal(a.decode(pa, pay), s.decode(ps, pay))
    keep = torch.ones_like(pay)
    keep[0, :8] = 0
    assert torch.equal(a.decode_masked(pa, pay, keep), s.decode_masked(ps, pay, keep))


@pytest.mark.parametrize("R", [2, 4, 8])
def test_current_bucket_math_matches_reference_on_its_keys(R):
    j = jcodecs.build("adaptive:c3sl:R=8,D=64,min_R=2|int8").pin(R)
    t = codecs.build("adaptive:c3sl:R=8,D=64,min_R=2|int8").pin(R)
    pj = j.init(jax.random.PRNGKey(3))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    Z = np.random.default_rng(R).normal(size=(16, 64)).astype(np.float32)
    want = np.asarray(j.decode(pj, j.encode(pj, Z)))
    got = t.decode(pt, t.encode(pt, torch.from_numpy(Z))).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_program_table_makes_one_callable_per_bucket_and_never_again():
    """The reference's "zero recompiles after warm-up" becomes: ``make``
    runs exactly once per ladder bucket at build time, and a schedule that
    bounces across the ladder dispatches to those callables only."""
    a = codecs.build("adaptive:c3sl:R=8,D=64,min_R=2")
    p = a.init(device="cpu")
    made = []

    def make(bucket, bucket_params):
        made.append(bucket.spec())
        return lambda Z: bucket.decode(bucket_params, bucket.encode(bucket_params, Z))

    table = codecs.build_program_table(a, p, make)
    assert made == ["c3sl:R=2,D=64", "c3sl:R=4,D=64", "c3sl:R=8,D=64"]
    assert sorted(table) == list(a.ladder)
    Z = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    for R in (2, 8, 4, 2, 8, 8, 4):
        a.pin(R)
        assert torch.equal(table[codecs.program_key(a)](Z), a.decode(p, a.encode(p, Z)))
    assert len(made) == 3
    static = codecs.build("c3sl:R=4,D=64")
    assert list(codecs.build_program_table(static, None, make)) == [None]
    assert codecs.program_key(static) is None and codecs.program_key(None) is None
