"""The port's circconv kernel wrappers (their plain versions on the CPU), its
oracles and its autograd Functions, held against the JAX reference
(repro.kernels: the oracles, and the Pallas kernels in interpret mode)."""
import math
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import circconv, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# jitted reference functions: one compile per shape instead of one per op
_ref_bind = jax.jit(jref.bind_superpose_ref)
_ref_unbind = jax.jit(jref.unbind_ref)

# the reference's kernel test shapes (tests/test_kernels.py)
SHAPES = [(1, 1, 64), (2, 2, 128), (4, 4, 128), (8, 2, 256), (3, 5, 96),
          (16, 16, 128), (2, 8, 512)]
# tolerances of tests/test_kernels.py: f32 1e-5, bf16 5e-2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _data(G, R, D, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(G, R, D)).astype(np.float32)
    K = rng.normal(size=(R, D)).astype(np.float32)
    K /= np.linalg.norm(K, axis=-1, keepdims=True)
    return Z, K


def _cast(Z, K, dtype):
    """Both sides see the same values: round to the working type once."""
    Zt = torch.from_numpy(Z).to(getattr(torch, dtype))
    Kt = torch.from_numpy(K).to(getattr(torch, dtype))
    return Zt, Kt, Zt.float().numpy(), Kt.float().numpy()


@pytest.mark.parametrize("G,R,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bind_plain_matches_reference_oracle(G, R, D, dtype):
    Zt, Kt, Z, K = _cast(*_data(G, R, D), dtype)
    before = dict(circconv.LAUNCHES)
    got = circconv.bind_superpose_kernel(Zt, ops._kext(Kt))
    want = _ref_bind(jnp.asarray(Z), jnp.asarray(K))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert got.dtype == getattr(torch, dtype) and got.shape == (G, D)
    assert circconv.LAUNCHES == before   # CPU tensors never count a launch


@pytest.mark.parametrize("G,R,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unbind_plain_matches_reference_oracle(G, R, D, dtype):
    Z, K = _data(G, R, D)
    S = np.array(_ref_bind(jnp.asarray(Z), jnp.asarray(K)))
    St = torch.from_numpy(S).to(getattr(torch, dtype))
    Kt = torch.from_numpy(K).to(getattr(torch, dtype))
    got = circconv.unbind_kernel(St, ops._kext(Kt))
    want = _ref_unbind(jnp.asarray(St.float().numpy()),
                           jnp.asarray(Kt.float().numpy()))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert got.dtype == getattr(torch, dtype) and got.shape == (G, R, D)


@pytest.mark.parametrize("G,R,D", [(2, 2, 128), (3, 5, 96), (4, 3, 127)])
def test_port_oracles_match_reference_oracles(G, R, D):
    Z, K = _data(G, R, D, seed=1)
    S = tref.bind_superpose_ref(torch.from_numpy(Z), torch.from_numpy(K))
    np.testing.assert_allclose(
        S.numpy(), np.asarray(_ref_bind(jnp.asarray(Z), jnp.asarray(K))),
        rtol=1e-5, atol=1e-5)
    Zh = tref.unbind_ref(S, torch.from_numpy(K))
    np.testing.assert_allclose(
        Zh.numpy(), np.asarray(_ref_unbind(jnp.asarray(S.numpy()), jnp.asarray(K))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G,R,D", [(2, 2, 128), (3, 5, 96), (2, 8, 512),
                                   (2, 4, 640), (2, 2, 1536), (1, 2, 1920)])
def test_ops_match_reference_pallas_interpret(G, R, D):
    """The port's autograd Functions against the reference's Pallas
    kernels, run in interpret mode as tests/test_kernels.py runs them."""
    Z, K = _data(G, R, D, seed=2)
    S = ops.bind_superpose_pallas(torch.from_numpy(Z), torch.from_numpy(K))
    np.testing.assert_allclose(
        S.numpy(), np.asarray(jops.bind_superpose_pallas(jnp.asarray(Z), jnp.asarray(K))),
        rtol=1e-5, atol=1e-5)
    Zh = ops.unbind_pallas(S, torch.from_numpy(K))
    np.testing.assert_allclose(
        Zh.numpy(), np.asarray(jops.unbind_pallas(jnp.asarray(S.numpy()), jnp.asarray(K))),
        rtol=1e-5, atol=1e-5)


def test_bind_backward_matches_reference_custom_vjp():
    Z, K = _data(2, 4, 128)
    dS = np.random.default_rng(7).normal(size=(2, 128)).astype(np.float32)
    Zt = torch.from_numpy(Z).requires_grad_()
    (g,) = torch.autograd.grad(
        (ops.bind_superpose_pallas(Zt, torch.from_numpy(K)) * torch.from_numpy(dS)).sum(),
        [Zt])
    gj = jax.jit(jax.grad(lambda z: jnp.vdot(jops.bind_superpose_pallas(
        z, jnp.asarray(K)), jnp.asarray(dS))))(jnp.asarray(Z))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4)


def test_unbind_backward_matches_reference_custom_vjp():
    Z, K = _data(2, 4, 128)
    S = np.array(_ref_bind(jnp.asarray(Z), jnp.asarray(K)))
    dZ = np.random.default_rng(8).normal(size=(2, 4, 128)).astype(np.float32)
    St = torch.from_numpy(S).requires_grad_()
    (g,) = torch.autograd.grad(
        (ops.unbind_pallas(St, torch.from_numpy(K)) * torch.from_numpy(dZ)).sum(), [St])
    gj = jax.jit(jax.grad(lambda s: jnp.vdot(jops.unbind_pallas(
        s, jnp.asarray(K)), jnp.asarray(dZ))))(jnp.asarray(S))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", ["bind", "unbind"])
def test_keys_get_no_gradient(op):
    Z, K = _data(2, 2, 128)
    Kt = torch.from_numpy(K).requires_grad_()
    if op == "bind":
        x = torch.from_numpy(Z).requires_grad_()
        out = ops.bind_superpose_pallas(x, Kt)
    else:
        x = torch.from_numpy(Z[:, 0]).requires_grad_()
        out = ops.unbind_pallas(x, Kt)
    gx, gk = torch.autograd.grad(out.sum(), [x, Kt], allow_unused=True,
                                 materialize_grads=True)
    assert (gk == 0).all() and gx.abs().sum() > 0


def test_wrapper_validates_before_launch():
    """Shape, device, dtype and contiguity checks raise before any build or
    launch (the CUDA path's checks run on CPU tensors here)."""
    Z = torch.zeros(2, 2, 64)
    kext = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="Kext shape"):
        circconv.bind_superpose_kernel(Z, torch.zeros(2, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        circconv.bind_superpose_kernel(Z.to("meta"), kext.to("meta"))
    out = torch.empty(2, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        circconv._launch("bind_superpose", "direct", Z.double(), kext, out,
                         2, 2, 64)
    with pytest.raises(TypeError, match="Kext must be float32"):
        circconv._launch("bind_superpose", "direct", Z, kext.bfloat16(), out,
                         2, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        circconv._launch("unbind", "direct", torch.zeros(64, 2).t(),
                         kext, out, 2, 2, 64)


def test_execution_mode_follows_the_device():
    assert circconv.execution_mode("cpu") == "torch-plain"
    assert circconv.execution_mode("cuda") == "cuda-kernel"
    assert circconv.execution_mode(torch.device("cuda", 0)) == "cuda-kernel"


@pytest.mark.parametrize("D,want", [
    (1, "direct"), (2, "direct"), (3, "direct"), (4, "fft"), (8, "fft"),
    (32, "fft"), (64, "fft"), (96, "fft"), (127, "direct"), (2048, "fft"),
    (4096, "fft"), (4097, "direct"), (5120, "fft"), (12288, "fft"),
    (16384, "fft"), (32768, "fft4"), (20480, "fft4"), (65536, "fft4"),
    (524288, "fft4"), (655360, "fft4"), (1572864, "fft4"), (1 << 22, "fft4"),
    ((1 << 22) + 1, "direct"), (14336, "direct"), (28672, "direct"),
    (10, "direct"), (30, "direct"), (6250, "direct")])
def test_route_picks_fft_for_powers_of_two_up_to_the_limit(D, want):
    """The one-pass FFT kernels take every D = 2^a 3^b 5^c with a >= 2 in
    [4, 16384] (the serving widths 5120 and 12288 among them), the
    four-step kernels every such D past it up to 2^22 (the LM training
    path's D = S * d_model, 524288, 655360 and 1572864 at S 128); every
    other D (ragged, odd, a factor of 7 as in 14336 and 28672, or a single
    factor of 2 as in 10, 30 and 6250) goes to the direct kernels.  By D
    alone."""
    assert circconv.route(D) == want
    assert (circconv.FFT_MIN_D, circconv.FFT_MAX_D, circconv.FFT4_MAX_D) == \
        (4, 16384, 1 << 22)


def _archs():
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.configs.base import get_config
    return {name: get_config(name) for name in ALL_ARCHS}


@pytest.mark.parametrize("S", [1, 128])
def test_route_takes_every_arch_width_off_the_direct_kernel(S):
    """Every d_model of configs/archs.py, and S * d_model at the LM
    training CLI's S = 128, goes to an FFT-form route."""
    widths = sorted({cfg.d_model for cfg in _archs().values()})
    assert {1024, 2048, 4096, 5120, 8192, 12288} <= set(widths)
    for d in widths:
        assert circconv.route(S * d) == ("fft" if S * d <= 16384 else "fft4"), d


def _smooth_numbers(limit):
    """Every 2^a 3^b 5^c <= limit with a >= 2."""
    out, p2 = [], 4
    while p2 <= limit:
        p3 = p2
        while p3 <= limit:
            p5 = p3
            while p5 <= limit:
                out.append(p5)
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return sorted(out)


@pytest.mark.parametrize("kind", ["fft", "fft4"])
def test_plan_invariants_for_every_smooth_d(kind):
    """For every D = 2^a 3^b 5^c (a >= 2) up to the four-step limit: the
    one-pass plan's radices multiply to D and its working set fits the 227
    KB of shared memory; the four-step plan splits D = D1 D2 with each side
    at most 2048 points and a multiple of 4, D2 <= D1, each side's radices
    multiplying to it, and tile columns that divide D2; a D the four-step
    kernels cannot split raises, and nothing goes direct."""
    seen = 0
    for D in _smooth_numbers(circconv.FFT4_MAX_D):
        try:
            p = circconv.plan(D)
        except ValueError as e:
            assert D > circconv.FFT_MAX_D and "no four-step split" in str(e)
            continue
        assert p is not None and p.D == D and circconv.route(D) == p.route
        if p.route != kind:
            continue
        seen += 1
        assert math.prod(p.sides) == D
        for side, passes in zip(p.sides, p.passes):
            assert math.prod(passes) == side
            assert set(passes) <= {2, 4, 8, 3, 5}
            assert all(r == 8 for r in passes[1:] if r in (2, 4, 8))
        if kind == "fft":
            assert D <= circconv.FFT_MAX_D
            assert circconv.onepass_smem_bytes(D) <= circconv.SMEM_BYTES
        else:
            D1, D2 = p.sides
            assert D > circconv.FFT_MAX_D and D2 <= D1 <= circconv.FFT4_MAX_SIDE
            assert D1 % 4 == 0 and D2 % 4 == 0 and p.cols in (4, 8)
            assert D2 % p.cols == 0 and p.cols * D1 <= 16384
    assert seen > 100


@pytest.mark.parametrize("D,sides", [(32768, (256, 128)), (524288, (1024, 512)),
                                     (655360, (1280, 512)), (1572864, (1536, 1024)),
                                     (20480, (160, 128)), (1 << 22, (2048, 2048))])
def test_four_step_split_of_the_lm_shapes(D, sides):
    """The splits the LM training path runs (qwen2.5-32b 1280 x 512,
    mistral-large-123b 1536 x 1024 at S 128) and the powers of two as
    before (D1 = 2^ceil(n/2))."""
    assert circconv.plan(D).sides == sides


def test_plan_struct_matches_its_radices():
    """The ctypes Plan the kernels read: each side's n = 2^la 3^n3 5^n5,
    m = 3^n3 5^n5 and magic = ceil(2^32 / m)."""
    st = circconv.plan(655360).struct
    assert (st.d.n, st.d1.n, st.d2.n, st.cols) == (655360, 1280, 512, 8)
    assert (st.d1.la, st.d1.n3, st.d1.n5, st.d1.m) == (8, 0, 1, 5)
    assert st.d1.magic == -(-(1 << 32) // 5) and st.d2.magic == 0
    for x in range(0, 1 << 16, 7):
        assert (x * st.d1.magic) >> 32 == x // 5
    st = circconv.plan(12288).struct
    assert (st.d.n, st.d.la, st.d.n3, st.d.n5, st.d.m, st.cols) == (12288, 12, 1, 0, 3, 0)


@pytest.mark.parametrize("D", [1 << 23, 1 << 24])
def test_route_raises_for_a_power_of_two_past_the_four_step_limit(D):
    """No kernel takes it, and nothing falls back to another route."""
    with pytest.raises(ValueError, match="four-step kernels' limit"):
        circconv.route(D)
    with pytest.raises(ValueError, match="four-step kernels' limit"):
        circconv.bind_superpose_kernel(torch.zeros(1, 1, D), torch.zeros(1, 2 * D))


@pytest.mark.parametrize("name,G,R,D,want", [
    ("bind_superpose", 4, 4, 524288, (8 + 2) * 524288 * 2),
    ("unbind", 4, 4, 524288, (2 + 8) * 524288 * 2),
    ("bind_superpose", 1, 3, 32768, (3 + 1) * 32768 * 2),
    ("bind_superpose", 4, 4, 655360, (8 + 2) * 655360 * 2),
    ("unbind", 3, 4, 1572864, (2 + 8) * 1572864 * 2)])
def test_fft4_scratch_holds_every_pass_row(name, G, R, D, want):
    """The four-step kernels' scratch: D complex points for each packed row
    of pass A and of pass B, two groups' rows to a complex row (an odd G
    packs its last group alone), in float32 words."""
    assert circconv.fft4_scratch_floats(name, G, R, D) == want


@pytest.mark.parametrize("D,R,want", [(655360, 4, 4 * 641 * 512 * 2),
                                      (524288, 2, 2 * 513 * 512 * 2)])
def test_fft4_tables_and_key_spectra_sizes(D, R, want):
    """The four-step kernels' tables (D twiddles and both sides' quarter
    tables) and R keys' spectra (rows k1 <= D1/2 of the (D1, D2) spectrum),
    in float32 words; the one-pass kernels' quarter table."""
    p = circconv.plan(D)
    D1, D2 = p.sides
    assert circconv.table_floats(p) == (D + D1 // 4 + D2 // 4) * 2
    assert circconv.key_spectra_floats(p, R) == want
    assert circconv.table_floats(circconv.plan(12288)) == 3072 * 2


@pytest.mark.parametrize("D", [64, 16384, 28672, 1 << 23])
def test_fft4_route_refuses_what_its_kernels_do_not_take(D):
    with pytest.raises(ValueError, match="fft4 kernels take a power of two"):
        circconv._bind_superpose_on("fft4", torch.zeros(1, 1, D), torch.zeros(1, 2 * D))


def test_fft4_route_runs_the_plain_version_on_cpu():
    """On CPU tensors the four-step route is the plain contraction (its
    gather in chunks past 16384 points); nothing counts a launch."""
    Z, K = _data(1, 1, 32768, seed=4)
    Zt, kext = torch.from_numpy(Z), ops._kext(torch.from_numpy(K))
    before = dict(circconv.ROUTE_LAUNCHES)
    S = circconv._bind_superpose_on("fft4", Zt, kext)
    want = np.fft.irfft(np.fft.rfft(Z[0, 0].astype(np.float64))
                        * np.fft.rfft(K[0].astype(np.float64)), n=32768)
    np.testing.assert_allclose(S[0].numpy(), want, rtol=1e-5, atol=1e-5)
    assert circconv.ROUTE_LAUNCHES == before


@pytest.mark.parametrize("sign_fn", ["circ_conv_ref", "circ_corr_ref"])
def test_chunked_plain_contraction_sums_the_same_terms(monkeypatch, sign_fn):
    """Past CHUNK_D the plain contraction gathers a chunk of output
    positions at a time; with the threshold lowered it agrees with the
    one-shot gather to float64 rounding (1e-12)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(3, 96)))
    b = torch.from_numpy(rng.normal(size=(2, 3, 96)))
    whole = getattr(tref, sign_fn)(a, b)
    monkeypatch.setattr(tref, "CHUNK_D", 16)
    monkeypatch.setattr(tref, "CHUNK_BYTES", 3 * 96 * 8 * 5)    # 5 rows a chunk
    np.testing.assert_allclose(getattr(tref, sign_fn)(a, b).numpy(), whole.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel_route", ["fft", "direct"])
def test_route_entry_points_run_the_plain_version_on_cpu(kernel_route):
    Z, K = _data(2, 3, 64, seed=3)
    Zt, kext = torch.from_numpy(Z), ops._kext(torch.from_numpy(K))
    before = dict(circconv.ROUTE_LAUNCHES)
    S = circconv._bind_superpose_on(kernel_route, Zt, kext)
    Zh = circconv._unbind_on(kernel_route, S, kext)
    assert torch.equal(S, circconv.bind_superpose_plain(Zt, kext))
    assert torch.equal(Zh, circconv.unbind_plain(S, kext))
    assert circconv.ROUTE_LAUNCHES == before   # CPU tensors never count


def test_route_entry_points_refuse_what_their_kernel_does_not_take():
    Z = torch.zeros(2, 2, 112)      # 112 = 2^4 7: the direct kernels' D
    kext = torch.zeros(2, 224)
    with pytest.raises(ValueError, match="power of two"):
        circconv._bind_superpose_on("fft", Z, kext)
    with pytest.raises(ValueError, match="power of two"):
        circconv._unbind_on("fft", Z[:, 0], kext)
    with pytest.raises(ValueError, match="unknown route"):
        circconv._bind_superpose_on("cufft", Z, kext)


def test_reset_clears_route_counts():
    circconv.ROUTE_LAUNCHES[("unbind", "fft")] += 3
    circconv.LAUNCHES["unbind"] += 3
    circconv.reset_launch_counts()
    assert set(circconv.ROUTE_LAUNCHES) == {
        (k, r) for k in ("bind_superpose", "unbind")
        for r in ("fft", "fft4", "direct")}
    assert not any(circconv.ROUTE_LAUNCHES.values())
    assert not any(circconv.LAUNCHES.values())


@pytest.mark.parametrize("G,R,D", [(2, 3, 12), (1, 2, 5120), (2, 2, 20480)])
def test_mixed_radix_routes_run_the_plain_version_on_cpu(G, R, D):
    """At a D the mixed-radix kernels take, a CPU tensor runs the plain
    contraction through either FFT route, agreeing with the numpy FFT in
    float64 (1e-5), and counts no launch."""
    Z, K = _data(G, R, D, seed=11)
    Zt, kext = torch.from_numpy(Z), ops._kext(torch.from_numpy(K))
    before = dict(circconv.ROUTE_LAUNCHES)
    S = circconv._bind_superpose_on(circconv.route(D), Zt, kext)
    want = np.fft.irfft((np.fft.rfft(Z.astype(np.float64))
                         * np.fft.rfft(K.astype(np.float64))).sum(1), n=D)
    np.testing.assert_allclose(S.numpy(), want, rtol=1e-5, atol=1e-5)
    assert circconv.ROUTE_LAUNCHES == before


def test_fft4_edge_shapes_take_their_branches():
    """The four-step edge shapes of the card's tests reach the branches
    they are there for: (1, 9, 262144) more keys than a pass B chunk of
    4096 points holds (8 rows of 512), and (2, 3, 18000) a divisor split
    with 4-column tiles."""
    p = circconv.plan(262144)
    assert p.route == "fft4" and p.sides == (512, 512) and 4096 // p.sides[1] < 9
    p = circconv.plan(18000)
    assert p.route == "fft4" and p.sides == (180, 100) and p.cols == 4


def test_kept_kext_is_made_anew_after_an_in_place_key_write():
    """The Kext kept per key tensor (with the four-step kernels' key
    spectra, so that they are made once) is the same object while the keys
    are unchanged, and a new one, with the new values, after an in-place
    write to the keys or a view of them; another tensor with equal values
    gets its own.  No spectra where the route is not the four-step one."""
    memo = OrderedDict()
    K = torch.from_numpy(_data(1, 2, 16, seed=12)[1]).clone()
    first, spectra = ops._kept_keys(K, memo)
    assert spectra is None
    assert ops._kept_keys(K, memo)[0] is first
    assert ops._kept_keys(K.detach(), memo)[0] is first
    K.add_(1.0)
    second = ops._kept_keys(K, memo)[0]
    assert second is not first and torch.equal(second, torch.cat([K, K], -1))
    K[0].mul_(2.0)                       # a write through a view
    third = ops._kept_keys(K, memo)[0]
    assert third is not second and torch.equal(third, torch.cat([K, K], -1))
    assert ops._kept_keys(K.clone(), memo)[0] is not third
    for _ in range(ops.KEY_CACHE_SIZE + 2):
        ops._kept_keys(torch.zeros(2, 16), memo)
    assert len(memo) <= ops.KEY_CACHE_SIZE


def test_kext_is_not_kept_on_cpu():
    """CPU tensors take a fresh Kext every call (numpy-backed keys can be
    rewritten without a version bump), and no key spectra."""
    K = torch.from_numpy(_data(1, 2, 16, seed=13)[1])
    assert ops._kext(K) is not ops._kext(K)
    assert ops._keys(K)[1] is None
    assert not ops._KEYS


def test_key_spectra_are_taken_by_the_four_step_route_alone():
    """Only the four-step route reads key spectra; the wrappers refuse them
    elsewhere, and refuse spectra of the wrong size, before any launch."""
    Z, K = _data(1, 2, 16, seed=14)
    Zt, kext = torch.from_numpy(Z), ops._kext(torch.from_numpy(K))
    with pytest.raises(ValueError, match="take no key spectra"):
        circconv.bind_superpose_kernel(Zt, kext, torch.zeros(4))
    with pytest.raises(ValueError, match="take no key spectra"):
        circconv._unbind_on("direct", Zt[:, 0], kext, torch.zeros(4))
    D = 20480
    Zb = torch.zeros(1, 2, D)
    kb = torch.zeros(2, 2 * D)
    want = circconv.key_spectra_floats(circconv.plan(D), 2)
    with pytest.raises(ValueError, match=f"want {want}"):
        circconv.bind_superpose_kernel(Zb, kb, torch.zeros(want - 2))
    with pytest.raises(ValueError, match=f"want {want}"):
        circconv.unbind_kernel(Zb[:, 0], kb, torch.zeros(want, dtype=torch.float64))
