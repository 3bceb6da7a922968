"""The port's circconv kernel wrappers (their plain versions on the CPU), its
oracles and its autograd Functions, held against the JAX reference
(repro.kernels: the oracles, and the Pallas kernels in interpret mode)."""
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


@pytest.mark.parametrize("G,R,D", [(2, 2, 128), (3, 5, 96), (2, 8, 512)])
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
    (32, "fft"), (64, "fft"), (96, "direct"), (127, "direct"), (2048, "fft"),
    (4096, "fft"), (4097, "direct"), (5120, "direct"), (12288, "direct"),
    (16384, "fft"), (32768, "fft4"), (20480, "direct"), (65536, "fft4"),
    (524288, "fft4"), (655360, "direct"), (1 << 22, "fft4"),
    ((1 << 22) + 1, "direct")])
def test_route_picks_fft_for_powers_of_two_up_to_the_limit(D, want):
    """The one-pass FFT kernels take every power of two in [4, 16384], the
    four-step kernels every power of two past it up to 2^22 (the LM
    training path's D = S * d_model, 524288 at S 128 and d_model 4096);
    every D that is not a power of two (ragged, the LM widths 5120 and
    12288, 128 * 5120 past shared memory) goes to the direct kernels.  By
    D alone."""
    assert circconv.route(D) == want
    assert (circconv.FFT_MIN_D, circconv.FFT_MAX_D, circconv.FFT4_MAX_D) == \
        (4, 16384, 1 << 22)


@pytest.mark.parametrize("D", [1 << 23, 1 << 24])
def test_route_raises_for_a_power_of_two_past_the_four_step_limit(D):
    """No kernel takes it, and nothing falls back to another route."""
    with pytest.raises(ValueError, match="four-step kernels' limit"):
        circconv.route(D)
    with pytest.raises(ValueError, match="four-step kernels' limit"):
        circconv.bind_superpose_kernel(torch.zeros(1, 1, D), torch.zeros(1, 2 * D))


@pytest.mark.parametrize("name,G,R,D,want", [
    ("bind_superpose", 4, 4, 524288, (16 + 4 + 4) * 524288 * 2),
    ("unbind", 4, 4, 524288, (4 + 4 + 16) * 524288 * 2),
    ("bind_superpose", 1, 3, 32768, (3 + 3 + 1) * 32768 * 2)])
def test_fft4_scratch_holds_every_pass_row(name, G, R, D, want):
    """The four-step kernels' scratch: D complex points for each data row
    and key of pass A and each output row of pass B (float32 words)."""
    assert circconv.fft4_scratch_floats(name, G, R, D) == want


@pytest.mark.parametrize("D", [64, 16384, 20480, 1 << 23])
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
    Z = torch.zeros(2, 2, 96)
    kext = torch.zeros(2, 192)
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
