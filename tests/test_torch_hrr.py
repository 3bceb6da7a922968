"""The port's HRR primitives (repro_torch.core.hrr) against the JAX reference
(repro.core.hrr), plus the reference's internal identities re-proved inside
the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hrr as jhrr  # noqa: E402
from repro_torch.core import hrr  # noqa: E402

# jitted reference functions: one compile per shape instead of one per op
_bind = jax.jit(jhrr.bind_superpose, static_argnames=("backend",))
_unbind = jax.jit(jhrr.unbind, static_argnames=("backend",))
_masked_unbind = jax.jit(jhrr.masked_unbind, static_argnames=("backend",))

# tolerance of the reference's backend-vs-oracle test (tests/test_kernels.py:59):
# the fft and direct routes sum in another order than the oracle
TOL = 2e-4


def _data(G, R, D, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(G, R, D)).astype(np.float32)
    K = rng.normal(size=(R, D)).astype(np.float32)
    K /= np.linalg.norm(K, axis=-1, keepdims=True)
    return Z, K


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("backend", ["fft", "direct"])
@pytest.mark.parametrize("cached_spectrum", [False, True])
@pytest.mark.parametrize("G,R,D", [(4, 4, 128), (3, 5, 96), (2, 2, 127)])
def test_backends_match_reference(backend, cached_spectrum, G, R, D):
    Z, K = _data(G, R, D)
    KF = jhrr.key_spectrum(jnp.asarray(K)) if cached_spectrum else None
    KFt = hrr.key_spectrum(_t(K)) if cached_spectrum else None
    S = hrr.bind_superpose(_t(Z), _t(K), backend=backend, K_fft=KFt)
    Sj = _bind(jnp.asarray(Z), jnp.asarray(K), backend=backend, K_fft=KF)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=TOL, atol=TOL)
    Zh = hrr.unbind(S, _t(K), backend=backend, K_fft=KFt)
    Zhj = _unbind(jnp.asarray(S.numpy()), jnp.asarray(K), backend=backend, K_fft=KF)
    np.testing.assert_allclose(Zh.numpy(), np.asarray(Zhj), rtol=TOL, atol=TOL)
    assert S.shape == (G, D) and Zh.shape == (G, R, D)


@pytest.mark.parametrize("name", ["circ_conv_fft", "circ_corr_fft",
                                  "circ_conv_direct", "circ_corr_direct"])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")])
def test_pairwise_helpers_match_reference(name, dtypes):
    """The four public helpers, with leading dims that broadcast, and the
    reference's output dtype (the operands' promoted type).  bfloat16
    inputs are rounded copies of the same values on both sides; the fft
    forms transform in float32 on both sides, the direct forms sum in the
    promoted type, so bfloat16 outputs are held to a bfloat16 step."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 1, 64)).astype(np.float32)
    b = rng.normal(size=(1, 4, 64)).astype(np.float32)
    ja, jb = (jnp.asarray(x).astype(d) for x, d in zip((a, b), dtypes))
    ta, tb = (_t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, d))
              for x, d in zip((ja, jb), dtypes))
    want = getattr(jhrr, name)(ja, jb)
    got = getattr(hrr, name)(ta, tb)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tuple(got.shape) == want.shape == (3, 4, 64)
    tol = 2e-2 * float(jnp.abs(want.astype(jnp.float32)).max()) \
        if got.dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=tol)


def test_key_spectrum_matches_reference():
    _, K = _data(1, 4, 128)
    np.testing.assert_allclose(hrr.key_spectrum(_t(K)).numpy(),
                               np.asarray(jhrr.key_spectrum(jnp.asarray(K))),
                               rtol=1e-5, atol=1e-5)
    assert hrr.key_spectrum(_t(K)).dtype == torch.complex64


@pytest.mark.parametrize("backend", ["fft", "direct", "pallas"])
def test_backward_matches_reference_custom_vjp(backend):
    """The adjoint of bind is unbind and the reverse, with the same keys."""
    Z, K = _data(2, 4, 128, seed=3)
    dS = np.random.default_rng(4).normal(size=(2, 128)).astype(np.float32)
    Zt = _t(Z).requires_grad_()
    (g,) = torch.autograd.grad(
        (hrr.bind_superpose(Zt, _t(K), backend=backend) * _t(dS)).sum(), [Zt])
    gj = jax.jit(jax.grad(lambda z: jnp.vdot(jhrr.bind_superpose(
        z, jnp.asarray(K), backend=backend), jnp.asarray(dS))))(jnp.asarray(Z))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=TOL, atol=TOL)
    S = np.array(_bind(jnp.asarray(Z), jnp.asarray(K)))
    St = _t(S).requires_grad_()
    dZ = np.random.default_rng(5).normal(size=(2, 4, 128)).astype(np.float32)
    (g,) = torch.autograd.grad(
        (hrr.unbind(St, _t(K), backend=backend) * _t(dZ)).sum(), [St])
    gj = jax.jit(jax.grad(lambda s: jnp.vdot(jhrr.unbind(
        s, jnp.asarray(K), backend=backend), jnp.asarray(dZ))))(jnp.asarray(S))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["fft", "direct", "pallas"])
def test_keys_take_no_gradient(backend):
    Z, K = _data(2, 2, 64)
    Kt = _t(K).requires_grad_()
    Zt = _t(Z).requires_grad_()
    out = hrr.bind_superpose(Zt, Kt, backend=backend)
    gz, gk = torch.autograd.grad(hrr.unbind(out, Kt, backend=backend).sum(),
                                 [Zt, Kt], allow_unused=True,
                                 materialize_grads=True)
    assert (gk == 0).all() and gz.abs().sum() > 0


@pytest.mark.parametrize("backend", ["fft", "direct", "pallas"])
def test_masked_unbind_all_ones_is_bitwise_unbind(backend):
    """Port against port: at an all-ones mask the erasure decode is exactly
    the plain decode (S * 1.0 and the scale D / D == 1.0 are IEEE-exact)."""
    Z, K = _data(4, 4, 128, seed=6)
    S = hrr.bind_superpose(_t(Z), _t(K), backend=backend)
    ones = torch.ones_like(S)
    a = hrr.masked_unbind(S, _t(K), ones, backend=backend)
    b = hrr.unbind(S, _t(K), backend=backend)
    assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["fft", "direct"])
def test_masked_unbind_matches_reference(backend):
    Z, K = _data(4, 4, 128, seed=7)
    S = np.array(_bind(jnp.asarray(Z), jnp.asarray(K)))
    keep = (np.random.default_rng(8).random(S.shape) > 0.2).astype(np.float32)
    got = hrr.masked_unbind(_t(S), _t(K), _t(keep), backend=backend)
    want = _masked_unbind(jnp.asarray(S), jnp.asarray(K), jnp.asarray(keep),
                          backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_retrieval_snr_matches_reference():
    Z, K = _data(4, 4, 128, seed=9)
    Zf = Z.reshape(16, 128)[:4].reshape(1, 4, 128)
    S = hrr.bind_superpose(_t(Zf), _t(K))
    Zh = hrr.unbind(S, _t(K))
    snr = hrr.retrieval_snr(_t(Zf), Zh)
    want = jhrr.retrieval_snr(jnp.asarray(Zf), jnp.asarray(Zh.numpy()))
    np.testing.assert_allclose(float(snr), float(want), rtol=1e-5)
    # perfect retrieval saturates at the 1e-12 error floor, as the reference
    assert float(hrr.retrieval_snr(_t(Zf), _t(Zf))) == pytest.approx(
        float(jhrr.retrieval_snr(jnp.asarray(Zf), jnp.asarray(Zf))), rel=1e-6)


def test_unitary_projection_on_given_keys():
    """RNG parity with jax.random is impossible, so the projection is held
    on keys given as input: against the reference formula on the same raw
    draws, and as a fixed point on the reference's own unitary keys."""
    D = 128
    raw = np.random.default_rng(10).normal(size=(4, D)).astype(np.float32) * D ** -0.5
    got = hrr.project_keys(_t(raw), unitary=True).numpy()
    F = np.fft.fft(raw.astype(np.float64), axis=-1)
    k = np.fft.ifft(F / np.maximum(np.abs(F), 1e-12), axis=-1).real
    want = k / np.linalg.norm(k, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.abs(np.fft.fft(got, axis=-1)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    ref_keys = np.asarray(jhrr.generate_keys(jax.random.PRNGKey(0), 4, D, unitary=True))
    np.testing.assert_allclose(hrr.project_keys(_t(ref_keys), unitary=True).numpy(),
                               ref_keys, atol=1e-6)
    # the paper-faithful sampler only normalizes
    plain = hrr.project_keys(_t(raw), unitary=False).numpy()
    np.testing.assert_allclose(plain, raw / np.linalg.norm(raw, axis=-1, keepdims=True),
                               rtol=1e-6)


@pytest.mark.parametrize("unitary", [False, True])
def test_generate_keys_seeded_unit_norm(unitary):
    a = hrr.generate_keys(torch.Generator().manual_seed(3), 4, 256, unitary=unitary,
                          device="cpu")
    b = hrr.generate_keys(torch.Generator().manual_seed(3), 4, 256, unitary=unitary,
                          device="cpu")
    assert a.shape == (4, 256) and a.dtype == torch.float32
    assert torch.equal(a, b)
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=-1).numpy(), 1.0,
                               rtol=1e-6)
    if unitary:   # exact self-retrieval: binding is a rotation
        Z = torch.randn(1, 1, 256, generator=torch.Generator().manual_seed(4))
        Zh = hrr.unbind(hrr.bind_superpose(Z, a[:1]), a[:1])
        np.testing.assert_allclose(Zh.numpy(), Z.numpy(), atol=1e-4)
