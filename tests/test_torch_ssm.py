"""The port's Mamba and RWKV-6 blocks (``repro_torch.models.mamba``,
``repro_torch.models.rwkv``) against the reference's, forward and
gradients: the reference's inits carried across through numpy (with the
zero-initialised biases and the 0.5 mixes set to numpy draws so that they
count), inputs from numpy seeds, float32 on both sides.  The RWKV time-mix
runs in both modes against the reference, and its chunked form against
its sequential one inside the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

B, S, D = 2, 12, 32
# float32.  The port runs the Mamba scan as a Hillis-Steele prefix scan,
# the reference as jax.lax.associative_scan: the same combine in another
# tree.  Measured (outputs / gradients, of their max): Mamba 3.8e-7 /
# 6.5e-7; RWKV
# time-mix, chunked 7.3e-7 / 1.4e-6, sequential 6.9e-7 / 1.0e-6;
# channel-mix 1.8e-7 / 2.8e-7; port chunked against port sequential
# 1.6e-7 / 9.0e-7.
Y_TOL = 1e-5            # max |y difference| / max |y|
GRAD_TOL = 1e-5         # max |grad difference| / max |grad|, per leaf


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _perturb(pj, keys, seed):
    rng = np.random.default_rng(seed)
    for k in keys:
        pj[k] = (pj[k] + 0.1 * rng.normal(size=pj[k].shape)).astype(np.float32)
    return pj


def _port_grads(tfn, pj, x, cot):
    tp = tree_map(lambda t: t.clone().requires_grad_(), params_from_numpy(pj, "cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    y = tfn(tp, xt)
    return y.detach(), torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                           tree_leaves(tp) + [xt])


def _check(jfn, tfn, pj, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)

    def jloss(p, x_):
        y = jfn(p, x_)
        return jnp.sum(y * cot), y
    (_, yj), gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        pj, jnp.asarray(x))
    yt, got = _port_grads(tfn, pj, x, cot)
    assert _rel(yt, yj) <= Y_TOL
    want = jax.tree.leaves(gj[0]) + [gj[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= GRAD_TOL, (g.shape, _rel(g, w))


@pytest.mark.parametrize("chunk", [6, 5], ids=["divides", "does-not-divide"])
def test_apply_mamba_matches_reference(chunk):
    """Chunk 6 scans S = 12 in two chunks; chunk 5 does not divide S, so
    both packages step down to 4 (three chunks)."""
    pj = jax.tree.map(np.asarray, jmamba.init_mamba(jax.random.PRNGKey(0), D, 2 * D,
                                                    d_state=8))
    pj = _perturb(pj, ("conv_b", "dt_bias", "D"), 1)
    kw = dict(d_state=8, chunk=chunk)
    _check(lambda p, x: jmamba.apply_mamba(p, x, **kw),
           lambda p, x: tmamba.apply_mamba(p, x, **kw), pj)


@pytest.mark.parametrize("c", [1, 7, 12])
def test_mamba_prefix_scan_equals_the_recurrence(c):
    """``_prefix_scan`` against the step-by-step recurrence h_t = a_t
    h_{t-1} + b_t from h = 0 (float64, so the two trees of products agree
    to 1e-12), at chunk lengths that are not powers of two."""
    rng = np.random.default_rng(c)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 4)))
    b = torch.from_numpy(rng.normal(size=(2, c, 3, 4)))
    cum_a, h = tmamba._prefix_scan(a, b)
    want_h, want_a = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(c):
        want_h = a[:, t] * want_h + b[:, t]
        want_a = want_a * a[:, t]
        torch.testing.assert_close(h[:, t], want_h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(cum_a[:, t], want_a, rtol=1e-12, atol=1e-12)


def _timemix_params():
    pj = jax.tree.map(np.asarray, jrwkv.init_rwkv_timemix(
        jax.random.PRNGKey(2), D, 4, decay_lora=8))
    return _perturb(pj, ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "w0",
                         "ln_scale"), 3)


@pytest.mark.parametrize("mode", ["chunked", "sequential"])
def test_rwkv_timemix_matches_reference(mode):
    """Chunk 4 over S = 12: three chunks, so the inter-chunk state and the
    midpoint-centred factors both count."""
    pj = _timemix_params()
    kw = dict(num_heads=4, chunk=4, mode=mode)
    _check(lambda p, x: jrwkv.apply_rwkv_timemix(p, x, **kw),
           lambda p, x: trwkv.apply_rwkv_timemix(p, x, **kw), pj)


def test_rwkv_timemix_chunked_equals_sequential_in_the_port():
    pj = _timemix_params()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    outs = {m: _port_grads(lambda p, x_: trwkv.apply_rwkv_timemix(
        p, x_, num_heads=4, chunk=4, mode=m), pj, x, cot)
        for m in ("chunked", "sequential")}
    (yc, gc), (ys, gs) = outs["chunked"], outs["sequential"]
    assert _rel(yc, ys) <= Y_TOL
    for a, b in zip(gc, gs):
        assert _rel(a, b) <= GRAD_TOL


def test_rwkv_channelmix_matches_reference():
    pj = jax.tree.map(np.asarray, jrwkv.init_rwkv_channelmix(
        jax.random.PRNGKey(5), D, 2 * D))
    pj = _perturb(pj, ("mix_k", "mix_r"), 6)
    _check(jrwkv.apply_rwkv_channelmix, trwkv.apply_rwkv_channelmix, pj)
