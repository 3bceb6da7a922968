"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``apply_moe``: the same weights (the reference's ``init_moe``, carried
across through numpy) and inputs (numpy seeds), float32 on both sides.

The routing is compared as integers, exactly: each token's experts in
top-k order, which copies keep a slot and which slot.  The reference's
routing is read with the same lines as its ``apply_moe``
(``src/repro/models/moe.py:45-55``).  Then the output y, the Switch aux
loss and the gradients of x and of every leaf, at the default capacity
factor and at one small enough that copies are dropped, with and without
shared experts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

B, S, D, FF, E, K = 2, 16, 32, 16, 4, 2
# float32; XLA:CPU and PyTorch sum the matmuls in other orders (measured:
# y 3.0e-7 and gradients 4.9e-7 of their max, aux 1.1e-7 relative)
Y_TOL = 1e-5            # max |y difference| / max |y|
AUX_TOL = 1e-6          # relative
GRAD_TOL = 1e-5         # max |grad difference| / max |grad|, per leaf


def _ref_routing(p, xf, top_k, capacity_factor):
    """The reference apply_moe's routing lines, returning its integers."""
    N = xf.shape[0]
    E_ = p["router"].shape[-1]
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    cap = max(int(top_k * N * capacity_factor / E_), 1)
    e_flat = expert_idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(e_flat, E_, dtype=jnp.int32), axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
    keep = pos_in_e < cap
    dest = jnp.where(keep, e_flat * cap + pos_in_e, E_ * cap)
    return np.asarray(expert_idx), np.asarray(keep), np.asarray(dest)


def _setup(shared, seed=0):
    pj = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), D, FF, E, num_shared_experts=shared))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    return pj, x, cot


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap", "drops"])
def test_apply_moe_matches_reference(cf, shared):
    pj, x, cot = _setup(shared)

    # routing, as integers
    want_idx, want_keep, want_dest = _ref_routing(pj, jnp.asarray(x).reshape(-1, D),
                                                  K, cf)
    pt = params_from_numpy(pj, device="cpu")
    r = tmoe.route(pt, torch.from_numpy(x).reshape(-1, D), top_k=K,
                   capacity_factor=cf)
    np.testing.assert_array_equal(r["expert_idx"].numpy(), want_idx)
    np.testing.assert_array_equal(r["keep"].numpy(), want_keep)
    np.testing.assert_array_equal(r["dest"].numpy(), want_dest)
    dropped = int((~want_keep).sum())
    assert (dropped > 0) == (cf < 1), dropped
    # every kept copy's slot names that copy back; empty slots name none
    slot = r["slot_copy"].numpy()
    kept = np.flatnonzero(want_keep)
    np.testing.assert_array_equal(slot[want_dest[kept]], kept)
    assert (slot == B * S * K).sum() == E * r["cap"] - kept.size

    # forward, aux and the gradients of x and every leaf
    def jf(p, x_):
        y, aux = jmoe.apply_moe(p, x_, top_k=K, capacity_factor=cf)
        return jnp.sum(y * cot) + aux, (y, aux)
    (_, (yj, auxj)), gj = jax.jit(jax.value_and_grad(jf, argnums=(0, 1),
                                                     has_aux=True))(pj, jnp.asarray(x))
    tp = tree_map(lambda t: t.clone().requires_grad_(), pt)
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = tmoe.apply_moe(tp, xt, top_k=K, capacity_factor=cf)
    loss = (yt * torch.from_numpy(cot)).sum() + auxt
    got = torch.autograd.grad(loss, tree_leaves(tp) + [xt])
    assert _rel(yt.detach(), yj) <= Y_TOL
    assert abs(float(auxt.detach()) - float(auxj)) <= AUX_TOL * abs(float(auxj))
    want = jax.tree.leaves(gj[0]) + [gj[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= GRAD_TOL, (g.shape, _rel(g, w))


def test_dispatch_rows_are_adjoint_gathers():
    """``_MoveRows`` forward gathers by one map, backward by its inverse:
    the gradient equals autograd of the plain zero-padded gather (float64,
    exact), and two runs are bitwise equal."""
    rng = np.random.default_rng(1)
    n, m, d = 6, 5, 3
    take = torch.tensor([2, 6, 0, 6, 4])        # 6 reads the zero row
    back = torch.tensor([2, 5, 0, 5, 4, 5])     # rows 1, 3 and 5 unread
    x = torch.from_numpy(rng.normal(size=(n, d))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(m, d)))
    y = tmoe._MoveRows.apply(x, take, back)
    (gx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_()
    y2 = torch.cat([x2, torch.zeros(1, d, dtype=x2.dtype)])[take]
    (gx2,) = torch.autograd.grad(y2, x2, g)
    assert torch.equal(y, y2) and torch.equal(gx, gx2)
    assert torch.equal(tmoe._MoveRows.apply(x, take, back), y)


def test_routing_log_records_kept_copies():
    pj, x, _ = _setup(0)
    pt = params_from_numpy(pj, device="cpu")
    tmoe.ROUTING_LOG = []
    try:
        _, aux = tmoe.apply_moe(pt, torch.from_numpy(x), top_k=K,
                                capacity_factor=0.5)
        (kept, total, logged_aux), = tmoe.ROUTING_LOG
    finally:
        tmoe.ROUTING_LOG = None
    _, want_keep, _ = _ref_routing(pj, jnp.asarray(x).reshape(-1, D), K, 0.5)
    assert int(kept) == int(want_keep.sum()) and total == B * S * K
    assert torch.equal(logged_aux, aux.detach())
