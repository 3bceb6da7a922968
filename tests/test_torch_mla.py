"""The port's training-time MLA (``apply_mla``) and cross-attention
(``apply_cross_attention``) against the reference's, forward and
gradients: the reference's inits carried across through numpy, inputs
from numpy seeds, float32 on both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

B, S, D, H = 2, 12, 64, 4
MLA = dict(kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=6)
# float32; the two packages sum the matmuls and the softmax in other orders
# (measured: outputs 3.6e-7 and gradients 6.0e-7 of their max)
Y_TOL = 1e-5            # max |y difference| / max |y|
GRAD_TOL = 1e-5         # max |grad difference| / max |grad|, per leaf


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _check(jfn, tfn, pj, inputs, seed=1):
    """y and the gradients of every leaf and input, both packages."""
    rng = np.random.default_rng(seed)
    y0 = np.asarray(jfn(pj, *inputs))
    cot = rng.normal(size=y0.shape).astype(np.float32)

    def jloss(p, *xs):
        y = jfn(p, *xs)
        return jnp.sum(y * cot), y
    (_, yj), gj = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
        pj, *map(jnp.asarray, inputs))
    tp = tree_map(lambda t: t.clone().requires_grad_(), params_from_numpy(pj, "cpu"))
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    yt = tfn(tp, *xs)
    got = torch.autograd.grad((yt * torch.from_numpy(cot)).sum(), tree_leaves(tp) + xs)
    assert _rel(yt.detach(), yj) <= Y_TOL
    want = jax.tree.leaves(gj[0]) + list(gj[1:])
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(pj)[0]] + ["input"] * len(xs)
    assert len(got) == len(want) == len(names)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape
        if name == "['b_k']":
            # a key bias adds q . b_k to every key's score alike, which the
            # softmax cancels: its exact gradient is 0, and both packages'
            # are rounding noise, held to GRAD_TOL of the largest gradient
            assert max(float(g.abs().max()), float(np.abs(w).max())) <= GRAD_TOL * top
        else:
            assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("window", [None, 5])
def test_apply_mla_matches_reference(window):
    pj = jax.tree.map(np.asarray, jattn.init_mla(jax.random.PRNGKey(0), D, H, **MLA))
    rng = np.random.default_rng(0)
    pj["kv_norm"] = (1 + 0.1 * rng.normal(size=pj["kv_norm"].shape)).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kw = dict(num_heads=H, rope_theta=10000.0, sliding_window=window, **MLA)
    _check(lambda p, x_: jattn.apply_mla(p, x_, jnp.asarray(positions), **kw),
           lambda p, x_: tattn.apply_mla(p, x_, torch.from_numpy(positions.copy()),
                                         **kw),
           pj, [x])


@pytest.mark.parametrize("bias", [False, True])
def test_apply_cross_attention_matches_reference(bias):
    """Queries from x (B, 12, D), keys and values from a longer memory
    (B, 20, D), GQA with 2 kv heads; no mask, no rope."""
    KV, hd = 2, 16
    pj = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(1), D, H, KV, hd,
                                                 qkv_bias=bias))
    rng = np.random.default_rng(2)
    if bias:
        for k in ("b_q", "b_k", "b_v"):
            pj[k] = (0.1 * rng.normal(size=pj[k].shape)).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    mem = rng.normal(size=(B, 20, D)).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd)
    _check(lambda p, x_, m: jattn.apply_cross_attention(p, x_, m, **kw),
           lambda p, x_, m: tattn.apply_cross_attention(p, x_, m, **kw),
           pj, [x, mem])
