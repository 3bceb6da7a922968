"""The port's split-learning train step and its parts (models, data,
optimizers, the codec at the cut) against the JAX reference, on the same
weights (drawn from a numpy seed, carried over through repro_torch.interop)
and the same HRR keys (the reference codec's).

Tolerances.  The reference for the whole VGG-16 step runs in float64: there
the port matches it to 1e-6 (loss) and 1e-5 of each gradient leaf's largest
entry (the codec itself still sums in float32 on both sides), which pins
the algorithm.  The port's float32 step is then held to that float64
truth: the loss to rtol 1e-4, and each gradient leaf to a relative L2 error
of 1e-2.  BatchNorm's backward over batch 8 cancels about three digits in
float32 on the client side of the cut: measured against the float64 truth,
the reference's own float32 gradients are up to 8.8e-3 off, the port's up to
3.1e-3 (the server side is within 1e-5 on both).  The same tolerances hold
the gradient that crosses the cut, which stands in for the client-side
leaves of the specs whose reference stops at the cut (see ``FULL_SPEC``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro import codecs as jcodecs  # noqa: E402
from repro.data.pipeline import SyntheticImageDataset as JDataset  # noqa: E402
from repro.models import convnets as jnets  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.transport import split as jsplit  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.configs import paper  # noqa: E402
from repro_torch.data.pipeline import SyntheticImageDataset  # noqa: E402
from repro_torch.interop import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 tree_leaves)
from repro_torch.models import convnets  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.transport import split  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_L2_RTOL = 1e-2     # float32 port vs float64 reference, per leaf


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaf_pairs(got, want):
    got_l = [np.asarray(x) for x in tree_leaves(params_to_numpy(got))]
    want_l = jax.tree.leaves(_np_tree(want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        yield g.astype(np.float64), w.astype(np.float64)


def _assert_pairs_close(pairs, tol):
    """Each (got, want) within ``tol`` of want's largest entry."""
    for g, w in pairs:
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def _assert_pairs_l2_close(pairs, rtol=GRAD_L2_RTOL):
    """Each (got, want)'s relative L2 error within ``rtol``."""
    for g, w in pairs:
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rtol, (g.shape, err)


def _numpy_init(init_fn, seed):
    """Weights of the reference's tree structure and shapes, drawn from a
    numpy seed (RNG parity with jax.random is impossible): conv and fc
    weights ~ N(0, 2/fan_in), BatchNorm scale ~ 1 + N(0, 0.1^2), biases
    ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.ndim == 1:
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan = int(np.prod(leaf.shape[1:])) if leaf.ndim == 4 else leaf.shape[0]
        return (rng.normal(size=leaf.shape) * (2.0 / fan) ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [32, 8, 7])
def test_conv2d_same_padding_matches_xla(k, stride, size):
    """XLA's SAME padding is uneven at stride 2 (low side total // 2): the
    ResNet stem (7x7, stride 2, 32 -> 16) pads (2, 3), F.conv2d's symmetric
    padding=3 would not match."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 5, size, size)).astype(np.float32)
    w = (rng.normal(size=(6, 5, k, k)) * (2.0 / (5 * k * k)) ** 0.5).astype(np.float32)
    got = convnets.conv2d(_t(x), _t(w), stride=stride)
    want = jnets.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bn_and_max_pool_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 5, 5)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    got = convnets._bn(_t(x), params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnets._bn(jnp.asarray(x), p)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(convnets.max_pool(_t(x)).numpy(),
                                  np.asarray(jnets.max_pool(jnp.asarray(x))))


def test_resnet_bottleneck_stride2_matches_reference():
    p = _numpy_init(lambda k: jnets._init_bottleneck(k, 32, 16, 2), 3)
    x = np.random.default_rng(2).normal(size=(4, 32, 8, 8)).astype(np.float32)
    got = convnets._apply_bottleneck(params_from_numpy(p, "cpu"), _t(x), 2)
    want = jax.jit(jnets._apply_bottleneck, static_argnums=2)(p, jnp.asarray(x), 2)
    assert tuple(got.shape) == want.shape == (4, 64, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_port_init_shapes_follow_reference():
    g = torch.Generator().manual_seed(0)
    vgg = convnets.init_vgg16(g, device="cpu")
    ref = jax.eval_shape(jnets.init_vgg16, jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in tree_leaves(vgg)] == \
        [x.shape for x in jax.tree.leaves(ref)]
    res = convnets.init_resnet50(g, device="cpu")
    ref = jax.eval_shape(jnets.init_resnet50, jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in tree_leaves(res)] == \
        [x.shape for x in jax.tree.leaves(ref)]
    assert 23e6 < sum(x.numel() for x in tree_leaves(res)) < 27e6
    assert convnets.VGG_D == paper.VGG16_CIFAR10.D == 2048
    assert convnets.RESNET_D == paper.RESNET50_CIFAR100.D == 4096


# --------------------------------------------------------------------------
# the VGG-16 split step (module-scoped reference weights)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg():
    net = _numpy_init(jnets.init_vgg16, 0)
    batch = JDataset(n_classes=10).batch(8, 0)
    return net, batch, {}


def test_vgg16_front_back_match_reference(vgg):
    net, batch, _ = vgg
    tnet = params_from_numpy(_np_tree(net), "cpu")
    x = _t(batch["x"])
    z = convnets.vgg16_front(tnet, x)
    zj = jax.jit(jnets.vgg16_front)(net, batch["x"])
    assert tuple(z.shape) == zj.shape == (8, *convnets.VGG_CUT_SHAPE)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-4, atol=1e-4)
    logits = convnets.vgg16_back(tnet, _t(zj))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax.jit(jnets.vgg16_back)(net, zj)),
                               rtol=1e-4, atol=1e-4)


def _ref_loss(logits, y):
    return -jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y].mean()


# The spec whose reference runs the front's float64 VJP, so that every
# gradient leaf of the port's step is compared directly.  That VJP costs
# about 4 s on XLA:CPU; for the other specs the reference stops at the cut:
# loss, the server-side (back) leaves and the gradient that crosses the cut
# are compared, and the client-side leaves follow from that cut gradient
# through the front's backward, which this spec pins.
FULL_SPEC = "c3sl:R=4,backend=pallas"
# the VGG-16 cut, for the flat (D) and the nchw (C, H, W) codecs
CUT = dict(D=2048, C=512, H=2, W=2)


def _reference(vgg, spec):
    """Reference codec keys, and the float64 step of VGG-16 through the
    codec (cached per spec for the module): ``{"jcp", "loss", "back"`` (the
    back's gradient tree, zero on the front's leaves), ``"cut"`` (the
    gradient at the front's output), ``"grads"`` (every leaf, for
    ``FULL_SPEC`` only, else None)``}``.

    The step is the reference's ``make_split_loss_fn`` composition, front ->
    ``apply_codec`` -> back -> loss, differentiated by the chain rule over
    its pieces (the front's VJP, the codec round trip's VJP, the back's
    gradient) so that VGG-16 compiles once for every codec."""
    net, batch, cache = vgg
    if spec in cache:
        return cache[spec]
    jc = jcodecs.build(spec, **CUT)
    jcp = _np_tree(jc.init(jax.random.PRNGKey(1)))
    trains = getattr(jc, "trainable", False)
    with jax.enable_x64(True):
        if "pieces" not in cache:
            net64 = jax.tree.map(lambda a: np.asarray(a, np.float64), net)
            x64 = np.asarray(batch["x"], np.float64)
            # one forward pass keeps the residuals that the VJP reuses
            z, vjp = jax.vjp(jax.jit(lambda n: jnets.vgg16_front(n, x64)), net64)
            back = jax.jit(jax.value_and_grad(
                lambda n, z: _ref_loss(jnets.vgg16_back(n, z), batch["y"]),
                argnums=(0, 1)))
            cache["pieces"] = (net64, z, vjp, back)
        net64, z, vjp, back = cache["pieces"]
        # a trainable codec runs in float64 too (its convs take one dtype)
        cp = jax.tree.map(lambda a: np.asarray(a, np.float64), jcp) if trains else jcp

        def roundtrip(t, cp):
            return jsplit.apply_codec(jc, cp, t)
        zhat = jax.jit(roundtrip)(z, cp)
        loss, (g_back, g_zhat) = back(net64, zhat)
        g_z, g_codec = jax.jit(lambda t, cp, ct: jax.vjp(roundtrip, t, cp)[1](ct))(
            z, cp, g_zhat)
        g_z = np.asarray(g_z, np.float64)
        grads = None
        if spec == FULL_SPEC:
            (g_front,) = jax.jit(lambda f, ct: f(ct))(vjp, g_z)
            grads = _np_tree(jax.tree.map(lambda a, b: a + b, g_back, g_front))
        cache[spec] = {"jcp": jcp, "loss": float(loss), "back": _np_tree(g_back),
                       "cut": g_z, "grads": grads,
                       "codec": _np_tree(g_codec) if trains else None}
    return cache[spec]


def _port_setup(vgg, spec, jcp, dtype=np.float32, cut=None):
    """Port weights, split loss and batch; with a list ``cut``, the gradient
    at the front's output is appended to it during the backward pass."""
    net, _, _ = vgg
    c = codecs.build(spec, **CUT)
    params = {"net": params_from_numpy(jax.tree.map(lambda a: np.asarray(a, dtype),
                                                    net), "cpu"),
              "codec": params_from_numpy(jcp, "cpu")}

    def front(p, x):
        z = convnets.vgg16_front(p, x)
        if cut is not None:
            z.register_hook(cut.append)
        return z
    loss_fn = split.make_split_loss_fn(front, convnets.vgg16_back, c, F.cross_entropy)
    batch = SyntheticImageDataset(n_classes=10).batch(8, 0, device="cpu")
    batch["x"] = batch["x"].to(getattr(torch, np.dtype(dtype).name))
    return params, loss_fn, batch


def _port_step_vs_reference(vgg, spec, dtype):
    """The port's step and the reference's, as pairs of float64 numpy trees
    to compare: every leaf for ``FULL_SPEC``; otherwise the back's leaves
    and the cut gradient, and every codec leaf for a trainable codec.
    Returns (port loss, reference loss, pairs)."""
    ref = _reference(vgg, spec)
    cut = []
    params, loss_fn, batch = _port_setup(vgg, spec, ref["jcp"], dtype, cut)
    lt, gt, _ = split.split_value_and_grad(loss_fn, params, batch)
    assert lt.dtype == getattr(torch, np.dtype(dtype).name) and len(cut) == 1
    assert sorted(gt) == (["codec", "net"] if ref["codec"] else ["net"])
    if ref["grads"] is not None:
        return lt, ref["loss"], list(_leaf_pairs(gt["net"], ref["grads"]))
    pairs = [(g, w) for g, w in _leaf_pairs(gt["net"], ref["back"]) if w.any()]
    assert 0 < len(pairs) < len(jax.tree.leaves(ref["back"]))
    pairs.append((cut[0].numpy().astype(np.float64), ref["cut"]))
    if ref["codec"] is not None:
        got = params_to_numpy(gt["codec"])
        for k, w in ref["codec"].items():
            g = got[k].astype(np.float64)
            if k in ("b_enc", "b_dec"):
                # in front of a BatchNorm: exactly 0, float32 noise here
                scale = np.abs(ref["codec"]["w" + k[1:]]).max()
                assert np.abs(g).max() <= 1e-4 * scale, k
            else:
                pairs.append((g, np.asarray(w, np.float64)))
    return lt, ref["loss"], pairs


@pytest.mark.parametrize("spec", ["c3sl:R=4", "c3sl:R=4|int8",
                                  "c3sl:R=4,backend=pallas", "bnpp:R=4"])
def test_vgg16_split_loss_and_grads_match_reference(vgg, spec):
    """The whole slice in float32: front -> encode -> (int8) -> decode ->
    back -> loss, and the backward pass through the codec's adjoint, at
    B=8, R=4, against the reference's float64 step.  BottleNet++ trains:
    its codec leaves take their gradients too (the pre-BatchNorm biases,
    whose exact gradient is 0, are left out)."""
    lt, lj, pairs = _port_step_vs_reference(vgg, spec, np.float32)
    np.testing.assert_allclose(float(lt), lj, rtol=LOSS_RTOL)
    _assert_pairs_l2_close(pairs)


@pytest.mark.parametrize("spec", ["c3sl:R=4", "c3sl:R=4,backend=pallas"])
def test_vgg16_split_float64_matches_reference_closely(vgg, spec):
    """The same step in float64 on both sides: the same algorithm, so only
    the codec's float32 sums differ (1e-6 loss, 1e-5 gradients)."""
    lt, lj, pairs = _port_step_vs_reference(vgg, spec, np.float64)
    np.testing.assert_allclose(float(lt), lj, rtol=1e-6)
    _assert_pairs_close(pairs, tol=1e-5)


def test_split_train_step_adam_matches_reference(vgg):
    """One full train step (loss, grads, Adam at the paper's lr 1e-4): the
    loss against the reference's, and the new weights against the
    reference's Adam applied to the same gradients (the gradients
    themselves are held by the tests above)."""
    ref = _reference(vgg, "c3sl:R=4")
    jcp, lj = ref["jcp"], ref["loss"]
    lr = paper.VGG16_CIFAR10.lr
    o = opt.adam(lr)
    params, loss_fn, batch = _port_setup(vgg, "c3sl:R=4", jcp)
    _, grads, _ = split.split_value_and_grad(loss_fn, params, batch)
    step = split.make_split_train_step(loss_fn, o)
    new_p, state, lt, _ = step(
        params, o.init(split.trainable_params(loss_fn, params)), batch)
    np.testing.assert_allclose(float(lt), lj, rtol=LOSS_RTOL)
    assert int(state["count"]) == 1 and new_p["codec"] is params["codec"]
    net = _np_tree(vgg[0])
    jo = jopt.adam(lr)
    gnp = params_to_numpy(grads["net"])
    new_j = jax.jit(lambda g, n: jopt.apply_updates(n, jo.update(g, jo.init(n), n)[0]))(
        gnp, net)
    # Adam's first move is -lr * g / (|g| + eps): compared where |g| stands
    # clear of eps, so a last-bit difference between the two gradient runs
    # cannot flip it
    for (a, b), g in zip(_leaf_pairs(new_p["net"], new_j), jax.tree.leaves(gnp)):
        clear = np.abs(g) > 1e-4 * np.abs(g).max()
        assert clear.mean() > 0.9
        np.testing.assert_allclose(a[clear], b[clear], rtol=1e-6, atol=1e-7)


def test_apply_codec_snr_erasure_and_comm_bytes_match_reference():
    jc = jcodecs.build("c3sl:R=4", D=64)
    jcp = jc.init(jax.random.PRNGKey(2))
    c = codecs.build("c3sl:R=4", D=64)
    cp = params_from_numpy(_np_tree(jcp), "cpu")
    Z = np.random.default_rng(3).normal(size=(8, 4, 4, 4)).astype(np.float32)
    Zh, snr = split.apply_codec(c, cp, _t(Z), with_snr=True)
    Zhj, snrj = jsplit.apply_codec(jc, jcp, jnp.asarray(Z), with_snr=True)
    assert Zh.shape == Z.shape
    np.testing.assert_allclose(Zh.numpy(), np.asarray(Zhj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(snr), float(snrj), rtol=1e-4)
    keep = (np.random.default_rng(4).random((2, 64)) > 0.3).astype(np.float32)
    got = split.apply_codec(c, cp, _t(Z), erasure={"fwd": _t(keep)})
    want = jsplit.apply_codec(jc, jcp, jnp.asarray(Z), erasure={"fwd": jnp.asarray(keep)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for spec in ("c3sl:R=4,D=2048", "c3sl:R=4,D=2048|int8", "identity:D=2048"):
        for directions in (1, 2):
            assert split.split_comm_bytes(codecs.build(spec), 64, directions) == \
                jsplit.split_comm_bytes(jcodecs.build(spec), 64, directions)


# --------------------------------------------------------------------------
# data and optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_classes,seed", [(10, 0), (100, 3)])
def test_synthetic_images_equal_reference_exactly(n_classes, seed):
    ours, ref = SyntheticImageDataset(n_classes=n_classes, seed=seed), \
        JDataset(n_classes=n_classes, seed=seed)
    np.testing.assert_array_equal(ours.templates, ref.templates)
    for B, step in ((8, 0), (64, 5)):
        b, r = ours.batch(B, step, device="cpu"), ref.batch(B, step)
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(r["x"]))
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(r["y"]))
        assert b["y"].dtype == torch.int64


def _opt_tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(5,)).astype(np.float32)},
                       {"w": rng.normal(size=(2, 2)).astype(np.float32)}],
            "spec": (rng.normal(size=3) + 1j * rng.normal(size=3)).astype(np.complex64)}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd_momentum", "adam_cosine"])
def test_three_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(5)
    params = _opt_tree(rng)
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape)).astype(p.dtype), params)
             for _ in range(3)]
    make = {"adam": lambda m: m.adam(1e-2), "adamw": lambda m: m.adamw(1e-2),
            "sgd_momentum": lambda m: m.sgd_momentum(1e-2),
            "adam_cosine": lambda m: m.adam(m.warmup_cosine(1e-2, 2, 10))}[name]
    jo, to = make(jopt), make(opt)
    jp, js = params, jo.init(params)
    tp = params_from_numpy(params, "cpu")
    ts = to.init(tp)
    for g in grads:
        ju, js = jo.update(g, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        tp = opt.apply_updates(tp, tu)
    for a, b in zip(tree_leaves(params_to_numpy(tp)), jax.tree.leaves(_np_tree(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the frozen complex leaf (a cached key spectrum) takes no update
    np.testing.assert_array_equal(tp["spec"].numpy(), params["spec"])
    assert int(ts["count"]) == 3


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(6)
    tree = {k: v for k, v in _opt_tree(rng).items() if k != "spec"}
    clipped, gn = opt.clip_by_global_norm(params_from_numpy(tree, "cpu"), 1.0)
    jclipped, jgn = jopt.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for a, b in zip(tree_leaves(params_to_numpy(clipped)), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
