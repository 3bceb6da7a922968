"""The port's 2-stage pod pipeline (``repro_torch.transport.pipeline``,
``lm.make_pipeline_fns`` / ``split_stack_for_pipeline``) held against the
reference's, which runs as ``tests/test_pipeline_async.py`` runs it: a
two-device host mesh in a subprocess (the XLA device count is fixed at the
first jax init), once for the module, its losses and gradients written to
an ``.npz``.

Two models: the toy stage functions of ``tests/test_pipeline_async.py``
(B 16, S 4, E 6, M 4, D 24) and ``deepseek-7b`` reduced to 2 superblocks at
narrow widths (B 8, S 16, d 128, M 2, D 2048), the same numpy-seeded inputs
and reference weights and keys in both packages.  The labels differ from
microbatch to microbatch, so a schedule that paired a payload with another
microbatch's labels would move the loss.  Tolerances are
``tests/test_torch_lm_train.py``'s: loss 1e-6 relative, each gradient
leaf 2e-5 of its max."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import transport as jtransport  # noqa: E402
from repro.configs import base as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.transport import pipeline as jpipeline  # noqa: E402
from repro_torch import codecs as tcodecs  # noqa: E402
from repro_torch import transport as ttransport  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.interop import (params_from_numpy, tree_leaves,  # noqa: E402
                                 tree_map)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.transport import pipeline as tpipeline  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL = 1e-6          # |loss difference| / |loss|
GRAD_TOL = 2e-5          # max |grad difference| / max |grad|, per leaf

# the inputs, made the same way in this process and in the reference's
INPUTS = textwrap.dedent("""
    import numpy as np
    TOY = dict(B=16, S=4, E=6, M=4)
    LM = dict(B=8, S=16, M=2)
    LM_OVERRIDES = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=128,
                        num_heads=4, num_kv_heads=2, head_dim=32)

    def toy_arrays():
        rng = np.random.default_rng(0)
        B, S, E = TOY["B"], TOY["S"], TOY["E"]
        return {"embed": (0.3 * rng.normal(size=(7, E))).astype(np.float32),
                "blocks": (0.2 * rng.normal(size=(2, 1, E, E))).astype(np.float32),
                "head": (0.5 * rng.normal(size=(E,))).astype(np.float32),
                "x": rng.integers(0, 7, (B, S)).astype(np.int32),
                "y": rng.normal(size=(B, S)).astype(np.float32)}

    def lm_tokens(vocab):
        rng = np.random.default_rng(1)
        x = rng.integers(0, vocab, (LM["B"], LM["S"])).astype(np.int32)
        y = rng.integers(0, vocab, (LM["B"], LM["S"])).astype(np.int32)
        y[0, :3] = -1             # masked positions
        return x, y

    def keep_stack(kind, M, depth, rows, D):
        if kind == "ones":
            return np.ones((M + depth, rows, D), np.float32)
        rng = np.random.default_rng(11)
        return (rng.random((M + depth, rows, D)) < 0.85).astype(np.float32)
""")
exec(INPUTS)  # noqa: S102  (toy_arrays, lm_tokens, keep_stack, TOY, LM, ...)

C3SL, LINK = "c3sl:R=2", "c3sl:R=2 >> bwd:c3sl:R=2"
# (model, spec, depth, erasure): the reference runs each once
# the toy model takes every case; the LM (each case seconds of compile
# in the reference) the depth that pairs payloads latest and the link.
# The LM's depth 1, identity and keep stacks are held within the port
# (bitwise across depths; against the logical model; all-ones bitwise).
CASES = ([("toy", C3SL, d, None) for d in (1, 2, 3)]
         + [("toy", LINK, 2, None), ("toy", "identity", 1, None),
            ("toy", C3SL, 2, "random")]
         + [("lm", C3SL, 3, None), ("lm", LINK, 2, None)])


def case_id(case):
    model, spec, depth, erasure = case
    name = {C3SL: "c3sl", LINK: "link", "identity": "identity"}[spec]
    return f"{model}-{name}-d{depth}" + (f"-keep_{erasure}" if erasure else "")


REFERENCE = INPUTS + textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from repro import transport
    from repro.codecs import build
    from repro.configs.base import get_config, reduced
    from repro.launch import mesh as mesh_lib
    from repro.models import lm as lm_lib

    cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
    mesh = mesh_lib.make_host_mesh(data=1, model=1, pod=2)

    def toy_setup():
        a = toy_arrays()
        def embed_fn(p, x): return p[x]
        def stage_fn(bl, h): return jnp.tanh(h @ bl[0])
        def head_loss_fn(hp, h, y): return jnp.mean(((h @ hp) - y) ** 2)
        params = {"embed": jnp.asarray(a["embed"]),
                  "blocks": jnp.asarray(a["blocks"]),
                  "head": jnp.asarray(a["head"])}
        batch = {"x": jnp.asarray(a["x"]), "y": jnp.asarray(a["y"])}
        return (embed_fn, stage_fn, head_loss_fn), params, batch, \\
            TOY["M"], TOY["S"] * TOY["E"], TOY["B"] // TOY["M"]

    def lm_setup():
        cfg = reduced(get_config("deepseek-7b"), **LM_OVERRIDES)
        full = lm_lib.init_lm_params(jax.random.PRNGKey(0), cfg)
        params = {"embed": {"embed": full["embed"]},
                  "blocks": lm_lib.split_stack_for_pipeline(full["stack"]),
                  "head": {"final_norm": full["final_norm"],
                           "head": full["head"]}}
        x, y = lm_tokens(cfg.vocab_size)
        return lm_lib.make_pipeline_fns(cfg), params, \\
            {"x": jnp.asarray(x), "y": jnp.asarray(y)}, LM["M"], \\
            LM["S"] * cfg.d_model, LM["B"] // LM["M"]

    setups = {"toy": toy_setup(), "lm": lm_setup()}
    out = {}
    for i, (model, spec, depth, erasure) in enumerate(cases):
        fns, params, batch, M, D, mb = setups[model]
        codec = (build("identity", D=D) if spec == "identity"
                 else transport.build_link_or_codec(spec, D=D))
        params = dict(params, codec=codec.init(jax.random.PRNGKey(7)))
        lf = transport.make_pod_pipeline_loss_fn(
            *fns, codec, mesh, num_microbatches=M, async_depth=depth,
            with_erasure=erasure is not None)
        with mesh_lib.set_mesh(mesh):
            if erasure is None:
                loss, grads = jax.jit(jax.value_and_grad(lf))(params, batch)
            else:
                R = codec.fwd.codec.R if hasattr(codec, "fwd") else codec.R
                keep = jnp.asarray(keep_stack(erasure, M, depth, mb // R, D))
                loss, grads = jax.jit(jax.value_and_grad(lf))(params, batch,
                                                              keep)
        out[f"loss_{i}"] = np.asarray(loss)
        for j, g in enumerate(jax.tree.leaves(grads)):
            out[f"grad_{i}_{j}"] = np.asarray(g)
    np.savez(out_path, **out)
    print(json.dumps({"cases": len(cases)}))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under the suite's parallel workers: one intra-op thread
    (as ``tests/test_torch_frontdoor.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference loss and gradient leaves (``jax.tree``
    order), from one two-device subprocess."""
    path = tmp_path_factory.mktemp("pipeline") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(CASES),
                          str(path)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    data = np.load(path)
    return {i: (float(data[f"loss_{i}"]),
                [data[k] for k in sorted((k for k in data.files
                                          if k.startswith(f"grad_{i}_")),
                                         key=lambda k: int(k.split("_")[-1]))])
            for i in range(len(CASES))}


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------

def toy_fns():
    def embed_fn(p, x):
        return p[x.long()]

    def stage_fn(bl, h):
        return torch.tanh(h @ bl[0])

    def head_loss_fn(hp, h, y):
        return torch.mean(((h @ hp) - y) ** 2)

    return embed_fn, stage_fn, head_loss_fn


@functools.lru_cache(maxsize=None)
def lm_model():
    """(port config, reference params as numpy) of the reduced deepseek-7b."""
    jcfg = jconfigs.reduced(jconfigs.get_config("deepseek-7b"), **LM_OVERRIDES)
    tcfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), **LM_OVERRIDES)
    full = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(0), jcfg))
    return tcfg, full


@functools.lru_cache(maxsize=None)
def codec_keys(spec, D):
    """The reference's keys for ``spec`` at D (``init(PRNGKey(7))``), as
    numpy."""
    if spec == "identity":
        return {}
    jc = jtransport.build_link_or_codec(spec, D=D)
    return jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(7)))


def port_codec(spec, D):
    if spec == "identity":
        return tcodecs.build("identity", D=D)
    return ttransport.build_link_or_codec(spec, D=D)


def setup(model, spec):
    """(fns, params, batch, M, D, mb) of ``model`` in the port, the codec
    keys the reference's."""
    if model == "toy":
        a = toy_arrays()
        fns = toy_fns()
        params = {k: a[k] for k in ("embed", "blocks", "head")}
        x, y = a["x"], a["y"]
        M, D, mb = TOY["M"], TOY["S"] * TOY["E"], TOY["B"] // TOY["M"]
    else:
        cfg, full = lm_model()
        fns = tlm.make_pipeline_fns(cfg)
        params = {"embed": {"embed": full["embed"]},
                  "blocks": jax.tree.map(
                      lambda v: v.reshape(2, v.shape[0] // 2, *v.shape[1:]),
                      full["stack"]),
                  "head": {"final_norm": full["final_norm"], "head": full["head"]}}
        x, y = lm_tokens(cfg.vocab_size)
        M, D, mb = LM["M"], LM["S"] * cfg.d_model, LM["B"] // LM["M"]
    params = params_from_numpy(dict(params, codec=codec_keys(spec, D)), "cpu")
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    return fns, params, batch, M, D, mb


def port_run(case, fns=None):
    """(loss, gradient leaves, the loss function) of the port on ``case``;
    ``fns`` replaces the stage functions."""
    model, spec, depth, erasure = case
    base_fns, params, batch, M, D, mb = setup(model, spec)
    codec = port_codec(spec, D)
    lf = tpipeline.make_pod_pipeline_loss_fn(
        *(fns or base_fns), codec, num_microbatches=M, async_depth=depth,
        with_erasure=erasure is not None)
    train = tree_map(lambda t: t.detach().requires_grad_(), params)
    args = (train, batch)
    if erasure is not None:
        R = codec.fwd.codec.R if isinstance(codec, ttransport.SplitLink) else codec.R
        args += (torch.from_numpy(keep_stack(erasure, M, depth, mb // R, D)),)
    loss = lf(*args)
    grads = torch.autograd.grad(loss, tree_leaves(train), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads, lf


def leaf_err(a, b) -> float:
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    scale = float(np.abs(b).max()) if b.size else 0.0
    diff = float(np.abs(a - b).max()) if a.size else 0.0
    return diff if scale == 0.0 else diff / scale


def assert_close(loss, grads, ref_loss, ref_grads, what):
    rel = abs(float(loss) - ref_loss) / abs(ref_loss)
    assert rel <= LOSS_TOL, (what, float(loss), ref_loss, rel)
    assert len(grads) == len(ref_grads), what
    errs = [leaf_err(g.numpy(), r) for g, r in zip(grads, ref_grads)]
    assert max(errs) <= GRAD_TOL, (what, errs)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_loss_and_grads_match_reference(reference, i):
    loss, grads, _ = port_run(CASES[i])
    ref_loss, ref_grads = reference[i]
    assert_close(loss, grads, ref_loss, ref_grads, case_id(CASES[i]))


@pytest.mark.parametrize("model", ["toy", "lm"])
def test_wrong_label_pairing_would_fail(reference, model):
    """The parity above sees the pairing: the same run with each
    microbatch's labels rolled by one microbatch misses the reference."""
    i = CASES.index((model, C3SL, 3, None))
    _, _, batch, M, _, mb = setup(model, C3SL)
    y = batch["y"]
    fns = list(toy_fns() if model == "toy" else tlm.make_pipeline_fns(lm_model()[0]))
    head = fns[2]
    # a head that reads the labels of the next microbatch in the batch
    calls = []

    def shifted_head(hp, h, y_mb):
        m = len(calls)
        calls.append(m)
        return head(hp, h, y[((m + 1) % M) * mb:((m + 1) % M + 1) * mb])

    fns[2] = shifted_head
    loss, _, _ = port_run(CASES[i], fns=fns)
    assert calls == list(range(M))
    assert abs(float(loss) - reference[i][0]) / abs(reference[i][0]) > 1e-3


# --------------------------------------------------------------------------
# within the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model,spec", [("toy", C3SL), ("lm", C3SL),
                                        ("toy", LINK), ("lm", LINK)])
def test_depths_are_bitwise_the_synchronous_schedule(model, spec):
    """Depths 2 and 3 consume each payload later, paired with its own
    labels: loss and every gradient leaf bitwise depth 1's."""
    loss1, g1, _ = port_run((model, spec, 1, None))
    for depth in (2, 3):
        loss, g, _ = port_run((model, spec, depth, None))
        assert torch.equal(loss, loss1), (depth, float(loss), float(loss1))
        assert all(torch.equal(a, b) for a, b in zip(g, g1)), depth


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_per_microbatch_composition(depth):
    """Each microbatch through embed -> stage 0 -> encode/decode -> stage 1
    -> head with its own labels, meaned over microbatches: the pipeline's
    loss and gradients (the hand-rolled reference of
    ``tests/test_pipeline_async.py``)."""
    (embed_fn, stage_fn, head_loss_fn), params, batch, M, D, mb = setup("toy", C3SL)
    codec = port_codec(C3SL, D)
    loss, grads, _ = port_run(("toy", C3SL, depth, None))
    train = tree_map(lambda t: t.detach().requires_grad_(), params)
    tot = 0.0
    for m in range(M):
        sl = slice(m * mb, (m + 1) * mb)
        h = stage_fn(train["blocks"][0], embed_fn(train["embed"], batch["x"][sl]))
        Zf = codec.decode(train["codec"], codec.encode(train["codec"],
                                                        h.reshape(mb, D)))
        h = stage_fn(train["blocks"][1], Zf.reshape(h.shape))
        tot = tot + head_loss_fn(train["head"], h, batch["y"][sl])
    want = tot / M
    want_g = torch.autograd.grad(want, tree_leaves(train), allow_unused=True,
                                 materialize_grads=True)
    assert_close(loss, grads, float(want.detach()), [g.numpy() for g in want_g],
                 f"composition d{depth}")


def test_link_loss_is_the_flat_codecs_grads_differ():
    """An asymmetric link's seam is the identity forward: the loss is
    bitwise the flat codec's; the gradient crossing back is re-compressed,
    so the front stage's gradients differ."""
    l_flat, g_flat, _ = port_run(("toy", C3SL, 2, None))
    l_link, g_link, _ = port_run(("toy", LINK, 2, None))
    assert torch.equal(l_flat, l_link)
    # leaves in order: blocks, codec..., embed, head
    assert not torch.equal(g_flat[0], g_link[0])
    assert not torch.equal(g_flat[-2], g_link[-2])
    assert torch.equal(g_flat[-1], g_link[-1])     # the head is behind the cut


def test_all_ones_keep_is_the_clean_loss_bitwise():
    clean, g_clean, _ = port_run(("lm", C3SL, 2, None))
    ones, g_ones, _ = port_run(("lm", C3SL, 2, "ones"))
    assert torch.equal(clean, ones)
    assert all(torch.equal(a, b) for a, b in zip(g_clean, g_ones))
    lossy, _, _ = port_run(("lm", C3SL, 2, "random"))
    assert not torch.equal(clean, lossy)


def test_identity_codec_matches_the_logical_model():
    """Through the identity codec the pipeline is the unsplit model
    (``lm_loss`` without a codec) on each microbatch, meaned over the
    microbatches: the loss, and every gradient leaf mapped back to the
    LM's tree."""
    cfg, full = lm_model()
    loss, grads, _ = port_run(("lm", "identity", 1, None))
    tp = tree_map(lambda t: t.detach().requires_grad_(),
                  params_from_numpy(full, "cpu"))
    x, y = (torch.from_numpy(a) for a in lm_tokens(cfg.vocab_size))
    mb = LM["B"] // LM["M"]
    want = sum(tlm.lm_loss(tp, {"tokens": x[m * mb:(m + 1) * mb],
                                "labels": y[m * mb:(m + 1) * mb]}, cfg)
               for m in range(LM["M"])) / LM["M"]
    want_g = torch.autograd.grad(want, tree_leaves(tp))
    got = dict(zip(leaf_paths(pipeline_tree(full)), grads))
    ref = dict(zip(leaf_paths(full), want_g))
    assert abs(float(loss) - float(want.detach())) / abs(float(want.detach())) \
        <= LOSS_TOL
    assert set(ref) == {logical_path(p) for p in got}
    for p, g in got.items():
        r = ref[logical_path(p)]
        assert leaf_err(g.reshape(r.shape).numpy(), r.numpy()) <= GRAD_TOL, p


def pipeline_tree(full):
    return {"blocks": full["stack"], "codec": {},
            "embed": {"embed": full["embed"]},
            "head": {"final_norm": full["final_norm"], "head": full["head"]}}


def leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def logical_path(p):
    """A pipeline tree's leaf path -> the LM tree's."""
    head, _, rest = p.partition("/")
    return {"blocks": "stack/" + rest, "embed": "embed",
            "head": rest}.get(head, p)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("spec", [C3SL, LINK, "identity"])
def test_call_record(spec, depth):
    """M + depth steps run, M payloads handed over, at most ``depth``
    held, no copy on one device; the payload tensors that moved hold
    exactly the codec's forward wire bytes of a microbatch each."""
    _, _, lf = port_run(("toy", spec, depth, None))
    M, D, mb = TOY["M"], TOY["S"] * TOY["E"], TOY["B"] // TOY["M"]
    codec = port_codec(spec, D)
    rec = lf.last_call
    assert (rec.steps, rec.payloads, rec.max_held, rec.wire) == \
        (M + depth, M, min(depth, M), "same-device")
    assert rec.payload_bytes == \
        M * ttransport.split_comm_bytes(codec, mb, directions=1)
    if spec != "identity":
        assert rec.payload_bytes == M * (mb // 2) * D * 4


# --------------------------------------------------------------------------
# refusals, in both packages
# --------------------------------------------------------------------------

PACKAGES = {"port": (tpipeline, ttransport, {}),
            "reference": (jpipeline, jtransport, {"mesh": None})}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_adaptive_link_refused_and_pinned(pkg):
    mod, transport, kw = PACKAGES[pkg]
    fns = toy_fns()
    link = transport.build_link("adaptive:c3sl:R=4,min_R=2 >> bwd:c3sl:R=2", D=24)
    with pytest.raises(ValueError, match="static"):
        mod.make_pod_pipeline_loss_fn(*fns, link, num_microbatches=4, **kw)
    static = transport.pin_link(link)
    mod.make_pod_pipeline_loss_fn(*fns, static, num_microbatches=4, **kw)
    assert static.spec() == "c3sl:R=2,D=24 >> bwd:c3sl:R=2,D=24"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_async_depth_zero_refused(pkg):
    mod, transport, kw = PACKAGES[pkg]
    codec = transport.build_link_or_codec(C3SL, D=24)
    with pytest.raises(ValueError, match="async_depth must be >= 1, got 0"):
        mod.make_pod_pipeline_loss_fn(*toy_fns(), codec, async_depth=0, **kw)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("with_erasure", [True, False])
def test_erasure_misuse_refused(pkg, with_erasure):
    mod, transport, kw = PACKAGES[pkg]
    codec = transport.build_link_or_codec(C3SL, D=24)
    lf = mod.make_pod_pipeline_loss_fn(*toy_fns(), codec, num_microbatches=4,
                                       with_erasure=with_erasure, **kw)
    keep = None if with_erasure else np.ones((5, 2, 24), np.float32)
    match = "pass the" if with_erasure else "keep masks need the with_erasure=True"
    with pytest.raises(ValueError, match=match):
        lf({}, {}, keep)


def test_split_shim_reexports_the_pipeline():
    from repro_torch.core import split as tsplit_shim
    assert tsplit_shim.make_pod_pipeline_loss_fn is \
        ttransport.make_pod_pipeline_loss_fn
    assert "make_pod_pipeline_loss_fn" in tsplit_shim.__all__


def test_split_stack_is_a_view_with_a_stage_axis():
    cfg, full = lm_model()
    stack = params_from_numpy(full["stack"], "cpu")
    split = tlm.split_stack_for_pipeline(stack)
    for a, b in zip(tree_leaves(stack), tree_leaves(split)):
        assert b.shape == (2, a.shape[0] // 2, *a.shape[1:])
        assert b.data_ptr() == a.data_ptr()
    ref = jlm.split_stack_for_pipeline(full["stack"])
    for a, b in zip(tree_leaves(split), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
