"""One pod-pipeline step of the reduced LM on the card, held against the
same step on the CPU.  Needs an NVIDIA GPU with nvcc (sm_90a); skips where
``torch.cuda.is_available()`` is false.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pipeline_cuda.py

``deepseek-7b`` at ``reduced()`` size (2 superblocks, one a stage), B 8,
S 8, 2 microbatches, ``c3sl:R=2,backend=pallas`` on the stage channel: on
the card it launches the CUDA circconv kernels (counted: 2 bind and 2
unbind a microbatch), on the CPU their plain versions.  TF32 is off.  At
depths 1 and 2: the loss within 1e-5 relative and every gradient leaf
within 1e-4 of its max; then ``launch.train.make_pipeline_step`` takes the
step on the card: the same loss, finite params.  With the stages on two
devices (``stage_devices=(cpu, cuda)``: the front stage and its encode on
the CPU, the decode and the back stage on the card) the payload is a peer
copy and autograd carries its gradient back: the same loss and gradients,
wire mode ``"peer-copy"``, the card's kernels launched for the decode and
its backward only."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.interop import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import circconv  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm as lm_lib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.transport import make_pod_pipeline_loss_fn  # noqa: E402

pytestmark = pytest.mark.cuda

B, S, M = 8, 8, 2
SPEC = "c3sl:R=2,backend=pallas"
LOSS_TOL = 1e-5         # relative
GRAD_TOL = 1e-4         # max |grad difference| / max |grad|, per leaf


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _setup(cfg, full, depth, device, stage_devices=None):
    codec, cp = train.make_codec(SPEC, S * cfg.d_model, max_R=B // M,
                                 device=device)
    params = tree_map(lambda t: t.to(device), train.pipeline_params(full, cp))
    lf = make_pod_pipeline_loss_fn(*lm_lib.make_pipeline_fns(cfg), codec,
                                   stage_devices=stage_devices,
                                   num_microbatches=M, async_depth=depth)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(device)
             for k in ("x", "y")}
    return params, lf, batch


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_step_on_the_card_matches_the_cpu(dev, depth):
    cfg = reduced(get_config("deepseek-7b"))
    full = lm_lib.init_lm_params(0, cfg, device="cpu")
    res = {}
    for d in ("cpu", dev):
        params, lf, batch = _setup(cfg, full, depth, d)
        tp = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        circconv.reset_launch_counts()
        loss = lf(tp, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                    materialize_grads=True)
        if d == dev:
            torch.cuda.synchronize()
            assert dict(circconv.LAUNCHES) == {"bind_superpose": 2 * M,
                                               "unbind": 2 * M}
            assert lf.last_call.wire == "same-device"
        res[d] = (float(loss.detach()), grads, params, lf, batch)
    (lc, gc, *_), (lg, gg, params, lf, batch) = res["cpu"], res[dev]
    assert abs(lg - lc) <= LOSS_TOL * abs(lc), (lg, lc)
    for a, b in zip(gg, gc):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max()) / scale if scale else \
            float(a.abs().max())
        assert err <= GRAD_TOL, (a.shape, err)

    opt = adamw(1e-3)
    step = train.make_pipeline_step(lf, opt)
    _, _, loss, gn = step(params, opt.init(params), batch)
    assert abs(float(loss) - lg) <= LOSS_TOL * abs(lg)
    assert math.isfinite(float(gn))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_across_two_devices_matches_one(dev, depth):
    cfg = reduced(get_config("deepseek-7b"))
    full = lm_lib.init_lm_params(0, cfg, device="cpu")
    res = {}
    for stages in (None, (torch.device("cpu"), torch.device(dev))):
        params, lf, batch = _setup(cfg, full, depth, "cpu", stages)
        tp = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        circconv.reset_launch_counts()
        loss = lf(tp, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                    materialize_grads=True)
        if stages is not None:
            torch.cuda.synchronize()
            assert loss.device.type == dev
            assert dict(circconv.LAUNCHES) == {"bind_superpose": M, "unbind": M}
            assert lf.last_call.wire == "peer-copy"
            assert all(g.device.type == "cpu" for g in grads)
        else:
            assert lf.last_call.wire == "same-device"
        res[stages is None] = (float(loss.detach()), grads)
    (lc, gc), (lp, gp) = res[True], res[False]
    assert abs(lp - lc) <= LOSS_TOL * abs(lc), (lp, lc)
    for a, b in zip(gp, gc):
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / scale if scale else \
            float(a.abs().max())
        assert err <= GRAD_TOL, (a.shape, err)
