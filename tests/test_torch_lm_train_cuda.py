"""One training step of each newer model family on the card, held against
the same step on the CPU.  Needs an NVIDIA GPU with nvcc (sm_90a); skips
where ``torch.cuda.is_available()`` is false.  Imports no JAX, so it runs
on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_train_cuda.py

Each arch at ``reduced()`` size, S = 8, B = 4, the port's seeded weights
copied to both devices, a numpy-seeded batch (and frontend batch), the
codec ``c3sl:R=2,backend=pallas`` at the superblock midpoint: on the card
it launches the CUDA circconv kernels, on the CPU their plain versions.
TF32 is off.  The loss within 1e-5 relative and every gradient leaf within
1e-4 of its max (float32 matmuls and the kernels' FFT sum in other orders
on the two devices); then ``launch.train.make_train_step`` takes the step
on the card: the same loss, 2 bind and 2 unbind launches, finite params."""
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

pytestmark = pytest.mark.cuda

B, S = 4, 8
SPEC = "c3sl:R=2,backend=pallas"
LOSS_TOL = 1e-5         # relative
GRAD_TOL = 1e-4         # max |grad difference| / max |grad|, per leaf
FAMILIES = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
            "rwkv6-1.6b", "seamless-m4t-large-v2", "pixtral-12b"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _batch(cfg, device):
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend:
        b["frontend"] = rng.normal(size=(B, cfg.frontend_seq, cfg.frontend_dim)
                                   ).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _loss_and_grads(params, cfg, codec, cp, batch):
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = lm_lib.lm_loss(tp, batch, cfg, codec=codec, codec_params=cp)
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(tp))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_the_card_matches_the_cpu(arch, dev):
    cfg = reduced(get_config(arch))
    cut = S + (cfg.frontend_seq if cfg.frontend and not cfg.is_encdec else 0)
    params = lm_lib.init_lm_params(0, cfg, device="cpu")
    res = {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), params)
        codec, cp = train.make_codec(SPEC, cut * cfg.d_model, device=d)
        res[d] = (p, codec, cp, _batch(cfg, d)) + _loss_and_grads(
            p, cfg, codec, cp, _batch(cfg, d))
    (_, _, _, _, lc, gc), (p, codec, cp, batch, lg, gg) = res["cpu"], res[dev]
    assert abs(lg - lc) <= LOSS_TOL * abs(lc), (lg, lc)
    for a, b in zip(gg, gc):
        err = float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
        assert err <= GRAD_TOL, (a.shape, err)

    opt = adamw(1e-3)
    state = opt.init(p)
    step = train.make_train_step(cfg, opt, codec, cp)
    circconv.reset_launch_counts()
    probe = torch.zeros((), device=dev)
    _, _, loss, gn, _, _ = step(p, state, batch, probe)
    torch.cuda.synchronize()
    assert dict(circconv.LAUNCHES) == {"bind_superpose": 2, "unbind": 2}
    assert abs(float(loss) - lc) <= LOSS_TOL * abs(lc)
    assert math.isfinite(float(gn))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(p))
