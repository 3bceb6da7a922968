"""The dry run against a real step on the card.  Needs an NVIDIA GPU with
nvcc (sm_90a); skips where ``torch.cuda.is_available()`` is false.
Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

Reduced ``deepseek-7b``, B 8, S 16, float32, TF32 off, the codec at the
superblock midpoint: ``dryrun_one`` counts the step on ``meta`` with
``c3sl:R=2`` (the fft backend, as the reference's dry run builds it);
``build_train_step`` takes the same step on the card with
``c3sl:R=2,backend=pallas`` (the CUDA circconv kernels, which count no
FLOPs, as the FFTs count none) from the seed's weights.  The counted FLOPs
by op equal the meta count and the argument bytes the real tensors';
bind and unbind launch twice each; the loss equals the same step's on the
CPU (the kernels' plain versions there) within 1e-5 relative (float32
matmuls and the kernels' FFT sum in other orders on the two devices)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import SHAPES  # noqa: E402
from repro_torch.interop import tree_map  # noqa: E402
from repro_torch.kernels import circconv  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.models import lm as lm_lib  # noqa: E402

pytestmark = pytest.mark.cuda

B, S = 8, 16
SHAPE = "cuda_test_train"
LOSS_TOL = 1e-5         # relative


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setitem(SHAPES, SHAPE, dict(seq_len=S, global_batch=B,
                                            kind="train"))
    return "cuda"


def _step(cfg, device):
    """(params, AdamW state, batch) on ``device`` and the step: the seed's
    weights drawn on the CPU, so both devices start from the same ones."""
    params = tree_map(lambda t: t.to(device),
                      lm_lib.init_lm_params(0, cfg, device="cpu"))
    codec, cp = train.make_codec("c3sl:R=2,backend=pallas", S * cfg.d_model,
                                 device=device)
    opt, step = dryrun.build_train_step(cfg, codec, cp)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(device)
             for k in ("tokens", "labels")}
    return (params, opt.init(params), batch), step


def test_card_step_counts_what_meta_counts(dev):
    cfg = reduced(get_config("deepseek-7b"))
    dry = dryrun.dryrun_one("deepseek-7b", SHAPE, "card", codec_kind="c3sl:R=2",
                            save=False, cfg_override=cfg,
                            param_dtype=torch.float32)
    args, step = _step(cfg, dev)
    assert dryrun.tree_bytes(args) == dry["per_device"]["argument_bytes"]
    circconv.reset_launch_counts()
    (_, _, loss), flops, by_op = dryrun.count_flops(step, *args)
    torch.cuda.synchronize()
    assert (flops, by_op) == (dry["hlo_flops_per_device"], dry["flops_by_op"])
    assert dict(circconv.LAUNCHES) == {"bind_superpose": 2, "unbind": 2}
    cpu_args, cpu_step = _step(cfg, "cpu")
    _, _, want = cpu_step(*cpu_args)
    assert abs(float(loss) - float(want)) <= LOSS_TOL * abs(float(want))
