"""The dry run's train step over a one-rank NCCL mesh on the card, held
against the same step on plain tensors.  Needs an NVIDIA GPU with nvcc
(sm_90a); skips where ``torch.cuda.is_available()`` is false.  Imports no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharding_cuda.py

Reduced ``deepseek-7b`` at d 1024, d_ff 1024, vocabulary 1024 (so the
rules name both axes), B 8, S 16, float32, TF32 off, the codec
``c3sl:R=2,backend=pallas`` at the superblock midpoint.  One process group
of one rank over NCCL on a free localhost port, made and destroyed here;
every param, AdamW moment and batch leaf a DTensor on the (data 1, model
1) mesh, the step under ``set_mesh``.  Two steps from the same weights as
the plain step's: the loss within 1e-6 relative, each param leaf within
2e-5 of its norm in L2 and 2 lr a step elementwise (the figures of
``tests/test_torch_sharding_step.py``, which says why); bind and unbind
launched 2 + 2 a step inside the sharded step, at (4, 2, 16384).  The multi-rank runs are the CPU tests'
(``tests/test_torch_sharding_step.py``): the machine with the card has
one."""
import contextlib
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.interop import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import circconv  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import lm as lm_lib  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

pytestmark = pytest.mark.cuda

B, S, STEPS = 8, 16, 2
SPEC = "c3sl:R=2,backend=pallas"
LOSS_TOL = 1e-6         # relative
LEAF_TOL = 2e-5         # |param difference| / |param| in L2, per leaf
LR = 1e-4               # build_train_step's AdamW


@pytest.fixture
def mesh(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    import torch.distributed as dist
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.cuda.set_device(0)            # the one rank's card, before the mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_host_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def _run(cfg, mesh=None):
    """(losses, params after the steps) of ``build_train_step`` from the
    seed's weights, on plain tensors or placed on ``mesh``."""
    params = tree_map(lambda t: t.to("cuda"),
                      lm_lib.init_lm_params(0, cfg, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).cuda()
             for k in ("tokens", "labels")}
    if mesh is not None:
        params = rules.distribute_tree(params, rules.param_shardings(params, mesh),
                                       mesh)
        batch = rules.distribute_tree(batch, rules.batch_shardings(batch, mesh),
                                      mesh)
    codec, cp = train.make_codec(SPEC, S * cfg.d_model, device="cuda")
    opt, step = dryrun.build_train_step(cfg, codec, cp)
    state = opt.init(params)
    losses = []
    with mesh_lib.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for _ in range(STEPS):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss.full_tensor() if mesh is not None else loss))
    return losses, [t.full_tensor() if mesh is not None else t
                    for t in tree_leaves(params)]


def test_one_rank_mesh_step_matches_the_plain_step(mesh):
    cfg = reduced(get_config("deepseek-7b"), d_model=1024, d_ff=1024,
                  vocab_size=1024)
    want_losses, want = _run(cfg)
    circconv.reset_launch_counts()
    losses, got = _run(cfg, mesh)
    torch.cuda.synchronize()
    assert dict(circconv.LAUNCHES) == {"bind_superpose": 2 * STEPS,
                                       "unbind": 2 * STEPS}
    assert set(circconv.SHAPE_LAUNCHES) == {
        (k, B // 2, 2, S * cfg.d_model) for k in ("bind_superpose", "unbind")}
    for a, b in zip(losses, want_losses):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    for a, b in zip(got, want):
        assert (a - b).norm() <= LEAF_TOL * b.norm()
        assert (a - b).abs().max() <= 2 * STEPS * LR
