"""The hand-written CUDA circconv kernels on the card, against their plain
versions.  Needs an NVIDIA GPU with nvcc (sm_90a); every test skips where
``torch.cuda.is_available()`` is false.  Imports no JAX, so it runs on a
GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hrr  # noqa: E402
from repro_torch.kernels import circconv, ops  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 against a float64 oracle: 1e-5 elementwise (tests/test_kernels.py:38).
# bfloat16 outputs are rounded once (half an ulp, at most 2^-8 of the
# element), so their limits scale with the compared values: max|err| within
# 1e-2 of max|want|, and 5e-3 in relative L2.
TOL = {torch.float32: 1e-5}
BF16_REL_MAX, BF16_REL_L2 = 1e-2, 5e-3
SHAPES = [(1, 1, 64), (3, 5, 96), (16, 16, 128), (16, 4, 2048), (4, 3, 127),
          (2, 2, 4097)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _data(G, R, D, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    K = hrr.generate_keys(gen, R, D, device=dev)
    Z = torch.randn((G, R, D), generator=gen).to(dev)
    return Z, K


def _close(got, want, dtype, tol=None):
    """bfloat16 against the scaled limits; otherwise elementwise within
    ``tol`` (default TOL[dtype]) plus ``tol`` of the value."""
    want = want.double()
    err = (got.double() - want).abs()
    if dtype == torch.bfloat16:
        rel_max = float(err.max() / want.abs().max())
        rel_l2 = float(err.norm() / want.norm())
        assert rel_max <= BF16_REL_MAX and rel_l2 <= BF16_REL_L2, (rel_max, rel_l2)
        return
    tol = TOL[dtype] if tol is None else tol
    assert bool((err <= tol + tol * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("G,R,D", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dev, G, R, D, dtype):
    Z, K = _data(G, R, D, dev)
    kext = ops._kext(K)
    Z = Z.to(dtype)
    before = dict(circconv.LAUNCHES)
    S = circconv.bind_superpose_kernel(Z, kext)
    _close(S, circconv.bind_superpose_plain(Z.double(), kext.double()), dtype)
    Zh = circconv.unbind_kernel(S, kext)
    _close(Zh, circconv.unbind_plain(S.double(), kext.double()), dtype)
    torch.cuda.synchronize()
    assert S.dtype == dtype and Zh.dtype == dtype and Zh.shape == (G, R, D)
    assert circconv.LAUNCHES["bind_superpose"] == before["bind_superpose"] + 1
    assert circconv.LAUNCHES["unbind"] == before["unbind"] + 1


def test_autograd_functions_on_card(dev):
    Z, K = _data(16, 4, 2048, dev, seed=1)
    Z.requires_grad_()
    K.requires_grad_()
    dS = torch.randn(16, 2048, device=dev)
    gz, gk = torch.autograd.grad((ops.bind_superpose_pallas(Z, K) * dS).sum(), [Z, K],
                                 allow_unused=True, materialize_grads=True)
    _close(gz, circconv.unbind_plain(dS.double(), ops._kext(K).double()),
           torch.float32, tol=1e-4)
    assert (gk == 0).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    Z, K = _data(2, 2, 64, dev)
    kext = ops._kext(K)
    with pytest.raises(TypeError):
        circconv.bind_superpose_kernel(Z.half(), kext)
    with pytest.raises(ValueError, match="contiguous"):
        circconv.unbind_kernel(torch.randn(64, 2, device=dev).t(), kext)
    with pytest.raises(ValueError, match="Kext on"):
        circconv.bind_superpose_kernel(Z, kext.cpu())


def test_execution_mode_on_card(dev):
    from repro_torch import codecs
    c = codecs.build("c3sl:R=2,backend=pallas", D=256)
    assert c.execution_mode(dev) == "cuda-kernel"
    assert c.spec() == "c3sl:R=2,D=256,backend=pallas"
