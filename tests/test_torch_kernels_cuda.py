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
# the FFT kernels' edges: R 1, 5, 8, 9, 16 (bind's cluster is min(R, 8)
# blocks); G 1, 2, 128; D from 4 to the route's upper limit
FFT_SHAPES = [(2, 1, 2048), (2, 5, 2048), (2, 8, 2048), (2, 9, 2048),
              (2, 16, 4096), (1, 4, 4096), (2, 4, 4096), (128, 4, 4096),
              (3, 2, 4), (2, 3, 8), (2, 2, 16), (3, 2, 32), (1, 3, 16384)]


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


def _routed(name, kernel_route, x, kext):
    """Output of ``name`` through ``kernel_route``, checking that exactly
    that kernel launched once."""
    before = dict(circconv.ROUTE_LAUNCHES)
    on = {"bind": circconv._bind_superpose_on, "unbind": circconv._unbind_on}[name]
    out = on(kernel_route, x, kext)
    key = ("bind_superpose" if name == "bind" else "unbind", kernel_route)
    assert {k: v - before[k] for k, v in circconv.ROUTE_LAUNCHES.items()} == {
        k: int(k == key) for k in before}
    return out


@pytest.mark.parametrize("G,R,D", FFT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_kernels_match_plain_on_card(dev, G, R, D, dtype):
    assert circconv.route(D) == "fft"
    Z, K = _data(G, R, D, dev, seed=3)
    kext = ops._kext(K)
    Z = Z.to(dtype)
    S = _routed("bind", "fft", Z, kext)
    _close(S, circconv.bind_superpose_plain(Z.double(), kext.double()), dtype)
    Zh = _routed("unbind", "fft", S, kext)
    _close(Zh, circconv.unbind_plain(S.double(), kext.double()), dtype)
    torch.cuda.synchronize()
    assert S.dtype == dtype and S.shape == (G, D) and Zh.shape == (G, R, D)


@pytest.mark.parametrize("G,R,D", [(16, 4, 2048), (16, 4, 4096)])
def test_direct_kernels_at_main_path_shapes(dev, G, R, D):
    Z, K = _data(G, R, D, dev, seed=4)
    kext = ops._kext(K)
    S = _routed("bind", "direct", Z, kext)
    _close(S, circconv.bind_superpose_plain(Z.double(), kext.double()), torch.float32)
    Zh = _routed("unbind", "direct", S, kext)
    _close(Zh, circconv.unbind_plain(S.double(), kext.double()), torch.float32)


@pytest.mark.parametrize("G,R,D", [(16, 4, 2048), (2, 16, 4096), (128, 4, 4096)])
def test_fft_kernels_are_bitwise_repeatable(dev, G, R, D):
    Z, K = _data(G, R, D, dev, seed=5)
    kext = ops._kext(K)
    S = circconv.bind_superpose_kernel(Z, kext)
    Zh = circconv.unbind_kernel(S, kext)
    for _ in range(3):
        assert torch.equal(circconv.bind_superpose_kernel(Z, kext), S)
        assert torch.equal(circconv.unbind_kernel(S, kext), Zh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_kernels_give_exact_zeros_for_zero_rows(dev, dtype):
    """An all-zero data row (a dead slot's features) adds exactly zero, as
    in the plain version: its transform holds only the key's rounding."""
    Z, K = _data(4, 4, 2048, dev, seed=7)
    kext = ops._kext(K)
    Z = Z.to(dtype)
    Z[1] = 0                 # a whole group
    S = circconv.bind_superpose_kernel(Z, kext)
    assert bool((S[1] == 0).all()) and bool((S[0] != 0).any())
    S[2] = 0
    Zh = circconv.unbind_kernel(S, kext)
    assert bool((Zh[1] == 0).all()) and bool((Zh[2] == 0).all())


def test_fft_kernels_take_unaligned_views(dev):
    """A view one element into its storage is not 16-byte aligned: the
    wrapper copies it for the kernels' 16-byte loads."""
    Z, K = _data(2, 4, 2048, dev, seed=6)
    kext = ops._kext(K)
    flat = torch.cat([torch.zeros(1, device=dev), Z.reshape(-1)])
    Zv = flat[1:].view(2, 4, 2048)
    assert Zv.data_ptr() % 16 and Zv.is_contiguous()
    assert torch.equal(circconv.bind_superpose_kernel(Zv, kext),
                       circconv.bind_superpose_kernel(Z, kext))


def test_pallas_codec_makes_no_torch_fft_call(dev, monkeypatch):
    """The backend=pallas path runs the FFT-form kernels, not cuFFT: with
    torch.fft's transforms patched to raise, an encode and a decode and
    their backward still run on the card, on the FFT route."""
    from repro_torch import codecs
    codec = codecs.build("c3sl:R=4,backend=pallas", D=2048)
    params = codec.init(device=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.fft called on the backend=pallas path")

    for fn in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, fn, refuse)
    circconv.reset_launch_counts()
    Z = torch.randn(64, 2048, device=dev, requires_grad=True)
    payload = codec.encode(params, Z)
    Zhat = codec.decode(params, payload)
    (gz,) = torch.autograd.grad((Zhat * torch.randn_like(Zhat)).sum(), [Z])
    torch.cuda.synchronize()
    assert payload.shape == (16, 2048) and gz.shape == Z.shape
    assert bool(torch.isfinite(gz).all())
    assert circconv.ROUTE_LAUNCHES == {("bind_superpose", "fft"): 2,
                                       ("unbind", "fft"): 2,
                                       ("bind_superpose", "direct"): 0,
                                       ("unbind", "direct"): 0}


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
