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
# blocks); G 1, 2, 128; D from 4 to the route's upper limit; and the
# serving cut of deepseek-v2-lite-16b (D 2048) at a decode step and a
# prefill chunk
FFT_SHAPES = [(2, 1, 2048), (2, 5, 2048), (2, 8, 2048), (2, 9, 2048),
              (2, 16, 4096), (1, 4, 4096), (2, 4, 4096), (128, 4, 4096),
              (3, 2, 4), (2, 3, 8), (2, 2, 16), (3, 2, 32), (1, 3, 16384),
              (2, 4, 2048), (128, 4, 2048)]
# the four-step kernels against the plain version past shared memory (its
# gather runs in chunks there), and at the LM training shape (G = B/R = 4,
# R 4, D = 128 * 4096) against a float64 torch.fft oracle
FFT4_SHAPES = [(1, 1, 32768), (2, 4, 65536)]
FFT4_ORACLE_SHAPES = [(4, 4, 524288)]
# the mixed-radix one-pass kernels (D = 2^a 3^b 5^c): the serving widths of
# qwen2.5-32b / pixtral-12b (5120) and mistral-large-123b (12288) at a
# decode step (G 2) and a 64-token prefill chunk at 8 slots (G 128), and
# edges: D 12 and 160 (D/4 not a multiple of 32), two odd radices (960,
# 15360), the largest odd part (16200 = 8 3^4 5^2), R 9 (a cluster of 8)
MIXED_SHAPES = [(2, 4, 5120), (128, 4, 5120), (2, 4, 12288), (2, 3, 12),
                (3, 2, 160), (2, 9, 960), (1, 3, 15360), (1, 2, 16200)]
MIXED_ORACLE_SHAPES = [(128, 4, 12288)]
# the four-step kernels at mixed radix: against the plain version, and at
# the LM training shapes of qwen2.5-32b (D = 128 * 5120, 1280 x 512) and
# mistral-large-123b (D = 128 * 12288, 1536 x 1024) against the oracle
FFT4_MIXED_SHAPES = [(1, 2, 20480), (2, 4, 61440), (3, 5, 40960)]
FFT4_MIXED_ORACLE_SHAPES = [(4, 4, 655360), (4, 4, 1572864)]
# the four-step kernels' other branches, against the oracle: R 9 past the
# keys a pass B chunk holds (262144 = 512 x 512, 8 keys a chunk), and a D
# whose split is a divisor of 4-point tiles (18000 = 180 x 100)
FFT4_EDGE_ORACLE_SHAPES = [(1, 9, 262144), (2, 3, 18000)]


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


def _oracle(name, x, K):
    """bind or unbind in float64 through torch.fft (a check only)."""
    X, Kf = torch.fft.fft(x.double(), dim=-1), torch.fft.fft(K.double(), dim=-1)
    if name == "bind":
        return torch.fft.ifft((X * Kf).sum(-2), dim=-1).real
    return torch.fft.ifft(X[:, None, :] * Kf.conj(), dim=-1).real


def _check_routed(kernel_route, G, R, D, dtype, oracle, seed):
    """bind and unbind through ``kernel_route`` against the plain version,
    or the float64 torch.fft oracle with ``oracle``."""
    assert circconv.route(D) == kernel_route
    Z, K = _data(G, R, D, dev="cuda", seed=seed)
    kext = ops._kext(K)
    Z = Z.to(dtype)
    S = _routed("bind", kernel_route, Z, kext)
    _close(S, _oracle("bind", Z, K) if oracle
           else circconv.bind_superpose_plain(Z.double(), kext.double()), dtype)
    Zh = _routed("unbind", kernel_route, S, kext)
    _close(Zh, _oracle("unbind", S, K) if oracle
           else circconv.unbind_plain(S.double(), kext.double()), dtype)
    torch.cuda.synchronize()
    assert S.dtype == dtype and S.shape == (G, D) and Zh.shape == (G, R, D)


@pytest.mark.parametrize("G,R,D", FFT4_SHAPES + FFT4_ORACLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft4_kernels_match_plain_on_card(dev, G, R, D, dtype):
    _check_routed("fft4", G, R, D, dtype, (G, R, D) in FFT4_ORACLE_SHAPES, seed=8)


@pytest.mark.parametrize("G,R,D", MIXED_SHAPES + MIXED_ORACLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_radix_fft_kernels_match_plain_on_card(dev, G, R, D, dtype):
    _check_routed("fft", G, R, D, dtype, (G, R, D) in MIXED_ORACLE_SHAPES, seed=14)


@pytest.mark.parametrize("G,R,D", FFT4_MIXED_SHAPES + FFT4_MIXED_ORACLE_SHAPES
                         + FFT4_EDGE_ORACLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_radix_fft4_kernels_match_plain_on_card(dev, G, R, D, dtype):
    _check_routed("fft4", G, R, D, dtype, (G, R, D) in FFT4_MIXED_ORACLE_SHAPES
                  + FFT4_EDGE_ORACLE_SHAPES, seed=15)


@pytest.mark.parametrize("G,R,D", [(4, 4, 524288), (4, 4, 655360), (4, 4, 1572864),
                                   (128, 4, 12288), (3, 5, 5120)]
                         + FFT4_EDGE_ORACLE_SHAPES)
def test_fft4_kernels_are_bitwise_repeatable_and_adjoint(dev, G, R, D):
    """Two runs equal bit for bit (no atomics), and <bind(Z), S> = <Z,
    unbind(S)> to float32 rounding (each kernel's backward is the other),
    on the four-step route and the mixed-radix one-pass route."""
    Z, K = _data(G, R, D, dev, seed=9)
    kext = ops._kext(K)
    S = torch.randn(G, D, device=dev)
    b, u = circconv.bind_superpose_kernel(Z, kext), circconv.unbind_kernel(S, kext)
    assert torch.equal(circconv.bind_superpose_kernel(Z, kext), b)
    assert torch.equal(circconv.unbind_kernel(S, kext), u)
    lhs, rhs = (b.double() * S.double()).sum(), (Z.double() * u.double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * float(b.double().norm() * S.double().norm())


@pytest.mark.parametrize("G,R,D", [(1, 1, 28672)])
def test_direct_kernels_past_shared_memory(dev, G, R, D):
    """A D past 16384 outside 2^a 3^b 5^c (28672 = 2^12 7) stays on the
    direct route."""
    assert circconv.route(D) == "direct"
    Z, K = _data(G, R, D, dev, seed=10)
    kext = ops._kext(K)
    S = _routed("bind", "direct", Z, kext)
    _close(S, circconv.bind_superpose_plain(Z.double(), kext.double()), torch.float32)
    Zh = _routed("unbind", "direct", S, kext)
    _close(Zh, circconv.unbind_plain(S.double(), kext.double()), torch.float32)


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


@pytest.mark.parametrize("D", [2048, 5120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_kernels_give_exact_zeros_for_zero_rows(dev, dtype, D):
    """An all-zero data row (a dead slot's features) adds exactly zero, as
    in the plain version: its transform holds only the key's rounding.  The
    mixed-radix one-pass kernels (5120) keep it."""
    Z, K = _data(4, 4, D, dev, seed=7)
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


@pytest.mark.parametrize("D", [2048, 5120, 12288])
def test_pallas_codec_makes_no_torch_fft_call(dev, monkeypatch, D):
    """The backend=pallas path runs the FFT-form kernels, not cuFFT: with
    torch.fft's transforms patched to raise, an encode and a decode and
    their backward still run on the card, on the FFT route (mixed radix at
    the serving widths 5120 and 12288)."""
    from repro_torch import codecs
    codec = codecs.build("c3sl:R=4,backend=pallas", D=D)
    params = codec.init(device=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.fft called on the backend=pallas path")

    for fn in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, fn, refuse)
    circconv.reset_launch_counts()
    Z = torch.randn(64, D, device=dev, requires_grad=True)
    payload = codec.encode(params, Z)
    Zhat = codec.decode(params, payload)
    (gz,) = torch.autograd.grad((Zhat * torch.randn_like(Zhat)).sum(), [Z])
    torch.cuda.synchronize()
    assert payload.shape == (16, D) and gz.shape == Z.shape
    assert bool(torch.isfinite(gz).all())
    assert circconv.ROUTE_LAUNCHES == {("bind_superpose", "fft"): 2,
                                       ("unbind", "fft"): 2,
                                       ("bind_superpose", "fft4"): 0,
                                       ("unbind", "fft4"): 0,
                                       ("bind_superpose", "direct"): 0,
                                       ("unbind", "direct"): 0}


@pytest.mark.parametrize("D", [524288, 655360])
def test_pallas_codec_at_the_lm_width_makes_no_torch_fft_call(dev, monkeypatch, D):
    """At the LM training path's D = 128 * d_model (deepseek-7b's 4096 and
    qwen2.5-32b's 5120) the backend=pallas codec runs the four-step
    kernels, forward and backward, with torch.fft's transforms patched to
    raise; the keys' spectra are made once for the four launches."""
    from repro_torch import codecs
    codec = codecs.build("c3sl:R=4,backend=pallas", D=D)
    params = codec.init(device=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.fft called on the backend=pallas path")

    for fn in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, fn, refuse)
    circconv.reset_launch_counts()
    Z = torch.randn(16, D, device=dev, requires_grad=True)
    Zhat = codec.decode(params, codec.encode(params, Z))
    (gz,) = torch.autograd.grad((Zhat * Zhat).sum(), [Z])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(gz).all())
    assert circconv.KEY_SPECTRA_BUILDS == 1
    assert circconv.ROUTE_LAUNCHES[("bind_superpose", "fft4")] == 2
    assert circconv.ROUTE_LAUNCHES[("unbind", "fft4")] == 2
    assert sum(circconv.ROUTE_LAUNCHES.values()) == 4


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


def test_fft4_key_spectra_are_kept_and_never_stale(dev):
    """The four-step kernels' key spectra are made once per key tensor and
    kept: a second call with the same keys makes none; after an in-place
    write to the keys the next call makes them anew and agrees with the
    oracle on the new keys, not the old."""
    G, R, D = 2, 2, 40960
    Z, K = _data(G, R, D, dev, seed=16)
    circconv.reset_launch_counts()
    S = ops.bind_superpose_pallas(Z, K)
    ops.bind_superpose_pallas(Z, K)
    ops.unbind_pallas(S, K)
    assert circconv.KEY_SPECTRA_BUILDS == 1
    K.mul_(-0.5)
    S2 = ops.bind_superpose_pallas(Z, K)
    torch.cuda.synchronize()
    assert circconv.KEY_SPECTRA_BUILDS == 2
    _close(S2, _oracle("bind", Z, K), torch.float32)
    _close(S2, -0.5 * S.double(), torch.float32)
    ops.clear_key_caches()
    assert torch.equal(ops.bind_superpose_pallas(Z, K), S2)
    assert circconv.KEY_SPECTRA_BUILDS == 3
