"""The codec control plane on the card: every Adaptive-R ladder bucket's
bind and unbind at the VGG-16 (D 2048) and ResNet-50 (D 4096) cut shapes
against the plain versions, the asymmetric link's gradient seam taking an
expanded (non-contiguous) cotangent through the kernels, and the masked
decode bitwise equal to the decode at an all-ones mask.  Needs an NVIDIA
GPU with nvcc (sm_90a); every test skips where ``torch.cuda.is_available()``
is false.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_control_plane_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import codecs, transport  # noqa: E402
from repro_torch.core import hrr  # noqa: E402
from repro_torch.kernels import circconv, ops  # noqa: E402

pytestmark = pytest.mark.cuda

B = 64                          # the paper's batch
TOL = 1e-5                      # float32 against a float64 oracle
FWD_LADDER = (2, 4, 8, 16)      # adaptive:c3sl:R=16,min_R=2
BWD_LADDER = (1, 2, 4)          # bwd:adaptive:c3sl:R=4,min_R=1, clamped to B/16


def _shapes():
    """(G, R, D) of every bind/unbind the link's 12 (R_fwd, R_bwd) programs
    launch: the forward payload G = B/R_fwd, and the gradient payload's
    B/R_fwd rows regrouped by R_bwd."""
    out = set()
    for D in (2048, 4096):
        for rf in FWD_LADDER:
            out.add((B // rf, rf, D))
            for rb in BWD_LADDER:
                out.add((B // rf // rb, rb, D))
    return sorted(out)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _close(got, want):
    want = want.double()
    err = (got.double() - want).abs()
    assert bool((err <= TOL + TOL * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("G,R,D", _shapes())
def test_every_bucket_shape_against_plain(dev, G, R, D):
    gen = torch.Generator().manual_seed(G * 100 + R)
    K = hrr.generate_keys(gen, R, D, device=dev)
    Z = torch.randn((G, R, D), generator=gen).to(dev)
    kext = ops._kext(K)
    circconv.reset_launch_counts()
    S = circconv.bind_superpose_kernel(Z, kext)
    Zhat = circconv.unbind_kernel(S, kext)
    torch.cuda.synchronize()
    assert circconv.ROUTE_LAUNCHES[("bind_superpose", "fft")] == 1
    assert circconv.ROUTE_LAUNCHES[("unbind", "fft")] == 1
    _close(S, circconv.bind_superpose_plain(Z.double(), kext))
    _close(Zhat, circconv.unbind_plain(S.double(), kext))


@pytest.mark.parametrize("D", [2048, 4096])
def test_seam_takes_an_expanded_cotangent_through_the_kernels(dev, D):
    """``out.sum()``'s backward hands the seam a stride-0 view; the seam
    makes it contiguous for the kernels, and the result equals a dense
    cotangent's, and the fft backend's within the float32 tolerance."""
    c = codecs.build(f"c3sl:R=4,D={D},backend=pallas")
    p = c.init(device=dev)
    P = torch.randn(16, D, device=dev, requires_grad=True)
    probe = torch.zeros((), device=dev, requires_grad=True)
    circconv.reset_launch_counts()
    g_exp, s_exp = torch.autograd.grad(
        transport.grad_roundtrip(c, P, p, probe).sum(), [P, probe])
    torch.cuda.synchronize()
    assert circconv.ROUTE_LAUNCHES[("bind_superpose", "fft")] == 1
    assert circconv.ROUTE_LAUNCHES[("unbind", "fft")] == 1
    g_den, s_den = torch.autograd.grad(
        transport.grad_roundtrip(c, P, p, probe), [P, probe],
        torch.ones(16, D, device=dev))
    assert torch.equal(g_exp, g_den) and torch.equal(s_exp, s_den)
    f = codecs.build(f"c3sl:R=4,D={D},backend=fft")
    pf = f.init(device=dev)
    g_fft, s_fft = torch.autograd.grad(
        transport.grad_roundtrip(f, P, pf, probe).sum(), [P, probe])
    scale = float(g_fft.abs().max())
    assert float((g_exp - g_fft).abs().max()) <= 1e-4 * scale
    assert abs(float(s_exp) - float(s_fft)) <= 1e-3


@pytest.mark.parametrize("spec", ["c3sl:R=4,D=2048,backend=pallas",
                                  "c3sl:R=16,D=4096,backend=pallas|int8",
                                  "c3sl:R=1,D=2048,backend=pallas"])
def test_masked_decode_all_ones_is_bitwise_decode(dev, spec):
    c = codecs.build(spec)
    p = c.init(device=dev)
    Z = torch.randn(B, c.D, device=dev)
    payload = c.encode(p, Z)
    ones = torch.ones_like(payload)
    circconv.reset_launch_counts()
    assert torch.equal(c.decode_masked(p, payload, ones), c.decode(p, payload))
    assert circconv.ROUTE_LAUNCHES[("unbind", "fft")] == 2
    keep = ones.clone()
    keep[:, : c.D // 4] = 0
    got = c.decode_masked(p, payload, keep)
    assert bool(torch.isfinite(got).all())
    assert not torch.equal(got, c.decode(p, payload))
