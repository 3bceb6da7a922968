"""The hand-written CUDA paged-attention kernels on the card, against their
plain versions run on float64 copies of the same values.  Needs an NVIDIA
GPU with nvcc (sm_90a); every test skips where ``torch.cuda.is_available()``
is false.  Imports no JAX, so it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention_cuda.py
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import lm as lm_lib  # noqa: E402
from repro_torch.models.paging import PagedLayout  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 and int8 pools in float32 compute: 1e-5 elementwise against a
# float64 oracle.  bfloat16 outputs are rounded once (half an ulp, at most
# 2^-8 of the element), so their limits scale with the compared values:
# max|err| within 1e-2 of max|want|, and 5e-3 in relative L2.
TOL = {torch.float32: 1e-5}
BF16_REL_MAX, BF16_REL_L2 = 1e-2, 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def make_case(B, ps, H, KV, hd, length, *, quant=False, seed=0, dev="cuda"):
    """Pools with spare pages, a shuffled table, staggered positions on both
    sides of the last page boundary, and a dead slot (table row 0, pos 0)."""
    rng = np.random.RandomState(seed)
    P = -(-length // ps)
    npages = B * P + 2
    table = rng.permutation(npages)[:B * P].astype(np.int32).reshape(B, P)
    pos = rng.randint(0, length, B).astype(np.int32)
    pos[0] = length - 1
    if B > 1:
        pos[1] = max(length - ps - 1, 0)
    if B > 2:
        table[2] = 0                       # dead slot: reads page 0 only
        pos[2] = 0
    t = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    case = {"q": t(rng.randn(B, 1, H, hd).astype(np.float32)),
            "table": t(table), "pos": t(pos), "length": length}
    if quant:
        for n in "kv":
            case[n] = t(rng.randint(-127, 128, (npages, ps, KV, hd)).astype(np.int8))
            case[n + "s"] = t((rng.rand(npages, ps, KV, 1) * 0.02 + 1e-3)
                              .astype(np.float32))
    else:
        for n in "kv":
            case[n] = t(rng.randn(npages, ps, KV, hd).astype(np.float32))
    return case


def run_pair(case, dtype, *, quant=False, window=None, compute_dtype=None):
    """(kernel output, float64 plain output) on the same values."""
    q = case["q"].to(dtype)
    kw = dict(length=case["length"], sliding_window=window)
    if quant:
        cd = compute_dtype or dtype
        got = pa.paged_attention_quant(q, case["k"], case["ks"], case["v"],
                                       case["vs"], case["table"], case["pos"],
                                       compute_dtype=cd, **kw)
        want = pa.paged_attention_quant_plain(
            q.double(), case["k"], case["ks"].double(), case["v"],
            case["vs"].double(), case["table"], case["pos"],
            compute_dtype=torch.float64, **kw)
        return got, want, cd
    k, v = case["k"].to(dtype), case["v"].to(dtype)
    got = pa.paged_attention(q, k, v, case["table"], case["pos"], **kw)
    want = pa.paged_attention_plain(q.double(), k.double(), v.double(),
                                    case["table"], case["pos"], **kw)
    return got, want, dtype


def assert_close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    if dtype == torch.bfloat16:
        rel_max = float(err.max() / want.abs().max())
        rel_l2 = float(err.norm() / want.norm())
        assert rel_max <= BF16_REL_MAX and rel_l2 <= BF16_REL_L2, (rel_max, rel_l2)
        return
    tol = TOL[dtype]
    assert bool((err <= tol + tol * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("length", [16, 17, 23])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trailing_pages_match_plain(dev, length, groups, dtype):
    case = make_case(4, 8, 2 * groups, 2, 16, length, seed=length + groups)
    before = dict(pa.LAUNCHES)
    got, want, _ = run_pair(case, dtype)
    assert_close(got, want, dtype)
    assert got.dtype == dtype and got.shape == (4, 1, 2 * groups * 16)
    assert pa.LAUNCHES["paged_attention"] == before["paged_attention"] + 1


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("window", [None, 24])
def test_geometry_and_masks_match_plain(dev, hd, groups, window):
    case = make_case(3, 17, 2 * groups, 2, hd, 40, seed=hd + groups)
    got, want, _ = run_pair(case, torch.float32, window=window)
    assert_close(got, want, torch.float32)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
def test_int8_pools_match_plain(dev, q_dtype, compute_dtype, groups):
    case = make_case(4, 23, 2 * groups, 2, 32, 60, quant=True, seed=groups)
    before = dict(pa.LAUNCHES)
    got, want, cd = run_pair(case, q_dtype, quant=True,
                             compute_dtype=compute_dtype)
    # the plain version takes the same (rounded) q, so the output's dtype
    # sets the limit
    assert_close(got, want, cd)
    assert got.dtype == compute_dtype
    assert pa.LAUNCHES["paged_attention_quant"] == \
        before["paged_attention_quant"] + 1


def test_main_path_shape_matches_plain(dev):
    """B 8, T 512, ps 16, KV 32, hd 128, groups 1: the full-width serving
    run's shape, with positions spread over the pool."""
    case = make_case(8, 16, 32, 32, 128, 512, seed=7)
    got, want, _ = run_pair(case, torch.float32)
    assert_close(got, want, torch.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_gqa_serving_shape_matches_plain(dev, quant):
    """B 8, T 512, ps 16, 32 heads over KV 8, hd 128: phi3.5-moe-42b-a6.6b's
    full-width serving read (float32 pools; int8 pools in bfloat16)."""
    case = make_case(8, 16, 32, 8, 128, 512, quant=quant, seed=11)
    dtype = torch.bfloat16 if quant else torch.float32
    got, want, _ = run_pair(case, dtype, quant=quant)
    assert_close(got, want, dtype)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    case = make_case(2, 8, 4, 2, 16, 16)
    q, k, v, tab, pos = (case[n] for n in ("q", "k", "v", "table", "pos"))
    with pytest.raises(TypeError, match="must match q"):
        pa.paged_attention(q.bfloat16(), k, v, tab, pos, length=16)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, tab.long(), pos, length=16)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, k.transpose(0, 1), v, tab, pos, length=16)
    with pytest.raises(ValueError, match="multiple of 8"):
        c = make_case(2, 8, 4, 2, 12, 16)
        pa.paged_attention(c["q"].bfloat16(), c["k"].bfloat16(),
                           c["v"].bfloat16(), c["table"], c["pos"], length=16)
    with pytest.raises(ValueError, match="operand on"):
        pa.paged_attention(q, k.cpu(), v, tab, pos, length=16)


def test_decode_step_kernel_matches_gather_on_card(dev):
    cfg = reduced(get_config("deepseek-7b"), num_layers=2, d_model=128,
                  d_ff=256, vocab_size=128, num_heads=4, num_kv_heads=2,
                  head_dim=32)
    params = lm_lib.init_lm_params(0, cfg, device=dev)
    B, T, ps = 4, 32, 8
    layout = PagedLayout(ps, T, B * (T // ps))
    cache = lm_lib.init_decode_cache(params, cfg, B, T, paged=layout)
    cache["pages"] = torch.randperm(B * (T // ps)).to(dev, torch.int32).reshape(B, -1)
    cache_k = {"stack": {k: {n: t.clone() for n, t in v.items()}
                         for k, v in cache["stack"].items()},
               "pages": cache["pages"]}
    toks = torch.randint(0, 128, (B, 1), device=dev)
    pos = torch.tensor([0, 3, 1, 5], dtype=torch.int32, device=dev)
    live = torch.tensor([True, True, False, True], device=dev)
    for _ in range(4):
        lg, _ = lm_lib.decode_step(params, cache, toks, pos, cfg, paged=layout,
                                   live=live, kv_read="gather")
        lk, _ = lm_lib.decode_step(params, cache_k, toks, pos, cfg,
                                   paged=layout, live=live, kv_read="kernel")
        torch.cuda.synchronize()
        assert float((lg - lk).abs().max()) <= 1e-4 * float(lg.abs().max())
        toks = lg[:, -1].argmax(-1, keepdim=True)
        pos = pos + live.to(torch.int32)


def test_engine_execution_mode_on_card(dev):
    from repro_torch.serving.engine import BatchedEngine, Request
    cfg = reduced(get_config("deepseek-7b"), num_layers=2, d_model=128,
                  d_ff=256, vocab_size=128, num_heads=4, num_kv_heads=2,
                  head_dim=32)
    params = lm_lib.init_lm_params(0, cfg, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = BatchedEngine(params, cfg, num_slots=4, max_len=32, chunk_size=8,
                            kv_layout="paged", page_size=8, kv_read="kernel",
                            codec="c3sl:R=2,backend=pallas")
    assert eng.stats["kv_read_execution_mode"] == "cuda-kernel"
    assert eng.stats["codec_execution_mode"] == "cuda-kernel"
    pa.reset_launch_counts()
    for u in range(4):
        eng.submit(Request(uid=u, prompt=[1 + u, 2, 3], max_new_tokens=5))
    done = eng.run()
    assert len(done) == 4 and all(len(r.out) == 5 for r in done)
    # one launch per attention layer per decode step
    assert pa.LAUNCHES["paged_attention"] == 2 * eng.stats["decode_steps"]


# ---------------------------------------------------------------------------
# split-K edges: the chunks of split_plan, the empty partials, the combine
# ---------------------------------------------------------------------------

def _plan(case, H, KV, hd, ps):
    B = case["q"].shape[0]
    return pa.split_plan(B, KV, H // KV, hd, case["length"], ps,
                         pa.sm_count(torch.cuda.current_device()))


def _split_case(edge, *, quant):
    """(case, window) for one split edge; positions are set from the plan
    where the edge is a chunk boundary."""
    window = None
    if edge == "long_T":            # T 4096: 32 splits of 4 tiles
        geo, pos = (2, 16, 8, 4, 128, 4096), [4095, 1000]
    elif edge == "S_is_1":          # B*KV past the plan's block target
        geo, pos = (72, 16, 32, 32, 64, 64), None
    elif edge == "ring":            # T = the window, wrapped positions
        geo, pos, window = (4, 16, 8, 2, 64, 256), [255, 300, 700, 10], 256
    elif edge == "deep_ring":       # one split of 64 tiles: the ring wraps
        geo = (8, 16, 32, 32, 128, 2048)
        pos = [2047, 1500, 700, 255, 256, 257, 95, 96]
    elif edge == "later_chunks_empty":
        geo, pos = (4, 16, 4, 2, 128, 512), [511, 3, 40, 0]
    else:                           # n = 1, one chunk, one chunk + 1
        geo, pos = (2, 16, 4, 2, 128, 512), None
    B, ps, H, KV, hd, length = geo
    case = make_case(B, ps, H, KV, hd, length, quant=quant, seed=len(edge))
    S, chunk = _plan(case, H, KV, hd, ps)
    assert (S == 1) == (edge in ("S_is_1", "deep_ring")), (edge, S, chunk)
    if pos is None and edge != "S_is_1":
        n = {"n_is_1": 1, "one_chunk": chunk, "chunk_plus_one": chunk + 1}[edge]
        pos = [n - 1, max(n - 2, 0)]
    if pos is not None:
        case["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return case, window


SPLIT_EDGES = ["n_is_1", "one_chunk", "chunk_plus_one", "later_chunks_empty",
               "long_T", "deep_ring", "S_is_1", "ring"]


@pytest.mark.parametrize("edge", SPLIT_EDGES)
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_split_edges_match_plain(dev, edge, quant):
    case, window = _split_case(edge, quant=quant)
    got, want, dt = run_pair(case, torch.float32, quant=quant, window=window)
    assert_close(got, want, dt)


# (G, hd) -> each head block head_block returns: 1, 2, 4, 8, 16, two
# blocks a group (G 32), and the widest rows of GB 8 and 4
HEAD_BLOCKS = [(1, 128, 1), (2, 64, 2), (3, 64, 4), (8, 128, 8), (16, 128, 16),
               (32, 128, 16), (5, 192, 8), (4, 512, 4)]


@pytest.mark.parametrize("G, hd, gb", HEAD_BLOCKS)
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_every_head_block_matches_plain(dev, G, hd, gb, quant):
    assert pa.head_block(G, hd) == gb
    case = make_case(3, 16, 2 * G, 2, hd, 96, quant=quant, seed=G + hd)
    got, want, dt = run_pair(case, torch.float32, quant=quant)
    assert_close(got, want, dt)


# (hd, pools, ring depth): chunks of four tiles (T 4096, four slots of two
# kv heads, so the plan gives 32 splits of 128 on 132 SMs), whose float32
# rows of 384 and 512 fit a ring of two tiles and of one in the shared
# memory, and whose bfloat16 and int8 rows of 512 keep three
WIDE_ROWS = [(384, "float32", 2), (512, "float32", 1), (512, "bfloat16", 3),
             (512, "int8", 3)]


@pytest.mark.parametrize("hd, pools, stages", WIDE_ROWS)
def test_wide_rows_take_the_ring_that_fits(dev, hd, pools, stages):
    quant = pools == "int8"
    dtype = torch.bfloat16 if pools == "bfloat16" else torch.float32
    case = make_case(4, 16, 2, 2, hd, 4096, quant=quant, seed=hd)
    got, want, dt = run_pair(case, dtype, quant=quant)
    assert_close(got, want, dt)
    S, chunk = _plan(case, 2, 2, hd, 16)
    assert S > 1 and chunk > 3 * pa.TILE_ROWS, (S, chunk)
    kv_bytes = 1 if quant else dtype.itemsize
    _, _, plan = pa.launch_plan(torch.cuda.current_device(), quant,
                                case["q"].shape, case["k"].shape,
                                case["table"].shape, case["pos"].shape,
                                kv_bytes, case["length"])
    assert (plan.splits, plan.chunk, plan.stages) == (S, chunk, stages)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_two_calls_are_bitwise_equal(dev, quant):
    for edge in ("later_chunks_empty", "S_is_1"):
        case, _ = _split_case(edge, quant=quant)
        for dtype in (torch.float32, torch.bfloat16):
            a, _, _ = run_pair(case, dtype, quant=quant)
            b, _, _ = run_pair(case, dtype, quant=quant)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (edge, dtype)


def test_wrapper_rejects_unaligned_pools_and_wide_heads(dev):
    case = make_case(2, 8, 4, 2, 16, 16)
    q, k, v, tab, pos = (case[n] for n in ("q", "k", "v", "table", "pos"))
    shifted = torch.empty(k.numel() + 1, device=dev)[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pa.paged_attention(q, shifted, v, tab, pos, length=16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pa.paged_attention(q, k, shifted, tab, pos, length=16)
    wide = make_case(2, 8, 2, 2, 516, 16)
    with pytest.raises(ValueError, match="over 512"):
        pa.paged_attention(wide["q"], wide["k"], wide["v"], wide["table"],
                           wide["pos"], length=16)
