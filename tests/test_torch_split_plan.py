"""The split-K plan of the port's paged-attention kernels
(``repro_torch.kernels.paged_attention``): pure Python, held on the CPU.
The plan must cover a slot's positions exactly once, follow the tile and
page sizes, depend on nothing but the shapes and the SM count (never on
``pos``), give the same answer for the same inputs, ask only for head
blocks the CUDA source instantiates, and be made once per shape."""
import ctypes
import math
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

# (B, KV, G, hd, length, ps, sm_count): the serving shape, one live slot, a
# long T, a B*KV past the block target, the reference's test geometry,
# odd page sizes, GQA groups and wide heads
PLANS = [(8, 32, 1, 128, 512, 16, 132), (1, 32, 1, 128, 512, 16, 132),
         (8, 32, 1, 128, 4096, 16, 132), (72, 32, 1, 64, 64, 16, 132),
         (3, 2, 2, 16, 23, 8, 132), (3, 2, 1, 16, 17, 8, 132),
         (4, 2, 4, 16, 60, 23, 132), (3, 2, 16, 128, 40, 17, 132),
         (2, 4, 8, 256, 1000, 7, 114), (1, 1, 1, 512, 1, 1, 1),
         (16, 8, 12, 128, 2048, 32, 132)]


@pytest.mark.parametrize("shape", PLANS)
def test_chunks_cover_the_length_exactly_once(shape):
    length = shape[4]
    S, chunk = pa.split_plan(*shape)
    seen = [0] * length
    for s in range(S):
        lo, hi = s * chunk, min((s + 1) * chunk, length)
        assert lo < hi, (s, lo, hi)            # no split is empty of positions
        for t in range(lo, hi):
            seen[t] += 1
    assert seen == [1] * length


@pytest.mark.parametrize("shape", PLANS)
def test_chunk_follows_the_tile_and_the_page(shape):
    ps = shape[5]
    _, chunk = pa.split_plan(*shape)
    assert chunk % pa.TILE_ROWS == 0
    if math.lcm(pa.TILE_ROWS, ps) <= 8 * pa.TILE_ROWS:
        assert chunk % ps == 0


def test_same_inputs_give_the_same_plan():
    for shape in PLANS:
        assert pa.split_plan(*shape) == pa.split_plan(*shape)


def test_split_count_follows_the_block_target():
    # the serving shape: 256 blocks a split, about 2 an SM: one split
    assert pa.split_plan(8, 32, 1, 128, 512, 16, 132) == (1, 512)
    # one live slot: 32 blocks a split, so 8 splits of 64 positions
    assert pa.split_plan(1, 32, 1, 128, 512, 16, 132) == (8, 64)
    # past the target, one split of the whole length
    assert pa.split_plan(72, 32, 1, 64, 512, 16, 132) == (1, 512)
    # never more splits than chunks of the length
    assert pa.split_plan(1, 1, 1, 128, 40, 16, 132) == (2, 32)
    # more SMs, or fewer slots, never mean fewer splits
    for B in (1, 2, 4, 8):
        for sms in (66, 132, 264):
            a = pa.split_plan(B, 32, 1, 128, 4096, 16, sms)[0]
            assert pa.split_plan(B, 32, 1, 128, 4096, 16, 2 * sms)[0] >= a
            if B > 1:
                assert pa.split_plan(B // 2, 32, 1, 128, 4096, 16, sms)[0] >= a


def _instantiated_head_blocks():
    """{GB: widest head dim} from csrc/paged_attention.cu: the GB cases of
    launch_split_for, and hd <= 128 * kch_of(GB)."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    body = src[src.index("int launch_split_for("):]
    body = body[:body.index("default:")]
    gbs = [int(g) for g in re.findall(r"case (\d+): return", body)]
    lim, small, big = map(int, re.search(
        r"constexpr int kch_of\(int gb\) \{ return gb <= (\d+) \? (\d+) : "
        r"(\d+) / gb; \}", src).groups())
    assert gbs and all(f"launch_split<TKV, {g}, QUANT>" in body for g in gbs)
    return {g: 128 * (small if g <= lim else big // g) for g in gbs}


def test_head_block_returns_only_what_the_source_instantiates():
    widest = _instantiated_head_blocks()
    assert sorted(widest) == [1, 2, 4, 8, 16]
    for G in range(1, 70):
        for hd in range(4, pa.MAX_HEAD_DIM + 1, 4):
            gb = pa.head_block(G, hd)
            assert gb in widest and hd <= widest[gb], (G, hd, gb)
            # a power of two that holds the group, or the most hd allows
            assert gb >= G or 2 * gb not in widest or hd > widest[2 * gb]


@pytest.mark.parametrize("G, hd, want", [(1, 128, 1), (3, 64, 4), (16, 128, 16),
                                         (32, 128, 16), (8, 256, 8),
                                         (16, 512, 4), (5, 200, 8)])
def test_head_block_examples(G, hd, want):
    assert pa.head_block(G, hd) == want


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="over 512"):
        pa.head_block(1, 516)
    with pytest.raises(ValueError, match="positive"):
        pa.split_plan(0, 32, 1, 128, 512, 16, 132)
    with pytest.raises(ValueError, match="positive"):
        pa.split_plan(8, 32, 1, 128, 512, 16, 0)


class _FakeLib:
    """Stands in for the built library: records the set-up and launch calls
    it is given (the CPU has no card and no ``nvcc``); the set-up writes a
    ring depth of ``stages`` into the plan, as the CUDA one does."""

    def __init__(self, smem=4096, stages=2):
        self.smem, self.stages, self.prepared, self.launched = smem, stages, [], []

    def paged_attention_prepare(self, *args):
        self.prepared.append(args)
        if self.smem >= 0:
            pa.Plan.from_address(args[0]).stages = self.stages
        return self.smem

    def _launch(self, *args):
        self.launched.append(args)
        return 0

    paged_attention_float = paged_attention_int8 = _launch


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's launch path on CPU tensors: a fake library, 132 SMs,
    stream 0, a fresh per-shape cache, and every ``torch.empty`` counted."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(pa, "sm_count", lambda index: 132)
    monkeypatch.setattr(pa, "_current_stream", lambda index: 0)
    empties = []
    real_empty = torch.empty

    def empty(*a, **k):
        empties.append(a)
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    pa.launch_plan.cache_clear()
    yield lib, empties
    pa.launch_plan.cache_clear()


def _operands(B, ps, H, KV, hd, length, quant, pos):
    dt = torch.int8 if quant else torch.float32
    q = torch.zeros(B, 1, H, hd)
    pool = torch.zeros(B * length // ps + 2, ps, KV, hd, dtype=dt)
    table = torch.zeros(B, length // ps, dtype=torch.int32)
    return q, pool, table, pos


def _launch(q, pool, table, pos, quant, length):
    if quant:
        scales = torch.zeros(*pool.shape[:3], 1)
        return pa._launch("paged_attention_quant", q, pool, pool, table, pos,
                          (q, pool, scales, pool, scales, table, pos), q.dtype,
                          (0, 0), quant=True, length=length)
    return pa._launch("paged_attention", q, pool, pool, table, pos,
                      (q, pool, pool, table, pos), q.dtype, (0,), quant=False,
                      length=length)


def _fields(plan_address):
    p = pa.Plan.from_address(plan_address)
    return tuple(getattr(p, n) for n, _ in pa.Plan._fields_)


def test_plan_struct_matches_the_source():
    """``Plan`` has the fields of ``struct Plan`` in the CUDA source, in
    order and of the same C types."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    body = re.search(r"struct Plan \{([^}]*)\};", src).group(1)
    want = []
    for ctype, names in re.findall(r"(int|float) ([^;]+);", body):
        want += [(n.strip(), ctype) for n in names.split(",")]
    got = [(n, {ctypes.c_int: "int", ctypes.c_float: "float"}[t])
           for n, t in pa.Plan._fields_]
    assert got == want


@pytest.mark.parametrize("quant", [False, True])
def test_launch_arguments_never_read_pos(fake_card, quant):
    """The kernel's arguments come from shapes alone: ``pos`` on the meta
    device (which holds no values, so any host read of it raises) gives the
    same arguments as two real ``pos``; the pointers aside.  The plan
    carries the ring depth that the set-up wrote."""
    lib, _ = fake_card
    B, ps, H, KV, hd, length = 8, 16, 32, 32, 128, 512
    for pos in (torch.zeros(B, dtype=torch.int32),
                torch.full((B,), length - 1, dtype=torch.int32),
                torch.empty(B, dtype=torch.int32, device="meta")):
        _launch(*_operands(B, ps, H, KV, hd, length, quant, pos), quant, length)
    nptr = 9 if quant else 7
    rest = [(_fields(call[nptr]), call[nptr + 1:]) for call in lib.launched]
    assert len(rest) == 3 and rest[0] == rest[1] == rest[2]
    splits, chunk = pa.split_plan(B, KV, 1, hd, length, ps, 132)
    assert rest[0][0] == (B, length // ps, ps, B * length // ps + 2, KV, 1,
                          pa.head_block(1, hd), hd, length, splits, chunk,
                          lib.stages, pytest.approx(hd ** -0.5))


@pytest.mark.parametrize("B, splits", [(8, 1), (1, 8)])
def test_scratch_only_with_more_than_one_split(fake_card, B, splits):
    """The serving shape plans one split: the wrapper asks for the output
    alone and passes a null scratch.  One live slot plans 8: one scratch of
    B*H*S*(hd + 2) float32 elements beside the output."""
    lib, empties = fake_card
    ps, H, KV, hd, length = 16, 32, 32, 128, 512
    assert pa.split_plan(B, KV, 1, hd, length, ps, 132)[0] == splits
    ops = _operands(B, ps, H, KV, hd, length, False,
                    torch.zeros(B, dtype=torch.int32))
    empties.clear()
    out = _launch(*ops, False, length)
    assert out.shape == (B, 1, H * hd)
    part_ptr = lib.launched[-1][5]
    if splits == 1:
        assert len(empties) == 1 and part_ptr is None
    else:
        assert len(empties) == 2 and empties[1] == (B * H * splits * (hd + 2),)
        assert part_ptr


def test_launch_plan_is_kept_per_shape(fake_card):
    """A decode step's 30 reads of one shape plan once: the checks, the plan
    and the kernel's set-up (``paged_attention_prepare``) are kept per
    shape, and a new shape or device plans again."""
    lib, _ = fake_card
    B, ps, H, KV, hd, length = 8, 16, 32, 32, 128, 512
    ops = _operands(B, ps, H, KV, hd, length, False,
                    torch.zeros(B, dtype=torch.int32))
    for _ in range(30):
        _launch(*ops, False, length)
    assert len(lib.launched) == 30 and len(lib.prepared) == 1
    assert lib.prepared[0][1:] == (4, 0, None)
    assert _fields(lib.prepared[0][0])[6:11] == (1, hd, length, 1, 512)
    assert pa.launch_plan.cache_info().hits == 29
    _launch(*_operands(1, ps, H, KV, hd, length, True,
                       torch.zeros(1, dtype=torch.int32)), True, length)
    assert len(lib.prepared) == 2 and lib.prepared[1][1:] == (1, 1, None)
    pa.launch_plan(3, False, *(t.shape for t in ops), 4, length)
    assert len(lib.prepared) == 3 and lib.prepared[2][-1] == 3


def test_launch_plan_refuses_what_prepare_refuses(fake_card):
    lib, _ = fake_card
    lib.smem = -9
    with pytest.raises(ValueError, match="shared memory"):
        _launch(*_operands(2, 16, 4, 2, 128, 64, False,
                           torch.zeros(2, dtype=torch.int32)), False, 64)
