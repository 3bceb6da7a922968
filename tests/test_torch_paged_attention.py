"""The port's paged-attention wrappers (their plain versions on the CPU), the
paged-KV addressing, and the paged_attention_decode dispatch, held against
the JAX reference: its Pallas kernels in interpret mode, and ``_sdpa`` over
``gather_pages``."""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402

TOL = 1e-5       # float32, as tests/test_kernels.py:38


def _case(B, ps, H, KV, hd, length, *, quant=False, seed=0):
    """numpy inputs: spare pages, a shuffled table, positions on both sides
    of the last page boundary, and a dead slot (table row 0, pos 0)."""
    rng = np.random.RandomState(seed)
    P = -(-length // ps)
    npages = B * P + 2
    table = rng.permutation(npages)[:B * P].astype(np.int32).reshape(B, P)
    pos = rng.randint(0, length, B).astype(np.int32)
    pos[0] = length - 1
    pos[1] = max(length - ps - 1, 0)
    table[2] = 0
    pos[2] = 0
    c = {"q": rng.randn(B, 1, H, hd).astype(np.float32), "table": table,
         "pos": pos, "length": length}
    if quant:
        for n in "kv":
            c[n] = rng.randint(-127, 128, (npages, ps, KV, hd)).astype(np.int8)
            c[n + "s"] = (rng.rand(npages, ps, KV, 1) * 0.02 + 1e-3).astype(np.float32)
    else:
        for n in "kv":
            c[n] = rng.randn(npages, ps, KV, hd).astype(np.float32)
    return c


def _t(c):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in c.items()}


def _j(c):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in c.items()}


@functools.partial(jax.jit, static_argnums=(5, 6))
def _want_sdpa(q, k_pool, v_pool, table, pos, length, window):
    """The reference's ``_sdpa`` over ``gather_pages`` with its decode mask."""
    k = jpaging.gather_pages(k_pool, table, length)
    v = jpaging.gather_pages(v_pool, table, length)
    idx = jnp.arange(length)[None, :]
    if window is None:
        valid = idx <= pos[:, None]
    else:
        age = ((pos % length)[:, None] - idx) % length
        valid = age < jnp.minimum(pos + 1, length)[:, None]
    return jattn._sdpa(q, k, v, valid[:, None, None, :])


@pytest.mark.parametrize("length", [16, 17, 23])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 12])
def test_plain_matches_reference_sdpa_over_gather(length, groups, window):
    c = _case(4, 8, 2 * groups, 2, 16, length, seed=length * groups)
    t = _t(c)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention(t["q"], t["k"], t["v"], t["table"], t["pos"],
                             length=length, sliding_window=window)
    assert pa.LAUNCHES == before          # CPU tensors never count a launch
    want = _want_sdpa(*(c[n] for n in ("q", "k", "v", "table", "pos")),
                      length, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# the reference's Pallas kernels compile once per shape in interpret mode
# (about a second each), so they see a covering subset of the grid above
@pytest.mark.parametrize("length,groups,window", [
    (16, 1, None), (17, 2, 12), (23, 4, None), (17, 4, 12), (23, 1, 12)])
def test_plain_matches_reference_kernel(length, groups, window):
    c = _case(4, 8, 2 * groups, 2, 16, length, seed=length * groups)
    t, j = _t(c), _j(c)
    got = pa.paged_attention(t["q"], t["k"], t["v"], t["table"], t["pos"],
                             length=length, sliding_window=window)
    want = jpa.paged_attention(j["q"], j["k"], j["v"], j["table"], j["pos"],
                               length=length, sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length,groups,window", [
    (16, 1, None), (23, 2, 12), (17, 4, None)])
def test_quant_plain_matches_reference_kernel(length, groups, window):
    c = _case(4, 8, 2 * groups, 2, 16, length, quant=True, seed=groups)
    t, j = _t(c), _j(c)
    got = pa.paged_attention_quant(t["q"], t["k"], t["ks"], t["v"], t["vs"],
                                   t["table"], t["pos"], length=length,
                                   sliding_window=window)
    want = jpa.paged_attention_quant(j["q"], j["k"], j["ks"], j["v"], j["vs"],
                                     j["table"], j["pos"], length=length,
                                     sliding_window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [8, 17])
def test_ring_and_linear_masks_admit_the_same_prefix(T):
    """The kernel takes no mask argument: over idx in [0, T) the ring mask
    (last min(pos + 1, T) writes) and the linear mask (idx <= pos) admit
    the same positions, [0, min(pos, T - 1)], for every pos."""
    pos = torch.arange(0, 3 * T, dtype=torch.int32)
    ring = tattn.decode_mask(pos, T, sliding_window=T)
    linear = tattn.decode_mask(pos, T, sliding_window=None)
    assert torch.equal(ring, linear)
    n = torch.clamp(pos, max=T - 1) + 1
    assert torch.equal(linear.sum(-1), n)


def test_decode_dispatch_follows_the_cache_kind():
    c = _t(_case(4, 8, 4, 2, 16, 16, quant=True))
    f = _t(_case(4, 8, 4, 2, 16, 16))
    quant = {"k": c["k"], "v": c["v"], "k_scale": c["ks"], "v_scale": c["vs"]}
    got = ops.paged_attention_decode(c["q"], quant, c["table"], c["pos"],
                                     length=16, compute_dtype=torch.float32)
    want = pa.paged_attention_quant_plain(c["q"], c["k"], c["ks"], c["v"],
                                          c["vs"], c["table"], c["pos"],
                                          length=16)
    assert torch.equal(got, want)
    got = ops.paged_attention_decode(f["q"], {"k": f["k"], "v": f["v"]},
                                     f["table"], f["pos"], length=16)
    assert torch.equal(got, pa.paged_attention_plain(
        f["q"], f["k"], f["v"], f["table"], f["pos"], length=16))


def test_geometry_checks_match_the_reference():
    c = _t(_case(4, 8, 4, 2, 16, 16))
    with pytest.raises(ValueError, match="one query token"):
        pa.paged_attention(c["q"].expand(4, 2, 4, 16), c["k"], c["v"],
                           c["table"], c["pos"], length=16)
    with pytest.raises(ValueError, match="exceeds table capacity"):
        pa.paged_attention(c["q"], c["k"], c["v"], c["table"], c["pos"],
                           length=17)
    with pytest.raises(ValueError, match="not a multiple of KV"):
        pa.paged_attention(c["q"][:, :, :3], c["k"], c["v"], c["table"],
                           c["pos"], length=16)
    assert pa.execution_mode("cpu") == "torch-plain"
    assert pa.execution_mode("cuda") == "cuda-kernel"


def test_c_entry_points_exist_in_the_source():
    """Every entry point ``build.SIGNATURES`` binds is defined in its
    source, with as many parameters as its argtypes."""
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, (name, fn)
            assert len(m.group(1).split(",")) == len(argtypes), fn
    assert Path(build.CSRC / "paged_attention.cu").exists()


# ---------------------------------------------------------------------------
# paged-KV addressing: gather, and the in-place scatters' drop semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [16, 17, 23])
def test_gather_pages_matches_reference(length):
    c = _case(4, 8, 4, 2, 16, length)
    got = tpaging.gather_pages(torch.from_numpy(c["k"]),
                               torch.from_numpy(c["table"]), length)
    want = jpaging.gather_pages(jnp.asarray(c["k"]), jnp.asarray(c["table"]),
                                length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("live", [None, [True, False, True, True],
                                  [False, False, False, False]])
def test_scatter_rows_in_place_matches_reference(live):
    """Dead rows and positions past the table (pos == P * ps) drop; the
    write lands in the pool it was given."""
    rng = np.random.RandomState(3)
    pool = rng.randn(10, 4, 2, 8).astype(np.float32)
    table = rng.permutation(10)[:8].astype(np.int32).reshape(4, 2)
    table[1] = 0                  # row 1 points at page 0, as a freed slot does
    slots = np.array([3, 5, 8, 7], np.int32)        # 8 == P * ps: dropped
    vals = rng.randn(4, 1, 2, 8).astype(np.float32)
    lv = None if live is None else np.array(live)
    want = jpaging.scatter_rows(jnp.asarray(pool), jnp.asarray(table),
                                jnp.asarray(slots), jnp.asarray(vals),
                                live=None if lv is None else jnp.asarray(lv))
    tp = torch.from_numpy(pool.copy())
    out = tpaging.scatter_rows(tp, torch.from_numpy(table),
                               torch.from_numpy(slots), torch.from_numpy(vals),
                               live=None if lv is None else torch.from_numpy(lv))
    assert out is tp
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))


def test_scatter_chunk_in_place_matches_reference():
    rng = np.random.RandomState(4)
    pool = rng.randn(12, 4, 2, 8).astype(np.float32)
    table = rng.permutation(12)[:9].astype(np.int32).reshape(3, 3)
    slots = np.array([[0, 1, 2, 3, 4], [6, 7, 8, 9, 10], [9, 10, 11, 12, 13]],
                     np.int32)
    valid = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], bool)
    vals = rng.randn(3, 5, 2, 8).astype(np.float32)
    want = jpaging.scatter_chunk(jnp.asarray(pool), jnp.asarray(table),
                                 jnp.asarray(slots), jnp.asarray(valid),
                                 jnp.asarray(vals))
    tp = torch.from_numpy(pool.copy())
    tpaging.scatter_chunk(tp, torch.from_numpy(table), torch.from_numpy(slots),
                          torch.from_numpy(valid), torch.from_numpy(vals))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))


def test_masked_write_duplicate_targets_carry_one_value():
    """A dropped entry aimed at a kept entry's row must not clobber it."""
    rows = torch.zeros(4, 3)
    idx = torch.tensor([2, 2, 1, 2])
    vals = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    keep = torch.tensor([False, True, False, False])
    tpaging.masked_write(rows, idx, vals, keep)
    assert torch.equal(rows[2], vals[1])
    assert torch.equal(rows[[0, 1, 3]], torch.zeros(3, 3))


def test_paged_layout_geometry_matches_reference():
    for args in [(16, 512, 256), (8, 23, 5, 8, 2), (17, 40, 9)]:
        a, b = tpaging.PagedLayout(*args), jpaging.PagedLayout(*args)
        assert (a.pages_per_slot, a.pages_per_slot_swa) == \
            (b.pages_per_slot, b.pages_per_slot_swa)
        assert [a.pages_for(n) for n in (1, 16, 17, 600)] == \
            [b.pages_for(n) for n in (1, 16, 17, 600)]
    with pytest.raises(ValueError):
        tpaging.PagedLayout(0, 16, 4)
