"""Times the port's paged-attention decode wrappers on the card.

For two shapes of the ``deepseek-7b`` serving read (KV = H = 32, head dim
128, T 512, page size 16), those ``chip_smoke.py`` times:

- ``serving``: 8 live slots with positions spread over 128-160, as the
  full-width serving run decodes them;
- ``one_slot``: 1 live slot at position 511, the whole cache admitted;

and, on request (``--shapes``), ``pos0`` (8 slots at position 0: one row
each, so the time is the launches' and the blocks' own) and ``full`` (8
slots at position 511).  It calls ``paged_attention`` (float32 pools) and
``paged_attention_quant`` (int8 pools, bfloat16 q and output) of
``repro_torch.kernels.paged_attention`` in the tree at ``--src``, and
reports in ms per call:

- ``device``: CUDA events around 10 calls queued behind a sleep kernel, so
  the time is the device's alone; median of 21 runs;
- ``host_included``: CUDA events around 10 back-to-back calls with nothing
  queued before them, so the time is the larger of the host's and the
  device's per call; median of 21 runs;
- ``host_enqueue``: the host's clock around 200 back-to-back calls, before
  the device is synchronised: the wrapper's own cost (checks, plan,
  allocation, the ``ctypes`` call, the launches) where the device keeps
  up; median of 21 runs.

The timers are ``cuda_timing.py``'s; the operands (``paged_case``) and the
bound (``paged_bound``) are ``chip_smoke.py``'s.  Calls cycle through 4
page tables over disjoint pages of one pool, so each finds its rows cold in
the 50 MB L2 cache, as each of the 30 layers' reads does on the serving
path.  Beside each time: the bound, the share of it reached, and the tree's
plan (splits, chunk, the tile ring's depth) where it has one.

``--splits 1,2,4`` also times each shape with the split count forced to
each value (the chunk rounded up to whole tiles), to check the plan: a
forced run sets up a copy of the wrapper's ``Plan`` with those splits and
calls the C entry point itself, so the wrapper's plan and counters stay as
they are.

Give ``--src`` the ``src`` directory of another checkout to time its
wrappers with this script; run two trees in one call, alternating
(A B B A, at least three processes a side), to compare them on one card,
then ``--summarize`` the JSON lines they printed.  Needs one CUDA card and
``nvcc`` (the kernels build into the tree's ``build/kernels/`` at first
use)::

    python3 scripts/paged_attention_times.py --label change
    python3 scripts/paged_attention_times.py --src /path/to/parent/src --label parent
    python3 scripts/paged_attention_times.py --shapes serving,one_slot,pos0,full \\
        --splits 1,2,4,8,16 --label sweep
    python3 scripts/paged_attention_times.py --summarize runs.txt

Prints the card's name and power limit, one line per time, then one JSON
line.  ``--summarize`` reads those JSON lines from files and prints, per
tree, kernel and shape, the median of each time over the processes and
their range.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import sys
from pathlib import Path

import numpy as np

from cuda_timing import card_line, cuda_ms, enqueue_ms
from chip_smoke import MAIN_PAGED, PAGED_TIME_POS, paged_bound, paged_case

SETS = 4
SHAPES = dict(PAGED_TIME_POS, pos0=np.zeros(8, np.int32),
              full=np.full(8, 511, np.int32))
TIMES = ("device_ms", "host_included_ms", "host_enqueue_ms")


def forced_call(pa, plan0, splits, quant, operands, out_shape, out_dtype,
                codes):
    """A call of the C entry point over ``operands`` (the tensors whose
    pointers lead its arguments; the page table second from last) with
    ``plan0``'s shapes but ``splits`` splits, the chunk rounded up to whole
    tiles.  Set up once here; returns (fn(table), splits, chunk, stages)."""
    import torch
    from repro_torch.kernels import build
    lib = build.load("paged_attention")
    plan = pa.Plan.from_buffer_copy(plan0)
    T = plan.T
    plan.chunk = -(-(-(-T // splits)) // pa.TILE_ROWS) * pa.TILE_ROWS
    plan.splits = -(-T // plan.chunk)
    dev = operands[0].device
    smem = lib.paged_attention_prepare(ctypes.addressof(plan),
                                       operands[1].element_size(), int(quant),
                                       dev.index)
    if smem < 0:
        raise RuntimeError(f"set-up of {plan.splits} splits refused: "
                           f"cudaError {-smem}")
    entry = lib.paged_attention_int8 if quant else lib.paged_attention_float
    part_numel = (plan.B * plan.KV * plan.G * plan.splits * (plan.hd + 2)
                  if plan.splits > 1 else 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fn(table):
        out = torch.empty(out_shape, dtype=out_dtype, device=dev)
        part = (torch.empty(part_numel, dtype=torch.float32, device=dev)
                if part_numel else None)
        ops = (*operands[:-2], table, operands[-1])
        err = entry(*(t.data_ptr() for t in ops),
                    None if part is None else part.data_ptr(), out.data_ptr(),
                    ctypes.addressof(plan), *codes, dev.index, stream)
        if err:
            raise RuntimeError(f"forced launch failed: cudaError {err}")
        return out
    return fn, plan.splits, plan.chunk, plan.stages


def summarize(paths) -> int:
    runs = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            for r in rec["rows"]:
                if r["forced"]:
                    continue
                key = (rec["label"], r["kernel"], r["shape"])
                runs.setdefault(key, []).append((rec["card"], r))
    for (label, kernel, shape), rs in sorted(runs.items()):
        cards = sorted({c for c, _ in rs})
        parts = []
        for t in TIMES:
            vals = [r[t] for _, r in rs]
            parts.append(f"{t[:-3]} {statistics.median(vals):.4f} "
                         f"[{min(vals):.4f}-{max(vals):.4f}]")
        r0 = rs[0][1]
        print(f"[{'; '.join(cards)}] {label} {kernel} {shape}: "
              f"{len(rs)} processes, ms median [range]: {', '.join(parts)}; "
              f"bound {r0['bound_ms']:.5f}, splits {r0['splits']}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for the tree timed")
    ap.add_argument("--shapes", default="serving,one_slot",
                    help=f"comma-separated, of {', '.join(SHAPES)}")
    ap.add_argument("--splits", default="",
                    help="comma-separated split counts to force besides the "
                         "tree's own plan (trees with a Plan only)")
    ap.add_argument("--summarize", nargs="+", metavar="FILE",
                    help="print medians over the JSON lines in these files")
    args = ap.parse_args()
    if args.summarize:
        return summarize(args.summarize)
    forced = [int(x) for x in args.splits.split(",") if x]
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("paged_attention_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import paged_attention as pa

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(5)
    geo = {k: v for k, v in MAIN_PAGED.items() if k != "B"}
    T, H, KV, hd = (geo[k] for k in ("length", "H", "KV", "hd"))
    planned = hasattr(pa, "launch_plan")
    rows_out = []
    for shape in args.shapes.split(","):
        pos = SHAPES[shape]
        B = len(pos)
        rows = int(sum(min(int(p), T - 1) + 1 for p in pos))
        for name, quant, dtype in (("paged_attention", False, torch.float32),
                                   ("paged_attention_quant", True, torch.bfloat16)):
            case = paged_case(rng, dev, quant=quant, pos=pos, sets=SETS, B=B,
                              **geo)
            q, tabs, p, k, v = (case[n] for n in ("q", "tables", "pos", "k", "v"))
            q = q.to(dtype)
            nxt = itertools.cycle(range(SETS)).__next__
            if quant:
                ks, vs = case["ks"], case["vs"]
                operands = (q, k, ks, v, vs, tabs[0], p)
                codes = (pa._DTYPE_CODE[dtype], pa._DTYPE_CODE[dtype])

                def fn():
                    return pa.paged_attention_quant(q, k, ks, v, vs, tabs[nxt()],
                                                    p, length=T)
            else:
                operands = (q, k, v, tabs[0], p)
                codes = (pa._DTYPE_CODE[dtype],)

                def fn():
                    return pa.paged_attention(q, k, v, tabs[nxt()], p, length=T)
            bound = paged_bound(rows, B, H, KV, hd, kv_bytes=k.element_size(),
                                q_bytes=q.element_size(), quant=quant)["bound_ms"]
            runs = [(False, fn, None)]
            if planned:
                fn()
                _, _, plan0 = pa.launch_plan(0, quant, q.shape, k.shape,
                                             tabs[0].shape, p.shape,
                                             k.element_size(), T)
                runs[0] = (False, fn, (plan0.splits, plan0.chunk,
                                       getattr(plan0, "stages", None)))
                for S in forced:
                    call, *plan = forced_call(pa, plan0, S, quant, operands,
                                              (B, 1, H * hd), dtype, codes)
                    runs.append((True, lambda c=call: c(tabs[nxt()]), plan))
            for is_forced, run_fn, plan in runs:
                device = cuda_ms(run_fn)
                host = cuda_ms(run_fn, hide_host=False)
                enqueue = enqueue_ms(run_fn)
                splits, chunk, stages = plan or (None, None, None)
                rows_out.append({
                    "kernel": name, "shape": shape, "B": B, "pos": pos.tolist(),
                    "dtype": str(dtype), "admitted_rows": rows,
                    "forced": is_forced, "splits": splits, "chunk": chunk,
                    "stages": stages, "device_ms": device,
                    "host_included_ms": host, "host_enqueue_ms": enqueue,
                    "bound_ms": bound, "share_of_bound": bound / device})
                print(f"[{card}] {args.label} {name} {shape} (B {B}): device "
                      f"{device:.4f} ms, host included {host:.4f} ms, host "
                      f"enqueue {enqueue:.4f} ms, bound {bound:.5f} ms "
                      f"({bound / device:.1%}), splits {splits} chunk {chunk} "
                      f"stages {stages}{' (forced)' if is_forced else ''}",
                      flush=True)
            del case, fn, runs, operands
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "src": args.src, "card": card,
                      "rows": rows_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
