"""Times the port's circconv wrappers as a caller sees them, host included.

For each shape (G, R, D) it calls ``bind_superpose_kernel`` and
``unbind_kernel`` of ``repro_torch.kernels.circconv`` on float32 CUDA
tensors, whichever kernel the tree at ``--src`` routes them to, and reports
in ms per call:

- ``host_included``: CUDA events around 10 back-to-back calls with nothing
  queued before them, so the time is the larger of the host's and the
  device's per call; median of 21 runs;
- ``host_enqueue``: the host's clock around 200 back-to-back calls, before
  the device is synchronised: the wrapper's own cost (checks, the ``ctypes``
  call, the launch, the output's allocation) where the device keeps up;
  median of 21 runs;
- ``device``: CUDA events around 10 calls queued behind a sleep kernel, so
  the time is the device's alone; median of 21 runs.

The timers are ``cuda_timing.py``'s, shared with the other scripts here.

Give ``--src`` the ``src`` directory of another checkout to time its
wrappers with this script; run two trees in one call, alternating
(A B B A), to compare them on one card.  Needs one CUDA card and ``nvcc``
(the kernels build into the tree's ``build/kernels/`` at first use)::

    python3 scripts/circconv_host_times.py --label change
    python3 scripts/circconv_host_times.py --src /path/to/parent/src --label parent

Prints the card's name and power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from cuda_timing import card_line, cuda_ms, enqueue_ms

SHAPES = ((2, 4, 4096), (16, 4, 2048), (16, 4, 4096), (128, 4, 4096))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for the tree timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("circconv_host_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import circconv

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for G, R, D in SHAPES:
        K = torch.randn((R, D), generator=gen) / math.sqrt(D)
        kext = torch.cat([K, K], dim=1).to(dev)
        Z = torch.randn((G, R, D), generator=gen).to(dev)
        S = torch.randn((G, D), generator=gen).to(dev)
        route = circconv.route(D) if hasattr(circconv, "route") else "direct"
        for name, fn in (("bind_superpose",
                          lambda: circconv.bind_superpose_kernel(Z, kext)),
                         ("unbind", lambda: circconv.unbind_kernel(S, kext))):
            rows.append({"kernel": name, "shape": [G, R, D], "route": route,
                         "host_included_ms": cuda_ms(fn, hide_host=False),
                         "host_enqueue_ms": enqueue_ms(fn),
                         "device_ms": cuda_ms(fn)})
    print(json.dumps({"label": args.label, "src": args.src, "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
