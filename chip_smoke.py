#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), builds the hand-written kernels from ``src/`` (one
   ``nvcc`` per source, all started together) and prints the build time.
2. Kernels against their plain versions on the card (run on float64
   copies of the same values):
   Float32 is held elementwise to 1e-5 (plus 1e-5 of the value);
   bfloat16, which the kernels round once on output, to 1e-2 of the
   compared values' max|want| and 5e-3 in relative L2.
   - bind and unbind in float32 and bfloat16, through the kernel that
     ``circconv.route(D)`` picks (the one-pass FFT-form kernels for every D
     = 2^a 3^b 5^c with a >= 2 in [4, 16384], mixed radix where D is not a
     power of two; the four-step ones for such a D past it up to 2^22; the
     direct ones for every other D; each call's route is checked on
     ``ROUTE_LAUNCHES``): the reference's test shapes, the main-path shapes,
     ragged D, and the FFT kernels' edges (R 1, 5, 8, 9, 16; G 1, 2, 128; D
     4 to 32, the route's upper limit 16384, and 28672 = 2^12 7, which goes
     direct), every (G, R) the control plane's (R_fwd, R_bwd) programs
     launch (phase 5) at D 2048 and 4096, the mixed-radix one-pass kernels
     at the serving widths 5120 and 12288 (G 2 a decode step, 128 a prefill
     chunk) and their edges (D 12, 160, 960, 15360, 16200), the four-step
     kernels at (1, 1, 32768), (2, 4, 65536), (1, 2, 20480), (2, 4, 61440)
     and (3, 5, 40960), at their edges (1, 9, 262144) (more keys than a
     pass B chunk holds) and (2, 3, 18000) (a divisor split, 4-column
     tiles), and at the LM training shapes (4, 4, D) for D = 128 d_model =
     524288, 655360 and 1572864 (deepseek-7b, qwen2.5-32b,
     mistral-large-123b); at the edges, the LM shapes and (128, 4, 12288)
     against a float64 torch.fft oracle made in the phase (the O(D^2)
     plain version would gather terabytes), with the adjoint identity
     <bind(Z), S> = <Z, unbind(S)> to float32 rounding; the direct kernels
     called explicitly at the main-path shapes; two runs of each FFT and
     four-step kernel bitwise equal; the autograd Functions' gradients
     against autograd of the plain version (1e-4); zero key gradient;
   - the two paged-attention decode kernels in float32, bfloat16 and over
     int8 pools (in float32 and in bfloat16 compute): the geometry of
     tests/test_paged_kernel.py (shuffled
     tables, spare pages, staggered positions, a dead slot, lengths 16, 17
     and 23 at page size 8), the serving run's shape (B 8, T 512, page
     size 16, 32 kv heads, head dim 128), GQA groups 4 and 16, the
     ring mask with wrapped positions, and the split-K edges (one admitted
     row, a prefix of one chunk of the plan and of one chunk + 1, slots
     whose later chunks are empty, T 4096, chunks over which the tile ring
     wraps, a batch that the plan gives one split, the ring at T 256, one
     live slot at position 511, rows of 512 whose float32 tile ring is cut
     to fit the shared memory), each with the plan's split count checked;
     two calls bitwise equal at the serving shape and at one edge.
3. The training path, with TF32 off for matmuls and cuDNN convolutions:
   the paper's VGG-16/CIFAR-10 split train step at B=64 through
   ``c3sl:R=4,backend=pallas`` with Adam at 1e-4 on the synthetic images.
   Step 0's loss and gradients must match ``backend=direct`` on the same
   weights; then 20 steps with a finite loss and exactly 2 bind and 2
   unbind launches per step, every one on the FFT route; then 3 steps
   through ``|int8`` and 3 steps of ResNet-50/CIFAR-100 (D=4096), counted
   the same way.
4. The serving path: ``deepseek-7b`` at full width and depth (30 layers,
   d_model 4096, 32 heads of 128; random float32 weights from the seed)
   behind ``BatchedEngine(kv_layout="paged", kv_read="kernel")`` with the
   codec ``c3sl:R=4,backend=pallas`` at the superblock midpoint: 8 slots,
   max_len 512, page size 16, chunk 64, windows of 8, greedy; 16 requests
   of 128 prompt tokens and 32 new ones.
   - Teacher-forced parity: three decode steps through the kernel read
     against the gather read on copies of one prefilled cache; logits
     within 1e-3 of max|logit|.
   - The engine run: every request completes, every logit is finite, the
     execution mode is ``cuda-kernel``, the paged kernel launches exactly
     30 times per decode step, and bind and unbind each launch once per
     decode step and once per prefill chunk, on the FFT route.
   - A gather-read run of the same requests: the share of generated tokens
     on which the two agree (not gated: an argmax may flip within the
     tolerance).
   - Then bfloat16 weights with an int8 KV cache (8 requests, 16 new
     tokens), which drives ``paged_attention_quant``, checked the same way.
5. The codec control plane, at full width, through the circconv kernels:
   - step-0 parity of one asymmetric pair (R_fwd 4, R_bwd 2) on the VGG-16
     step through the kernels against ``backend=fft`` on the card (loss,
     every gradient leaf, the gradient at the cut, both SNRs);
   - the Adaptive-R link ``CP_LINK`` (``adaptive:c3sl:R=16,min_R=2 >>
     bwd:adaptive:c3sl:R=4,min_R=1``, both ``backend=pallas``) on the
     VGG-16 step (B 64, Adam 1e-4), clamped to the batch: one train step
     per (R_fwd, R_bwd) pair made by ``build_link_program_table`` (4 x 3 =
     12, ``make`` counted), every pair once pinned, then 12 free steps fed
     the cut SNR and the probe's gradient SNR (one host transfer a step),
     then 8 steps with a 10% packet drop on both directions and erasure
     recovery (masks from ``next_erasure``), plus one burst a direction
     that drops a whole payload: the forward one is retransmitted, the
     backward one (no resend allowed) raises ChannelErasure, at the steps
     the schedule predicts and as often as a host replay.  Every step: a
     finite loss, wire bytes equal to ``split_comm_bytes`` of the served
     pair; over the phase: 3 bind and 3 unbind launches a step, all on the
     FFT route, counted by (G, R) as the served pairs imply, ``make`` never
     called again;
   - the masked decode at an all-ones mask bitwise the decode, through the
     kernels, at every bucket;
   - Table 2 on the card at both paper cuts (B 64): ``bnpp:R=4`` against
     ``c3sl:R=4,backend=pallas``, the codec's parameter bytes on the card
     and its device time for encode + decode and their backward, beside
     the analytic param_count and flops ratios; 3 ResNet-50 steps through
     ``bnpp:R=4`` with finite losses and nonzero codec gradients.
6. Times (CUDA events around runs of back-to-back calls, the median of at
   least 20 runs after warm-up).  Every kernel, plain version and library
   call is enqueued behind a sleep kernel, so its time is the device's
   alone (each kernel's host-inclusive time is kept beside it): bind and
   unbind at the training shapes (16, 4, 2048) and (16, 4, 4096), the
   serving shapes (2, 4, 4096) and (128, 4, 4096), the mixed-radix serving
   shapes (2, 4, 5120), (128, 4, 5120), (2, 4, 12288) and (128, 4, 12288)
   and the ``BENCH_roofline.json`` circconv shapes (B 64, R 4, D 256 and
   1024), each through the FFT kernel, the direct kernel, its plain version
   (fewer runs where one call takes milliseconds) and the torch.fft route
   of the same function (the library yardstick); each paged
   kernel at the serving shape with positions 128-160 and with one live
   slot at position 511 (with the wrapper's split plan, the share of the
   bound and the host-included time), its plain version and, for the
   float kernel, gather_pages followed by
   ``scaled_dot_product_attention``.  The four-step kernels at the LM
   training shapes (4, 4, D), D = 524288, 655360 and 1572864: the kernel,
   the torch.fft route, the bound, the build of the keys' spectra (once per
   key tensor), and the direct kernel, which took every D but the first
   before, one call a side; their plain version at (2, 4, 65536) (three
   single calls, host included).  Host
   included: the VGG-16 train step
   with the kernel and the fft backend in turns, and a ``torch.profiler``
   breakdown of it; the serving engine's decode-step time, tokens/s and
   mean TTFT, and a profile of one decode window.
7. The LM training path, after the rest and ``free_cuda()``: ``deepseek-7b``
   at full width (d_model 4096, 32 heads of 128, d_ff 11008, vocab
   102400), its depth cut to 8 layers (2.458 B parameters; float32 params,
   gradients and two AdamW moments take 39.3 GB, 110.6 GB at the full 30),
   float32 with TF32 off, B 16, S 128, ``c3sl:R=4,backend=pallas`` at the
   superblock midpoint (after layer 4; D = 524288, G = 4), AdamW at 1e-3
   with the global-norm clip at 1.0: ``launch.train.run_standard`` on a
   config of ``dataclasses.replace(get_config("deepseek-7b"),
   num_layers=8)``, from the CLI's own parser.
   - Step-0 parity: the loss (1e-6 relative) and every gradient leaf
     (1e-4 of its max) through the kernels against ``backend=fft`` on the
     same weights and batch; the cut SNR.
   - 3 steps: finite losses, exactly 2 bind and 2 unbind launches a step,
     all on the four-step route and all at (4, 4, 524288); the wire bytes
     a direction a step exactly 4 * 524288 * 4 = 8,388,608.
   - The checkpoint ``--ckpt-dir`` wrote under ``chiprun_out/`` restored
     bitwise, then deleted (9.8 GB).
   - The step time (CUDA events around single steps, the median of 3,
     host included) and a ``torch.profiler`` breakdown of 2 steps: device
     time, idle share, the codec's share.
8. The LM training path at a width that is not a power of two, after
   ``free_cuda()``: ``qwen2.5-32b`` at full width (d_model 5120, 40 heads
   and 8 KV heads of 128, d_ff 27648, vocab 152064, QKV bias), its depth
   cut to 4 layers (3.51 B parameters; float32 params, gradients and two
   AdamW moments take 56.1 GB, 16 bytes a parameter, 263 GB at the full
   64), otherwise as phase 7: the codec after layer 2 at D = 128 * 5120 =
   655360, G = 4, on the mixed-radix four-step kernels (1280 x 512).
   Step-0 parity against ``backend=fft`` at phase 7's tolerances; 3 steps
   with finite losses, exactly 2 + 2 launches a step, all on ``"fft4"`` at
   (4, 4, 655360) and none direct; 4 * 655360 * 4 = 10,485,760 wire bytes a
   direction a step; the step time and profile.  No checkpoint (phase 7
   covers it).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
F32_PEAK_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

SEED = 0
MAIN_STEPS = 20
SHORT_STEPS = 3
# the reference's kernel test shapes (tests/test_kernels.py), the main-path
# shapes (G = B/R = 16, R = 4, D = 2048 VGG-16 / 4096 ResNet-50), ragged D
KERNEL_SHAPES = [(1, 1, 64), (2, 2, 128), (4, 4, 128), (8, 2, 256), (3, 5, 96),
                 (16, 16, 128), (2, 8, 512), (16, 4, 2048), (16, 4, 4096),
                 (4, 3, 127), (2, 2, 4097)]
# the FFT kernels' edges: R 1, 5, 8, 9, 16 (bind's cluster is min(R, 8)
# blocks, block 0 then takes two keys); G 1, 2 (decode), 128 (prefill
# chunk); D from 4, the route's upper limit 16384, and a D past it that is
# not a power of two (direct)
FFT_EDGE_SHAPES = [(2, 1, 2048), (2, 5, 2048), (2, 8, 2048), (2, 9, 2048),
                   (2, 16, 4096), (1, 4, 4096), (2, 4, 4096), (128, 4, 4096),
                   (3, 2, 4), (2, 3, 8), (2, 2, 16), (3, 2, 32), (1, 3, 16384),
                   (1, 1, 28672)]
# the mixed-radix one-pass kernels (D = 2^a 3^b 5^c, not a power of two):
# the serving widths of qwen2.5-32b / pixtral-12b (5120 = 2^10 5) and
# mistral-large-123b (12288 = 2^12 3) at a decode step (G 2) and a 64-token
# prefill chunk at 8 slots (G 128), and edges: D 12 and 160 (D/4 not a
# multiple of 32), two odd radices (960, 15360), the largest odd part
# (16200 = 8 3^4 5^2) and R 9
MIXED_SERVE_SHAPES = [(2, 4, 5120), (128, 4, 5120), (2, 4, 12288), (128, 4, 12288)]
MIXED_SHAPES = MIXED_SERVE_SHAPES + [(2, 3, 12), (3, 2, 160), (2, 9, 960),
                                     (1, 3, 15360), (1, 2, 16200)]
# the four-step kernels (D past 16384): against the plain version (its
# gather in chunks there) at five shapes, three of them mixed radix, and at
# the LM training paths' shapes (G = B/R = 4, R 4, D = S * d_model at S 128:
# deepseek-7b, qwen2.5-32b, mistral-large-123b), where the O(D^2) plain
# version would gather terabytes, against a float64 torch.fft oracle
# computed in the phase (never on the path), as at (128, 4, 12288)
FFT4_SHAPES = [(1, 1, 32768), (2, 4, 65536), (1, 2, 20480), (2, 4, 61440),
               (3, 5, 40960)]
# the four-step kernels' other branches, against the oracle: R 9 past the
# 8 keys a pass B chunk holds at 262144 = 512 x 512, and 18000 = 180 x 100,
# a divisor split with 4-column tiles
FFT4_EDGE_SHAPES = [(1, 9, 262144), (2, 3, 18000)]
LM_SHAPES = [(4, 4, 524288), (4, 4, 655360), (4, 4, 1572864)]
LM_SHAPE = LM_SHAPES[0]
ORACLE_SHAPES = LM_SHAPES + FFT4_EDGE_SHAPES + [(128, 4, 12288)]
# the direct kernels, called explicitly at the main-path shapes
DIRECT_SHAPES = [(16, 4, 2048), (16, 4, 4096)]
# phase 6: training, serving (decode, prefill chunk) and BENCH_roofline.json
# circconv shapes (B 64 = G 16 x R 4; its D = 4096 is the training one)
TIME_SHAPES = [(16, 4, 2048), (16, 4, 4096), (2, 4, 4096), (128, 4, 4096),
               (16, 4, 256), (16, 4, 1024)] + MIXED_SERVE_SHAPES
TOL = {"float32": 1e-5}
# bfloat16 outputs are rounded once, by half an ulp (at most 2^-8 of the
# element, 2^-8/sqrt(3) in RMS), so their limits scale with the compared
# values: max|err| over max|want|, and the relative L2 error
BF16_REL_MAX, BF16_REL_L2 = 1e-2, 5e-3

# the serving path: deepseek-7b at full width, its decode read (B 8 slots,
# T 512, page size 16, KV = H = 32, head dim 128) and the engine settings
SERVE_ARCH = "deepseek-7b"
SERVE_CODEC = "c3sl:R=4,backend=pallas"
SERVE_ENGINE = dict(num_slots=8, max_len=512, page_size=16, chunk_size=64,
                    sync_every=8, greedy=True, kv_layout="paged")
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 16, 128, 32
QUANT_REQUESTS, QUANT_NEW = 8, 16
MAIN_PAGED = dict(B=8, ps=16, H=32, KV=32, hd=128, length=512)
LOGIT_TOL = 1e-3            # teacher-forced kernel vs gather, of max|logit|
SLEEP_CYCLES = 10_000_000   # about 5 ms: the host enqueues the timed calls

# phase 5, the codec control plane: the Adaptive-R asymmetric link on the
# VGG-16 step (B 64, D 2048).  Targets: the forward controller aims at a
# cut SNR of -6 dB and the backward one at a gradient SNR of -5 dB (each
# with the 1 dB deadband and an EMA of 0.5), between the levels the buckets
# give at step 0 (cut: R 2, 4, 8, 16 at about -2, -5, -8, -19 dB;
# gradient: R 1, 2, 4 at about -2, -4, -7 dB), so both walk their ladders.
CP_LINK = ("adaptive:c3sl:R=16,min_R=2,target_snr=-6.0,ema=0.5,backend=pallas"
           " >> bwd:adaptive:c3sl:R=4,min_R=1,target_snr=-5.0,ema=0.5,"
           "backend=pallas")
CP_FREE_STEPS = 12
CP_FAULT_STEPS = 8
CP_FAULT_RATES = {"drop": 0.1}
# on top of the rate, one scheduled burst per direction drops the whole
# first transmission of that step's payload; the forward channel may resend
# once (so its burst is retransmitted), the backward one not at all (so its
# burst exceeds the budget and raises ChannelErasure)
CP_FAULT_BURSTS = {"fwd": 2, "bwd": 5}
CP_FAULT_BUDGET = {"fwd": 1, "bwd": 0}
CP_PARITY_PAIR = (4, 2)          # (R_fwd, R_bwd) of the step-0 parity
CP_BNPP_STEPS = 3

# phase 7, the LM training path: deepseek-7b at full width, depth cut so
# that float32 params, gradients and two AdamW moments (39.3 GB at 8
# layers, 110.6 GB at the full 30) fit the card; the codec at the
# superblock midpoint (after layer 4), D = S * d_model = 524288, G = 4
LM_ARCH = "deepseek-7b"
LM_LAYERS = 8
LM_BATCH, LM_SEQ = 16, 128
LM_CODEC = "c3sl:R=4,backend=pallas"
LM_STEPS = 3
LM_TIMED_STEPS = 3
LM_PROFILED_STEPS = 2
LM_WIRE_BYTES = 4 * 524288 * 4   # G rows of D float32, a direction a step

# phase 8, the LM training path at a width that is not a power of two:
# qwen2.5-32b at full width, depth cut so that float32 params, gradients
# and two AdamW moments (56.1 GB at 4 layers, 263 GB at the full 64) fit
# the card; the codec after layer 2, D = 128 * 5120 = 655360, G = 4, on the
# mixed-radix four-step kernels
QWEN_ARCH = "qwen2.5-32b"
QWEN_LAYERS = 4
QWEN_SHAPE = (4, 4, 655360)
QWEN_WIRE_BYTES = 4 * 655360 * 4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, warmup=5, calls=10, reps=21, hide_host=True) -> float:
    """Time of one call of ``fn``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs after
    ``warmup`` calls.  With ``hide_host`` (every kernel, plain version and
    library call) a sleep kernel is enqueued first, so the calls are queued
    while the device waits and the events time the device's work alone, not
    the wrappers' host time (checks, ctypes); a run whose sleep ended before
    the calls were all queued is dropped and the sleep doubled.  Without it
    (the whole train step) the time is what a caller sees, host included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if hide_host and start.query():
            end.synchronize()
            cycles *= 2
            check(cycles <= 64 * SLEEP_CYCLES,
                  "cuda_ms: the host could not queue the calls within the sleep")
            continue
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cuda_ms_scaled(fn, hide_host=True) -> float:
    """``cuda_ms`` for a call that may take milliseconds (a plain version or
    a direct kernel at a large shape): one call is timed first, host
    included, and a call over 2 ms is timed as the median of 3 single calls
    after one warm-up, host included (no sleep could hide the host there,
    and its share is small)."""
    if cuda_ms(fn, warmup=1, calls=1, reps=1, hide_host=False) > 2.0:
        return cuda_ms(fn, warmup=0, calls=1, reps=3, hide_host=False)
    return cuda_ms(fn, hide_host=hide_host)


def close(got, want, tol) -> tuple[bool, float]:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all())
    return ok, float(err.max())


BF16_READINGS: dict = {}   # kernel -> worst (max|err|/max|want|, rel L2)
ADJOINT_GAPS: dict = {}    # "GxRxD" -> |<bind(Z), S> - <Z, unbind(S)>| / norms


def close_as(got, want, dtype_name, kernel) -> tuple[bool, float]:
    """float32 elementwise within TOL; bfloat16 within BF16_REL_MAX of
    max|want| and BF16_REL_L2 in relative L2, whose readings are kept in
    BF16_READINGS.  Returns (ok, max|err|)."""
    if dtype_name != "bfloat16":
        return close(got, want, TOL[dtype_name])
    got, want = got.double(), want.double()
    err = (got - want).abs()
    rel_max = float(err.max() / want.abs().max())
    rel_l2 = float(err.norm() / want.norm())
    old = BF16_READINGS.get(kernel, (0.0, 0.0))
    BF16_READINGS[kernel] = (max(old[0], rel_max), max(old[1], rel_l2))
    return rel_max <= BF16_REL_MAX and rel_l2 <= BF16_REL_L2, float(err.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def fft_oracle(name, x, kext):
    """bind or unbind in float64 through torch.fft: the check of the
    four-step kernels where the O(D^2) plain version is out of reach."""
    import torch
    X = torch.fft.fft(x.double(), dim=-1)
    Kf = torch.fft.fft(kext[:, :x.shape[-1]].double(), dim=-1)
    if name == "bind_superpose":
        return torch.fft.ifft((X * Kf).sum(-2), dim=-1).real
    return torch.fft.ifft(X[:, None, :] * Kf.conj(), dim=-1).real


def circconv_pair(name, kernel_route, x, kext, oracle=False):
    """(kernel output, float64 plain output, or the float64 torch.fft
    oracle's with ``oracle``) of bind or unbind through the named route's
    kernel, checking that exactly that kernel launched."""
    import torch
    from repro_torch.kernels import circconv
    on, plain = {"bind_superpose": (circconv._bind_superpose_on,
                                    circconv.bind_superpose_plain),
                 "unbind": (circconv._unbind_on, circconv.unbind_plain)}[name]
    before = dict(circconv.ROUTE_LAUNCHES)
    got = on(kernel_route, x, kext)
    want = (fft_oracle(name, x, kext) if oracle
            else plain(x.double(), kext.double()))
    torch.cuda.synchronize()
    after = dict(circconv.ROUTE_LAUNCHES)
    check(all(after[k] - before[k] == (k == (name, kernel_route)) for k in after),
          f"{name} {tuple(x.shape)} via {kernel_route}: launches {before} -> {after}")
    return got, want


def _record_suffix(kernel_route: str, D: int) -> str:
    """The record's kernel of a route at D: "" the power-of-two one-pass
    kernels, "_mixed" the mixed-radix ones (circconv_fft.cu both),
    "_fft4", "_direct"."""
    if kernel_route == "fft":
        return "_mixed" if D & (D - 1) else ""
    return "_" + kernel_route


def kernel_checks(dev) -> dict:
    """Each kernel against its plain version on the same values.  The plain
    version runs on float64 copies, so the difference is the kernel's own
    rounding (float32 sums over up to R*D = 16384 terms at D = 4096)."""
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv, ops

    gen = torch.Generator().manual_seed(SEED)
    errs = {k + sfx: {} for sfx in ("", "_mixed", "_fft4", "_direct")
            for k in ("bind_superpose", "unbind")}
    routed = list(dict.fromkeys(KERNEL_SHAPES + FFT_EDGE_SHAPES + cp_kernel_shapes()
                                + MIXED_SHAPES + FFT4_SHAPES + FFT4_EDGE_SHAPES
                                + LM_SHAPES))
    # errors kept by kernel: the power-of-two one-pass kernels', the
    # mixed-radix ones', the four-step ones' and the direct ones' apart
    cases = ([(s, r, _record_suffix(r, s[-1]))
              for s in routed for r in [circconv.route(s[-1])]]
             + [(s, "direct", "_direct") for s in DIRECT_SHAPES])
    for (G, R, D), kernel_route, suffix in cases:
        K = hrr.generate_keys(gen, R, D, device=dev)
        kext = ops._kext(K)
        Z32 = torch.randn((G, R, D), generator=gen).to(dev)
        oracle = (G, R, D) in ORACLE_SHAPES
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            Z = Z32.to(dt)
            got, want = circconv_pair("bind_superpose", kernel_route, Z, kext,
                                      oracle)
            check(got.dtype == dt and got.shape == (G, D), f"bind {G,R,D} {name}: "
                  f"{got.dtype} {tuple(got.shape)}")
            ok, e = close_as(got, want, name, "bind_superpose" + suffix)
            check(ok, f"bind {kernel_route} kernel != plain at {(G, R, D)} {name}: "
                  f"max err {e}")
            errs["bind_superpose" + suffix][f"{G}x{R}x{D}/{name}"] = e
            S = want.to(dt)
            got_u, want = circconv_pair("unbind", kernel_route, S, kext, oracle)
            check(got_u.dtype == dt and got_u.shape == (G, R, D),
                  f"unbind {G,R,D} {name}")
            ok, e = close_as(got_u, want, name, "unbind" + suffix)
            check(ok, f"unbind {kernel_route} kernel != plain at {(G, R, D)} {name}: "
                  f"max err {e}")
            errs["unbind" + suffix][f"{G}x{R}x{D}/{name}"] = e
            if kernel_route in ("fft", "fft4") and name == "float32":
                again = (circconv.bind_superpose_kernel(Z, kext),
                         circconv.unbind_kernel(S, kext))
                torch.cuda.synchronize()
                check(torch.equal(again[0], got) and torch.equal(again[1], got_u),
                      f"{kernel_route} kernels not bitwise repeatable at {(G, R, D)}")
            if oracle and name == "float32":
                # the adjoint identity <bind(Z), S> = <Z, unbind(S)>, to
                # float32 rounding: each kernel's backward is the other
                lhs = (got.double() * S.double()).sum()
                rhs = (Z.double() * got_u.double()).sum()
                gap = float((lhs - rhs).abs() / (got.double().norm()
                                                 * S.double().norm()))
                check(gap <= 1e-5, f"{kernel_route} adjoint identity off by {gap} "
                      f"at {(G, R, D)}")
                ADJOINT_GAPS[f"{G}x{R}x{D}"] = gap
        del K, kext, Z32, Z, S, got, got_u, want
        free_cuda()

    # gradients: each autograd Function's backward is the other kernel,
    # against autograd of the plain version (float64)
    for G, R, D in ((16, 4, 2048), (16, 4, 4096), (3, 5, 96)):
        K = hrr.generate_keys(gen, R, D, device=dev).requires_grad_()
        k64 = ops._kext(K).double()
        Z = torch.randn((G, R, D), generator=gen).to(dev).requires_grad_()
        dS = torch.randn((G, D), generator=gen).to(dev)
        gz, gk = torch.autograd.grad((ops.bind_superpose_pallas(Z, K) * dS).sum(),
                                     [Z, K], allow_unused=True,
                                     materialize_grads=True)
        z64 = Z.detach().double().requires_grad_()
        (gz_ref,) = torch.autograd.grad(
            (circconv.bind_superpose_plain(z64, k64) * dS).sum(), [z64])
        torch.cuda.synchronize()
        ok, e = close(gz, gz_ref, 1e-4)
        check(ok, f"bind grad != autograd of plain at {(G, R, D)}: {e}")
        check(bool((gk == 0).all()), "bind: keys got a gradient")
        errs["bind_superpose"][f"grad {G}x{R}x{D}"] = e
        S = torch.randn((G, D), generator=gen).to(dev).requires_grad_()
        dZ = torch.randn((G, R, D), generator=gen).to(dev)
        gs, gk = torch.autograd.grad((ops.unbind_pallas(S, K) * dZ).sum(), [S, K],
                                     allow_unused=True, materialize_grads=True)
        s64 = S.detach().double().requires_grad_()
        (gs_ref,) = torch.autograd.grad(
            (circconv.unbind_plain(s64, k64) * dZ).sum(), [s64])
        torch.cuda.synchronize()
        ok, e = close(gs, gs_ref, 1e-4)
        check(ok, f"unbind grad != autograd of plain at {(G, R, D)}: {e}")
        check(bool((gk == 0).all()), "unbind: keys got a gradient")
        errs["unbind"][f"grad {G}x{R}x{D}"] = e
    return errs


def paged_case(rng, dev, *, B, ps, H, KV, hd, length, quant=False, pos=None,
               sets=1) -> dict:
    """One paged decode read with the geometry of tests/test_paged_kernel.py:
    pools with two spare pages, shuffled tables, and (unless ``pos`` is
    given) staggered positions on both sides of the last page boundary and,
    from B = 3, a dead slot (table row 0, pos 0).  ``sets`` > 1 makes that
    many tables over disjoint pages of one pool: a timing run cycles through
    them, so each call finds its rows cold in the L2 cache, as each of the
    30 layers' reads does on the serving path."""
    import torch
    P = -(-length // ps)
    npages = sets * B * P + 2
    tables = rng.permutation(npages)[:sets * B * P].astype(np.int32)
    tables = tables.reshape(sets, B, P)
    if pos is None:
        pos = rng.randint(0, length, B)
        pos[0] = length - 1
        if B > 1:
            pos[1] = max(length - ps - 1, 0)
        if B > 2:
            tables[:, 2] = 0
            pos[2] = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    case = {"q": t(rng.randn(B, 1, H, hd).astype(np.float32)),
            "tables": [t(tb) for tb in tables],
            "pos": t(np.asarray(pos, np.int32)), "length": length}
    shape = (npages, ps, KV, hd)
    for n in "kv":
        if quant:
            case[n] = t(rng.randint(-127, 128, shape).astype(np.int8))
            case[n + "s"] = t((rng.rand(npages, ps, KV, 1) * 0.02 + 1e-3)
                              .astype(np.float32))
        else:
            case[n] = t(rng.randn(*shape).astype(np.float32))
    return case


def paged_pair(case, dtype, *, quant, window=None):
    """(kernel output, float64 plain output) on the same values.  int8
    pools take q in ``dtype`` and compute in it."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    q = case["q"].to(dtype)
    tab, pos = case["tables"][0], case["pos"]
    kw = dict(length=case["length"], sliding_window=window)
    if quant:
        got = pa.paged_attention_quant(q, case["k"], case["ks"], case["v"],
                                       case["vs"], tab, pos,
                                       compute_dtype=dtype, **kw)
        want = pa.paged_attention_quant_plain(
            q.double(), case["k"], case["ks"].double(), case["v"],
            case["vs"].double(), tab, pos, compute_dtype=torch.float64, **kw)
        return got, want
    k, v = case["k"].to(dtype), case["v"].to(dtype)
    got = pa.paged_attention(q, k, v, tab, pos, **kw)
    want = pa.paged_attention_plain(q.double(), k.double(), v.double(), tab,
                                    pos, **kw)
    return got, want


def split_edge_shapes() -> list:
    """The split-K edges of ``csrc/paged_attention.cu``, as
    (label, geometry with positions, window): one admitted row (pos 0); a
    prefix of exactly one chunk of the plan and one chunk + 1; slots whose
    later chunks are all empty; a long T (4096) with many splits; chunks of
    many tiles, so the three-tile ring wraps; a B*KV past the plan's block
    target (one split: pass 1 writes the output); the ring with wrapped
    positions; one live slot of the serving geometry at position 511;
    rows of 512 in chunks of four tiles, whose float32 ring the set-up cuts
    to one tile to fit the shared memory."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    base = dict(B=2, ps=16, H=4, KV=2, hd=128, length=512)
    _, chunk = pa.split_plan(2, 2, 2, 128, 512, 16,
                             pa.sm_count(torch.cuda.current_device()))
    return [
        ("split/n1", dict(base, pos=[0, 0]), None),
        ("split/one_chunk", dict(base, pos=[chunk - 1, chunk - 2]), None),
        ("split/chunk+1", dict(base, pos=[chunk, chunk - 1]), None),
        ("split/later_empty", dict(base, B=4, pos=[511, 3, 40, 0]), None),
        ("split/long_T", dict(B=2, ps=16, H=8, KV=4, hd=128, length=4096,
                              pos=[4095, 1000]), None),
        ("split/deep_ring", dict(MAIN_PAGED, length=2048,
                                 pos=[2047, 1500, 700, 255, 256, 257, 95, 96]),
         None),
        ("split/S1", dict(B=72, ps=16, H=32, KV=32, hd=64, length=64), None),
        ("split/ring", dict(B=4, ps=16, H=8, KV=2, hd=64, length=256,
                            pos=[255, 300, 700, 10]), 256),
        ("split/one_slot", dict(MAIN_PAGED, B=1, pos=[511]), None),
        ("split/wide_rows", dict(B=4, ps=16, H=2, KV=2, hd=512, length=4096,
                                 pos=[4095, 2000, 130, 0]), None)]


def paged_kernel_checks(dev) -> dict:
    """Both paged kernels against their plain versions (float64 copies):
    float32 and bfloat16 pools through ``paged_attention``, int8 pools in
    float32 and bfloat16 compute through ``paged_attention_quant``, at the
    reference's geometry, the serving shape, GQA groups, the ring and the
    split-K edges; at the serving shape and one split edge, two calls
    bitwise equal."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.RandomState(SEED + 4)
    shapes = [(f"ps8/T{n}", dict(B=3, ps=8, H=4, KV=2, hd=16, length=n), None)
              for n in (16, 17, 23)]
    shapes.append(("main", MAIN_PAGED, None))
    shapes += [(f"groups{g}", dict(B=4, ps=16, H=2 * g, KV=2, hd=128,
                                   length=100), None) for g in (4, 16)]
    # the ring: T = the window, positions past T have wrapped
    shapes.append(("ring", dict(B=4, ps=16, H=8, KV=4, hd=64, length=48,
                                pos=[47, 53, 146, 10]), 48))
    errs = {"paged_attention": {}, "paged_attention_quant": {}}
    repeat = ("main", "split/later_empty")
    for name, quant in (("paged_attention", False),
                        ("paged_attention_quant", True)):
        for label, geo, window in shapes + split_edge_shapes():
            B, H, hd = geo["B"], geo["H"], geo["hd"]
            case = paged_case(rng, dev, quant=quant, **geo)
            for dt_name, dt in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                got, want = paged_pair(case, dt, quant=quant, window=window)
                torch.cuda.synchronize()
                check(got.dtype == dt and tuple(got.shape) == (B, 1, H * hd),
                      f"{name} {label} {dt_name}: {got.dtype} {tuple(got.shape)}")
                ok, e = close_as(got, want, dt_name, name)
                check(ok, f"{name} kernel != plain at {label} {dt_name}: "
                      f"max err {e}")
                errs[name][f"{label}/{dt_name}"] = e
                if label in repeat:
                    again, _ = paged_pair(case, dt, quant=quant, window=window)
                    torch.cuda.synchronize()
                    check(torch.equal(again, got), f"{name} not bitwise "
                          f"repeatable at {label} {dt_name}")
            if label.startswith("split/"):
                S, _ = pa.split_plan(B, geo["KV"], H // geo["KV"], hd,
                                     geo["length"], geo["ps"],
                                     pa.sm_count(torch.cuda.current_device()))
                # S1 and deep_ring (8 x 32 blocks) fill the card in one split
                check((S == 1) == (label in ("split/S1", "split/deep_ring")),
                      f"{name} {label}: the plan gave {S} splits")
            del case
            free_cuda()
    return errs


# --------------------------------------------------------------------------
# phase 3: the training path
# --------------------------------------------------------------------------

def make_setup(model: str, spec: str, dev, net=None):
    import torch
    import torch.nn.functional as F
    from repro_torch import codecs
    from repro_torch.configs.paper import RESNET50_CIFAR100, VGG16_CIFAR10
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.models import convnets
    from repro_torch.transport.split import make_split_loss_fn

    cfg = VGG16_CIFAR10 if model == "vgg16" else RESNET50_CIFAR100
    front, back, init = {
        "vgg16": (convnets.vgg16_front, convnets.vgg16_back, convnets.init_vgg16),
        "resnet50": (convnets.resnet50_front, convnets.resnet50_back,
                     convnets.init_resnet50)}[model]
    if net is None:
        net = init(torch.Generator().manual_seed(SEED), n_classes=cfg.n_classes,
                   device=dev)
    C, H, W = cfg.cut_shape
    codec = codecs.build(spec, D=cfg.D, C=C, H=H, W=W)
    params = {"net": net, "codec": codec.init(device=dev)}
    loss = make_split_loss_fn(front, back, codec, F.cross_entropy)
    data = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED)
    return cfg, codec, params, loss, data


def leaf_rel_err(a, b) -> float:
    """Largest over leaves of max|a - b| / max|b|."""
    from repro_torch.interop import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        scale = float(y.abs().max())
        worst = max(worst, float((x - y).abs().max()) / max(scale, 1e-30))
    return worst


def step0_parity(model: str, spec: str, dev) -> dict:
    """Loss and grads through the kernel backend vs ``backend=direct`` on
    the same weights, keys and batch.  Tolerances: the two differ only in
    the codec's float32 summation order (kernel tiles vs a cuBLAS GEMM), so
    loss rtol 1e-4 and every gradient leaf within 1e-3 of its max."""
    import torch
    from repro_torch.transport.split import split_value_and_grad
    cfg, codec, params, loss_k, data = make_setup(model, spec, dev)
    _, _, params_d, loss_d, _ = make_setup(
        model, spec.replace("backend=pallas", "backend=direct"), dev,
        net=params["net"])
    params_d["codec"] = params["codec"]
    batch = data.batch(cfg.batch_size, 0, device=dev)
    lk, gk, _ = split_value_and_grad(loss_k, params, batch)
    ld, gd, _ = split_value_and_grad(loss_d, params_d, batch)
    torch.cuda.synchronize()
    lk, ld = float(lk), float(ld)
    rel = abs(lk - ld) / abs(ld)
    check(rel <= 1e-4, f"{model} step-0 loss kernel {lk} vs direct {ld}")
    gerr = leaf_rel_err(gk, gd)
    check(gerr <= 1e-3, f"{model} step-0 grads kernel vs direct: {gerr}")
    return {"loss_kernel": lk, "loss_direct": ld, "loss_rel_err": rel,
            "grad_leaf_rel_err": gerr}


def route_counts() -> dict:
    """``circconv.ROUTE_LAUNCHES`` with string keys ("bind_superpose/fft")."""
    from repro_torch.kernels import circconv
    return {f"{k}/{r}": n for (k, r), n in circconv.ROUTE_LAUNCHES.items()}


def record_launches() -> dict:
    """The circconv launches since the last reset, by the record's kernel
    (``_record_suffix``: the power-of-two and the mixed-radix one-pass
    kernels apart), from ``SHAPE_LAUNCHES`` and the route each D takes (a
    main-path run launches through ``route(D)``)."""
    from collections import Counter
    from repro_torch.kernels import circconv
    out = Counter()
    for (name, G, R, D), n in circconv.SHAPE_LAUNCHES.items():
        out[name + _record_suffix(circconv.route(D), D)] += n
    return dict(out)


def check_fft_route(routes: dict, per_kernel: int, what: str, route="fft"):
    """Every circconv launch went to ``route``'s kernels: ``per_kernel``
    each."""
    from repro_torch.kernels import circconv
    want = {f"{k}/{r}": per_kernel if r == route else 0
            for k in ("bind_superpose", "unbind") for r in circconv.ROUTES}
    check(routes == want, f"{what}: circconv routes {routes}, want {want}")


def run_steps(model: str, spec: str, steps: int, dev) -> dict:
    """``steps`` train steps from fresh weights, launch counts reset just
    before and read just after."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.optim import adam
    from repro_torch.transport.split import (make_split_train_step,
                                             trainable_params)
    cfg, codec, params, loss, data = make_setup(model, spec, dev)
    opt = adam(cfg.lr)
    opt_state = opt.init(trainable_params(loss, params))
    step = make_split_train_step(loss, opt)
    batches = [data.batch(cfg.batch_size, s, device=dev) for s in range(steps)]
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    losses = []
    for b in batches:
        params, opt_state, l, _ = step(params, opt_state, b)
        losses.append(l)
    torch.cuda.synchronize()
    counts = dict(circconv.LAUNCHES)
    routes, by_kernel = route_counts(), record_launches()
    losses = torch.stack(losses).tolist()
    check(all(map(math.isfinite, losses)), f"{model} {spec}: non-finite loss {losses}")
    want = {"bind_superpose": 2 * steps, "unbind": 2 * steps}
    check(counts == want, f"{model} {spec}: launches {counts}, want {want}")
    check_fft_route(routes, 2 * steps, f"{model} {spec}")
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{spec} ran as {mode}, not the CUDA kernel")
    return {"model": model, "spec": codec.spec(), "steps": steps,
            "batch": cfg.batch_size, "losses": losses, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel}


# --------------------------------------------------------------------------
# phase 4: the serving path
# --------------------------------------------------------------------------

def serve_model(dtype, dev, quant=False):
    """deepseek-7b at full width and depth, random weights from the seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm as lm_lib
    cfg = get_config(SERVE_ARCH)
    if quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    return cfg, lm_lib.init_lm_params(SEED, cfg, dtype=dtype, device=dev)


def free_cuda():
    import torch
    from repro_torch.kernels import ops
    ops.clear_key_caches()
    gc.collect()
    torch.cuda.empty_cache()


def n_attn_layers(cfg) -> int:
    return cfg.num_superblocks * sum(k == "attn" for layer in cfg.block_pattern
                                     for k in layer)


def serve_prompts(n: int, vocab: int) -> list:
    rng = np.random.RandomState(SEED + 1)
    return rng.randint(0, vocab, (n, SERVE_PROMPT)).tolist()


@contextlib.contextmanager
def finite_logits():
    """Within the block, every ``decode_step`` and ``prefill_chunk`` the
    engine calls ANDs "all logits finite" into a flag on the device (no
    host sync); yields a one-element list that holds the flag's value on
    exit."""
    import torch
    from repro_torch.models import lm as lm_lib
    flag = None
    orig = {n: getattr(lm_lib, n) for n in ("decode_step", "prefill_chunk")}

    def wrap(fn):
        def probed(*a, **kw):
            nonlocal flag
            out = fn(*a, **kw)
            ok = torch.isfinite(out[0]).all()
            flag = ok if flag is None else flag & ok
            return out
        return probed

    result = [None]
    for n, fn in orig.items():
        setattr(lm_lib, n, wrap(fn))
    try:
        yield result
    finally:
        for n, fn in orig.items():
            setattr(lm_lib, n, fn)
        result[0] = flag is not None and bool(flag)


def make_engine(params, cfg, kv_read: str):
    from repro_torch.serving.engine import BatchedEngine
    return BatchedEngine(params, cfg, codec=SERVE_CODEC, seed=SEED,
                         kv_read=kv_read, **SERVE_ENGINE)


def serve_run(params, cfg, kv_read: str, n_req: int, max_new: int):
    """One engine run of ``n_req`` requests, launch counts reset just
    before and read just after.  Returns (engine, record)."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import Request
    eng = make_engine(params, cfg, kv_read)
    prompts = serve_prompts(n_req, cfg.vocab_size)
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    circconv.reset_launch_counts()
    with finite_logits() as finite:
        t0 = time.perf_counter()
        for u, p in enumerate(prompts):
            eng.submit(Request(uid=u, prompt=p, max_new_tokens=max_new))
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {**pa.LAUNCHES, **circconv.LAUNCHES}
    routes, by_kernel = route_counts(), record_launches()
    outs = {r.uid: r.out for r in done}
    gen = sum(len(o) for o in outs.values())
    st = eng.stats
    rec = {"kv_read": kv_read, "requests": n_req, "max_new": max_new,
           "completed": len(done), "generated": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "total_tokens_per_s": (gen + n_req * SERVE_PROMPT) / wall,
           "mean_ttft_ms": statistics.mean(r.t_first - r.t_submit
                                           for r in done) * 1e3,
           "finite_logits": finite[0], "launches": counts,
           "route_launches": routes, "record_launches": by_kernel, "outs": outs,
           **{k: st[k] for k in ("decode_steps", "prefill_chunks", "dispatches",
                                 "wire_bytes_fwd", "kv_read_execution_mode",
                                 "codec_execution_mode")}}
    check(len(done) == n_req and all(len(o) == max_new for o in outs.values()),
          f"serve {kv_read}: {len(done)} of {n_req} requests, lengths "
          f"{sorted({len(o) for o in outs.values()})}")
    check(rec["finite_logits"], f"serve {kv_read}: non-finite logits")
    return eng, rec


def check_serve_launches(rec, cfg, quant: bool):
    """The kernel run went through the kernels: the paged kernel (float or
    int8) once per attention layer per decode step, the other one never;
    bind and unbind once per decode step (8 slots / R 4 = 2 groups, one
    launch) and once per prefill chunk (64 positions x 2 groups, one
    launch), all on the FFT route (D = 4096)."""
    name, other = (("paged_attention_quant", "paged_attention") if quant
                   else ("paged_attention", "paged_attention_quant"))
    steps, chunks = rec["decode_steps"], rec["prefill_chunks"]
    got = rec["launches"]
    want = {name: n_attn_layers(cfg) * steps, other: 0,
            "bind_superpose": steps + chunks, "unbind": steps + chunks}
    check(got == want, f"serve launches {got}, want {want} "
          f"({steps} decode steps, {chunks} prefill chunks)")
    check_fft_route(rec["route_launches"], steps + chunks, "serve")
    check(rec["kv_read_execution_mode"] == "cuda-kernel",
          f"kv read ran as {rec['kv_read_execution_mode']}")
    check(rec["codec_execution_mode"] == "cuda-kernel",
          f"codec ran as {rec['codec_execution_mode']}")


def teacher_forced_parity(params, cfg, dev, steps=3) -> dict:
    """Prefill 8 slots (staggered prompt lengths 128 down to 72, a shuffled
    page table) once, copy the cache, then ``steps`` decode steps through
    the kernel read on one copy and the gather read on the other, both fed
    the gather run's greedy tokens.  The logits must agree within
    LOGIT_TOL of max|logit|: the two differ only in the order of the
    attention sums."""
    import torch
    from repro_torch import codecs
    from repro_torch.interop import tree_map
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.paging import PagedLayout
    B, T, ps, C = (SERVE_ENGINE[k] for k in ("num_slots", "max_len",
                                              "page_size", "chunk_size"))
    rng = np.random.RandomState(SEED + 3)
    layout = PagedLayout(ps, T, B * T // ps)
    codec = codecs.build(SERVE_CODEC, D=cfg.d_model)
    cp = codec.init(torch.Generator().manual_seed(SEED), device=dev)
    cache = lm_lib.init_decode_cache(params, cfg, B, T, paged=layout)
    cache["pages"] = torch.from_numpy(
        rng.permutation(B * T // ps).astype(np.int32).reshape(B, -1)).to(dev)
    lens = torch.tensor([max(SERVE_PROMPT - 8 * b, 1) for b in range(B)],
                        device=dev)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, SERVE_PROMPT))).to(dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    for c0 in range(0, SERVE_PROMPT, C):
        valid = (c0 + torch.arange(C, device=dev))[None, :] < lens[:, None]
        logits, _ = lm_lib.prefill_chunk(params, cache, toks[:, c0:c0 + C], pos,
                                         cfg, codec=codec, codec_params=cp,
                                         valid=valid, paged=layout)
        pos = pos + valid.sum(-1).to(torch.int32)
    nxt = logits.argmax(-1)[:, None]
    cache_g = tree_map(lambda t: t.clone(), cache)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    gaps = []
    for _ in range(steps):
        lk, _ = lm_lib.decode_step(params, cache, nxt, pos, cfg, codec=codec,
                                   codec_params=cp, paged=layout, live=live,
                                   kv_read="kernel")
        lg, _ = lm_lib.decode_step(params, cache_g, nxt, pos, cfg, codec=codec,
                                   codec_params=cp, paged=layout, live=live,
                                   kv_read="gather")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all() and torch.isfinite(lg).all()),
              "teacher-forced decode: non-finite logits")
        gaps.append(float((lk - lg).abs().max() / lg.abs().max()))
        nxt = lg[:, -1].argmax(-1)[:, None]
        pos = pos + 1
    del cache, cache_g
    free_cuda()
    check(max(gaps) <= LOGIT_TOL, f"teacher-forced kernel vs gather logits: "
          f"gaps {gaps} of max|logit| > {LOGIT_TOL}")
    return {"steps": steps, "gap_of_max_logit": gaps,
            "prompt_lens": lens.tolist()}


def token_agreement(outs_a: dict, outs_b: dict) -> dict:
    """Share of generated tokens on which two runs agree, position by
    position, and the first decode position where any request differs."""
    same = total = 0
    first = None
    for uid, a in outs_a.items():
        b = outs_b[uid]
        total += len(a)
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        same += len(a) - len(diff)
        if diff:
            first = diff[0] if first is None else min(first, diff[0])
    return {"share_equal": same / total, "first_differing_position": first}


def decode_window_times(eng, windows=3) -> dict:
    """The engine's decode-step time at a full batch: 8 fresh requests,
    one ``tick()`` to admit and prefill them and warm up, then ``windows``
    ticks of one 8-step decode window each (with their admit/retire
    boundaries) timed on the host clock, each ending in a synchronise; then
    one tick under ``torch.profiler``: the paged kernel's share of device
    time and the device's idle share.  The engine is drained at the end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request
    n = SERVE_ENGINE["sync_every"]
    for u, p in enumerate(serve_prompts(eng.num_slots, eng.cfg.vocab_size)):
        eng.submit(Request(uid=1000 + u, prompt=p,
                           max_new_tokens=(windows + 3) * n))

    def timed_tick():
        s0 = eng.stats["decode_steps"]
        t0 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.stats["decode_steps"] - s0

    eng.tick()
    torch.cuda.synchronize()
    per_step = []
    for _ in range(windows):
        dt, executed = timed_tick()
        per_step.append(dt * 1e3 / executed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, executed = timed_tick()
        wall_ms = dt * 1e3
    eng.run()
    step_ms = statistics.median(per_step)
    rows, launches, host = {}, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            rows[e.key] = rows.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total:
            host.append((e.key, e.self_cpu_time_total / 1e3 / executed,
                         e.count / executed))
    busy = sum(rows.values()) / executed
    out = {"decode_step_ms": step_ms, "per_window_step_ms": per_step,
           "tokens_per_s_full_batch": eng.num_slots / step_ms * 1e3}
    if not busy:
        out["profile"] = None
        return out
    # the two passes of a paged read: pass 2 is a programmatic dependent of
    # pass 1 and its blocks wait on the card while pass 1 drains, so their
    # kernel times overlap; the read's time is the union of their spans
    paged_names = ("paged_attention_split_kernel", "paged_attention_combine_kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and any(n in e.name for n in paged_names))
    paged, end = 0.0, -math.inf
    for a, b in spans:
        paged += max(0.0, b - max(a, end))
        end = max(end, b)
    paged = paged / 1e3 / executed
    pass_ms = {n: sum(t for k, t in rows.items() if n in k) / executed
               for n in paged_names}
    circ = sum(t for k, t in rows.items() if "bind_superpose_kernel" in k
               or "unbind_kernel" in k) / executed
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:12]
    out["profile"] = {
        "device_ms_per_step": busy, "wall_ms_per_step": wall_ms / executed,
        "idle_share_profiled": 1 - busy / (wall_ms / executed),
        "idle_share_vs_unprofiled_step": 1 - busy / step_ms,
        "paged_kernel_ms_per_step": paged, "paged_kernel_share": paged / busy,
        "paged_pass_ms_per_step": pass_ms,
        "circconv_ms_per_step": circ, "device_ops_per_step": launches / executed,
        "top": [{"name": k[:90], "ms_per_step": t / executed} for k, t in top],
        # host self time by op (profiled, so inflated by the profiler)
        "host_top": [{"name": k[:60], "ms_per_step": t, "calls_per_step": c}
                     for k, t, c in sorted(host, key=lambda r: -r[1])[:10]]}
    return out


def serving_path(dev) -> dict:
    """Phase 4: the float32 run (parity, kernel run, window times and
    profile, gather run), then the bfloat16 / int8-KV run."""
    import torch
    from repro_torch.interop import tree_leaves
    cfg, params = serve_model(torch.float32, dev)
    res = {"arch": SERVE_ARCH, "codec": SERVE_CODEC, "engine": SERVE_ENGINE,
           "n_attn_layers": n_attn_layers(cfg),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    res["teacher_forced"] = teacher_forced_parity(params, cfg, dev)
    eng, run_k = serve_run(params, cfg, "kernel", SERVE_REQUESTS, SERVE_NEW)
    check_serve_launches(run_k, cfg, quant=False)
    res["cache_bytes"] = eng.cache_bytes
    res["kernel_run"] = run_k
    res["window"] = decode_window_times(eng)
    del eng
    free_cuda()
    eng, run_g = serve_run(params, cfg, "gather", SERVE_REQUESTS, SERVE_NEW)
    check(run_g["kv_read_execution_mode"] == "gather", "gather run mode")
    res["gather_run"] = run_g
    res["agreement"] = token_agreement(run_k["outs"], run_g["outs"])
    del eng, params
    free_cuda()

    cfg_q, params_q = serve_model(torch.bfloat16, dev, quant=True)
    eng, run_q = serve_run(params_q, cfg_q, "kernel", QUANT_REQUESTS, QUANT_NEW)
    check_serve_launches(run_q, cfg_q, quant=True)
    res["quant_run"] = run_q
    del eng, params_q
    free_cuda()
    return res


# --------------------------------------------------------------------------
# phase 5: the codec control plane
# --------------------------------------------------------------------------

def cp_link(spec: str, B: int):
    from repro_torch import transport
    return transport.build_link(spec, D=2048).with_max_R(B)


def cp_payload_shapes(rf: int, rb: int, B: int) -> tuple:
    """(G, R) of the forward payload and of the gradient payload of the
    (R_fwd, R_bwd) program at batch B: the bwd codec regroups the gradient
    payload's B/R_fwd rows."""
    return (B // rf, rf), (B // rf // rb, rb)


def cp_kernel_shapes() -> list:
    """(G, R, D) of every bind/unbind that CP_LINK's (R_fwd, R_bwd)
    programs launch at the paper's batch, at both paper cuts' D (phase 2
    checks each against the plain versions)."""
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    link = cp_link(CP_LINK, cfg.batch_size)
    return sorted({(G, R, D) for D in (2048, 4096)
                   for rf in link.fwd.codec.ladder for rb in link.bwd.codec.ladder
                   for G, R in cp_payload_shapes(rf, rb, cfg.batch_size)})


def cp_step_table(link, link_params, loss_fn, opt, made: list):
    """One train step per (R_fwd, R_bwd) pair, through
    ``build_link_program_table``; ``made`` counts the calls of ``make``."""
    from repro_torch.models import convnets
    from repro_torch.transport import (build_link_program_table,
                                       make_split_loss_fn,
                                       make_split_train_step)

    def make(static, static_params):
        made.append(static.spec())
        loss = make_split_loss_fn(convnets.vgg16_front, convnets.vgg16_back,
                                  static, loss_fn, with_metrics=True)
        step = make_split_train_step(loss, opt)

        def run(net, opt_state, batch, erasure=None):
            p, opt_state, l, m = step({"net": net, "codec": static_params},
                                      opt_state, batch, bwd_probe=True,
                                      erasure=erasure)
            return p["net"], opt_state, l, m
        return {"static": static, "run": run}
    return build_link_program_table(link, link_params, make)


def cp_parity(dev) -> dict:
    """Step 0 of one asymmetric pair through the kernels against the same
    step through ``backend=fft`` on the card (same weights, keys and
    batch): loss rtol 1e-4, every gradient leaf and the gradient at the cut
    within 1e-3 of its max (phase 3's step-0 tolerances), the two SNRs
    within 1e-3 dB."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.models import convnets
    from repro_torch.transport import (build_link, make_split_loss_fn,
                                       split_value_and_grad)
    rf, rb = CP_PARITY_PAIR
    net = convnets.init_vgg16(torch.Generator().manual_seed(SEED),
                              n_classes=cfg.n_classes, device=dev)
    batch = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED).batch(
        cfg.batch_size, 0, device=dev)
    res = {}
    for backend in ("pallas", "fft"):
        link = build_link(f"c3sl:R={rf},backend={backend} >> "
                          f"bwd:c3sl:R={rb},backend={backend}", D=cfg.D)
        cut = []

        def front(p, x):
            z = convnets.vgg16_front(p, x)
            z.register_hook(cut.append)
            return z
        loss = make_split_loss_fn(front, convnets.vgg16_back, link,
                                  F.cross_entropy, with_metrics=True)
        params = {"net": net, "codec": link.init(
            torch.Generator().manual_seed(SEED), device=dev)}
        res[backend] = (*split_value_and_grad(loss, params, batch,
                                              bwd_probe=True), cut[0])
    torch.cuda.synchronize()
    (lk, gk, mk, ck), (lf, gf, mf, cf) = res["pallas"], res["fft"]
    out = {"pair": [rf, rb], "loss_kernel": float(lk), "loss_fft": float(lf),
           "loss_rel_err": abs(float(lk) - float(lf)) / abs(float(lf)),
           "grad_leaf_rel_err": leaf_rel_err(gk, gf),
           "cut_grad_rel_err": float((ck - cf).abs().max() / cf.abs().max()),
           "cut_snr": [float(mk["cut_snr"]), float(mf["cut_snr"])],
           "bwd_snr": [float(mk["bwd_snr"]), float(mf["bwd_snr"])]}
    check(out["loss_rel_err"] <= 1e-4, f"control plane step-0 loss {out}")
    check(out["grad_leaf_rel_err"] <= 1e-3 and out["cut_grad_rel_err"] <= 1e-3,
          f"control plane step-0 grads {out}")
    check(abs(out["cut_snr"][0] - out["cut_snr"][1]) <= 1e-3
          and abs(out["bwd_snr"][0] - out["bwd_snr"][1]) <= 1e-3,
          f"control plane step-0 SNRs {out}")
    return out


def cp_launch_shapes(served: dict, B: int) -> dict:
    """Launches by (G, R) that the served (R_fwd, R_bwd) pairs imply, for
    bind and for unbind alike: per step, each at the forward payload twice
    (encode and decode, and each one's backward) and at the gradient
    payload once."""
    from collections import Counter
    shapes = Counter()
    for (rf, rb), n in served.items():
        fwd, grad = cp_payload_shapes(rf, rb, B)
        shapes[fwd] += 2 * n
        shapes[grad] += n
    return {f"{g}x{r}": n for (g, r), n in sorted(shapes.items())}


def cp_counted_shapes() -> dict:
    """The launches counted by (G, R, D) since the last reset, by kernel:
    {name: {"GxR" or "GxRxD": count}} (D only where it is not 2048)."""
    from repro_torch.kernels import circconv
    out = {name: {} for name in circconv.LAUNCHES}
    for (name, G, R, D), n in sorted(circconv.SHAPE_LAUNCHES.items()):
        out[name][f"{G}x{R}" + ("" if D == 2048 else f"x{D}")] = n
    return out


def control_plane(dev) -> dict:
    """Phase 5 (a) and (b): the Adaptive-R asymmetric link ``CP_LINK`` on
    the VGG-16 train step (B 64, Adam 1e-4), clamped to the batch.  Every
    (R_fwd, R_bwd) pair runs one step pinned, then the controllers run
    free, fed the cut SNR and the probe's gradient SNR (read with the loss
    in one transfer a step, the only sync); then the same link under a
    ``drop`` FaultPlan with erasure recovery on both directions.  Launch
    counts are reset just before the steps and read just after."""
    import torch
    import torch.nn.functional as F
    from collections import Counter
    from repro_torch import faults
    from repro_torch.configs.paper import VGG16_CIFAR10 as cfg
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.kernels import circconv
    from repro_torch.models import convnets
    from repro_torch.optim import adam
    from repro_torch.transport import link_program_key, split_comm_bytes

    B = cfg.batch_size
    link = cp_link(CP_LINK, B)
    made = []
    opt = adam(cfg.lr)
    link_params = link.init(torch.Generator().manual_seed(SEED), device=dev)
    table = cp_step_table(link, link_params, F.cross_entropy, opt, made)
    n_pairs = len(link.fwd.codec.ladder) * len(link.bwd.codec.ladder)
    check(len(made) == len(table) == n_pairs == 12,
          f"control plane: make ran {len(made)} times for {len(table)} entries")
    net = convnets.init_vgg16(torch.Generator().manual_seed(SEED),
                              n_classes=cfg.n_classes, device=dev)
    opt_state = opt.init({"net": net})
    data = SyntheticImageDataset(n_classes=cfg.n_classes, seed=SEED)
    n_steps = n_pairs + CP_FREE_STEPS + CP_FAULT_STEPS
    batches = [data.batch(B, s, device=dev) for s in range(n_steps)]
    served, steps, wire_checked = Counter(), [], 0
    torch.cuda.synchronize()
    circconv.reset_launch_counts()

    def one(batch, erasure=None, phase="free"):
        nonlocal net, opt_state, wire_checked
        key = link_program_key(link)
        entry = table[key]
        net, opt_state, loss, m = entry["run"](net, opt_state, batch, erasure)
        # the one host transfer of the step
        l, cut, bwd = torch.stack([loss, m["cut_snr"], m["bwd_snr"]]).tolist()
        wire = link.wire_bytes_fwd(B) + link.wire_bytes_bwd(B)
        check(wire == split_comm_bytes(entry["static"], B),
              f"control plane wire bytes {wire} for {key}")
        wire_checked += 1
        served[key] += 1
        steps.append({"phase": phase, "R": list(key), "loss": l,
                      "cut_snr": cut, "bwd_snr": bwd, "wire_bytes": wire})
        check(math.isfinite(l), f"control plane {phase} step loss {l} at {key}")
        return cut, bwd

    it = iter(batches)
    for rf, rb in table:                             # (a) every pair, pinned
        link.fwd.codec.pin(rf)
        link.bwd.codec.pin(rb)
        check(link_program_key(link) == (rf, rb), "pin")
        one(next(it), phase="pinned")
    for ctl in (link.fwd.codec, link.bwd.codec):     # back to the start
        ctl.pin(ctl.min_R).unpin()
    observed = []
    for _ in range(CP_FREE_STEPS):                   # (a) free
        observed.append(one(next(it)))
        link.observe(*observed[-1])

    # (b) faults: both directions drop packets, the decode renormalises
    plan = faults.FaultPlan(seed=SEED, rates=CP_FAULT_RATES, schedule={
        d: {s: faults.FaultEvent("drop", 1.0)} for d, s in CP_FAULT_BURSTS.items()})

    def install(lnk):
        for ch in (lnk.fwd, lnk.bwd):
            ch.install_faults(plan, faults.RecoveryPolicy(
                mode="erasure", retry_budget=CP_FAULT_BUDGET[ch.direction]))
    install(link)
    erased_at, retransmitted_at, erased_packets = [], [], 0
    for s in range(CP_FAULT_STEPS):
        batch = next(it)
        try:
            masks, info = link.next_erasure(B)
        except faults.ChannelErasure:
            erased_at.append(s)
            observed.append(None)
            continue
        if any(i["attempts"] > 1 for i in info.values() if i):
            retransmitted_at.append(s)
        erased_packets += sum(i["erased_packets"] for i in info.values() if i)
        erasure = {k: torch.from_numpy(v).to(dev) for k, v in masks.items()}
        observed.append(one(batch, erasure, phase="faults"))
        link.observe(*observed[-1])
    torch.cuda.synchronize()
    counts = dict(circconv.LAUNCHES)
    routes, by_kernel = route_counts(), record_launches()
    by_shape = cp_counted_shapes()
    check(len(made) == 12, f"control plane: make ran again ({len(made)})")

    # the host's replay of the plan: a fresh link fed the same observations
    replay = cp_link(CP_LINK, B)
    for obs in observed[:CP_FREE_STEPS]:
        replay.observe(*obs)
    install(replay)
    replayed = 0
    for obs in observed[CP_FREE_STEPS:]:
        try:
            replay.next_erasure(B)
        except faults.ChannelErasure:
            replayed += 1
            continue
        if obs is not None:
            replay.observe(*obs)
    check(len(erased_at) == replayed,
          f"ChannelErasure {erased_at} on the card vs {replayed} replayed")
    # what the schedule alone predicts: a burst loses every packet of its
    # first transmission, more than erasure recovery accepts; a direction
    # with no resend left raises at its burst, one with a resend retransmits
    # (the 10% rate alone stays under the accepted half)
    want_erased = sorted(s for d, s in CP_FAULT_BURSTS.items()
                         if CP_FAULT_BUDGET[d] == 0)
    want_resent = sorted(s for d, s in CP_FAULT_BURSTS.items()
                         if CP_FAULT_BUDGET[d] > 0)
    check(erased_at == want_erased and want_erased,
          f"ChannelErasure at fault steps {erased_at}, predicted {want_erased}")
    check(set(want_resent) <= set(retransmitted_at) and want_resent,
          f"retransmitted at fault steps {retransmitted_at}, predicted "
          f"at least {want_resent}")
    executed = sum(served.values())
    check_fft_route(routes, 3 * executed, "control plane")
    check(set(served) == set(table), f"pairs served {sorted(served)}")
    implied = cp_launch_shapes(served, B)
    check(all(by_shape[name] == implied for name in by_shape),
          f"control plane launches by shape {by_shape}, implied {implied}")
    return {"link": link.spec(), "pairs": [list(k) for k in table],
            "make_calls": len(made), "steps": steps, "executed": executed,
            "served": {f"{rf},{rb}": n for (rf, rb), n in sorted(served.items())},
            "wire_checked": wire_checked, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel,
            "launches_by_shape": by_shape,
            "faults": {"rates": CP_FAULT_RATES, "bursts": CP_FAULT_BURSTS,
                       "retry_budget": CP_FAULT_BUDGET,
                       "erased_at": erased_at, "replayed_erasures": replayed,
                       "retransmitted_at": retransmitted_at,
                       "erased_packets": erased_packets}}


def cp_masked_decode_bitwise(dev) -> dict:
    """(b) The masked decode through the kernels at an all-ones mask is
    bitwise the decode, at every forward bucket and every backward one."""
    import torch
    from repro_torch import codecs
    out = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for R, rows in ((2, 64), (4, 64), (8, 64), (16, 64), (1, 4), (2, 4), (4, 4)):
        c = codecs.build(f"c3sl:R={R},D=2048,backend=pallas")
        p = c.init(device=dev)
        payload = c.encode(p, torch.randn((rows, 2048), generator=gen).to(dev))
        a = c.decode(p, payload)
        b = c.decode_masked(p, payload, torch.ones_like(payload))
        out[f"R{R}/rows{rows}"] = bool(torch.equal(a, b))
    check(all(out.values()), f"masked decode at all ones not bitwise: {out}")
    return out


@contextlib.contextmanager
def cudnn_defaults():
    """PyTorch's own cuDNN settings (TF32 convolutions, nondeterministic
    algorithms allowed) instead of the comparison settings of this run."""
    import torch
    b = torch.backends.cudnn
    saved = (b.allow_tf32, b.deterministic)
    b.allow_tf32, b.deterministic = True, False
    try:
        yield
    finally:
        b.allow_tf32, b.deterministic = saved


def device_top(fn, n=6) -> list:
    """``torch.profiler``'s self device time of ``fn``'s kernels, by name
    (the largest ``n``), ms a call over 10 calls; [] where the profiler
    sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return [{"name": k[:80], "ms": t, "calls": c}
            for k, t, c in device_rows(prof, 10)[:n]]


def device_rows(prof, n_calls: int) -> list:
    """(kernel name, self device ms a call, launches a call) of a
    ``torch.profiler`` run over ``n_calls`` calls, largest first: device-side
    events only (an op's own event repeats its kernels' time)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3 / n_calls, e.count // n_calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[1])


def cp_table2(dev) -> dict:
    """(c) Table 2 on the card at both paper cuts, B 64: BottleNet++
    against C3-SL (the kernels), R 4 each.  The codec's parameter bytes
    resident on the card, and its device time per train step (encode +
    decode forward, and their backward: the input's gradient, and the
    params' for BottleNet++) in this run's comparison settings (float32,
    deterministic cuDNN) and in PyTorch's defaults (TF32 convolutions),
    beside the analytic param_count / flops ratios; and where
    BottleNet++'s device time goes."""
    import torch
    from repro_torch import codecs
    from repro_torch.configs.paper import RESNET50_CIFAR100, VGG16_CIFAR10
    from repro_torch.interop import tree_leaves
    out = {}
    for cfg in (VGG16_CIFAR10, RESNET50_CIFAR100):
        C, H, W = cfg.cut_shape
        B = cfg.batch_size
        row = {}
        for name, spec in (("bnpp", "bnpp:R=4"),
                           ("c3sl", "c3sl:R=4,backend=pallas")):
            c = codecs.build(spec, D=cfg.D, C=C, H=H, W=W)
            p = c.init(torch.Generator().manual_seed(SEED), device=dev)
            shape = (B, C, H, W) if c.feature_layout == "nchw" else (B, cfg.D)
            gen = torch.Generator().manual_seed(SEED + 4)
            Z = torch.randn(shape, generator=gen).to(dev).requires_grad_()
            G = torch.randn(shape, generator=gen).to(dev)
            trains = [t.requires_grad_() for t in tree_leaves(p)
                      if getattr(c, "trainable", False)]

            def fwd_bwd(c=c, p=p, Z=Z, G=G, trains=trains):
                zhat = c.decode(p, c.encode(p, Z))
                return torch.autograd.grad(zhat, [Z, *trains], G)
            row[name] = {
                "spec": c.spec(),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(p)),
                "param_count": c.param_count(), "flops": c.flops(B),
                "ms": cuda_ms(fwd_bwd)}
            with cudnn_defaults():
                row[name]["ms_tf32"] = cuda_ms(fwd_bwd)
            row[name]["top"] = device_top(fwd_bwd)
        b, h = row["bnpp"], row["c3sl"]
        row["ratios"] = {
            "param_bytes": b["param_bytes"] / h["param_bytes"],
            "param_count": b["param_count"] / h["param_count"],
            "ms": b["ms"] / h["ms"], "ms_tf32": b["ms_tf32"] / h["ms_tf32"],
            "flops": b["flops"] / h["flops"]}
        out[cfg.name] = row
    return out


def cp_bnpp_resnet(dev) -> dict:
    """(c) BottleNet++ trains: ResNet-50/CIFAR-100 through ``bnpp:R=4`` for
    CP_BNPP_STEPS steps (finite losses), and the codec's gradients at step
    0 are nonzero on every weight and BatchNorm leaf (the conv biases in
    front of a BatchNorm have an exact gradient of 0)."""
    import torch
    from repro_torch.optim import adam
    from repro_torch.transport import (make_split_train_step,
                                       split_value_and_grad, trainable_params)
    cfg, codec, params, loss, data = make_setup("resnet50", "bnpp:R=4", dev)
    batches = [data.batch(cfg.batch_size, s, device=dev)
               for s in range(CP_BNPP_STEPS)]
    _, g0, _ = split_value_and_grad(loss, params, batches[0])
    gmax = {k: float(v.abs().max()) for k, v in g0["codec"].items()}
    check(all(v > 0 for k, v in gmax.items() if k not in ("b_enc", "b_dec")),
          f"bnpp codec grads {gmax}")
    opt = adam(cfg.lr)
    state = opt.init(trainable_params(loss, params))
    step = make_split_train_step(loss, opt)
    losses = []
    for b in batches:
        params, state, l, _ = step(params, state, b)
        losses.append(l)
    losses = torch.stack(losses).tolist()
    check(all(map(math.isfinite, losses)), f"resnet50 bnpp losses {losses}")
    return {"spec": codec.spec(), "losses": losses, "codec_grad_max": gmax}


# --------------------------------------------------------------------------
# phase 6: times
# --------------------------------------------------------------------------

def circconv_operands(G, R, D, dev, seed=SEED + 1):
    """Keys, their spectrum, Kext, the four-step kernels' key spectra (None
    off that route), Z (G, R, D) and S (G, D), float32."""
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(seed)
    K = hrr.generate_keys(gen, R, D, device=dev)
    Z = torch.randn((G, R, D), generator=gen).to(dev)
    S = torch.randn((G, D), generator=gen).to(dev)
    return (K, hrr.key_spectrum(K), *ops._keys(K), Z, S)


def circconv_bound(name, G, R, D) -> dict:
    """The least work of bind or unbind at (G, R, D) in float32, whatever
    the algorithm: Z or S, the keys K (R, D) and the output each cross HBM
    once, and the operations are the FFT form's (rfft of every data row and
    key, one complex multiply-add per frequency and binding, an irfft per
    output row; a real transform of length D at 2.5 D log2 D).  The direct
    O(D^2) form (2 G R D^2 FLOPs) is kept beside it as a design figure."""
    flops = (G * R + G + R) * 2.5 * D * math.log2(D) + G * R * (D // 2 + 1) * 8
    x, out = (G * R * D, G * D) if name == "bind_superpose" else (G * D, G * R * D)
    nbytes = (x + R * D + out) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    direct_flops = 2 * G * R * D * D
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "direct_flops": direct_flops,
            "direct_flops_ms": direct_flops / F32_PEAK_FLOPS * 1e3}


def circconv_calls(G, R, D, dev):
    """name -> (data, route entry point, plain version, torch.fft route) of
    bind and unbind at (G, R, D), and the Kext the plain versions take.  The
    entry point ``on(route)`` runs the named route's kernel on the data, the
    four-step one with the keys' spectra made beforehand (as ``ops`` keeps
    them)."""
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv
    K, KF, kext, spectra, Z, S = circconv_operands(G, R, D, dev)

    def entry(fn, x):
        return lambda r: fn(r, x, kext, spectra if r == "fft4" else None)

    return {"bind_superpose": (Z, entry(circconv._bind_superpose_on, Z),
                               circconv.bind_superpose_plain,
                               lambda: hrr._bind_impl(Z, K, KF, "fft")),
            "unbind": (S, entry(circconv._unbind_on, S), circconv.unbind_plain,
                       lambda: hrr._unbind_impl(S, K, KF, "fft"))}, kext


def kernel_times(dev, G, R, D) -> dict:
    """bind and unbind at (G, R, D): the kernel ``route(D)`` picks (``ms``,
    also host included), the FFT kernel where D is a power of two it takes,
    the direct kernel, the plain version and the torch.fft route."""
    from repro_torch.kernels import circconv
    calls, kext = circconv_calls(G, R, D, dev)
    kernel_route = circconv.route(D)
    out = {}
    for name, (x, on, plain, fft) in calls.items():
        by_route = {r: cuda_ms_scaled(lambda r=r: on(r))
                    for r in dict.fromkeys((kernel_route, "direct"))}
        out[name] = {
            "shape": [G, R, D], "route": kernel_route,
            "ms": by_route[kernel_route],
            "ms_host_included": cuda_ms(lambda: on(kernel_route), hide_host=False),
            "fft_ms": by_route.get("fft"), "direct_ms": by_route["direct"],
            "plain_ms": cuda_ms_scaled(lambda: plain(x, kext)),
            "library_ms": cuda_ms(fft),
            **circconv_bound(name, G, R, D),
        }
    del calls, kext
    free_cuda()
    return out


def fft4_times(dev) -> dict:
    """bind and unbind on the four-step route at the LM training shapes
    LM_SHAPES: the kernel (device time, and host included), the torch.fft
    route of the same function (the library yardstick, with the keys'
    spectrum made beforehand, as the kernels' is), the bound, one build of
    the keys' spectra (made once per key tensor, not per call), and the
    direct kernel, one call a side.  The plain version's O(D^2) gather is
    out of reach there (terabytes), so it is timed at the largest shape
    phase 2 holds it at, (2, 4, 65536), in fewer runs, host included; each
    shape's record carries that figure."""
    from repro_torch.kernels import circconv
    out = {}
    for G, R, D in LM_SHAPES:
        calls, kext = circconv_calls(G, R, D, dev)
        p = circconv.plan(D)

        spectra_ms = cuda_ms(lambda: circconv.key_spectra(kext, p), warmup=2,
                             calls=1, reps=5)
        for name, (x, on, _, fft) in calls.items():
            passes = device_top(lambda: on("fft4"), n=4)
            out[f"{name}/{G}x{R}x{D}"] = {
                "passes": [{"name": (re.search(r"\w+_kernel", t["name"])
                                     or [t["name"][:40]])[0], "ms": t["ms"]}
                           for t in passes],
                "shape": [G, R, D], "route": "fft4", "sides": list(p.sides),
                "ms": cuda_ms(lambda: on("fft4")),
                "ms_host_included": cuda_ms(lambda: on("fft4"), hide_host=False),
                "library_ms": cuda_ms(fft),
                "key_spectra_ms": spectra_ms,
                "direct_one_call_ms": cuda_ms(lambda: on("direct"), warmup=0,
                                              calls=1, reps=1, hide_host=False),
                **circconv_bound(name, G, R, D)}
        del calls, kext
        free_cuda()
    G, R, D = (2, 4, 65536)
    calls, kext = circconv_calls(G, R, D, dev)
    for name, (x, _, plain, _) in calls.items():
        # host included: its chunked gather is a Python loop of hundreds
        # of launches, which outlasts the sleep that hides the host
        plain_ms = cuda_ms(lambda: plain(x, kext), warmup=1, calls=1, reps=3,
                           hide_host=False)
        for key, t in out.items():
            if key.startswith(name + "/"):
                t["plain_shape"], t["plain_ms"] = [G, R, D], plain_ms
    return out


# phase 6's paged shapes: the serving run's decode read (8 slots, positions
# spread over 128-160) and one live slot with the whole cache admitted
PAGED_TIME_POS = {"serving": np.linspace(128, 160, 8).round().astype(np.int32),
                  "one_slot": np.array([511], np.int32)}


def paged_bound(rows, B, H, KV, hd, *, kv_bytes, q_bytes, quant) -> dict:
    """The least time of one decode read over ``rows`` admitted positions
    (summed over the slots): the bytes it must move (the admitted K/V rows
    of ``kv_bytes``-byte elements and, over int8 pools, their float32
    scales; q and the output, of ``q_bytes``) each crossing HBM once,
    against its operations (4 per admitted row, head and dimension) at the
    float32 peak; the larger of the two bounds it."""
    nbytes = (rows * KV * 2 * (hd * kv_bytes + (4 if quant else 0))
              + 2 * B * H * hd * q_bytes)
    flops = 4 * rows * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "flops": flops}


def paged_times(dev, sets=4) -> dict:
    """Each paged kernel at the serving geometry (T 512, page size 16, KV = H
    = 32, head dim 128) at the two shapes of ``PAGED_TIME_POS``: the float
    kernel on float32 pools, the int8 kernel with bfloat16 q and compute,
    as the two serving runs call them.  Calls cycle through ``sets`` tables
    over disjoint pages, so the rows they read are cold in the 50 MB L2
    cache, as each of the 30 layers' reads is on the serving path.  The
    bound is ``paged_bound``'s, set by the bytes at these shapes.  The library yardstick of the float kernel is
    gather_pages followed by ``scaled_dot_product_attention``; the int8
    kernel has no single PyTorch call that computes it (SDPA takes no int8
    K/V with per-row scales).  ``splits`` and ``chunk`` are the wrapper's
    plan for the shape.  Returns {kernel: {shape: record}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import decode_mask
    from repro_torch.models.paging import gather_pages
    g = dict(MAIN_PAGED)
    T, H, KV, hd = g["length"], g["H"], g["KV"], g["hd"]
    rng = np.random.RandomState(SEED + 5)
    out = {"paged_attention": {}, "paged_attention_quant": {}}
    for shape, pos in PAGED_TIME_POS.items():
        B = g["B"] = len(pos)
        rows = int(sum(min(int(p), T - 1) + 1 for p in pos))
        for name, quant, dtype in (("paged_attention", False, torch.float32),
                                   ("paged_attention_quant", True, torch.bfloat16)):
            case = paged_case(rng, dev, quant=quant, pos=pos, sets=sets, **g)
            q, tabs, p = case["q"].to(dtype), case["tables"], case["pos"]
            nxt = itertools.cycle(range(sets)).__next__
            k, v = case["k"], case["v"]
            if quant:
                ks, vs = case["ks"], case["vs"]
                kern = lambda: pa.paged_attention_quant(  # noqa: E731
                    q, k, ks, v, vs, tabs[nxt()], p, length=T)
                plain = lambda: pa.paged_attention_quant_plain(  # noqa: E731
                    q, k, ks, v, vs, tabs[nxt()], p, length=T)
                library = None
            else:
                kern = lambda: pa.paged_attention(  # noqa: E731
                    q, k, v, tabs[nxt()], p, length=T)
                plain = lambda: pa.paged_attention_plain(  # noqa: E731
                    q, k, v, tabs[nxt()], p, length=T)

                def library():
                    tab = tabs[nxt()]
                    kk = gather_pages(k, tab, T).transpose(1, 2)   # (B, KV, T, hd)
                    vv = gather_pages(v, tab, T).transpose(1, 2)
                    mask = decode_mask(p, T, None)[:, None, None, :]
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), kk, vv, attn_mask=mask)
            bound = paged_bound(rows, B, H, KV, hd, kv_bytes=k.element_size(),
                                q_bytes=q.element_size(), quant=quant)
            splits, chunk = pa.split_plan(B, KV, H // KV, hd, T, g["ps"],
                                          pa.sm_count(torch.cuda.current_device()))
            ms = cuda_ms(kern)
            out[name][shape] = {
                "shape": dict(g, pos=pos.tolist()), "dtype": str(dtype),
                "splits": splits, "chunk": chunk, "ms": ms,
                "ms_host_included": cuda_ms(kern, hide_host=False),
                "plain_ms": cuda_ms(plain),
                "library_ms": None if library is None else cuda_ms(library),
                **bound, "share_of_bound": bound["bound_ms"] / ms,
                "admitted_rows": rows}
            del case, kern, plain, library
            free_cuda()
    return out


def vgg_stepper(spec: str, dev):
    """A closure that runs one VGG-16 train step (B=64, R=4) in place."""
    from repro_torch.optim import adam
    from repro_torch.transport.split import (make_split_train_step,
                                             trainable_params)

    cfg, codec, params, loss, data = make_setup("vgg16", spec, dev)
    opt = adam(cfg.lr)
    state = {"p": params, "o": opt.init(trainable_params(loss, params))}
    step = make_split_train_step(loss, opt)
    batch = data.batch(cfg.batch_size, 0, device=dev)

    def one():
        state["p"], state["o"], _, _ = step(state["p"], state["o"], batch)
    return one


def step_times(dev) -> dict:
    """Time of one VGG-16 train step as a caller sees it (host included),
    kernel backend vs fft backend, in turns: kernel, fft, fft, kernel."""
    k = vgg_stepper("c3sl:R=4,backend=pallas", dev)
    f = vgg_stepper("c3sl:R=4,backend=fft", dev)
    runs = {"kernel": [], "fft": []}
    for name, fn in (("kernel", k), ("fft", f), ("fft", f), ("kernel", k)):
        runs[name].append(cuda_ms(fn, warmup=3, calls=4, reps=20,
                                  hide_host=False))
    return {"vgg16_step_ms_kernel": statistics.mean(runs["kernel"]),
            "vgg16_step_ms_fft": statistics.mean(runs["fft"]),
            "runs": runs}


def step_profile(dev, steps=5) -> dict:
    """Where a VGG-16 train step's device time goes (kernel backend):
    ``torch.profiler`` over ``steps`` steps, self device time by kernel,
    the circconv kernels' share, and the sum of kernel times over wall time
    (the profiler's own overhead lengthens the wall time, so that busy
    share is a lower bound).  Device times come back None where the
    profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = vgg_stepper("c3sl:R=4,backend=pallas", dev)
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, steps)
    busy = sum(r[1] for r in rows)
    if not busy:
        return {"device_ms_per_step": None, "wall_ms_per_step": wall_ms / steps}
    circ = sum(r[1] for r in rows if "bind_superpose_kernel" in r[0]
               or "unbind_kernel" in r[0])
    return {"device_ms_per_step": busy, "wall_ms_per_step": wall_ms / steps,
            "busy_share": busy / (wall_ms / steps),
            "circconv_ms_per_step": circ, "circconv_share": circ / busy,
            "top": [{"name": n[:90], "ms_per_step": t, "calls_per_step": c}
                    for n, t, c in rows[:12]]}


# --------------------------------------------------------------------------
# phase 7: the LM training path
# --------------------------------------------------------------------------

def lm_config(arch=LM_ARCH, layers=LM_LAYERS):
    """``arch`` at full width (deepseek-7b: d_model 4096, 32 heads of 128,
    d_ff 11008, vocab 102400), its depth cut to ``layers``."""
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def lm_args(ckpt_dir, arch=LM_ARCH):
    """``launch/train.py``'s flags for the run: the CLI's own parser;
    ``ckpt_dir`` None writes no checkpoint."""
    from repro_torch.launch import train
    return train.build_parser().parse_args([
        "--arch", arch, "--steps", str(LM_STEPS), "--batch", str(LM_BATCH),
        "--seq", str(LM_SEQ), "--codec", LM_CODEC, "--seed", str(SEED),
        "--log-every", "1", "--device", "cuda"]
        + ([] if ckpt_dir is None else ["--ckpt-dir", str(ckpt_dir)]))


def lm_parity(params, cfg, args, dev) -> dict:
    """Step 0's loss and gradients through the kernels against
    ``backend=fft`` (torch.fft on the card) on the same weights, keys and
    batch: the loss within 1e-6 relative and every gradient leaf within
    1e-4 of its max (the control plane's step-0 tolerances), and the cut
    SNR of both."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokenDataset
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=args.seed)
    batch = data.batch(args.batch, 0, device=dev)
    res = {}
    for backend in ("pallas", "fft"):
        codec, cp = train.make_codec(LM_CODEC.replace("pallas", backend),
                                     args.seq * cfg.d_model, max_R=args.batch,
                                     device=dev)
        tp = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = lm_lib.lm_loss(tp, batch, cfg, codec=codec,
                                       codec_params=cp, with_metrics=True)
        grads = torch.autograd.grad(loss, tree_leaves(tp))
        res[backend] = (float(loss.detach()), float(metrics["cut_snr"].detach()),
                        grads)
        del tp, loss, metrics
    (lk, sk, gk), (lf, sf, gf) = res["pallas"], res["fft"]
    rel = abs(lk - lf) / abs(lf)
    check(rel <= 1e-6, f"lm step-0 loss kernels {lk} vs fft {lf}")
    gerr = leaf_rel_err(gk, gf)
    check(gerr <= 1e-4, f"lm step-0 grads kernels vs fft: {gerr}")
    return {"loss_kernel": lk, "loss_fft": lf, "loss_rel_err": rel,
            "grad_leaf_rel_err": gerr, "cut_snr_kernel": sk, "cut_snr_fft": sf}


def lm_training(dev, arch=LM_ARCH, layers=LM_LAYERS, shape=LM_SHAPE,
                wire_bytes=LM_WIRE_BYTES, ckpt=True) -> dict:
    """``arch`` cut to ``layers``: (a) step-0 parity; (b)
    ``launch.train.run_standard`` for LM_STEPS steps from the same weights,
    launch counts reset just before and read just after: finite losses,
    2 + 2 circconv launches a step, all on the four-step route at
    ``shape``, none direct, ``wire_bytes`` a direction a step; (c) with
    ``ckpt``, the checkpoint it wrote (``--ckpt-dir``) restored bitwise,
    then deleted; (d) the step time (CUDA events around single steps, the
    median of LM_TIMED_STEPS, host included) and a ``torch.profiler``
    breakdown over LM_PROFILED_STEPS steps: device time, idle share, the
    codec's share."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data.pipeline import SyntheticTokenDataset
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels import circconv
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.transport import split_comm_bytes

    cfg = lm_config(arch, layers)
    ckpt_dir = OUT_DIR / "lm_ckpt" if ckpt else None
    if ckpt:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = lm_args(ckpt_dir, arch)
    # run_standard's own init (the seed's generator on the card), made here
    # so that the parity runs on the weights the run starts from
    params = lm_lib.init_lm_params(args.seed, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    parity = lm_parity(params, cfg, args, dev)
    free_cuda()

    out = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.run_standard(args, cfg, params=params, out=out)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, routes, by_kernel = (dict(circconv.LAUNCHES), route_counts(),
                                 record_launches())
    shapes = {f"{k[0]}/{k[1]}x{k[2]}x{k[3]}": n
              for k, n in circconv.SHAPE_LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(losses) == LM_STEPS and all(map(math.isfinite, losses)),
          f"lm training losses {losses}")
    want = {"bind_superpose": 2 * LM_STEPS, "unbind": 2 * LM_STEPS}
    check(counts == want, f"lm training launches {counts}, want {want}")
    check_fft_route(routes, 2 * LM_STEPS, f"lm training {arch}", route="fft4")
    G, R, D = shape
    want_shapes = {f"{k}/{G}x{R}x{D}": 2 * LM_STEPS
                   for k in ("bind_superpose", "unbind")}
    check(shapes == want_shapes, f"lm training shapes {shapes}, want {want_shapes}")
    codec = out["codec"]
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{LM_CODEC} ran as {mode}, not the CUDA kernels")
    wire_fwd = split_comm_bytes(codec, args.batch, directions=1)
    wire_bwd = split_comm_bytes(codec, args.batch) - wire_fwd
    check(wire_fwd == wire_bwd == wire_bytes,
          f"lm wire bytes {wire_fwd} + {wire_bwd}, want {wire_bytes} each")

    ckpt_bytes = restore_s = None
    if ckpt:
        t0 = time.perf_counter()
        template = {"params": out["params"]}
        restored = restore_checkpoint(str(ckpt_dir), LM_STEPS, template)
        restore_s = time.perf_counter() - t0
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(restored), tree_leaves(template)))
        check(bitwise, "lm checkpoint did not restore bitwise")
        ckpt_bytes = sum(p.stat().st_size for p in ckpt_dir.rglob("*")
                         if p.is_file())
        del restored
        shutil.rmtree(ckpt_dir)   # 9.8 GB: the output directory keeps the record only
        free_cuda()

    step = out["step_fns"][None]          # the static codec's one callable
    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=args.seed)
    batch = data.batch(args.batch, LM_STEPS, device=dev)
    probe = torch.zeros((), dtype=torch.float32, device=dev)

    def one():
        step(out["params"], out["opt_state"], batch, probe)

    step_ms = cuda_ms(one, warmup=0, calls=1, reps=LM_TIMED_STEPS, hide_host=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILED_STEPS
    rows = device_rows(prof, LM_PROFILED_STEPS)
    busy = sum(r[1] for r in rows)
    circ = sum(r[1] for r in rows if "columns_kernel" in r[0] or "rows_kernel" in r[0])
    prof_out = None if not busy else {
        "device_ms_per_step": busy, "wall_ms_per_step": wall_ms,
        "idle_share_profiled": 1 - busy / wall_ms,
        "idle_share_vs_unprofiled_step": 1 - busy / step_ms,
        "circconv_ms_per_step": circ, "circconv_share": circ / busy,
        "top": [{"name": n[:90], "ms_per_step": t, "calls_per_step": c}
                for n, t, c in rows[:10]]}
    del out, step, batch
    free_cuda()
    return {"arch": arch, "layers": layers, "params": n_params, "shape": list(shape),
            "batch": LM_BATCH, "seq": LM_SEQ, "codec": LM_CODEC,
            "parity": parity, "losses": losses, "launches": counts,
            "route_launches": routes, "record_launches": by_kernel,
            "shape_launches": shapes,
            "wire_bytes": [wire_fwd, wire_bwd], "run_s": run_s,
            "peak_gb": peak_gb, "ckpt_bytes": ckpt_bytes,
            "restore_s": restore_s, "step_ms": step_ms, "profile": prof_out}


def print_lm(card, lm):
    """Phase 7's and 8's lines."""
    par, lp = lm["parity"], lm["profile"]
    print(f"lm training {lm['arch']} full width, {lm['layers']} layers (cut after "
          f"superblock {lm['layers'] // 2}), {lm['params'] / 1e9:.3f} B params, "
          f"B {LM_BATCH} S {LM_SEQ}, {LM_CODEC} (D {lm['shape'][2]}): step-0 "
          f"kernels vs backend=fft loss {par['loss_kernel']:.6f} vs "
          f"{par['loss_fft']:.6f} (rel err {par['loss_rel_err']:.3g}), grad leaf "
          f"rel err {par['grad_leaf_rel_err']:.3g}, cut SNR "
          f"{par['cut_snr_kernel']:.4f} dB (fft {par['cut_snr_fft']:.4f})",
          flush=True)
    print(f"lm training run_standard: {LM_STEPS} steps, losses "
          f"{[round(v, 4) for v in lm['losses']]}, launches {lm['launches']}, "
          f"routes {lm['route_launches']}, by shape {lm['shape_launches']}, wire "
          f"fwd {lm['wire_bytes'][0]:,d} B + bwd {lm['wire_bytes'][1]:,d} B a "
          f"step, peak {lm['peak_gb']:.1f} GB; " + (
              "no checkpoint" if lm["ckpt_bytes"] is None else
              f"checkpoint {lm['ckpt_bytes']:,d} B restored bitwise in "
              f"{lm['restore_s']:.1f} s"), flush=True)
    print(f"time [{card}] lm train step ({lm['arch']} x{lm['layers']} layers, B "
          f"{LM_BATCH} S {LM_SEQ}, {LM_CODEC}): {lm['step_ms']:.1f} ms (median "
          f"of {LM_TIMED_STEPS}, host included)", flush=True)
    if lp is None:
        print(f"profile [{card}] lm train step: the profiler saw no device time "
              "(not measured)")
    else:
        print(f"profile [{card}] lm train step: device {lp['device_ms_per_step']:.1f} "
              f"ms of {lp['wall_ms_per_step']:.1f} ms wall (idle "
              f"{lp['idle_share_profiled']:.3f} profiled, "
              f"{lp['idle_share_vs_unprofiled_step']:.3f} of the unprofiled step); "
              f"circconv kernels {lp['circconv_ms_per_step']:.4f} ms "
              f"({lp['circconv_share']:.5f})", flush=True)
        for r in lp["top"]:
            print(f"  {r['ms_per_step']:.3f} ms x{r['calls_per_step']}  {r['name']}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = "cuda"
    # the port is compared on the card in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    elapsed = {}
    t_start = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        elapsed[name] = now - t0
        t0 = now

    # one nvcc per source, all started together
    sources = list(build.SIGNATURES)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    lap("build")
    build_s = elapsed["build"]
    print(f"build: {build_s:.2f} s for {', '.join(f'csrc/{n}.cu' for n in sources)}",
          flush=True)
    for name in sources:
        for line in build.build_logs[name].splitlines():
            entry = re.search(r"\d+([a-z][a-z_]*_kernel)I(\w+?)E", line)
            if "Compiling entry" in line and entry:
                print(f"  ptxas {name}: {entry[1]}<{entry[2].lstrip('0123456789')}>")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.strip()}")

    errs = kernel_checks(dev)
    print("kernels: " + "; ".join(
        f"{k} vs plain max_abs_err f32 "
        f"{max(e for s, e in v.items() if s.endswith('float32')):.3g} "
        f"bf16 {max(e for s, e in v.items() if s.endswith('bfloat16')):.3g} "
        f"grad {max((e for s, e in v.items() if s.startswith('grad')), default=math.nan):.3g}"
        for k, v in errs.items()), flush=True)
    errs.update(paged_kernel_checks(dev))
    summary = {k: max(v.values()) for k, v in errs.items()}
    print("paged kernels vs plain max_abs_err: " + "; ".join(
        f"{k} f32 {max(e for s, e in errs[k].items() if s.endswith('float32')):.3g} "
        f"bf16 {max(e for s, e in errs[k].items() if s.endswith('bfloat16')):.3g}"
        for k in ("paged_attention", "paged_attention_quant")), flush=True)
    print("bf16 worst readings (max|err|/max|want| limit "
          f"{BF16_REL_MAX}, rel L2 limit {BF16_REL_L2}): " + "; ".join(
              f"{k} {m:.3g} / {l2:.3g}" for k, (m, l2) in BF16_READINGS.items()),
          flush=True)
    lap("kernel_checks")

    parity = {m: step0_parity(m, "c3sl:R=4,backend=pallas", dev)
              for m in ("vgg16", "resnet50")}
    print(f"step-0 parity vs backend=direct: {json.dumps(parity)}", flush=True)

    main_run = run_steps("vgg16", "c3sl:R=4,backend=pallas", MAIN_STEPS, dev)
    print(f"main path vgg16 c3sl:R=4,backend=pallas: {MAIN_STEPS} steps, "
          f"launches {main_run['launches']}, loss {main_run['losses'][0]:.4f} -> "
          f"{main_run['losses'][-1]:.4f}", flush=True)
    other_runs = [run_steps("vgg16", "c3sl:R=4,backend=pallas|int8", SHORT_STEPS, dev),
                  run_steps("resnet50", "c3sl:R=4,backend=pallas", SHORT_STEPS, dev)]
    for r in other_runs:
        print(f"path {r['model']} {r['spec']}: {r['steps']} steps, launches "
              f"{r['launches']}, losses {[round(v, 4) for v in r['losses']]}",
              flush=True)
    free_cuda()
    lap("train_path")

    serve = serving_path(dev)
    tf, rk, rg, rq = (serve[k] for k in ("teacher_forced", "kernel_run",
                                         "gather_run", "quant_run"))
    print(f"serving {SERVE_ARCH} full width, {SERVE_CODEC}: teacher-forced "
          f"kernel vs gather logit gap {max(tf['gap_of_max_logit']):.3g} of "
          f"max|logit| (limit {LOGIT_TOL})", flush=True)
    for r in (rk, rg, rq):
        print(f"serve kv_read={r['kv_read']} ({r['kv_read_execution_mode']}): "
              f"{r['completed']} requests, {r['generated']} tokens, "
              f"{r['decode_steps']} decode steps, {r['prefill_chunks']} prefill "
              f"chunks, launches {r['launches']}", flush=True)
    print(f"serve kernel vs gather greedy tokens: "
          f"{serve['agreement']['share_equal']:.4f} equal, first difference "
          f"at position {serve['agreement']['first_differing_position']}",
          flush=True)
    lap("serving_path")

    cp_par = cp_parity(dev)
    cp = control_plane(dev)
    cp_bits = cp_masked_decode_bitwise(dev)
    cp_t2 = cp_table2(dev)
    cp_bn = cp_bnpp_resnet(dev)
    free_cuda()
    lap("control_plane")
    print(f"control plane step-0 parity (R_fwd, R_bwd) = {cp_par['pair']}, "
          f"kernels vs backend=fft: loss rel err {cp_par['loss_rel_err']:.3g}, "
          f"grad leaf rel err {cp_par['grad_leaf_rel_err']:.3g}, cut grad rel "
          f"err {cp_par['cut_grad_rel_err']:.3g}, cut SNR {cp_par['cut_snr']}, "
          f"grad SNR {cp_par['bwd_snr']}", flush=True)
    print(f"control plane {cp['link']}: make ran {cp['make_calls']} times for "
          f"{len(cp['pairs'])} (R_fwd, R_bwd) pairs; {cp['executed']} VGG-16 "
          f"steps (B 64), served {cp['served']}, wire bytes checked on "
          f"{cp['wire_checked']} steps; launches {cp['launches']}, routes "
          f"{cp['route_launches']}; by (G, R) {cp['launches_by_shape']}",
          flush=True)
    for i, st in enumerate(cp["steps"]):
        print(f"  cp step {i:2d} {st['phase']:6s} R_fwd {st['R'][0]:2d} R_bwd "
              f"{st['R'][1]} cut SNR {st['cut_snr']:7.3f} dB grad SNR "
              f"{st['bwd_snr']:7.3f} dB loss {st['loss']:.4f} wire "
              f"{st['wire_bytes']} B")
    fl = cp["faults"]
    print(f"control plane faults {fl['rates']} + bursts at {fl['bursts']}, "
          f"retry budget {fl['retry_budget']} (erasure recovery): "
          f"ChannelErasure at fault steps {fl['erased_at']} (host replay "
          f"{fl['replayed_erasures']}), retransmitted at {fl['retransmitted_at']}, "
          f"{fl['erased_packets']} packets erased and renormalised; masked "
          f"decode at all ones bitwise the decode: {cp_bits}", flush=True)
    for name, row in cp_t2.items():
        b, h, r = row["bnpp"], row["c3sl"], row["ratios"]
        print(f"time [{card}] table2 {name} B=64 {b['spec']} vs {h['spec']}: "
              f"codec params on the card {b['param_bytes']} vs "
              f"{h['param_bytes']} B ({r['param_bytes']:.2f}x; param_count "
              f"{r['param_count']:.2f}x), codec fwd+bwd device time "
              f"{b['ms']:.4f} vs {h['ms']:.4f} ms ({r['ms']:.2f}x; flops "
              f"{r['flops']:.3f}x); with TF32 convolutions {b['ms_tf32']:.4f} "
              f"vs {h['ms_tf32']:.4f} ms ({r['ms_tf32']:.2f}x)", flush=True)
        for k in (b, h):
            for t in k["top"]:
                print(f"  {k['spec'].split(':')[0]} {t['ms']:.4f} ms x{t['calls']}"
                      f"  {t['name']}")
    print(f"resnet50 {cp_bn['spec']}: {CP_BNPP_STEPS} steps, losses "
          f"{[round(v, 4) for v in cp_bn['losses']]}, codec grad max "
          f"{ {k: f'{v:.3g}' for k, v in cp_bn['codec_grad_max'].items()} }",
          flush=True)

    times = {f"{G}x{R}x{D}": kernel_times(dev, G, R, D) for G, R, D in TIME_SHAPES}
    free_cuda()
    fft4t = fft4_times(dev)
    free_cuda()
    ptimes = paged_times(dev)
    steps = step_times(dev)
    prof = step_profile(dev)
    lap("times")
    for shape, per in times.items():
        for name, t in per.items():
            fft_ms = "-" if t["fft_ms"] is None else f"{t['fft_ms']:.4f} ms"
            print(f"time [{card}] {name} G,R,D={t['shape']} route {t['route']}: "
                  f"fft kernel {fft_ms}, direct kernel {t['direct_ms']:.4f} ms, "
                  f"routed kernel host included {t['ms_host_included']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, torch.fft {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}), direct-form "
                  f"FLOPs at the f32 peak {t['direct_flops_ms']:.4f} ms", flush=True)
    for key, t in fft4t.items():
        print(f"time [{card}] {key.split('/')[0]} G,R,D={t['shape']} route fft4 "
              f"{t['sides'][0]} x {t['sides'][1]}: kernel "
              f"{t['ms']:.4f} ms, host included {t['ms_host_included']:.4f} ms, "
              f"torch.fft {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}, {t['bytes'] / 1e6:.1f} MB), keys' spectra "
              f"{t['key_spectra_ms']:.4f} ms once, direct kernel one "
              f"call {t['direct_one_call_ms']:.1f} ms; plain at "
              f"G,R,D={t['plain_shape']} {t['plain_ms']:.2f} ms; passes (profiler) "
              + ", ".join(f"{q['name']} {q['ms']:.4f}" for q in t["passes"]),
              flush=True)
    for name, per in ptimes.items():
        for shape, t in per.items():
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            where = (f"B{t['shape']['B']} pos {min(t['shape']['pos'])}-"
                     f"{max(t['shape']['pos'])}")
            print(f"time [{card}] {name} {shape} ({where}) T512 ps16 KV32 "
                  f"hd128 {t['dtype']}: kernel {t['ms']:.4f} ms "
                  f"({t['ms_host_included']:.4f} host included), splits "
                  f"{t['splits']} x chunk {t['chunk']}, plain "
                  f"{t['plain_ms']:.4f} ms, gather+sdpa {lib}, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}, "
                  f"{t['bytes'] / 1e6:.1f} MB; {t['share_of_bound']:.1%} of it)",
                  flush=True)
    print(f"time [{card}] vgg16 train step B=64 R=4: kernel backend "
          f"{steps['vgg16_step_ms_kernel']:.3f} ms, fft backend "
          f"{steps['vgg16_step_ms_fft']:.3f} ms", flush=True)
    if prof["device_ms_per_step"] is None:
        print(f"profile [{card}]: the profiler saw no device time (not measured)")
    else:
        print(f"profile [{card}] vgg16 step (kernel backend): device "
              f"{prof['device_ms_per_step']:.3f} ms of {prof['wall_ms_per_step']:.3f} ms "
              f"wall (busy {prof['busy_share']:.2f}); circconv kernels "
              f"{prof['circconv_ms_per_step']:.4f} ms ({prof['circconv_share']:.4f})",
              flush=True)
        for r in prof["top"]:
            print(f"  {r['ms_per_step']:.4f} ms x{r['calls_per_step']}  {r['name']}")
    for r in (rk, rg, rq):
        print(f"time [{card}] serve {SERVE_ARCH} kv_read={r['kv_read']} "
              f"{r['requests']}x({SERVE_PROMPT}+{r['max_new']}): "
              f"{r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} generated tok/s, "
              f"mean TTFT {r['mean_ttft_ms']:.1f} ms", flush=True)
    w = serve["window"]
    print(f"time [{card}] serve decode step (8 live slots, float32, kernel "
          f"read): {w['decode_step_ms']:.3f} ms ({w['tokens_per_s_full_batch']:.1f} "
          f"tok/s)", flush=True)
    if w["profile"] is None:
        print(f"profile [{card}] decode window: the profiler saw no device time "
              "(not measured)")
    else:
        wp = w["profile"]
        print(f"profile [{card}] decode window: device {wp['device_ms_per_step']:.3f} "
              f"ms/step, idle {wp['idle_share_vs_unprofiled_step']:.3f} of the "
              f"unprofiled step ({wp['idle_share_profiled']:.3f} profiled); paged "
              f"kernel {wp['paged_kernel_ms_per_step']:.4f} ms/step "
              f"({wp['paged_kernel_share']:.4f} of device time; passes "
              f"{', '.join(f'{k} {v:.4f}' for k, v in wp['paged_pass_ms_per_step'].items())}"
              f" ms/step overlapping); circconv "
              f"{wp['circconv_ms_per_step']:.4f} ms/step; "
              f"{wp['device_ops_per_step']:.0f} device ops/step", flush=True)
        for r in wp["top"]:
            print(f"  {r['ms_per_step']:.4f} ms/step  {r['name']}")
        for r in wp["host_top"]:
            print(f"  host {r['ms_per_step']:.3f} ms/step x{r['calls_per_step']:.0f}"
                  f"  {r['name']}")

    free_cuda()
    lm = lm_training(dev)
    lap("lm_training")
    print_lm(card, lm)
    free_cuda()
    qwen = lm_training(dev, QWEN_ARCH, QWEN_LAYERS, QWEN_SHAPE, QWEN_WIRE_BYTES,
                       ckpt=False)
    lap("lm_training_qwen")
    print_lm(card, qwen)

    replaces = {"bind_superpose": "src/repro/kernels/circconv.py:134",
                "unbind": "src/repro/kernels/circconv.py:157",
                "paged_attention": "src/repro/kernels/paged_attention.py:142",
                "paged_attention_quant": "src/repro/kernels/paged_attention.py:173"}
    csrc = "src/repro_torch/kernels/csrc/"
    # every kernel entry point: (record name, wrapper, circconv route, source)
    entries = [("bind_superpose", "bind_superpose", "fft", "circconv_fft.cu"),
               ("unbind", "unbind", "fft", "circconv_fft.cu"),
               ("bind_superpose_direct", "bind_superpose", "direct", "circconv.cu"),
               ("unbind_direct", "unbind", "direct", "circconv.cu"),
               ("bind_superpose_mixed", "bind_superpose", "fft", "circconv_fft.cu"),
               ("unbind_mixed", "unbind", "fft", "circconv_fft.cu"),
               ("bind_superpose_fft4", "bind_superpose", "fft4", "circconv_fft4.cu"),
               ("unbind_fft4", "unbind", "fft4", "circconv_fft4.cu"),
               ("paged_attention", "paged_attention", None, "paged_attention.cu"),
               ("paged_attention_quant", "paged_attention_quant", None,
                "paged_attention.cu")]
    # at the shapes the record's launches ran: the FFT kernels' from the
    # routed float32 calls at the VGG-16 train step's shape and every
    # control-plane shape, and from the gradients; the direct kernels' from
    # their explicit calls at the train step's shape; the mixed-radix
    # one-pass kernels' at the four serving shapes; the four-step kernels'
    # at the three LM training shapes, against the float64 oracle
    serve_keys = ["{}x{}x{}/float32".format(*sh) for sh in MIXED_SERVE_SHAPES]
    lm_keys = ["{}x{}x{}/float32".format(*sh) for sh in LM_SHAPES]
    cp_keys = ["16x4x2048/float32"] + [f"{G}x{R}x{D}/float32"
                                       for G, R, D in cp_kernel_shapes() if D == 2048]
    main_errs = {"bind_superpose": max([errs["bind_superpose"][k] for k in cp_keys]
                                       + [errs["bind_superpose"]["grad 16x4x2048"]]),
                 "unbind": max([errs["unbind"][k] for k in cp_keys]
                               + [errs["unbind"]["grad 16x4x2048"]]),
                 "bind_superpose_direct":
                     errs["bind_superpose_direct"]["16x4x2048/float32"],
                 "unbind_direct": errs["unbind_direct"]["16x4x2048/float32"],
                 "bind_superpose_mixed": max(errs["bind_superpose_mixed"][k]
                                             for k in serve_keys),
                 "unbind_mixed": max(errs["unbind_mixed"][k] for k in serve_keys),
                 "bind_superpose_fft4": max(errs["bind_superpose_fft4"][k]
                                            for k in lm_keys),
                 "unbind_fft4": max(errs["unbind_fft4"][k] for k in lm_keys),
                 # the serving shape, in the dtype each serving run calls
                 "paged_attention": errs["paged_attention"]["main/float32"],
                 "paged_attention_quant":
                     errs["paged_attention_quant"]["main/bfloat16"]}
    # the circconv kernels' launches in each main-path run, counted by the
    # run and read just after it (record_launches): the one-pass kernels'
    # in the VGG-16 main run and the control plane's, the direct ones' in
    # the main run, the four-step ones' in the two LM training runs
    # (deepseek-7b, qwen2.5-32b), the mixed-radix one-pass ones' over every
    # run; every width these runs take is a power of two or past shared
    # memory, so that sum must be 0
    def counted(name, runs):
        return sum(r["record_launches"].get(name, 0) for r in runs)

    path_runs = [main_run, *other_runs, rk, rg, rq, cp, lm, qwen]
    launches = {name: counted(name, runs) for name, runs in (
        ("bind_superpose", [main_run, cp]), ("unbind", [main_run, cp]),
        ("bind_superpose_direct", [main_run]), ("unbind_direct", [main_run]),
        ("bind_superpose_mixed", path_runs), ("unbind_mixed", path_runs),
        ("bind_superpose_fft4", [lm, qwen]), ("unbind_fft4", [lm, qwen]))}
    check(launches["bind_superpose_mixed"] == launches["unbind_mixed"] == 0,
          f"mixed-radix one-pass launches on the main path: {launches}")
    launches.update({"paged_attention": rk["launches"]["paged_attention"],
                     "paged_attention_quant":
                         rq["launches"]["paged_attention_quant"]})
    vgg = times["16x4x2048"]

    def timing(name, wrapper, kernel_route):
        if kernel_route is None:
            t = ptimes[wrapper]["serving"]
            one = ptimes[wrapper]["one_slot"]
            return {**{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "splits", "share_of_bound",
                                         "ms_host_included")},
                    "one_slot": {k: one[k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "splits",
                        "share_of_bound", "ms_host_included")}}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                "direct_one_call_ms", "key_spectra_ms", "sides")
        if kernel_route == "fft4":
            # this slice's path's shape, the qwen2.5-32b LM step's, and the
            # others beside it
            t = fft4t["{}/{}x{}x{}".format(wrapper, *QWEN_SHAPE)]
            return {**{k: t[k] for k in keys + ("plain_shape",)},
                    "by_shape": {k.split("/")[1]: {k2: v[k2] for k2 in keys}
                                 for k, v in fft4t.items()
                                 if k.startswith(wrapper + "/")}}
        if name.endswith("_mixed"):
            # the prefill chunk at mistral-large-123b's width, and the other
            # serving shapes beside it
            by = {f"{G}x{R}x{D}": times[f"{G}x{R}x{D}"][wrapper]
                  for G, R, D in MIXED_SERVE_SHAPES}
            t = by["128x4x12288"]
            return {**{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "shape", "direct_ms")},
                    "by_shape": {k: {k2: v[k2] for k2 in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "direct_ms")}
                        for k, v in by.items()}}
        t = vgg[wrapper]
        return {"ms": t[f"{kernel_route}_ms"],
                **{k: t[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": replaces[wrapper],
         **({"circconv_route": kernel_route} if kernel_route else {}),
         "launches": launches[name], "max_abs_err": main_errs[name],
         **timing(name, wrapper, kernel_route)}
        for name, wrapper, kernel_route, source in entries]}
    elapsed["total"] = time.perf_counter() - t_start
    print(f"elapsed s: {json.dumps({k: round(v, 1) for k, v in elapsed.items()})}",
          flush=True)

    for r in (rk, rg, rq):
        r["outs"] = {str(k): v for k, v in r["outs"].items()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "build_s": build_s, "elapsed_s": elapsed, "kernel_errors": errs,
        "max_errors": summary, "bf16_readings": BF16_READINGS,
        "step0_parity": parity, "main_run": main_run,
        "other_runs": other_runs, "serving": serve,
        "control_plane": {"parity": cp_par, "run": cp,
                          "masked_decode_bitwise": cp_bits, "table2": cp_t2,
                          "bnpp_resnet50": cp_bn},
        "kernel_times": times, "fft4_times": fft4t, "lm_training": lm,
        "lm_training_qwen": qwen,
        "adjoint_gaps": ADJOINT_GAPS,
        "paged_kernel_times": ptimes, "step_times": steps,
        "step_profile": prof, "record": record},
        indent=1))
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
