#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), builds the hand-written kernels from ``src/`` and
   prints the build time.
2. Kernels against their plain versions on the card (run on float64
   copies of the same values): bind and unbind in float32 (tolerance 1e-5)
   and bfloat16 (5e-2) over the reference's test shapes, the main-path
   shapes and ragged D; the autograd Functions' gradients against autograd
   of the plain version (1e-4); zero key gradient.
3. The main path, with TF32 off for matmuls and cuDNN convolutions: the
   paper's VGG-16/CIFAR-10 split train step at B=64 through
   ``c3sl:R=4,backend=pallas`` with Adam at 1e-4 on the synthetic images.
   Step 0's loss and gradients must match ``backend=direct`` on the same
   weights; then 20 steps with a finite loss and exactly 2 bind and 2
   unbind launches per step; then 3 steps through ``|int8`` and 3 steps of
   ResNet-50/CIFAR-100 (D=4096), counted the same way.
4. Times (CUDA events around runs of back-to-back calls, the median of at
   least 20 runs after warm-up): each kernel at the main-path shapes, its
   plain version, the torch.fft route of the same function (the library
   yardstick), and the whole train step with the kernel backend and with
   the fft backend, in turns; then a ``torch.profiler`` breakdown of the
   step's device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


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


def cuda_ms(fn, warmup=5, calls=10, reps=21) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, divided by ``calls``; the median of ``reps`` such
    runs after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def close(got, want, tol) -> tuple[bool, float]:
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all())
    return ok, float(err.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_checks(dev) -> dict:
    """Each kernel against its plain version on the same values.  The plain
    version runs on float64 copies, so the difference is the kernel's own
    rounding (float32 sums over up to R*D = 16384 terms at D = 4096)."""
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv, ops

    gen = torch.Generator().manual_seed(SEED)
    errs = {"bind_superpose": {}, "unbind": {}}
    for G, R, D in KERNEL_SHAPES:
        K = hrr.generate_keys(gen, R, D, device=dev)
        kext = ops._kext(K)
        k64 = kext.double()
        Z32 = torch.randn((G, R, D), generator=gen).to(dev)
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            Z = Z32.to(dt)
            got = circconv.bind_superpose_kernel(Z, kext)
            want = circconv.bind_superpose_plain(Z.double(), k64)
            torch.cuda.synchronize()
            check(got.dtype == dt and got.shape == (G, D), f"bind {G,R,D} {name}: "
                  f"{got.dtype} {tuple(got.shape)}")
            ok, e = close(got, want, TOL[name])
            check(ok, f"bind kernel != plain at {(G, R, D)} {name}: max err {e}")
            errs["bind_superpose"][f"{G}x{R}x{D}/{name}"] = e
            S = want.to(dt)
            got = circconv.unbind_kernel(S, kext)
            want = circconv.unbind_plain(S.double(), k64)
            torch.cuda.synchronize()
            check(got.dtype == dt and got.shape == (G, R, D), f"unbind {G,R,D} {name}")
            ok, e = close(got, want, TOL[name])
            check(ok, f"unbind kernel != plain at {(G, R, D)} {name}: max err {e}")
            errs["unbind"][f"{G}x{R}x{D}/{name}"] = e

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


# --------------------------------------------------------------------------
# phase 3: the main path
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
    codec = codecs.build(spec, D=cfg.D)
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
    lk, gk = split_value_and_grad(loss_k, params, batch)
    ld, gd = split_value_and_grad(loss_d, params_d, batch)
    torch.cuda.synchronize()
    lk, ld = float(lk), float(ld)
    rel = abs(lk - ld) / abs(ld)
    check(rel <= 1e-4, f"{model} step-0 loss kernel {lk} vs direct {ld}")
    gerr = leaf_rel_err(gk, gd)
    check(gerr <= 1e-3, f"{model} step-0 grads kernel vs direct: {gerr}")
    return {"loss_kernel": lk, "loss_direct": ld, "loss_rel_err": rel,
            "grad_leaf_rel_err": gerr}


def run_steps(model: str, spec: str, steps: int, dev) -> dict:
    """``steps`` train steps from fresh weights, launch counts reset just
    before and read just after."""
    import torch
    from repro_torch.kernels import circconv
    from repro_torch.optim import adam
    from repro_torch.transport.split import make_split_train_step
    cfg, codec, params, loss, data = make_setup(model, spec, dev)
    opt = adam(cfg.lr)
    opt_state = opt.init(params["net"])
    step = make_split_train_step(loss, opt)
    batches = [data.batch(cfg.batch_size, s, device=dev) for s in range(steps)]
    torch.cuda.synchronize()
    circconv.reset_launch_counts()
    losses = []
    for b in batches:
        params, opt_state, l = step(params, opt_state, b)
        losses.append(l)
    torch.cuda.synchronize()
    counts = dict(circconv.LAUNCHES)
    losses = torch.stack(losses).tolist()
    check(all(map(math.isfinite, losses)), f"{model} {spec}: non-finite loss {losses}")
    want = {"bind_superpose": 2 * steps, "unbind": 2 * steps}
    check(counts == want, f"{model} {spec}: launches {counts}, want {want}")
    mode = getattr(codec, "transform", codec).execution_mode(dev)
    check(mode == "cuda-kernel", f"{spec} ran as {mode}, not the CUDA kernel")
    return {"model": model, "spec": codec.spec(), "steps": steps,
            "batch": cfg.batch_size, "losses": losses, "launches": counts}


# --------------------------------------------------------------------------
# phase 4: times
# --------------------------------------------------------------------------

def kernel_times(dev, G=16, R=4, D=2048) -> dict:
    import torch
    from repro_torch.core import hrr
    from repro_torch.kernels import circconv, ops

    gen = torch.Generator().manual_seed(SEED + 1)
    K = hrr.generate_keys(gen, R, D, device=dev)
    KF = hrr.key_spectrum(K)
    kext = ops._kext(K)
    Z = torch.randn((G, R, D), generator=gen).to(dev)
    S = torch.randn((G, D), generator=gen).to(dev)
    # The least work of the function, whatever the algorithm: Z or S, the
    # keys K (R, D) and the output each cross HBM once, and the operations
    # are the FFT form's (rfft of every data row and key, one complex
    # multiply-add per frequency and binding, an irfft per output row; a
    # real transform of length D at 2.5 D log2 D).  The direct O(D^2) form
    # the kernels run (2 G R D^2 FLOPs) is kept beside it as a design figure.
    fft_rows = G * R + G + R
    flops = fft_rows * 2.5 * D * math.log2(D) + G * R * (D // 2 + 1) * 8
    direct_flops = 2 * G * R * D * D
    out = {}
    for name, x, kernel, plain, fft, out_bytes in (
            ("bind_superpose", Z, circconv.bind_superpose_kernel,
             circconv.bind_superpose_plain,
             lambda: hrr._bind_impl(Z, K, KF, "fft"), G * D * 4),
            ("unbind", S, circconv.unbind_kernel, circconv.unbind_plain,
             lambda: hrr._unbind_impl(S, K, KF, "fft"), G * R * D * 4)):
        nbytes = x.numel() * 4 + K.numel() * 4 + out_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_PEAK_FLOPS * 1e3
        out[name] = {
            "shape": [G, R, D],
            "ms": cuda_ms(lambda: kernel(x, kext)),
            "plain_ms": cuda_ms(lambda: plain(x, kext)),
            "library_ms": cuda_ms(fft),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "direct_flops": direct_flops,
            "direct_flops_ms": direct_flops / F32_PEAK_FLOPS * 1e3,
        }
    return out


def vgg_stepper(spec: str, dev):
    """A closure that runs one VGG-16 train step (B=64, R=4) in place."""
    from repro_torch.optim import adam
    from repro_torch.transport.split import make_split_train_step

    cfg, codec, params, loss, data = make_setup("vgg16", spec, dev)
    opt = adam(cfg.lr)
    state = {"p": params, "o": opt.init(params["net"])}
    step = make_split_train_step(loss, opt)
    batch = data.batch(cfg.batch_size, 0, device=dev)

    def one():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)
    return one


def step_times(dev) -> dict:
    """Device time of one VGG-16 train step, kernel backend vs fft backend,
    in turns: kernel, fft, fft, kernel."""
    k = vgg_stepper("c3sl:R=4,backend=pallas", dev)
    f = vgg_stepper("c3sl:R=4,backend=fft", dev)
    runs = {"kernel": [], "fft": []}
    for name, fn in (("kernel", k), ("fft", f), ("fft", f), ("kernel", k)):
        runs[name].append(cuda_ms(fn, warmup=3, calls=4, reps=20))
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
    from torch.autograd import DeviceType
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
    rows = []
    for e in prof.key_averages():
        # device-side events only: an op's own event repeats its kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            rows.append((e.key, e.self_device_time_total / 1e3 / steps,
                         e.count // steps))
    rows.sort(key=lambda r: -r[1])
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

    t0 = time.perf_counter()
    build.load("circconv")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for csrc/circconv.cu", flush=True)
    for line in build.build_logs["circconv"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    errs = kernel_checks(dev)
    summary = {k: max(v.values()) for k, v in errs.items()}
    print("kernels: " + "; ".join(
        f"{k} vs plain max_abs_err f32 "
        f"{max(e for s, e in v.items() if s.endswith('float32')):.3g} "
        f"bf16 {max(e for s, e in v.items() if s.endswith('bfloat16')):.3g} "
        f"grad {max(e for s, e in v.items() if s.startswith('grad')):.3g}"
        for k, v in errs.items()), flush=True)

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

    times = {"D2048": kernel_times(dev, 16, 4, 2048),
             "D4096": kernel_times(dev, 16, 4, 4096)}
    steps = step_times(dev)
    prof = step_profile(dev)
    for shape, per in times.items():
        for name, t in per.items():
            print(f"time [{card}] {name} G,R,D={t['shape']}: kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, torch.fft {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}), direct-form "
                  f"FLOPs at the f32 peak {t['direct_flops_ms']:.4f} ms", flush=True)
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

    replaces = {"bind_superpose": "src/repro/kernels/circconv.py:134",
                "unbind": "src/repro/kernels/circconv.py:157"}
    main_errs = {k: max(v["16x4x2048/float32"], v["grad 16x4x2048"])
                 for k, v in errs.items()}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/circconv.cu",
         "replaces": replaces[name],
         "launches": main_run["launches"][name],
         "max_abs_err": main_errs[name],
         "ms": times["D2048"][name]["ms"],
         "plain_ms": times["D2048"][name]["plain_ms"],
         "bound_ms": times["D2048"][name]["bound_ms"],
         "bound_by": times["D2048"][name]["bound_by"],
         "library_ms": times["D2048"][name]["library_ms"]}
        for name in ("bind_superpose", "unbind")]}

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "build_s": build_s, "kernel_errors": errs, "max_errors": summary,
        "step0_parity": parity, "main_run": main_run, "other_runs": other_runs,
        "kernel_times": times, "step_times": steps, "step_profile": prof,
        "record": record},
        indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
