"""Training driver for the causal LM with the C3-SL codec at the cut.

Port of ``repro/launch/train.py``'s single-program loop (``run_standard``):
the same flags, step and log lines, plus ``--device`` (default ``cuda``;
weights are random, drawn from ``--seed`` on the device).

    # reduced config on the CPU, the int8 wire format behind the HRR codec
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \\
        --device cpu --codec "c3sl:R=4|int8"

    # Adaptive-R over a bucket ladder: one step callable per bucket, made
    # once; the loop logs the served R and the wire bytes
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 8 \\
        --device cpu --codec "adaptive:c3sl:R=16,min_R=2,target_snr=-6|int8"

    # full width on the card through the circconv kernels (D = 128 * 4096)
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --steps 3 --batch 16 --seq 128 --codec "c3sl:R=4,backend=pallas"

    # any of the ten registered archs trains: MoE + MLA, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \\
        --arch deepseek-v2-lite-16b --device cpu --codec "c3sl:R=4"

A model with a modality frontend gets the reference driver's stub batch:
zero embeddings (B, frontend_seq, frontend_dim) under "frontend", on the
run's device, unless the caller passes its own to ``run_standard``.  (The
zero stub makes every encoder row identical, so each LayerNorm divides by
sqrt(eps) in the backward: past about 8 encoder layers the gradients
overflow float32, in the reference as here.)

The step updates params and the optimizer state in place (the reference
returns new trees; the numbers are the same), so a full-width step holds
four copies of the params (params, gradients, two moments) and not eight.

Not ported yet: the 2-stage pod pipeline (``--pipeline``) and the
sanitizer tier (``--sanitize``), ROADMAP.md slice 7.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import codecs, transport
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticTokenDataset, make_batch_iterator
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import lm as lm_lib
from repro_torch.optim import adamw, clip_by_global_norm_

CODEC_SEED = 7   # the reference inits every codec from PRNGKey(7)


def make_codec(spec: str, D: int, *, R: int = 4, quant=None, unitary=False,
               max_R: int | None = None, device="cuda"):
    """Build (codec-or-link, params) from a registry spec string.

    ``spec == "none"`` means no codec at all.  A ``... >> bwd:...`` spec
    builds a per-direction ``repro_torch.transport.SplitLink``.  The legacy
    --R/--quant/--unitary flags act as defaults for spec-omitted fields
    (explicit spec args win; --quant 8 appends the int8 wire stage to plain
    specs).  Params come from a CPU generator seeded ``CODEC_SEED``.
    """
    if spec in (None, "", "none"):
        return None, None
    codec = transport.build_link_or_codec(spec, quant_bits=quant, D=D, R=R,
                                          unitary=unitary)
    if max_R is not None:
        codec = codecs.clamp_R(codec, max_R)
    return codec, codec.init(torch.Generator().manual_seed(CODEC_SEED),
                             device=device)


def make_train_step(cfg, opt, codec, codec_params):
    """One train step for ONE static codec or link and its params (None:
    no codec).  Under Adaptive-R it is made once per (R_fwd, R_bwd) bucket
    pair (``transport.build_link_program_table``).

    ``step(params, opt_state, batch, probe, erasure=None) -> (params,
    opt_state, loss, gnorm, cut_snr, bwd_snr)``: the loss and the
    gradients of ``lm_loss`` with respect to the params and the probe (the
    gradient-retrieval SNR of an asymmetric link; 0 otherwise), the
    global-norm clip at 1.0 and the optimizer's ``update_``, in place on
    ``params`` and ``opt_state``, which it returns.  ``erasure`` is the
    link's keep masks on the device, or None.  No host sync."""
    def step(params, opt_state, batch, probe, erasure=None):
        train = tree_map(lambda t: t.detach().requires_grad_(), params)
        pr = probe.detach().requires_grad_()
        loss, metrics = lm_lib.lm_loss(train, batch, cfg, codec=codec,
                                       codec_params=codec_params,
                                       with_metrics=True, bwd_probe=pr,
                                       erasure=erasure)
        leaves = tree_leaves(train)
        got = torch.autograd.grad(loss, leaves + [pr], allow_unused=True)
        if any(g is None for g in got[:-1]):
            raise RuntimeError("a param leaf is not on the loss's graph")
        bwd_snr = torch.zeros_like(probe) if got[-1] is None else got[-1]
        grads = tree_unflatten(params, got[:-1])
        del train, leaves, got
        gn = clip_by_global_norm_(grads, 1.0)
        opt.update_(grads, opt_state, params)
        snr = metrics.get("cut_snr")
        return (params, opt_state, loss.detach(), gn,
                None if snr is None else snr.detach(), bwd_snr)
    return step


def _to_device(erasure, device):
    if erasure is None:
        return None
    return {k: torch.from_numpy(v).to(device) for k, v in erasure.items()}


def run_standard(args, cfg, *, params=None, codec_params=None, out=None,
                 frontend=None):
    """The single-program training loop.  Returns the per-step losses.

    ``params`` and ``codec_params`` replace the seeded inits (the tests
    start both packages from the same weights and keys), ``frontend`` the
    zero frontend batch.  A dict ``out``
    receives the final ``params`` and ``opt_state``, the step table and the
    codec, for a caller that goes on from there."""
    if getattr(args, "sanitize", False):
        raise NotImplementedError("--sanitize is not ported yet: it comes "
                                  "with ROADMAP.md slice 7")
    device = args.device
    if params is None:
        params = lm_lib.init_lm_params(args.seed, cfg, device=device)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    # R clamps to the batch BEFORE init: batch-wise grouping needs R | batch
    codec, made = make_codec(args.codec, args.seq * cfg.d_model, R=args.R,
                             quant=args.quant, unitary=args.unitary,
                             max_R=args.batch, device=device)
    if codec_params is None:
        codec_params = made
    link = codec if isinstance(codec, transport.SplitLink) else None
    adaptive = isinstance(codec, codecs.AdaptiveC3SL)
    adaptive_bwd = link is not None and link.bwd.adaptive

    # seeded fault injection on the cut link: a FaultPlan draws per-step
    # packet loss, the RecoveryPolicy decides erasure decode vs retransmit
    fault_link = None
    if args.fault_drop > 0.0 or args.fault_corrupt > 0.0:
        if codec is None:
            raise SystemExit("--fault-drop/--fault-corrupt need a boundary "
                             "codec (--codec): a raw split has no payload "
                             "to lose")
        plan = transport.FaultPlan(
            seed=args.fault_seed,
            rates={"drop": args.fault_drop, "corrupt": args.fault_corrupt})
        fault_link = link if link is not None else transport.as_link(codec)
        fault_link.install_faults(
            plan, transport.RecoveryPolicy(mode=args.fault_mode))
        print(f"[faults] installed on the cut link: drop={args.fault_drop} "
              f"corrupt={args.fault_corrupt} seed={args.fault_seed} "
              f"recovery={args.fault_mode}", flush=True)

    step_fns = transport.build_link_program_table(
        codec, codec_params, lambda c, p: make_train_step(cfg, opt, c, p))

    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=args.seed)
    it = make_batch_iterator(data, args.batch, device=device)
    t0 = time.time()
    losses = []
    wire_fwd_total = wire_bwd_total = 0
    fault_skipped = 0
    probe0 = torch.zeros((), dtype=torch.float32, device=device)
    if cfg.frontend and frontend is None:
        frontend = torch.zeros((args.batch, cfg.frontend_seq, cfg.frontend_dim),
                               device=device)
    tokens_per_step = args.batch * args.seq
    step_flops = 6.0 * cfg.active_param_count() * tokens_per_step
    for step in range(args.steps):
        batch = next(it)
        if frontend is not None:
            batch["frontend"] = frontend
        erasure = fault_info = None
        if fault_link is not None:
            try:
                erasure, fault_info = fault_link.next_erasure(args.batch)
            except transport.ChannelErasure as e:
                # unrecoverable under the policy's retry budget: skip it
                # rather than train on garbage
                fault_skipped += 1
                print(f"step {step:5d} SKIPPED (unrecoverable): {e}",
                      flush=True)
                continue
        key = transport.link_program_key(codec)
        params, opt_state, loss, gn, snr, bwd_snr = step_fns[key](
            params, opt_state, batch, probe0, _to_device(erasure, device))
        losses.append(loss)       # device value; one sync after the loop
        # the bytes this step put on the boundary, per direction
        if codec is None:
            wf = wb = 0
        elif link is not None:
            wf = link.wire_bytes_fwd(args.batch)
            wb = link.wire_bytes_bwd(args.batch)
        else:
            step_codec = codec.buckets[key] if adaptive else codec
            wf = wb = step_codec.wire_bytes(args.batch)
        if fault_info is not None:
            # retransmissions inflate the actual wire traffic
            if fault_info.get("fwd"):
                wf = int(round(wf * fault_info["fwd"]["wire_mult"]))  # lint-ok: R3 host ints from the fault schedule, no device value
            if fault_info.get("bwd"):
                wb = int(round(wb * fault_info["bwd"]["wire_mult"]))  # lint-ok: R3 host ints from the fault schedule, no device value
        wire_fwd_total += wf
        wire_bwd_total += wb
        # the adaptive controllers are host-side: they see this step's SNR
        # before the next dispatch
        if link is not None:
            link.observe(fwd_snr=float(snr) if snr is not None else None,  # lint-ok: R3 adaptive controller is host-side by design: it must see this step's SNR before the next dispatch
                         bwd_snr=(float(bwd_snr) if adaptive_bwd else None))  # lint-ok: R3 adaptive controller is host-side by design
        elif adaptive:
            codec.observe(float(snr))      # EMA + ladder walk for NEXT step  # lint-ok: R3 adaptive controller is host-side by design
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tps = tokens_per_step * (step + 1) / dt
            sched = ""
            if codec is not None:
                sched = f" wire fwd {wf:,d}B + bwd {wb:,d}B /step"
                if link is not None:
                    # static channels keep a constant R; adaptive ones show
                    # the bucket that SERVED this step (the dispatch key)
                    rf = key[0] if key[0] is not None \
                        else getattr(link.fwd.codec, "R", 1)
                    rb = key[1] if key[1] is not None \
                        else getattr(link.bwd.codec, "R", 1)
                    sched = (f" R={rf}>>bwd:{rb}"
                             f" snr {float(snr):.1f}dB"  # lint-ok: R3 log-gated (log_every cadence)
                             f" grad-snr {float(bwd_snr):.1f}dB" + sched)  # lint-ok: R3 log-gated (log_every cadence)
                elif adaptive:
                    sched = (f" R={key} snr {float(snr):.1f}dB "  # lint-ok: R3 log-gated (log_every cadence)
                             f"(ema {codec.ema_snr:.1f})" + sched)
                elif snr is not None:
                    sched = f" snr {float(snr):.1f}dB" + sched  # lint-ok: R3 log-gated (log_every cadence)
                if fault_info is not None and fault_info.get("fwd"):
                    fi = fault_info["fwd"]
                    sched += (f" [erased {fi['erased_frac']:.0%} "
                              f"x{fi['wire_mult']:.2f} wire]")
            print(f"step {step:5d} loss {float(loss):.4f} gnorm {float(gn):.3f}"  # lint-ok: R3 log-gated (log_every cadence)
                  f"{sched} | {tps:,.0f} tok/s, "
                  f"{step_flops*(step+1)/dt/1e9:.1f} "
                  f"GFLOP/s model-flops ({dt:.1f}s)", flush=True)
    # one deferred device->host sync for the whole run
    losses = [float(l) for l in losses]
    if codec is not None:
        print(f"boundary traffic: {wire_fwd_total:,d} B fwd + "
              f"{wire_bwd_total:,d} B bwd = "
              f"{wire_fwd_total + wire_bwd_total:,d} B total over "
              f"{args.steps} steps", flush=True)
    if fault_link is not None:
        print(f"[faults] {fault_skipped} of {args.steps} steps skipped as "
              f"unrecoverable", flush=True)
        if not losses:
            raise SystemExit("[faults] every step was unrecoverable — "
                             "raise the retry budget or lower the rates")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, {"params": params},
                        {"arch": cfg.name, "loss": losses[-1]})
    if out is not None:
        out.update(params=params, opt_state=opt_state, step_fns=step_fns,
                   codec=codec, codec_params=codec_params)
    return losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec", default="none",
                    help="registry spec, e.g. 'c3sl:R=4|int8', "
                         "'adaptive:c3sl:R=16,min_R=2,target_snr=-6|int8', "
                         "or a per-direction link "
                         "'c3sl:R=8|int8 >> bwd:c3sl:R=4|int8' "
                         "(see repro_torch.codecs / repro_torch.transport)")
    ap.add_argument("--R", type=int, default=4,
                    help="default R for specs that omit it")
    ap.add_argument("--quant", type=int, default=None,
                    help="8 appends the int8 wire stage to the spec")
    ap.add_argument("--unitary", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="not ported yet (ROADMAP.md slice 7)")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pipeline only: not ported yet (ROADMAP.md slice 7)")
    ap.add_argument("--async-depth", type=int, default=1,
                    help="pipeline only: not ported yet (ROADMAP.md slice 7)")
    ap.add_argument("--fault-drop", type=float, default=0.0,
                    help="seeded per-packet drop rate on the cut payload "
                         "(repro_torch.faults.FaultPlan; 0 = clean)")
    ap.add_argument("--fault-corrupt", type=float, default=0.0,
                    help="seeded per-packet corruption rate on the cut "
                         "payload (corrupt packets are discarded = erased)")
    ap.add_argument("--fault-seed", type=int, default=7,
                    help="FaultPlan seed (the whole chaos run is replayable)")
    ap.add_argument("--fault-mode", choices=["erasure", "retransmit"],
                    default="erasure",
                    help="lossy-step recovery: 'erasure' decodes through "
                         "the renormalized mask, 'retransmit' NACKs until "
                         "complete and pays the wire bytes")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--sanitize", action="store_true",
                    help="not ported yet (ROADMAP.md slice 7)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device the run is on ('cuda' or 'cpu')")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.pipeline:
        raise NotImplementedError("--pipeline (the 2-stage pod pipeline) is "
                                  "not ported yet: it comes with ROADMAP.md "
                                  "slice 7")
    for flag, default in (("microbatches", 4), ("async_depth", 1)):
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} only sets the 2-stage pod "
                f"pipeline, which is not ported yet: it comes with "
                f"ROADMAP.md slice 7")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")
    losses = run_standard(args, cfg)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
