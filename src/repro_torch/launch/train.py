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

``--pipeline`` trains through the 2-stage pod pipeline
(``run_pipeline``; ``repro_torch.transport.pipeline``): the stack cut in
two stages, ``--microbatches`` microbatches, the codec's payload handed
from the front stage to the back one through a ring of ``--async-depth``
payloads, one autograd graph.  Both stages run on ``--device``::

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --pipeline \\
        --steps 4 --batch 16 --seq 16 --microbatches 2 --async-depth 2 \\
        --codec "c3sl:R=2 >> bwd:c3sl:R=2" --device cpu

``--sanitize`` arms the runtime sanitizer tier
(``repro_torch.analysis.sanitize``) in both loops: autograd's anomaly mode
with its NaN check around each step (the port of ``jax_debug_nans``; on for
the step only, restored after it), the step wrapped in ``finite_outputs``
(the port of checkify: every floating output checked, the first non-finite
one named), and ``TrainSanitizer.check_step`` on the loss and grad norm
after each step.  A trip raises ``SanitizerError`` naming the step::

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \
        --device cpu --codec "c3sl:R=4|int8" --sanitize
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch import codecs, transport
from repro_torch.analysis.sanitize import TrainSanitizer, finite_outputs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticTokenDataset, make_batch_iterator
from repro_torch.interop import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import lm as lm_lib
from repro_torch.optim import adamw, clip_by_global_norm_
from repro_torch.transport import pipeline as pipeline_lib

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


def _apply_grads(flat_grads, params, opt_state, opt):
    """How a train step applies its gradients (``params``' leaf order):
    the global-norm clip at 1.0, then the optimizer's ``update_`` in place
    on ``params`` and ``opt_state``.  Returns the norm before the clip."""
    grads = tree_unflatten(params, list(flat_grads))
    gn = clip_by_global_norm_(grads, 1.0)
    opt.update_(grads, opt_state, params)
    return gn


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
        del train, leaves
        gn = _apply_grads(got[:-1], params, opt_state, opt)
        snr = metrics.get("cut_snr")
        return (params, opt_state, loss.detach(), gn,
                None if snr is None else snr.detach(), bwd_snr)
    return step


def _arm_train_sanitizers(args):
    """The --sanitize tier for the train loops: a ``TrainSanitizer``, whose
    ``step_scope`` holds autograd's anomaly mode around a step, or None
    when sanitize mode is off."""
    if not args.sanitize:
        return None
    print("[sanitize] autograd anomaly mode (check_nan) + finite step "
          "outputs + per-step finite checks armed", flush=True)
    return TrainSanitizer()


def _scope(train_san, step):
    """The step's sanitizer scope (nothing without --sanitize)."""
    return (train_san.step_scope(step) if train_san is not None
            else contextlib.nullcontext())


def _to_device(erasure, device):
    if erasure is None:
        return None
    return {k: torch.from_numpy(v).to(device) for k, v in erasure.items()}  # lint-ok: R3 the fault plan's keep masks, drawn on the host (numpy, the reference's bit for bit) and uploaded once a step, only under --fault-*


def run_standard(args, cfg, *, params=None, codec_params=None, out=None,
                 frontend=None):
    """The single-program training loop.  Returns the per-step losses.

    ``params`` and ``codec_params`` replace the seeded inits (the tests
    start both packages from the same weights and keys), ``frontend`` the
    zero frontend batch.  A dict ``out``
    receives the final ``params`` and ``opt_state``, the step table, the
    codec and the ``TrainSanitizer`` (None without ``--sanitize``), for a
    caller that goes on from there."""
    train_san = _arm_train_sanitizers(args)
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

    def make_step(c, p):
        step = make_train_step(cfg, opt, c, p)
        return step if train_san is None else finite_outputs(step)

    step_fns = transport.build_link_program_table(codec, codec_params,
                                                  make_step)

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
        with _scope(train_san, step):
            params, opt_state, loss, gn, snr, bwd_snr = step_fns[key](
                params, opt_state, batch, probe0, _to_device(erasure, device))
        losses.append(loss)       # device value; one sync after the loop
        if train_san is not None:
            train_san.check_step(step, loss=loss, gnorm=gn)
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
                   codec=codec, codec_params=codec_params,
                   train_sanitizer=train_san)
    return losses


def make_pipeline_step(loss_fn, opt):
    """One train step through the pod pipeline's ``loss_fn``:
    ``step(params, opt_state, batch, keep=None) -> (params, opt_state,
    loss, gnorm)``.  The gradients of every leaf of the pipeline's params
    tree (zeros where a leaf is off the graph, as C3-SL's fixed keys), the
    global-norm clip at 1.0 and the optimizer's ``update_``, in place on
    ``params`` and ``opt_state``.  ``keep`` is the erasure variant's mask
    stack.  No host sync."""
    def step(params, opt_state, batch, keep=None):
        train = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(train, batch) if keep is None else loss_fn(train, batch,
                                                                   keep)
        leaves = tree_leaves(train)
        got = torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True)
        del train, leaves
        gn = _apply_grads(got, params, opt_state, opt)
        return params, opt_state, loss.detach(), gn
    return step


def pipeline_params(full, codec_params):
    """The pipeline's params tree from the LM's (``init_lm_params``):
    ``{"embed", "blocks" (the stack as views with a leading stage axis of
    2), "head", "codec"}``."""
    return {"embed": {"embed": full["embed"]},
            "blocks": lm_lib.split_stack_for_pipeline(full["stack"]),
            "head": {"final_norm": full["final_norm"], "head": full["head"]},
            "codec": codec_params}


def run_pipeline(args, cfg, *, params=None, codec_params=None, out=None):
    """The 2-stage pod pipeline with the compressed channel.  Returns the
    per-step losses.

    Port of the reference's ``run_pipeline``: R clamped to the microbatch,
    the identity codec where the spec is ``none``, an adaptive link or
    codec pinned at its current bucket, the params tree ``{"embed",
    "blocks" (leading stage axis 2), "head", "codec"}``, AdamW over all of
    it, the same log lines.  Unlike the reference it asks for no even
    device count: both stages go on ``args.device``.  ``params`` (the LM's
    own tree, ``init_lm_params``) and ``codec_params`` replace the seeded
    inits; a dict ``out`` receives the final ``params`` and ``opt_state``,
    the step, the loss function, the codec and the ``TrainSanitizer``."""
    train_san = _arm_train_sanitizers(args)
    device = args.device
    full = params if params is not None else lm_lib.init_lm_params(
        args.seed, cfg, device=device)
    # R is clamped to the microbatch size BEFORE init so the key shapes match
    mb = args.batch // args.microbatches
    codec, made = make_codec(args.codec, args.seq * cfg.d_model, R=args.R,
                             quant=args.quant, unitary=args.unitary, max_R=mb,
                             device=device)
    if codec is None:
        codec, made = codecs.build("identity", D=args.seq * cfg.d_model), {}
    if codec_params is None:
        codec_params = made
    if isinstance(codec, transport.SplitLink):
        if codec.fwd.adaptive or codec.bwd.adaptive:
            # the pipeline's loss closes over ONE codec pair: pin both
            # channels at their current buckets
            print(f"[pipeline] adaptive link pinned at "
                  f"R={codec.fwd.current_R}>>bwd:{codec.bwd.current_R} "
                  f"(per-step adaptation needs the single-program path)",
                  flush=True)
            codec_params = transport.slice_link_params(codec, codec_params)
            codec = transport.pin_link(codec)
    elif isinstance(codec, codecs.AdaptiveC3SL):
        print(f"[pipeline] adaptive codec pinned to its current bucket "
              f"R={codec.current_R} (per-step adaptation needs the "
              f"single-program path)", flush=True)
        codec_params = codec.params_for(codec_params)
        codec = codec.current

    params = pipeline_params(full, codec_params)
    loss_fn = pipeline_lib.make_pod_pipeline_loss_fn(
        *lm_lib.make_pipeline_fns(cfg), codec,
        num_microbatches=args.microbatches, async_depth=args.async_depth)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    step_fn = make_pipeline_step(loss_fn, opt)
    if train_san is not None:
        step_fn = finite_outputs(step_fn)

    data = SyntheticTokenDataset(cfg.vocab_size, args.seq, seed=args.seed)
    it = make_batch_iterator(data, args.batch, device=device)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        b = next(it)
        batch = {"x": b["tokens"], "y": b["labels"]}
        with _scope(train_san, step):
            params, opt_state, loss, gn = step_fn(params, opt_state, batch)
        losses.append(loss)   # device value; one sync after the loop
        if train_san is not None:
            train_san.check_step(step, loss=loss, gnorm=gn)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[pipeline] step {step:5d} loss {float(loss):.4f} "  # lint-ok: R3 log-gated (log_every cadence)
                  f"({time.time()-t0:.1f}s)", flush=True)
    losses = [float(l) for l in losses]   # one deferred sync for the run
    wf = transport.split_comm_bytes(codec, mb, directions=1)
    wb = transport.split_comm_bytes(codec, mb) - wf
    print(f"[pipeline] channel: async_depth={args.async_depth}, per-microbatch "
          f"wire fwd {wf:,d} B + bwd {wb:,d} B", flush=True)
    if out is not None:
        out.update(params=params, opt_state=opt_state, step=step_fn,
                   loss_fn=loss_fn, codec=codec, train_sanitizer=train_san)
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
                    help="train through the 2-stage pod pipeline "
                         "(repro_torch.transport.pipeline): both stages on "
                         "--device, the payload handed across the boundary")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pipeline only: microbatches a step (R is clamped "
                         "to the microbatch)")
    ap.add_argument("--async-depth", type=int, default=1,
                    help="pipeline only: in-flight payloads on the stage "
                         "channel: 1 = synchronous, 2 = the back stage "
                         "consumes the payload sent two steps earlier (one "
                         "extra bubble step; one stream, so only the order "
                         "of the enqueued work changes)")
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
                    help="runtime sanitizer tier (repro_torch.analysis."
                         "sanitize): autograd anomaly mode with its NaN "
                         "check around each step, every floating step "
                         "output checked, and per-step loss/grad-norm "
                         "finite checks (syncs every step)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device the run is on ('cuda' or 'cpu')")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.pipeline and (args.fault_drop > 0.0 or args.fault_corrupt > 0.0):
        raise SystemExit("fault injection drives the standard loop; the "
                         "pipeline path takes erasure masks through "
                         "make_pod_pipeline_loss_fn(with_erasure=True) "
                         "(see tests/test_faults.py)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")
    if args.pipeline:
        losses = run_pipeline(args, cfg)
    else:
        losses = run_standard(args, cfg)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
