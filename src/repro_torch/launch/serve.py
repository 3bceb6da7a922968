"""Batched serving driver: the lockstep decode loop, the continuous-
batching engine with chunked prefill (--engine), or that engine behind the
networked front door (--frontdoor).

Port of ``repro/launch/serve.py`` for what is ported.  Runs on the card
unless ``--device cpu`` is given; weights are random, drawn from
``--seed`` on the device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --reduced --engine --kv-layout paged --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --engine --kv-layout paged --kv-read kernel --batch 8 \\
        --cache-len 512 --requests 16 --prompt-len 128 --max-new 32 \\
        --chunk-size 64 --greedy --codec "c3sl:R=4,backend=pallas"

    # an adaptive codec pinned to one bucket, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --engine --device cpu --codec "adaptive:c3sl:R=4,min_R=1" \
        --pin-R 2

    # an encoder-decoder model, through the lockstep loop (the engine
    # refuses one, as the reference's fails on one)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --reduced --device cpu --codec "c3sl:R=4"

    # speculative decoding (--engine, --greedy): prints a "speculative:
    # k=... acceptance ... wire B/token" line; a link spec's "draft:"
    # segment turns it on too
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --engine --device cpu --greedy --draft-k 4 --draft-head copy

    # the multi-tenant front door (repro_torch.frontdoor) over the engine,
    # until interrupted: prints "front door on host:port", then clients
    # connect with repro_torch.frontdoor.FrontDoorClient (or the
    # reference's: the frames are the same bytes)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --frontdoor --port 0 --device cpu --codec "c3sl:R=4|int8"

``--sanitize`` (``--engine`` and ``--frontdoor``) arms the per-tick
engine invariant checks (``repro_torch.analysis.EngineSanitizer``: pool
accounting, slot hygiene, live-slot cut zeroing); a trip raises out of the
serving loop.  Under ``--frontdoor`` it also installs the event-loop stall
detector and prints its report on stop.  The reference also turns on
``jax_debug_nans``; serving runs no backward, so autograd's anomaly mode,
its counterpart in the port, has nothing to check here::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --engine --kv-layout paged --device cpu \
        --codec "c3sl:R=4|int8" --sanitize
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import codecs, transport
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import lm as lm_lib


def _serving_codec(spec: str, D: int, R: int, batch: int):
    """Build the serving-side codec from a spec.  A per-direction link spec
    (``... >> bwd:...``) keeps the LINK: the engine serves the forward
    channel (no gradient crosses the cut at inference, so the backward
    direction is accounted as 0), and a ``draft:`` segment becomes the
    speculative feedback channel (it turns speculative decoding on)."""
    if transport.is_link_spec(spec):
        link = transport.build_link(spec, D=D, R=R).with_max_R(batch)
        print(f"[serve] link spec {link.spec()!r}: forward channel serves "
              f"(no gradient crosses the cut at inference)"
              + ("; draft channel feeds speculative decode"
                 if link.draft is not None else ""), flush=True)
        return link
    return codecs.clamp_R(codecs.build(spec, D=D, R=R), batch)


def _pin(codec, pin_R):
    """``--pin-R``: fix an adaptive codec's schedule to one bucket."""
    if pin_R is None:
        return
    if not isinstance(codec, codecs.AdaptiveC3SL):
        raise SystemExit("--pin-R needs an 'adaptive:...' --codec spec")
    codec.pin(pin_R)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _spec_config(args):
    """SpecConfig from the --draft-* flags; None when none was given (a
    --codec link spec with a draft: segment still turns speculation on in
    the engine, with the defaults)."""
    from repro_torch.serving.spec import SpecConfig
    if (args.draft_k is None and args.draft_spec is None
            and args.draft_head is None and not args.draft_adaptive):
        return None
    kw = {}
    if args.draft_k is not None:
        kw["k"] = args.draft_k
    if args.draft_spec is not None and args.draft_spec != "none":
        kw["draft"] = args.draft_spec
    if args.draft_head is not None:
        kw["draft_head"] = args.draft_head
    if args.draft_adaptive:
        kw["adaptive"] = True
    return SpecConfig(**kw)


def _prompts(args, vocab: int) -> list:
    """The engine run's random prompts, from ``--seed`` + 1."""
    rng = np.random.RandomState(args.seed + 1)
    return rng.randint(0, vocab, (args.requests, args.prompt_len)).tolist()


def _build_engine(cfg, params, args):
    """The continuous-batching engine the --engine and --frontdoor modes
    serve, from the CLI's flags."""
    from repro_torch.serving.engine import BatchedEngine
    codec = None
    if args.codec != "none":
        codec = _serving_codec(args.codec, cfg.d_model, args.R, args.batch)
    spec_decode = _spec_config(args)
    if spec_decode is not None and not args.greedy:
        raise SystemExit("--draft-* speculative decoding needs --greedy "
                         "(greedy verification is the bit-identity "
                         "guarantee)")
    eng = BatchedEngine(params, cfg, num_slots=args.batch,
                        max_len=args.cache_len, codec=codec,
                        codec_params=(codec.init(torch.Generator().manual_seed(7),
                                                 device=args.device)
                                      if codec is not None else None),
                        greedy=args.greedy, seed=args.seed,
                        prefill_mode=args.prefill_mode,
                        chunk_size=args.chunk_size, sync_every=args.sync_every,
                        kv_layout=args.kv_layout, page_size=args.page_size,
                        num_pages=args.num_pages, interleave=args.interleave,
                        preemption=args.preemption, kv_read=args.kv_read,
                        spec_decode=spec_decode)
    _pin(eng.codec, args.pin_R)
    if args.sanitize:
        from repro_torch.analysis import EngineSanitizer
        eng.attach_sanitizer(EngineSanitizer(eng))
        print("[sanitize] per-tick engine invariant checks armed (pool "
              "accounting, slot hygiene, live-slot cut zeroing)", flush=True)
    return eng


def _run_engine(cfg, params, args):
    """Continuous batching: chunked prefill + device-resident slot state."""
    from repro_torch.serving.engine import Request
    eng = _build_engine(cfg, params, args)
    for u, p in enumerate(_prompts(args, cfg.vocab_size)):
        eng.submit(Request(uid=u, prompt=p, max_new_tokens=args.max_new))
    t0 = time.time()
    done = eng.run()
    _sync(args.device)
    dt = time.time() - t0
    gen = sum(len(r.out) for r in done)
    total = gen + args.requests * args.prompt_len
    print(f"arch={cfg.name} engine mode={args.prefill_mode} "
          f"slots={args.batch} chunk={eng.chunk_size} sync={eng.sync_every} "
          f"kv={args.kv_layout} kv_read={args.kv_read} "
          f"({eng.stats['kv_read_execution_mode']}) interleave={eng.interleave} "
          f"codec={eng.codec.spec() if eng.codec is not None else 'none'} "
          f"device={args.device}")
    if eng.codec is not None:
        line = (f"cut-layer wire: fwd {eng.stats['wire_bytes_fwd']:,d} B + "
                f"bwd {eng.stats['wire_bytes_bwd']:,d} B "
                f"over {eng.stats['decode_steps']} decode steps + "
                f"{eng.stats['prefill_chunks']} prefill chunks")
        if eng.r_served:
            hist = dict(sorted(eng.r_served.items()))
            line += f"; served R schedule {hist} (decode steps + chunks)"
        print(line)
    if eng.spec_cfg is not None:
        s = eng.stats
        tried = s["spec_accepted"] + s["spec_rejected"]
        wpt = eng.wire_per_token()
        print(f"speculative: k={eng._k_ctl.current_k} "
              f"head={eng.spec_cfg.draft_head} "
              f"draft={eng.draft_codec.spec() if eng.draft_codec else 'raw'} "
              f"rounds={s['spec_rounds']} accepted={s['spec_accepted']} "
              f"rejected={s['spec_rejected']} rollbacks={s['spec_rollbacks']} "
              f"(acceptance {s['spec_accepted'] / max(tried, 1):.2f}); "
              f"wire {wpt['wire_bytes_per_token']:.1f} B/token "
              f"(fwd {wpt['wire_bytes_fwd']:,d} + "
              f"draft {wpt['wire_bytes_draft']:,d} B)")
    if eng.paged is not None:
        print(f"paged pool: {eng.paged.num_pages} pages x "
              f"{eng.paged.page_size} positions "
              f"(vs {args.batch * args.cache_len} contiguous positions); "
              f"cache bytes {eng.cache_bytes}")
    ttfts = [r.t_first - r.t_submit for r in done if r.t_first is not None]
    print(f"{len(done)} requests ({args.requests * args.prompt_len} prompt + "
          f"{gen} generated tokens) in {dt:.2f}s ({total / dt:.1f} tok/s); "
          f"mean TTFT {sum(ttfts) / max(len(ttfts), 1) * 1e3:.1f}ms; "
          f"dispatches {eng.stats['dispatches']}")
    print("sample output:", done[0].out[:16])
    if eng._sanitizer is not None:
        san = eng._sanitizer
        print(f"[sanitize] {san.ticks} ticks checked (pool "
              f"{san.counts['pool']}, slot-state {san.counts['slot_state']}, "
              f"cut-zeroing {san.counts['cut_zeroing']})")


def _run_frontdoor(cfg, params, args):
    """Serve the engine over the multi-tenant front door (TCP loopback by
    default) until interrupted.  Clients connect with
    ``repro_torch.frontdoor.FrontDoorClient``, the reference's client, or
    anything speaking the frame protocol (the reference's
    ``src/repro/frontdoor/README.md``)."""
    import asyncio

    from repro_torch.frontdoor import (AdmissionController, FrontDoorServer,
                                       TenantPolicy)
    eng = _build_engine(cfg, params, args)
    server = FrontDoorServer(
        eng, host=args.host, port=args.port,
        admission=AdmissionController(
            max_queue_depth=args.max_queue_depth,
            default_policy=TenantPolicy(max_inflight=args.max_inflight)))

    async def serve():
        detector = None
        if args.sanitize:
            from repro_torch.analysis import SlowCallbackDetector
            detector = SlowCallbackDetector().install()
        host, port = await server.start()
        spec = eng.codec.spec() if eng.codec is not None else "none"
        print(f"[serve] front door on {host}:{port} arch={cfg.name} "
              f"slots={args.batch} kv={args.kv_layout} codec={spec} "
              f"preemption={args.preemption} device={args.device} "
              "(ctrl-c to stop)", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            if detector is not None:
                await detector.stop()
                print(f"[sanitize] {detector.report()}", flush=True)
            await server.stop(drain=False)

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    print(f"[serve] front door stopped; engine stats: "
          f"dispatches={eng.stats['dispatches']} "
          f"evictions={eng.stats['evictions']} "
          f"wire fwd {eng.stats['wire_bytes_fwd']:,d} B", flush=True)


def _run_lockstep(cfg, params, args):
    """Every slot decodes in lockstep from one random token (contiguous
    cache, one host sync per step for the sampled token)."""
    codec = codec_params = None
    if args.codec != "none":
        codec = _serving_codec(args.codec, cfg.d_model, args.R, args.batch)
        codec_params = codec.init(torch.Generator().manual_seed(7),
                                  device=args.device)
        if isinstance(codec, transport.SplitLink):
            codec, codec_params = codec.serving_codec(codec_params)
    _pin(codec, args.pin_R)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    fe = None
    if cfg.frontend:
        # random frames for the modality frontend (an encoder-decoder
        # model's encoder reads them; a VLM is served text-only and ignores
        # them, as in the reference)
        fe = torch.randn((args.batch, cfg.frontend_seq, cfg.frontend_dim),
                         generator=gen, device=args.device)
    cache = lm_lib.init_decode_cache(params, cfg, args.batch, args.cache_len,
                                     frontend_emb=fe)

    def make_step(step_codec, step_codec_params):
        # one step per (bucket) codec; the adaptive wrapper itself never
        # goes into a step: the bucket is picked on the host
        def step(cache, tokens, t):
            logits, cache = lm_lib.decode_step(
                params, cache, tokens, t, cfg, codec=step_codec,
                codec_params=step_codec_params)
            if args.greedy:
                nxt = torch.argmax(logits[:, -1], dim=-1)
            else:
                probs = torch.softmax(logits[:, -1].float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            return nxt[:, None], cache
        return step

    step_fns = codecs.build_program_table(codec, codec_params, make_step)
    rng = np.random.RandomState(args.seed + 1)
    tokens = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (args.batch, 1))).to(args.device)
    t0 = time.time()
    outs = [tokens]
    wire_total = 0
    for t in range(args.steps):
        key = codecs.program_key(codec)
        tokens, cache = step_fns[key](cache, tokens, t)
        if codec is not None:
            step_codec = codec.buckets[key] if key is not None else codec
            wire_total += codecs.payload_wire_bytes(
                step_codec, step_codec.payload_shape(args.batch))
        outs.append(tokens)
    _sync(args.device)
    dt = time.time() - t0
    seq = torch.cat(outs, dim=1)
    print(f"arch={cfg.name} batch={args.batch} steps={args.steps} "
          f"codec={codec.spec() if codec is not None else 'none'} "
          f"R={getattr(codec, 'R', 1)} device={args.device}")
    print(f"decoded {args.steps} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s total)")
    print("sample token ids:", seq[0, :16].tolist())
    if codec is not None:
        base = args.steps * args.batch * cfg.d_model * 4
        print(f"cut-layer wire bytes: {wire_total} over {args.steps} steps "
              f"vs vanilla {base} ({base / max(wire_total, 1):.1f}x compression)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--codec", default="none",
                    help="registry spec, e.g. 'c3sl:R=4|int8', "
                         "'c3sl:R=4,backend=pallas' (the CUDA kernels), "
                         "'adaptive:c3sl:R=8,min_R=2|int8', or a link spec "
                         "'c3sl:R=4|int8 >> bwd:c3sl:R=2' (serving uses the "
                         "forward channel)")
    ap.add_argument("--R", type=int, default=4,
                    help="default R for specs that omit it")
    ap.add_argument("--pin-R", type=int, default=None,
                    help="pin an adaptive codec's schedule to one bucket "
                         "(serving has no SNR probe in the step; R is driven "
                         "externally via engine.observe_snr or pinned)")
    ap.add_argument("--quant-kv", action="store_true",
                    help="int8 KV cache (2x less cache memory than bf16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine (chunked prefill + "
                         "device-resident slot state) instead of the "
                         "lockstep decode loop")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--prefill-mode", choices=["chunked", "decode"],
                    default="chunked",
                    help="'decode' = the legacy prefill-as-decode baseline")
    ap.add_argument("--kv-layout", choices=["contiguous", "paged"],
                    default="contiguous",
                    help="'paged' = shared page pool + per-slot page tables")
    ap.add_argument("--kv-read", choices=["gather", "kernel"], default="gather",
                    help="paged decode reads: 'gather' (contiguous view) or "
                         "'kernel' (the CUDA paged-attention kernel)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache positions per page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical pages in the pool (default: fully "
                         "provisioned = slots * ceil(max_len/page_size))")
    ap.add_argument("--interleave", type=int, default=0,
                    help="decode steps interleaved after each prefill chunk "
                         "(0 = prefill admitted prompts to completion)")
    ap.add_argument("--draft-k", type=int, default=None,
                    help="speculative decoding: positions per verify round "
                         "(1 input + k-1 drafts; --engine or --frontdoor, "
                         "needs --greedy)")
    ap.add_argument("--draft-spec", default=None,
                    help="draft feedback channel codec spec, e.g. "
                         "'c3sl:R=8|int8' ('none' = raw float32 feedback); "
                         "overrides a --codec link spec's 'draft:' segment")
    ap.add_argument("--draft-head", choices=["tied", "copy"], default=None,
                    help="client-side draft proposer: 'tied' (tied-embedding "
                         "head over the fed-back cut feature) or 'copy' "
                         "(repeat last token, zero feedback bytes)")
    ap.add_argument("--draft-adaptive", action="store_true",
                    help="adapt k from the measured acceptance rate "
                         "(EMA deadband over the {1,2,4,8} ladder)")
    ap.add_argument("--preemption", action="store_true",
                    help="evict lower-priority slots (pages freed, request "
                         "re-queued for re-prefill) instead of FIFO-blocking "
                         "when the queue head cannot be admitted (chunked "
                         "prefill only)")
    ap.add_argument("--frontdoor", action="store_true",
                    help="serve the engine over the multi-tenant TCP front "
                         "door (repro_torch.frontdoor) instead of running a "
                         "local request batch")
    ap.add_argument("--host", default="127.0.0.1",
                    help="front door bind address")
    ap.add_argument("--port", type=int, default=8787,
                    help="front door port (0 = ephemeral)")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="per-tenant in-flight request cap (front door)")
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="server-wide backlog cap before BUSY shedding "
                         "(front door)")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizer tier (repro_torch.analysis): "
                         "per-tick engine invariant checks (--engine/"
                         "--frontdoor; a trip raises out of the serving "
                         "loop) and event-loop stall diagnostics on the "
                         "front door")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.quant_kv:
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    params = lm_lib.init_lm_params(args.seed, cfg, device=args.device)
    if args.frontdoor:
        _run_frontdoor(cfg, params, args)
    elif args.engine:
        _run_engine(cfg, params, args)
    else:
        _run_lockstep(cfg, params, args)


if __name__ == "__main__":
    main()
