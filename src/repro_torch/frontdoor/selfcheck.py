"""Front-door loopback selfcheck — the CI ``frontdoor-smoke`` job.

Port of ``repro/frontdoor/selfcheck.py``: the same runs over the port's
server, client and engine, on the card unless ``--device cpu`` is given.
``--sanitize`` arms the runtime sanitizer tier on every engine of the run
(``repro_torch.analysis``: per-tick invariant checks at ``sync_every=2``,
whose trip ends the run nonzero, and the event-loop stall detector), and
requires the live-slot cut-zeroing check to have run; the plain, chaos and
spec runs all take it.

One process: a tiny-model engine behind a :class:`FrontDoorServer` on an
ephemeral loopback port, three tenants (one speaking the engine's full
ADAPTIVE spec, two pinned to a compatible R bucket), each streaming a few
requests through the BUSY-retry path.  Asserts every result is
well-formed, the per-tenant STATS are non-empty for all three tenants,
and the shutdown is clean (BYE handshakes, drained engine, stopped
listener).  Any failed tenant exits NONZERO.

``--chaos`` runs the fault-injected variant (the CI ``chaos-smoke``
job): three tenants run SEQUENTIALLY — one request in flight at a time,
so slot occupancy (and with it the batch-wise codec's cross-talk) is
schedule-independent — first fault-free to record the reference tokens,
then again under a seeded :class:`~repro_torch.faults.FaultPlan` that drops
and corrupts frames in both directions and forces one disconnect per
direction (exercising NACK/retransmit, heartbeat gap detection, and
reconnect-with-resume).  The chaos run must complete every request with
tokens BIT-IDENTICAL to the fault-free reference.  The chaos engine
serves a STATIC bucket spec: what is being pinned is transport
determinism (recovered frames and resumed sessions decode the exact same
tokens), and an adaptive controller would break the comparison for the
wrong reason — its R schedule is deliberately sensitive to the extra
re-prefill steps a disconnect induces, so schedule drift under faults is
expected behavior, not a transport bug.

    PYTHONPATH=src python -m repro_torch.frontdoor.selfcheck [--requests N] \
        [--chaos | --spec-decode] [--sanitize] [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import sys

import numpy as np

from repro_torch.configs.base import get_config, reduced
from repro_torch.faults import FaultPlan
from repro_torch.frontdoor.admission import AdmissionController, TenantPolicy
from repro_torch.frontdoor.client import FrontDoorClient
from repro_torch.frontdoor.server import FrontDoorServer
from repro_torch.models import lm as lm_lib
from repro_torch.serving.engine import BatchedEngine

ENGINE_SPEC = "adaptive:c3sl:R=4,min_R=2|int8"
BUCKET_SPEC = "c3sl:R=2|int8"

TENANTS = [("tenant-adaptive", ENGINE_SPEC),
           ("tenant-bucket-1", BUCKET_SPEC),
           ("tenant-bucket-2", BUCKET_SPEC)]

# the chaos variant pins transport determinism on a static bucket engine
# (see the module docstring); every tenant speaks the engine's spec
CHAOS_TENANTS = [("tenant-a", BUCKET_SPEC), ("tenant-b", BUCKET_SPEC),
                 ("tenant-c", BUCKET_SPEC)]


#: draft-channel spec for the --spec-decode run: batch-wise like the cut
#: codec, int8 on the wire — the cheap server->client feedback channel
SPEC_DRAFT = "c3sl:R=2|int8"


def build_engine(num_slots: int = 4, max_len: int = 64,
                 spec: str = ENGINE_SPEC,
                 sync_every: int = 8, spec_decode=None,
                 device: str = "cuda") -> BatchedEngine:
    cfg = reduced(get_config("deepseek-7b"), num_layers=2, d_model=128,
                  d_ff=256, vocab_size=256, num_heads=4, num_kv_heads=2,
                  head_dim=32)
    params = lm_lib.init_lm_params(0, cfg, device=device)
    return BatchedEngine(params, cfg, num_slots=num_slots, max_len=max_len,
                         codec=spec, greedy=True, seed=0,
                         kv_layout="paged", page_size=8,
                         num_pages=num_slots * (max_len // 8),
                         sync_every=sync_every, preemption=True,
                         spec_decode=spec_decode)


def chaos_plan() -> FaultPlan:
    """The seeded chaos schedule: frame drops + corruption both ways, one
    forced disconnect per direction (c2s seq 2 fires during a SUBMIT —
    reconnect + idempotent re-SUBMIT; s2c seq 3 fires around a RESULT —
    park + flush-on-resume)."""
    return FaultPlan(seed=7,
                     rates={"drop": 0.08, "corrupt": 0.04},
                     schedule={"c2s": {2: "disconnect"},
                               "s2c": {3: "disconnect"}})


async def _tenant(host, port, tenant, codec, requests, vocab, seed,
                  faults=None, draft=None, prompt_len=None, max_new=4):
    """``requests`` generates, one at a time, of ``prompt_len`` tokens
    (None: 4 + 2i for the i-th) and ``max_new`` new ones."""
    client = await FrontDoorClient.open(host, port, tenant=tenant,
                                        codec=codec, draft=draft,
                                        faults=faults)
    rng = np.random.RandomState(seed)
    results = []
    try:
        for i in range(requests):
            n = 4 + 2 * i if prompt_len is None else prompt_len
            prompt = [int(t) for t in rng.randint(1, vocab, n)]
            out = await client.generate(prompt, max_new=max_new)
            assert out["tokens"], f"{tenant} got an empty result"
            assert all(0 <= t < vocab for t in out["tokens"]), out
            # incremental TOKENS frames must preview the final output
            assert out["streamed"] == out["tokens"][:len(out["streamed"])], \
                (tenant, out["streamed"], out["tokens"])
            results.append(out)
        stats = await client.stats()
    finally:
        await client.close()
    return tenant, results, stats


def _arm_sanitizers(eng):
    """Attach the runtime sanitizer tier to a selfcheck engine: per-tick
    invariant checks (a trip raises out of the server's tick loop, which
    cancels every tenant and exits the selfcheck NONZERO via stop()) plus
    the event-loop stall detector (diagnostic only — a first call that
    builds or loads kernels blocks the loop legitimately)."""
    from repro_torch.analysis.sanitize import (EngineSanitizer,
                                               SlowCallbackDetector)
    san = EngineSanitizer(eng)
    eng.attach_sanitizer(san)
    det = SlowCallbackDetector().install()
    return san, det


async def _report_sanitizers(san, det, *, require_cut_checks: bool) -> dict:
    await det.stop()
    print(f"[selfcheck] sanitize: {san.ticks} ticks checked "
          f"(pool {san.counts['pool']}, slot-state "
          f"{san.counts['slot_state']}, cut-zeroing "
          f"{san.counts['cut_zeroing']}); {det.report()}")
    if require_cut_checks:
        assert san.counts["cut_zeroing"] > 0, (
            "the live-slot-zeroing invariant was never exercised — no "
            "tick observed a dead/live slot mix; the sanitize run is "
            "vacuous")
    return {"ticks": san.ticks, "counts": dict(san.counts),
            "stalls": len(det.stalls), "max_lag_s": det.max_lag_s,
            "report": det.report()}


async def amain(requests: int = 3, device: str = "cuda",
                sanitize: bool = False) -> dict:
    eng = build_engine(device=device, sync_every=2 if sanitize else 8)
    san = det = None
    if sanitize:
        san, det = _arm_sanitizers(eng)
    server = FrontDoorServer(
        eng,
        admission=AdmissionController(
            max_queue_depth=16,
            default_policy=TenantPolicy(max_inflight=4)))
    host, port = await server.start()
    print(f"[selfcheck] front door on {host}:{port} "
          f"(engine codec {server.stats()['engine']['codec']!r})")
    outs = await asyncio.gather(*(
        _tenant(host, port, name, codec, requests, eng.cfg.vocab_size, 7 + i)
        for i, (name, codec) in enumerate(TENANTS)),
        return_exceptions=True)
    failed = [(TENANTS[i][0], r) for i, r in enumerate(outs)
              if isinstance(r, BaseException)]
    if failed:
        await server.stop(drain=False)
        for name, err in failed:
            print(f"[selfcheck] FAILED tenant {name}: {err!r}",
                  file=sys.stderr)
        sys.exit(1)
    stats = outs[-1][2]          # last tenant's STATS snapshot
    await server.stop()
    assert server.tick_error is None, server.tick_error
    if sanitize:
        await _report_sanitizers(san, det, require_cut_checks=True)

    for name, results, _ in outs:
        assert len(results) == requests, (name, len(results))
    for name, _ in TENANTS:
        t = stats["tenants"].get(name)
        assert t and t["requests"] >= 1, f"empty stats for {name}: {t}"
        assert t["tokens_out"] > 0 and t["bytes_in"] > 0, t
        assert t["ttft_s"]["count"] >= 1, t
    assert not eng.queue and eng.active == 0, "engine not drained"
    acct = eng.pool_accounting()
    assert acct["free"] == acct["total"], acct
    print(f"[selfcheck] {3 * requests} requests across 3 tenants OK; "
          f"per-tenant stats non-empty; clean shutdown")
    for name, t in stats["tenants"].items():
        ttft = t["ttft_s"]
        print(f"[selfcheck]   {name}: {t['requests']} reqs, "
              f"{t['tokens_out']} tokens, ttft p50 "
              f"{ttft.get('p50', float('nan')) * 1e3:.1f}ms, "
              f"wire {t['bytes_in']}B in / {t['bytes_out']}B out")
    return stats


async def _sequential_run(eng: BatchedEngine, requests: int,
                          faults: FaultPlan | None, draft: str | None = None,
                          codec: str = BUCKET_SPEC, prompt_len=None,
                          max_new: int = 4, sanitize: bool = False):
    """One full sequential pass (every tenant, every request, one at a
    time, each speaking ``codec``) against ``eng``, which must be fresh;
    returns ({tenant: [token lists]} plus the final server stats under
    the "_stats" key, the total streamed-token-preview count under
    "_streamed" and, with ``sanitize``, the sanitizers' report under
    "_sanitize", the stopped server).  With ``sanitize`` the sanitizers
    are armed on ``eng`` here, in the running loop (build it with
    ``sync_every=2``)."""
    san = det = None
    if sanitize:
        san, det = _arm_sanitizers(eng)
    server = FrontDoorServer(
        eng,
        admission=AdmissionController(
            max_queue_depth=16,
            default_policy=TenantPolicy(max_inflight=4)),
        faults=faults,
        heartbeat_s=0.2, max_misses=10, resume_ttl_s=10.0)
    host, port = await server.start()
    tokens: dict = {}
    stats = None
    streamed = 0
    try:
        for i, (name, _) in enumerate(CHAOS_TENANTS):
            name_, results, stats = await _tenant(
                host, port, name, codec, requests, eng.cfg.vocab_size, 7 + i,
                faults=faults, draft=draft, prompt_len=prompt_len,
                max_new=max_new)
            tokens[name_] = [r["tokens"] for r in results]
            streamed += sum(len(r["streamed"]) for r in results)
    finally:
        await server.stop()
    assert server.tick_error is None, server.tick_error
    if sanitize:
        # sequential tenants leave the other slots empty while one
        # decodes, so the cut probe always sees a dead/live mix here
        tokens["_sanitize"] = await _report_sanitizers(
            san, det, require_cut_checks=True)
    assert not eng.queue and eng.active == 0, "engine not drained"
    tokens["_stats"] = stats
    tokens["_streamed"] = streamed
    return tokens, server


async def amain_chaos(requests: int = 3, device: str = "cuda",
                      sanitize: bool = False) -> dict:
    sync = 2 if sanitize else 8
    print("[selfcheck] chaos: recording the fault-free sequential reference")
    ref, _ = await _sequential_run(
        build_engine(spec=BUCKET_SPEC, device=device, sync_every=sync),
        requests, None, sanitize=sanitize)
    plan = chaos_plan()
    print(f"[selfcheck] chaos: replaying under {plan}")
    got, _ = await _sequential_run(
        build_engine(spec=BUCKET_SPEC, device=device, sync_every=sync),
        requests, plan, sanitize=sanitize)
    bad = []
    for name, _ in CHAOS_TENANTS:
        if got[name] != ref[name]:
            bad.append((name, ref[name], got[name]))
    if bad:
        for name, want, have in bad:
            print(f"[selfcheck] CHAOS MISMATCH for {name}:\n"
                  f"  fault-free: {want}\n  chaos:      {have}",
                  file=sys.stderr)
        sys.exit(1)
    stats = got["_stats"]
    recovered = sum(t.get("retransmits", 0) + t.get("nacks", 0)
                    + t.get("resumes", 0)
                    for t in stats["tenants"].values())
    assert recovered > 0, ("chaos run recovered nothing — the fault plan "
                           f"never fired? stats: {stats['tenants']}")
    n = sum(len(got[name]) for name, _ in CHAOS_TENANTS)
    print(f"[selfcheck] chaos: {n} requests bit-identical to the fault-free "
          f"reference through drops/corruption/disconnects "
          f"({recovered} recovery events)")
    return got


async def amain_spec(requests: int = 3, device: str = "cuda",
                     sanitize: bool = False) -> dict:
    """The CI ``spec-smoke`` job: speculative decoding end-to-end over
    the front door.  Sequential tenants (schedule-independent occupancy,
    same reasoning as the chaos run) decode once on a vanilla
    static-bucket engine to record the reference, then again with a
    draft/verify channel at each k — greedy verification must make every
    speculative run BIT-IDENTICAL to the vanilla one, while the engine
    counters prove speculation actually happened (verify rounds ran,
    drafts were accepted/rejected, TOKENS frames streamed bursts)."""
    from repro_torch.serving.spec import SpecConfig
    sync = 2 if sanitize else 8
    print("[selfcheck] spec: recording the non-speculative reference")
    ref, _ = await _sequential_run(
        build_engine(spec=BUCKET_SPEC, device=device, sync_every=sync),
        requests, None, sanitize=sanitize)
    runs = {}
    for k in (2, 4):
        print(f"[selfcheck] spec: replaying with k={k} "
              f"(draft {SPEC_DRAFT!r}, pinned by the client handshake)")
        eng = build_engine(spec=BUCKET_SPEC, device=device, sync_every=sync,
                           spec_decode=SpecConfig(k=k, draft=SPEC_DRAFT))
        got, _ = await _sequential_run(eng, requests, None, draft=SPEC_DRAFT,
                                       sanitize=sanitize)
        runs[k] = got
        bad = [(name, ref[name], got[name]) for name, _ in CHAOS_TENANTS
               if got[name] != ref[name]]
        if bad:
            for name, want, have in bad:
                print(f"[selfcheck] SPEC MISMATCH for {name} at k={k}:\n"
                      f"  vanilla:     {want}\n  speculative: {have}",
                      file=sys.stderr)
            sys.exit(1)
        est = got["_stats"]["engine"]
        acc, rej = est["spec_accepted"], est["spec_rejected"]
        assert est["spec_rounds"] > 0 and acc + rej > 0, (
            f"k={k} run never speculated: {est}")
        assert got["_streamed"] > 0, (
            f"k={k} run streamed no TOKENS previews")
        wpt = est["wire_per_token"]
        rate = acc / (acc + rej)
        print(f"[selfcheck] spec: k={k} bit-identical; acceptance "
              f"{rate:.2f} over {est['spec_rounds']} rounds, "
              f"{wpt['wire_bytes_per_token']:.1f} wire B/token, "
              f"{got['_streamed']} tokens streamed incrementally")
    n = len(CHAOS_TENANTS) * requests
    print(f"[selfcheck] spec: {n} requests per run bit-identical to "
          f"vanilla decode at every k")
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3,
                    help="requests per tenant")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded fault-injection run: sequential tenants, "
                         "outputs must be bit-identical to fault-free")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative-decoding run: sequential tenants "
                         "decode over a draft/verify channel; outputs must "
                         "be bit-identical to the vanilla engine")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the loopback tenants under the runtime "
                         "sanitizer tier (per-tick engine invariants + "
                         "event-loop stall detection); any invariant trip "
                         "exits nonzero")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, sanitize=args.sanitize)
    if args.chaos:
        asyncio.run(amain_chaos(args.requests, **kw))
    elif args.spec_decode:
        asyncio.run(amain_spec(args.requests, **kw))
    else:
        asyncio.run(amain(args.requests, **kw))
    print("[selfcheck] PASS")


if __name__ == "__main__":
    main()
