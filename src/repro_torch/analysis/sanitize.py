"""Opt-in runtime sanitizers (the ``--sanitize`` tier).

Port of ``repro/analysis/sanitize.py``: the same classes, checks, messages
and ``counts``, behind an explicit flag, because every check here costs
host syncs or extra dispatches that the production paths refuse to pay:

* :class:`EngineSanitizer` — per-tick
  :class:`~repro_torch.serving.engine.BatchedEngine` invariant checks,
  attached via ``engine.attach_sanitizer``:

  - **pool accounting**: every page is on the free list or owned by
    exactly one slot (``free + in_use == total``);
  - **slot-state hygiene**: a slot with no resident request must be
    inert device-side (``active``/``done`` False, ``pos``/``out_len``
    zero);
  - **live-slot zeroing pre-encode**: a probe re-runs the real decode
    step's front half (``lm.decode_cut``: the superblocks before the cut
    and the live mask, the cut ``decode_step`` hands to ``codec.encode``)
    and asserts that dead rows contribute EXACTLY zero to it.  The
    reference's probe is a non-donating program of the whole
    ``decode_step`` whose compiler drops everything after the cut; the
    port runs only the front half, and since it writes its caches in
    place, with nothing written: no cache position, no recurrent state,
    and nothing copied.  The cut does not depend on the codec, so one
    probe serves every bucket (the reference's table holds one program
    per bucket only because its program is the whole step).

* :class:`SlowCallbackDetector` — event-loop stall diagnostics for the
  front door (stalls are recorded and reported, not fatal).

* :class:`TrainSanitizer` — per-step finite checks for the train loops
  (a NaN/Inf loss or grad norm trips at once, with the step index).

The reference's two JAX-level functions have no exact torch counterpart:

* ``enable_debug_nans`` (``jax_debug_nans``, process-global) becomes
  autograd's anomaly mode with its NaN check,
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``, entered as
  a context manager around each train step by
  :meth:`TrainSanitizer.step_scope`, so the previous mode is back after
  the step returns or raises.  It raises where a backward function
  returns NaN; it does not look at the forward.
* ``checkify_jit`` becomes :func:`finite_outputs`: every floating tensor
  the wrapped function returns is checked with one device reduction and
  one host read a call, and the first non-finite one is named by its key
  path.  Where anomaly mode trips inside the call, it names the first
  non-finite input instead.  It does not catch a non-finite intermediate
  that reaches no output (checkify's float checks do, at the op that made
  it).
"""
from __future__ import annotations

import asyncio
import contextlib
import inspect
import math
import re
import time

import torch


class SanitizerError(AssertionError):
    """A checked runtime invariant was violated."""


# ---------------------------------------------------------------------------
# float sanitizers for the train step
# ---------------------------------------------------------------------------

def _float_leaves(tree, path=""):
    """(key path, tensor) for every floating tensor of a nest of dicts,
    lists and tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _float_leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def _first_nonfinite(tree, path=""):
    """The key path of the first floating tensor of ``tree`` that holds a
    NaN or an inf, or None: one reduction on the device (each tensor's
    largest magnitude) and one host read."""
    leaves = list(_float_leaves(tree, path))
    if not leaves:
        return None
    norms = torch._foreach_norm([t for _, t in leaves], math.inf)
    ok = torch.isfinite(torch.stack([n.float() for n in norms]))
    bad = (~ok).tolist()
    return next((p for (p, _), b in zip(leaves, bad) if b), None)


_ANOMALY = re.compile(r"Function '(\w+)' returned nan values")


def finite_outputs(fn):
    """``fn`` whose floating outputs are checked after each call: a
    :class:`SanitizerError` names the first one that holds a NaN or an
    inf by its key path (``output[0]['embed']``).  When autograd's anomaly
    mode raises inside ``fn`` (a backward function returned NaN), the
    error names the first non-finite input by its parameter name and key
    path, else the backward function.  Outputs pass through unchanged."""
    name = getattr(fn, "__name__", "fn")
    sig = inspect.signature(fn)

    def wrapper(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except RuntimeError as err:
            found = _ANOMALY.search(str(err))
            if found is None:
                raise
            bound = sig.bind(*args, **kwargs).arguments
            leaf = next(filter(None, (_first_nonfinite(v, k)
                                      for k, v in bound.items())), None)
            where = (f"input {leaf} is not finite" if leaf is not None else
                     "inputs are finite")
            raise SanitizerError(
                f"[sanitize] {name}() {where} — autograd's anomaly check "
                f"tripped: {found[1]} returned nan values") from err
        leaf = _first_nonfinite(out, "output")
        if leaf is not None:
            raise SanitizerError(
                f"[sanitize] {name}() {leaf} holds NaN or inf — "
                f"non-finite output")
        return out

    return wrapper


class TrainSanitizer:
    """Per-step host-side finite checks for the train loops.  Syncs on
    every step by design — sanitize mode trades throughput for checks."""

    def __init__(self):
        self.steps_checked = 0

    def check_step(self, step: int, **scalars) -> None:
        for name, value in scalars.items():
            if value is None:
                continue
            v = float(value)  # lint-ok: R3 sanitize mode trades throughput for per-step checks
            if not math.isfinite(v):
                raise SanitizerError(
                    f"[sanitize] step {step}: {name} is {v!r} — "
                    f"non-finite training signal")
        self.steps_checked += 1

    @contextlib.contextmanager
    def step_scope(self, step: int):
        """Autograd's anomaly mode with its NaN check for the block (the
        previous mode is restored after it, also when it raises); a
        :class:`SanitizerError` raised in the block is raised again naming
        ``step``."""
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            try:
                yield
            except SanitizerError as err:
                msg = str(err).removeprefix("[sanitize] ")
                raise SanitizerError(f"[sanitize] step {step}: {msg}") from err


# ---------------------------------------------------------------------------
# engine invariants
# ---------------------------------------------------------------------------

class EngineSanitizer:
    """Per-tick invariant checks for a :class:`BatchedEngine`.

    Attach with ``engine.attach_sanitizer(EngineSanitizer(engine))``;
    the engine then calls :meth:`on_tick` after every tick/run
    iteration.  ``every`` thins the expensive cut-probe (the cheap
    host-side checks always run); every caller keeps the default of 1,
    and the option stays for parity with the reference's API.
    ``counts`` records how often each check actually fired, so tests can
    assert the invariant was EXERCISED, not just never tripped.
    """

    def __init__(self, engine, *, every: int = 1):
        from repro_torch.models import lm as lm_lib
        self.every = max(1, int(every))
        self.ticks = 0
        self.counts = {"pool": 0, "slot_state": 0, "cut_zeroing": 0}
        self._probe = None
        if engine.codec is not None:
            cfg, paged = engine.cfg, engine.paged

            def probe(params, cache, state):
                live = state["active"] & ~state["done"]
                cut = lm_lib.decode_cut(params, cache, state["last_tok"][:, None],
                                        state["pos"], cfg, paged=paged, live=live)
                dead = (~live).to(cut.dtype)[:, None]
                return torch.sum(torch.abs(cut) * dead), live.sum()

            self._probe = probe

    # -- individual checks -------------------------------------------------

    def check_pool(self, engine) -> None:
        acct = engine.pool_accounting()
        if acct["total"] and acct["free"] + acct["in_use"] != acct["total"]:
            raise SanitizerError(
                f"[sanitize] page-pool accounting broken: free "
                f"{acct['free']} + in_use {acct['in_use']} != total "
                f"{acct['total']} — a page leaked or is double-owned")
        self.counts["pool"] += 1

    def check_slot_state(self, engine) -> None:
        empty = [i for i, s in enumerate(engine.slots) if s.req is None]
        if not empty:
            return
        keys = ("active", "done", "pos", "out_len")
        rows = torch.stack([engine.state[k].to(torch.int64) for k in keys])
        st = dict(zip(keys, rows.tolist()))       # one host read
        for i in empty:
            if st["active"][i] or st["done"][i] or st["pos"][i] \
                    or st["out_len"][i]:
                raise SanitizerError(
                    f"[sanitize] empty slot {i} is not inert: "
                    f"active={bool(st['active'][i])} "
                    f"done={bool(st['done'][i])} pos={st['pos'][i]} "
                    f"out_len={st['out_len'][i]} — stale device "
                    f"state survived a retire/evict")
        self.counts["slot_state"] += 1

    def check_cut_zeroing(self, engine) -> None:
        """Rows that are not live contribute EXACTLY zero to the cut-layer
        tensor entering the batch-wise codec.  ``torch.where`` writes
        exact zeros, so any tolerance would only mask a regression — the
        threshold is 0.0."""
        if self._probe is None:
            return
        live = engine.state["active"] & ~engine.state["done"]
        n_live = int(torch.sum(live))
        if n_live == 0 or n_live == engine.num_slots:
            return          # no dead/live mix: the invariant is vacuous
        dead_mag, _ = self._probe(engine.params, engine.cache, engine.state)
        dead_mag = float(dead_mag)
        if dead_mag != 0.0:
            raise SanitizerError(
                f"[sanitize] live-slot zeroing violated: dead rows "
                f"contribute |cut| sum = {dead_mag!r} (expected exactly "
                f"0.0) to the C3-SL superposition — stale slot state is "
                f"leaking into live rows through HRR cross-talk")
        self.counts["cut_zeroing"] += 1

    # -- engine hook -------------------------------------------------------

    def on_tick(self, engine) -> None:
        self.ticks += 1
        self.check_pool(engine)
        self.check_slot_state(engine)
        if self.ticks % self.every == 0:
            self.check_cut_zeroing(engine)


# ---------------------------------------------------------------------------
# event-loop stall diagnostics
# ---------------------------------------------------------------------------

class SlowCallbackDetector:
    """Record event-loop stalls: a probe task sleeps ``interval_s`` and
    measures how late it wakes; anything beyond ``threshold_s`` of lag
    is one stall.  Diagnostic, not fatal — a first call that builds or
    loads kernels legitimately blocks the loop.  Also turns on asyncio
    debug slow-callback logging at the same threshold."""

    def __init__(self, *, threshold_s: float = 0.25,
                 interval_s: float = 0.05):
        self.threshold_s = threshold_s
        self.interval_s = interval_s
        self.max_lag_s = 0.0
        self.stalls: list[float] = []
        self._task: asyncio.Task | None = None

    def install(self) -> "SlowCallbackDetector":
        loop = asyncio.get_running_loop()
        loop.slow_callback_duration = self.threshold_s
        self._task = asyncio.create_task(self._probe())
        return self

    async def _probe(self):
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(self.interval_s)
            lag = time.perf_counter() - t0 - self.interval_s
            self.max_lag_s = max(self.max_lag_s, lag)
            if lag > self.threshold_s:
                self.stalls.append(lag)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:  # lint-ok: R5 reaping the probe task WE just cancelled
                pass
            self._task = None

    def report(self) -> str:
        return (f"event-loop lag: max {self.max_lag_s * 1e3:.1f}ms, "
                f"{len(self.stalls)} stall(s) over {self.threshold_s}s")
