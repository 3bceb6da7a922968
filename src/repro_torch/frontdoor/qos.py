"""Per-tenant QoS accounting for the front door.

Port of ``repro/frontdoor/qos.py``: the same buckets, percentiles and
snapshot keys.

Every tenant gets a :class:`TenantQoS` record holding log-bucket
histograms of TTFT, per-request decode tokens/s, and per-request wire
bytes, plus scalar counters (requests, tokens, bytes in/out, BUSY
rejections, evictions).  The registry's :meth:`QoSRegistry.snapshot` is
what the ``STATS`` RPC ships — plain JSON-able dicts, no numpy.

Histograms are fixed log-spaced buckets (no unbounded per-request lists):
a long-lived server serves millions of requests, so percentiles are read
off the cumulative bucket counts (upper-bound estimate, clamped to the
exact observed min/max).
"""
from __future__ import annotations

import math


class LogHistogram:
    """Fixed log-spaced buckets over [lo, hi); O(1) record, O(buckets)
    percentile.  Values outside the range land in the edge buckets."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e5,
                 per_decade: int = 10):
        self.lo, self.per_decade = lo, per_decade
        self.n = max(1, int(math.ceil(math.log10(hi / lo) * per_decade)))
        self.counts = [0] * self.n
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.log10(v / self.lo) * self.per_decade)
        return min(i, self.n - 1)

    def record(self, v: float):
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, p: float) -> float | None:
        """Upper bucket bound at cumulative fraction ``p`` (0..100),
        clamped to the exact observed [min, max]."""
        if self.count == 0:
            return None
        need = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need and c:
                upper = self.lo * 10.0 ** ((i + 1) / self.per_decade)
                return min(max(upper, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50.0),
                "p99": self.percentile(99.0)}


class TenantQoS:
    """One tenant's accounting: histograms + scalar counters."""

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.ttft_s = LogHistogram()              # submit -> first token
        self.ttlt_s = LogHistogram()              # submit -> last token
        self.tokens_per_s = LogHistogram(lo=1e-2, hi=1e7)   # decode rate
        self.wire_bytes = LogHistogram(lo=1.0, hi=1e10)     # per request
        self.requests = 0          # completed requests
        self.tokens_out = 0        # generated tokens delivered
        self.bytes_in = 0          # frame bytes received from this tenant
        self.bytes_out = 0         # frame bytes sent to this tenant
        self.busy_rejections = 0   # SUBMITs shed with BUSY
        self.errors = 0            # SUBMITs refused with ERROR
        self.evictions = 0         # preemptions suffered by this tenant
        self.disconnects = 0       # connections that died mid-session
        self.resumes = 0           # sessions reattached after a disconnect
        self.expired = 0           # detached sessions past the resume TTL
        self.retransmits = 0       # frames re-sent to this tenant (NACKed)
        self.nacks = 0             # NACKs received from this tenant's stream

    def record_result(self, *, ttft_s: float | None, gen_tokens: int,
                      decode_s: float, wire_bytes: int, evictions: int = 0,
                      ttlt_s: float | None = None):
        self.requests += 1
        self.tokens_out += gen_tokens
        self.evictions += evictions
        if ttft_s is not None:
            self.ttft_s.record(ttft_s)
        if ttlt_s is not None:
            self.ttlt_s.record(ttlt_s)
        if gen_tokens and decode_s > 0:
            self.tokens_per_s.record(gen_tokens / decode_s)
        self.wire_bytes.record(wire_bytes)

    def snapshot(self) -> dict:
        return {"requests": self.requests,
                "tokens_out": self.tokens_out,
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "busy_rejections": self.busy_rejections,
                "errors": self.errors,
                "evictions": self.evictions,
                "disconnects": self.disconnects,
                "resumes": self.resumes,
                "expired": self.expired,
                "retransmits": self.retransmits,
                "nacks": self.nacks,
                "ttft_s": self.ttft_s.snapshot(),
                "ttlt_s": self.ttlt_s.snapshot(),
                "tokens_per_s": self.tokens_per_s.snapshot(),
                "wire_bytes": self.wire_bytes.snapshot()}


class QoSRegistry:
    """All tenants' QoS records, created on first touch."""

    def __init__(self):
        self._tenants: dict[str, TenantQoS] = {}

    def tenant(self, name: str) -> TenantQoS:
        if name not in self._tenants:
            self._tenants[name] = TenantQoS(name)
        return self._tenants[name]

    def snapshot(self) -> dict:
        return {name: t.snapshot()
                for name, t in sorted(self._tenants.items())}
