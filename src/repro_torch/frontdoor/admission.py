"""Admission control for the front door.

Port of ``repro/frontdoor/admission.py``: the same verdicts and strings.

Policy layer between the wire and the engine queue, reusing the engine's
``PageAllocator`` admission underneath (a request the engine can never
hold — prompt too long, page footprint above the whole pool — is refused
with ``ERROR`` before it is queued).  On top of that it enforces:

* **per-tenant concurrency caps** — at most ``TenantPolicy.max_inflight``
  requests of one tenant admitted-but-unfinished at a time; excess gets a
  retriable ``BUSY`` so one chatty tenant cannot monopolize the slots;
* **queue-depth shedding** — when the total admitted backlog reaches
  ``max_queue_depth``, every tenant gets ``BUSY`` (with a retry hint)
  instead of the queue growing without bound.

``TenantPolicy.priority`` is the engine slot priority stamped on the
tenant's requests — with engine ``preemption=True`` a higher-priority
tenant's blocked head evicts lower-priority slots (see
``repro_torch.serving.engine``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant QoS knobs (the server's defaults when unlisted)."""
    max_inflight: int = 8      # concurrent admitted requests for the tenant
    priority: int = 0          # engine slot priority (preemption ranking)


ADMIT = "admit"
BUSY_TENANT = "tenant_cap"     # this tenant is at its concurrency cap
BUSY_QUEUE = "queue_depth"     # the whole server backlog is shedding


class AdmissionController:
    """Book-keeps in-flight counts; decides admit vs shed per SUBMIT."""

    def __init__(self, *, max_queue_depth: int = 64,
                 default_policy: TenantPolicy | None = None,
                 policies: dict[str, TenantPolicy] | None = None):
        self.max_queue_depth = max_queue_depth
        self.default_policy = default_policy or TenantPolicy()
        self.policies = dict(policies or {})
        self.inflight_total = 0
        self.inflight: dict[str, int] = {}

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    def try_admit(self, tenant: str) -> str:
        """ADMIT (and count the request) or a BUSY_* shed reason."""
        if self.inflight_total >= self.max_queue_depth:
            return BUSY_QUEUE
        if self.inflight.get(tenant, 0) >= self.policy(tenant).max_inflight:
            return BUSY_TENANT
        self.inflight_total += 1
        self.inflight[tenant] = self.inflight.get(tenant, 0) + 1
        return ADMIT

    def release(self, tenant: str):
        """A previously admitted request finished (or was dropped)."""
        if self.inflight.get(tenant, 0) <= 0 or self.inflight_total <= 0:
            raise RuntimeError(f"release without admit for tenant {tenant!r}")
        self.inflight[tenant] -= 1
        self.inflight_total -= 1
