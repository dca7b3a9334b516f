"""Overload protection: per-tenant token-bucket admission for the
columnar front door.

Reference counterpart: Routerlicious' per-tenant throttling in front of
Alfred — the service rate-limits ops per tenant before they reach the
Kafka→Deli pipeline and answers over-budget clients with a retryAfter.
Here the door's drain pass offers every decoded op batch to one
:class:`AdmissionController` *before* it reaches the sequencer or the
``PipelinedIngestExecutor``; whatever is not admitted is answered with an
explicit ``throttled`` frame carrying ``retry_after_ms``. Shed work is
never silently dropped and never burns a clientSeq: it is refused before
the sequencer sees the number, so the client resubmits the SAME cseq
after backoff.

A tenant declares a budget (ops/sec + burst); a batch consumes tokens
for its admitted PREFIX only. The sequencer nacks clientSeq gaps, so
once op ``k`` of a batch is shed everything after it sheds too (the door
carries the rule across batches with a shed fence). A client bound to a
tenant with no declared budget is not limited.

The reference's other gates (per-doc buckets, a concurrency limit,
deadline shedding on an estimated service rate, and the pressure knobs
its SLO-driven ``ControlPolicy`` turns) are not ported: nothing on the
door's path sets them yet.

Every decision is counted (``admission_*`` counters).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..utils.telemetry import REGISTRY

#: floor on any retry hint — a 0ms hint would have clients hammering
_MIN_RETRY_MS = 5.0
#: ceiling on any retry hint — bounded client-side pause per episode
_MAX_RETRY_MS = 2000.0


class TokenBucket:
    """Classic token bucket with prefix-grant semantics: :meth:`grant`
    admits the largest prefix of ``n`` requested ops the current tokens
    cover (never a mid-batch subset — the door sheds suffixes only)."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else float(rate)
        self.tokens = self.burst
        self._t: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t is not None and now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + self.rate * (now - self._t))
        self._t = now

    def grant(self, n: int, now: float) -> int:
        """Admit the largest prefix of ``n`` ops covered by the current
        tokens; consumes exactly what it grants."""
        self._refill(now)
        k = min(n, int(self.tokens))
        if k > 0:
            self.tokens -= k
        return k

    def retry_after_ms(self, n: int, now: float) -> float:
        """Milliseconds until ``n`` tokens will have accumulated —
        pure query, consumes nothing."""
        self._refill(now)
        deficit = n - self.tokens
        if deficit <= 0:
            return _MIN_RETRY_MS
        return min(_MAX_RETRY_MS, max(
            _MIN_RETRY_MS, deficit / self.rate * 1000.0))


@dataclass
class Admission:
    """One :meth:`AdmissionController.admit` verdict: the admitted
    PREFIX length, the retry hint for the shed suffix, and why."""

    admitted: int
    retry_after_ms: float = 0.0
    reason: str = "ok"       # ok | budget


class AdmissionController:
    """Per-tenant token-bucket admission.

    ``tenants`` maps a name to its declared ops/sec budget (burst = one
    second's worth unless :meth:`register_tenant` sets it). Thread-safe:
    the door's event loop and its callers share one controller under a
    single lock."""

    def __init__(self, tenants: Optional[Dict[str, float]] = None,
                 clock=time.monotonic, registry=None):
        self._lock = threading.Lock()
        self.clock = clock
        self.registry = registry if registry is not None else REGISTRY
        self._tenant_bucket: Dict[str, TokenBucket] = {}
        self._tenant_of: Dict[Any, str] = {}
        self.admitted_total = 0
        self.shed_total = 0
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        for name, rate in (tenants or {}).items():
            self.register_tenant(name, rate)

    def register_tenant(self, name: str, rate: float,
                        burst: Optional[float] = None) -> None:
        """Declare (or re-declare) a tenant's ops/sec budget."""
        with self._lock:
            self._tenant_bucket[name] = TokenBucket(rate, burst)
            self._tenant_stats.setdefault(
                name, {"admitted": 0, "shed": 0})

    def bind(self, client_id: Any, tenant: Optional[str] = None) -> str:
        """Bind a client identity to a tenant (join time). A ``None``
        tenant keeps any existing binding, else falls back to a
        per-client default tenant name."""
        with self._lock:
            if tenant is None:
                tenant = self._tenant_of.get(client_id,
                                             f"client-{client_id}")
            self._tenant_of[client_id] = tenant
            self._tenant_stats.setdefault(
                tenant, {"admitted": 0, "shed": 0})
            return tenant

    def tenant_of(self, client_id: Any) -> str:
        with self._lock:
            return self._tenant_of.get(client_id, f"client-{client_id}")

    def admit(self, client_id: Any, n: int,
              now: Optional[float] = None) -> Admission:
        """Offer a batch of ``n`` ops from ``client_id``. Returns the
        admitted prefix length plus a retry hint for the shed suffix."""
        if n <= 0:
            return Admission(0, _MIN_RETRY_MS, "ok")
        now = self.clock() if now is None else now
        with self._lock:
            tenant = self._tenant_of.get(client_id,
                                         f"client-{client_id}")
            tb = self._tenant_bucket.get(tenant)
            k = n if tb is None else tb.grant(n, now)
            self.admitted_total += k
            st = self._tenant_stats.setdefault(
                tenant, {"admitted": 0, "shed": 0})
            st["admitted"] += k
            if k > 0:
                self.registry.inc("admission_admitted_total", k)
            if k == n:
                return Admission(k, 0.0, "ok")
            shed = n - k
            self.shed_total += shed
            st["shed"] += shed
            self.registry.inc("admission_shed_total", shed)
            self.registry.inc("admission_shed_budget_total", shed)
            return Admission(k, self._retry_locked(tenant, shed, now),
                             "budget")

    def retry_after_ms(self, client_id: Any, n: int = 1,
                       now: Optional[float] = None) -> float:
        """Pure retry hint for ``n`` ops (consumes nothing) — the
        door uses it for fence-blocked batches that were never offered
        to the buckets."""
        now = self.clock() if now is None else now
        with self._lock:
            return self._retry_locked(
                self._tenant_of.get(client_id, f"client-{client_id}"),
                n, now)

    def _retry_locked(self, tenant: str, n: int, now: float) -> float:
        hint = _MIN_RETRY_MS
        tb = self._tenant_bucket.get(tenant)
        if tb is not None:
            hint = max(hint, tb.retry_after_ms(n, now))
        return round(hint, 3)

    def snapshot(self) -> dict:
        """Controller state for reports: totals and per-tenant
        admitted/shed splits."""
        with self._lock:
            return {
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "tenants": {t: dict(st)
                            for t, st in self._tenant_stats.items()},
            }
