"""Tenant identity, configuration, and door-side quota machinery
(counterpart of hyperspace_tpu/serve/tenant.py).

Every query the scheduler admits belongs to exactly one *tenant* (the
``default`` tenant when the caller never says otherwise — the zero-config
path is bit-identical to the pre-tenancy scheduler). A tenant carries the
QoS contract the serving plane enforces:

- ``weight`` — the weighted-fair share of delivered resource (wall + io
  bytes + device bytes, charged from the attribution ledger's actual
  per-query costs; see serve/qos.py). A weight-3 tenant receives 3x the
  delivered cost share of a weight-1 tenant while both are backlogged.
- ``rate_qps`` / ``burst`` — a token bucket checked at the admission door;
  an empty bucket rejects with the typed ``TenantQuotaExceeded`` *before*
  the query ever queues.
- ``max_in_flight`` — ceiling on the tenant's queued + running queries;
  past it the door rejects (typed), bounding how much of the run queue one
  tenant can occupy.
- ``max_active`` — ceiling on the tenant's concurrently *running* queries;
  enforced at dispatch (the query waits in its tenant queue, it is not
  rejected), bounding worker-slot occupancy.
- ``budget_fraction`` — explicit share of the global read-ahead byte
  ledger (serve/budget.py); unset, the share is weight-proportional among
  the tenants currently holding bytes.

Configuration is process-wide (``TENANTS`` registry) and env-bootstrapped:
``HYPERSPACE_TENANTS`` accepts ``name:key=value,key=value;name2:...``
(e.g. ``gold:weight=4,rate_qps=50;bulk:weight=1,max_active=1``). A typo'd
spec raises ``TenantSpecError`` at registry construction — the
``HYPERSPACE_FAULTS`` precedent: a silently-ignored QoS contract is worse
than a loud one.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..exceptions import HyperspaceError
from ..staticcheck.concurrency import TrackedLock
from ..utils import env

DEFAULT_TENANT = "default"


class TenantQuotaExceeded(HyperspaceError):
    """A per-tenant quota (token bucket, ``max_in_flight``) rejected the
    submission at the door. Deliberately NOT an ``AdmissionRejected``
    subclass: global load shedding means *the server* is full, this means
    *your tenant* is over its contract — callers back off differently."""


class TenantSpecError(HyperspaceError):
    """Malformed ``HYPERSPACE_TENANTS`` spec."""


class TokenBucket:
    """Classic token bucket: ``rate_qps`` tokens/second refill up to
    ``burst`` capacity; ``try_acquire`` never blocks. The clock is
    injectable for deterministic tests. Its lock is a plain leaf — nothing
    is ever acquired while holding it (the per-metric-lock rule)."""

    __slots__ = ("rate_qps", "burst", "_tokens", "_t_last", "_clock", "_lock")

    def __init__(self, rate_qps: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate_qps = float(rate_qps)
        self.burst = float(burst) if burst is not None else max(
            1.0, 2.0 * self.rate_qps
        )
        self._tokens = self.burst  # a fresh tenant starts with a full burst
        self._clock = clock
        self._t_last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        now = self._clock()
        with self._lock:
            elapsed = max(0.0, now - self._t_last)
            self._t_last = now
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate_qps)
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        """Current (refilled) token count — introspection only."""
        now = self._clock()
        with self._lock:
            elapsed = max(0.0, now - self._t_last)
            return min(self.burst, self._tokens + elapsed * self.rate_qps)


class Tenant:
    """One tenant's QoS contract. Mutable via ``TenantRegistry.configure``
    (reweighting mid-stream takes effect on the next vclock charge)."""

    __slots__ = (
        "name", "weight", "rate_qps", "burst", "max_in_flight",
        "max_active", "budget_fraction", "_bucket",
    )

    def __init__(self, name: str, weight: float = 1.0,
                 rate_qps: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_in_flight: Optional[int] = None,
                 max_active: Optional[int] = None,
                 budget_fraction: Optional[float] = None):
        self.name = name
        self.weight = float(weight)
        self.rate_qps = rate_qps
        self.burst = burst
        self.max_in_flight = max_in_flight
        self.max_active = max_active
        self.budget_fraction = budget_fraction
        self._bucket: Optional[TokenBucket] = (
            TokenBucket(rate_qps, burst) if rate_qps is not None else None
        )

    def try_acquire_token(self) -> bool:
        """Door-side rate limit; always granted for unlimited tenants."""
        return self._bucket is None or self._bucket.try_acquire()

    def config(self) -> dict:
        return {
            "weight": self.weight,
            "rate_qps": self.rate_qps,
            "burst": self.burst,
            "max_in_flight": self.max_in_flight,
            "max_active": self.max_active,
            "budget_fraction": self.budget_fraction,
            "rate_tokens": (
                round(self._bucket.tokens(), 3)
                if self._bucket is not None else None
            ),
        }


_SPEC_FIELDS = {
    "weight": float,
    "rate_qps": float,
    "burst": float,
    "max_in_flight": int,
    "max_active": int,
    "budget_fraction": float,
}


def parse_tenant_spec(spec: str) -> dict[str, dict]:
    """``name:key=value,key=value;name2:...`` → {name: kwargs}. A bare
    ``name`` (no colon) declares a tenant with all defaults."""
    out: dict[str, dict] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, body = part.partition(":")
        name = name.strip()
        if not name:
            raise TenantSpecError(f"empty tenant name in {part!r}")
        kwargs: dict = {}
        for kv in filter(None, (s.strip() for s in body.split(","))):
            key, eq, raw = kv.partition("=")
            key = key.strip()
            if not eq or key not in _SPEC_FIELDS:
                raise TenantSpecError(
                    f"bad tenant field {kv!r} for {name!r} "
                    f"(known: {', '.join(sorted(_SPEC_FIELDS))})"
                )
            try:
                kwargs[key] = _SPEC_FIELDS[key](raw.strip())
            except ValueError as e:
                raise TenantSpecError(
                    f"unparseable value in {kv!r} for {name!r}: {e}"
                ) from None
        out[name] = kwargs
    return out


class TenantRegistry:
    """Process-wide tenant configuration. ``get`` auto-creates unknown
    tenants with defaults so tenancy is zero-config for existing callers;
    ``configure`` creates-or-updates. Bootstrapped from the
    ``HYPERSPACE_TENANTS`` spec knob at construction."""

    def __init__(self):
        self._lock = TrackedLock("serve.tenants")
        self._tenants: dict[str, Tenant] = {}
        spec = env.env_str("HYPERSPACE_TENANTS")
        if spec:
            for name, kwargs in parse_tenant_spec(spec).items():
                self._tenants[name] = Tenant(name, **kwargs)

    def get(self, name: str) -> Tenant:
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name)
            return t

    def configure(self, name: str, **kwargs) -> Tenant:
        """Create or update a tenant's contract; unknown kwargs raise."""
        bad = set(kwargs) - set(_SPEC_FIELDS)
        if bad:
            raise TenantSpecError(
                f"unknown tenant field(s) {sorted(bad)} for {name!r}"
            )
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name, **kwargs)
                return t
            for key, value in kwargs.items():
                setattr(t, key, value)
            if "rate_qps" in kwargs or "burst" in kwargs:
                t._bucket = (
                    TokenBucket(t.rate_qps, t.burst)
                    if t.rate_qps is not None else None
                )
            return t

    def known(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def state(self) -> dict:
        with self._lock:
            tenants = list(self._tenants.values())
        return {t.name: t.config() for t in tenants}

    def reset_for_testing(self) -> None:
        """Drop all configuration and re-bootstrap from the env spec."""
        with self._lock:
            self._tenants.clear()
            spec = env.env_str("HYPERSPACE_TENANTS")
            if spec:
                for name, kwargs in parse_tenant_spec(spec).items():
                    self._tenants[name] = Tenant(name, **kwargs)


TENANTS = TenantRegistry()
