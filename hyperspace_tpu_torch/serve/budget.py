"""Byte ledgers (counterpart of hyperspace_tpu/serve/budget.py).

Two process-wide accountants share one class. The global read-ahead
ledger (``global_budget()``) bounds the decoded bytes every streaming
consumer holds undelivered: the chunk streamer of multi-file scans
(columnar/io.iter_chunks) and the bucket-pair read-ahead of the bucketed
join (plan/bucket_join._iter_bucket_pairs) each open a ``stream(label)``
on it, reserve an estimate per chunk or pair before submitting its decode
and release it on delivery. Its limit is ``HYPERSPACE_GLOBAL_BUDGET_MB``
(default 1024), or ``HYPERSPACE_IO_BUDGET_MB`` when only that is set.

The device ledgers, one per mesh device ordinal (``device_budget(ordinal)``;
ordinal 0 is the one-device ledger): the band schedulers of the
co-bucketed joins (plan/device_join.py), plain and fused, reserve each
wave's padded device footprint through the ledger of the ordinal the wave
is placed on before it dispatches, and release it once the wave's results
are on the host. Each ledger's
limit is ``HYPERSPACE_DEVICE_BUDGET_MB`` (default 4096; 0 disables the
ledger). A stream that holds nothing is always granted its reservation,
even past the limit (the zero-holder progress rule), so joins that share
the ledger cannot deadlock.

Each ledger counts in the metrics registry under its name, as the
reference's do: ``<name>.reservations``, ``<name>.force_grants`` (a
zero-holder grant past the limit), ``<name>.stalls`` and the occupancy
gauge ``<name>_bytes``; the names are ``serve.budget`` and
``serve.device_budget``, with ``.d<N>`` for mesh ordinal N above 0.

Every stream opened under a serving query carries the query's id and
tenant (serve/context.current_query). While bytes are held by more than
one tenant, a stream that already holds bytes is also capped at its
tenant's share of the limit: ``budget_fraction`` where the tenant sets
one, else its weight's share among the tenants holding bytes; such a
stall counts as ``<name>.tenant_stalls`` too. With zero or one tenant
holding bytes the partition is never consulted, so a single-tenant
process reserves exactly as without tenants. ``state()`` lists the open
streams with their holder and the bytes each tenant holds;
``check_consistency()`` holds the total to the per-stream sum.
"""

from __future__ import annotations

import threading

from ..staticcheck.concurrency import TrackedLock, guarded_by
from ..staticcheck.lifecycle import release_resource, tracked_resource
from ..telemetry.metrics import REGISTRY
from ..utils import env
from .context import current_query


class BudgetStream:
    """One consumer's handle on a ledger (a scan stream, a pair loader, one
    join execution), pumped from one thread. ``query_id`` and ``tenant``
    name the serving query that opened it (None outside the scheduler)."""

    __slots__ = ("_acct", "label", "query_id", "tenant", "held", "_closed", "_lc")

    def __init__(self, acct: "BudgetAccountant", label: str = "", query_id=None,
                 tenant: "str | None" = None):
        self._acct = acct
        self.label = label
        self.query_id = query_id
        self.tenant = tenant
        self.held = 0
        self._closed = False
        self._lc = tracked_resource("budget.stream", f"{acct.name}/{label}",
                                    query=query_id, tenant=tenant)

    def try_reserve(self, nbytes: int) -> bool:
        """Reserve ``nbytes``; False when over the limit and holding bytes."""
        return self._acct._reserve(self, nbytes)

    def release(self, nbytes: int) -> None:
        self._acct._release(self, nbytes)

    def close(self) -> None:
        """Return whatever the stream still holds; idempotent."""
        if not self._closed:
            self._closed = True
            self._acct._close(self)
            release_resource(self._lc)


class BudgetAccountant:
    def __init__(self, max_bytes: int, name: str = "serve.budget"):
        self.max_bytes = max_bytes
        self.name = name  # the registry's metric prefix
        self._lock = TrackedLock(name)
        self._held = 0
        self._streams: dict[int, BudgetStream] = {}
        # wakes consumers parked on a full ledger when bytes come back (a
        # plain leaf Condition: never held while acquiring anything else,
        # so it stays out of the lock-order audit, as the per-metric value
        # locks do)
        self._released = threading.Condition(threading.Lock())

    def stream(self, label: str = "", query=None, tenant=None) -> BudgetStream:
        """Open a consumer handle; ``query`` and ``tenant`` default to the
        thread's current serving query (None outside the scheduler)."""
        if query is None:
            ctx = current_query()
            if ctx is not None:
                query = ctx.query_id
                if tenant is None:
                    tenant = ctx.tenant
        s = BudgetStream(self, label, query, tenant)
        with self._lock:
            self._streams[id(s)] = s
        return s

    def _tenant_over_share_locked(self, s: BudgetStream, nbytes: int) -> bool:
        """While bytes are held by more than one tenant, is ``s``'s tenant
        past its share of the limit with ``nbytes`` more? Never consulted
        with zero or one tenant in play."""
        if s.tenant is None:
            return False
        holders = {st.tenant for st in self._streams.values()
                   if st.held > 0 and st.tenant is not None}
        holders.add(s.tenant)
        if len(holders) <= 1:
            return False
        from .tenant import TENANTS

        tenants = {name: TENANTS.get(name) for name in holders}
        total_weight = sum(max(1e-6, t.weight) for t in tenants.values())
        mine = tenants[s.tenant]
        share = (mine.budget_fraction if mine.budget_fraction is not None
                 else max(1e-6, mine.weight) / total_weight)
        limit = self.max_bytes * max(0.0, min(1.0, share))
        held_t = sum(st.held for st in self._streams.values() if st.tenant == s.tenant)
        return held_t + nbytes > limit

    def _reserve(self, s: BudgetStream, nbytes: int) -> bool:
        forced = tenant_stall = False
        with self._lock:
            if s.held > 0 and self._held + nbytes > self.max_bytes:
                granted = False
            elif s.held > 0 and self._tenant_over_share_locked(s, nbytes):
                granted = False
                tenant_stall = True
            else:
                granted = True
                forced = self._held + nbytes > self.max_bytes
                s.held += nbytes
                self._held += nbytes
            occupancy = self._held
        if granted:
            REGISTRY.counter(f"{self.name}.reservations").inc()
            if forced:
                REGISTRY.counter(f"{self.name}.force_grants").inc()
            REGISTRY.gauge(f"{self.name}_bytes").set(occupancy)
        else:
            REGISTRY.counter(f"{self.name}.stalls").inc()
            if tenant_stall:
                REGISTRY.counter(f"{self.name}.tenant_stalls").inc()
        return granted

    def _release(self, s: BudgetStream, nbytes: int) -> None:
        with self._lock:
            n = min(nbytes, s.held)
            s.held -= n
            self._held -= n
            occupancy = self._held
        with self._released:
            self._released.notify_all()
        REGISTRY.gauge(f"{self.name}_bytes").set(occupancy)

    def _close(self, s: BudgetStream) -> None:
        with self._lock:
            self._held -= s.held
            s.held = 0
            self._streams.pop(id(s), None)
            occupancy = self._held
        with self._released:
            self._released.notify_all()
        REGISTRY.gauge(f"{self.name}_bytes").set(occupancy)

    def wait_for_release(self, timeout: float) -> None:
        """Block until some stream releases or ``timeout`` seconds pass;
        callers loop (a wake-up is a hint, not a grant)."""
        with self._released:
            self._released.wait(timeout)

    def held_bytes(self) -> int:
        with self._lock:
            return self._held

    def state(self) -> dict:
        """The limit, the total held, each open stream with its holder, and
        the bytes each tenant holds."""
        with self._lock:
            streams = [{"label": s.label, "query": s.query_id, "tenant": s.tenant,
                        "held_bytes": s.held} for s in self._streams.values()]
            held = self._held
        tenants: dict[str, int] = {}
        for s in streams:
            if s["tenant"] is not None and s["held_bytes"]:
                tenants[s["tenant"]] = tenants.get(s["tenant"], 0) + s["held_bytes"]
        return {"limit_bytes": self.max_bytes, "held_bytes": held, "streams": streams,
                "tenants": tenants}

    def check_consistency(self) -> bool:
        """The total equals the sum over the open streams."""
        with self._lock:
            return self._held == sum(s.held for s in self._streams.values())


def configured_device_budget_bytes() -> int:
    """``HYPERSPACE_DEVICE_BUDGET_MB`` in bytes; 0 disables the ledger."""
    try:
        mb = env.env_float("HYPERSPACE_DEVICE_BUDGET_MB")
    except ValueError:
        mb = env.knob("HYPERSPACE_DEVICE_BUDGET_MB").default
    return int(mb * 2**20)


_lock = TrackedLock("serve.budget_singleton")  # guards the swaps only


def _device_budget_name(ordinal: int) -> str:
    # ordinal 0 keeps the one-device metric prefix, so mesh-off telemetry
    # is unchanged; mesh ordinals add .d<N>
    return "serve.device_budget" if ordinal == 0 else f"serve.device_budget.d{ordinal}"


# the device ledgers by mesh device ordinal, made at first use
_DEVICES: dict = guarded_by({}, _lock, name="serve.budget._DEVICES")


def device_budget(ordinal: int = 0) -> BudgetAccountant:
    """The device-byte accountant of one mesh device ordinal, which every
    join band scheduler reserves a wave's footprint through (ordinal 0 is
    the one-device ledger; under ``HYPERSPACE_MESH`` a wave placed on
    ordinal d reserves through d's). Each is sized by
    ``HYPERSPACE_DEVICE_BUDGET_MB`` when first used: the knob is per
    device. The join strategy plan reads ordinal 0's limit as the grant."""
    with _lock:
        acct = _DEVICES.get(ordinal)
        if acct is None:
            acct = _DEVICES[ordinal] = BudgetAccountant(
                configured_device_budget_bytes(), _device_budget_name(ordinal))
        return acct


def device_budgets() -> dict:
    """Every device ledger made so far, by ordinal (ordinals appear as the
    placement first targets them)."""
    with _lock:
        return dict(_DEVICES)


def reset_device_budget() -> BudgetAccountant:
    """Re-read ``HYPERSPACE_DEVICE_BUDGET_MB`` and install fresh device
    ledgers (never mid-query): every mesh ordinal's is dropped, and the
    fresh ordinal-0 ledger returned."""
    with _lock:
        _DEVICES.clear()
        acct = _DEVICES[0] = BudgetAccountant(configured_device_budget_bytes(),
                                              _device_budget_name(0))
        return acct


def configured_budget_bytes() -> int:
    """``HYPERSPACE_GLOBAL_BUDGET_MB`` in bytes; when it is unset, an
    explicitly set ``HYPERSPACE_IO_BUDGET_MB`` carries over."""
    raw = env.read_raw("HYPERSPACE_GLOBAL_BUDGET_MB")
    if raw is None:
        raw = env.read_raw("HYPERSPACE_IO_BUDGET_MB")
    try:
        if raw is not None:
            return int(float(raw) * 2**20)
    except ValueError:
        pass
    return int(env.knob("HYPERSPACE_GLOBAL_BUDGET_MB").default * 2**20)


# the process-wide read-ahead accountant, made at first use
_GLOBAL: list = guarded_by([], _lock, name="serve.budget._GLOBAL")


def global_budget() -> BudgetAccountant:
    """The read-ahead accountant every streaming consumer reserves through,
    sized by the knob when first used."""
    with _lock:
        if not _GLOBAL:
            _GLOBAL.append(BudgetAccountant(configured_budget_bytes()))
        return _GLOBAL[0]


def reset_global_budget() -> BudgetAccountant:
    """Re-read the knob and install a fresh read-ahead ledger (never
    mid-query)."""
    with _lock:
        _GLOBAL[:] = [BudgetAccountant(configured_budget_bytes())]
        return _GLOBAL[0]
