"""Admission-controlled concurrent query scheduler (counterpart of
hyperspace_tpu/serve/scheduler.py).

The serving layer that turns the one-query-at-a-time engine into a
multi-query server: ``submit()`` enqueues a query under a bounded run
queue, an admission controller dispatches up to
``HYPERSPACE_MAX_CONCURRENT_QUERIES`` of them onto named worker threads,
and every admitted query executes its *unchanged* ``collect()`` path
under a ``QueryContext``. Dispatch order is multi-tenant weighted-fair
(serve/qos.py): every query belongs to a tenant (the zero-config
``default`` tenant degenerates to the original FIFO+priority order —
highest priority first, FIFO within a priority), each tenant's delivered
cost charges a virtual clock, and the smallest clock dispatches next.
Per-tenant token buckets and quotas reject at the door with the typed
``TenantQuotaExceeded`` (serve/tenant.py); a query submitted with a
deadline the cost model says cannot be met rejects fast with
``DeadlineUnmeetable`` — or, with the approximate tier enabled
(``HYPERSPACE_APPROX``) and the submitter's ``allow_approx``, degrades
instead of rejecting (serve/qos.choose_degrade_tier; plan/sampling.py
serves the tier). The scan pipeline and
the join streamer become tasks interleaved across queries by
construction: query A's worker blocks in a device launch while query B's
chunks decode on the shared engine IO pool, all read-ahead reserving
through the one global byte budget (serve/budget.py).

Concurrent execution stays bit-identical to serial per query: workers run
the exact same plan/executor/kernel code a direct ``collect()`` runs, the
shared caches serve one resident copy per key, and the budget only
throttles *scheduling* of read-ahead, never results.

Departures from the JAX package: ``_home_device_locked`` returns None (the
port has one card and no mesh tier, as the JAX package returns with fewer
than two mesh devices). A query whose
kernel fails to build or launch raises inside its own run; the error is
stored on its handle and the neighbouring queries go on.

Per-query attribution rides the existing telemetry: the trace stack is
thread-local, so each admitted query's spans root at its own
``serve:query`` span; ``serve:admit`` marks the admission decision on the
submitter's thread.

Cancellation: ``QueryHandle.cancel()`` flips the context flag; a queued
query resolves immediately, a running one unwinds at its next chunk
boundary (see serve/context.py), releasing budget reservations and
read-ahead futures through the streamers' ``finally`` blocks.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Optional

from ..exceptions import HyperspaceError
from ..staticcheck.concurrency import TrackedLock
from ..telemetry import trace
from ..utils import env
from . import qos
from .budget import global_budget
from .context import QueryCancelledError, QueryContext, query_scope
from .tenant import DEFAULT_TENANT, TENANTS, TenantQuotaExceeded


class AdmissionRejected(HyperspaceError):
    """The run queue is full (``HYPERSPACE_SERVE_QUEUE_DEPTH``): shed load
    at admission instead of queueing unboundedly."""


class DeadlineUnmeetable(AdmissionRejected):
    """SLO-aware admission: the query carried a deadline the cost model
    (serve/qos.py) says cannot be met given the current queue state —
    reject fast at submit time instead of queueing a query that is already
    dead. Subclasses ``AdmissionRejected`` because it IS load shedding;
    distinct type so deadline-aware callers can degrade differently."""


class SchedulerShutdown(HyperspaceError):
    """submit() after shutdown()."""


_QUEUED, _RUNNING, _DONE, _FAILED, _CANCELLED = (
    "queued", "running", "done", "failed", "cancelled",
)


class QueryHandle:
    """The submitter's view of one query: status, result, cancellation."""

    __slots__ = (
        "ctx", "_fn", "_sched", "status", "_result", "_error", "_done",
        "_submit_t", "_admit_t", "_finish_t", "_predicted_s",
    )

    def __init__(self, ctx: QueryContext, fn: Callable, sched=None):
        self.ctx = ctx
        self._fn = fn
        self._sched = sched
        self.status = _QUEUED
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._submit_t = 0.0
        self._admit_t = 0.0
        self._finish_t = 0.0
        self._predicted_s: Optional[float] = None  # SLO cost prediction

    @property
    def tenant(self) -> str:
        return self.ctx.tenant

    @property
    def query_id(self) -> int:
        return self.ctx.query_id

    @property
    def label(self) -> str:
        return self.ctx.label

    @property
    def priority(self) -> int:
        return self.ctx.priority

    @property
    def queue_wait_s(self) -> float:
        """Submission → admission wall time (0 until admitted)."""
        return max(0.0, self._admit_t - self._submit_t) if self._admit_t else 0.0

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the query's outcome. Re-raises the query's failure or
        ``QueryCancelledError``; ``TimeoutError`` when still in flight."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} ({self.label}) still {self.status} "
                f"after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> None:
        """Cooperative cancel: a queued query resolves immediately; a
        running one unwinds at its next chunk boundary."""
        if self._sched is not None:
            self._sched.cancel(self)
        else:
            self.ctx.cancel()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"QueryHandle(id={self.query_id}, {self.label!r}, {self.status})"


class QueryScheduler:
    """Bounded-queue, priority-ordered admission controller over a fixed
    worker pool. One instance serves many submitters; all state transitions
    happen under one lock, metric emission outside it."""

    def __init__(
        self,
        max_concurrent: Optional[int] = None,
        queue_depth: Optional[int] = None,
    ):
        from ..utils.workers import io_pool

        self.max_concurrent = max(
            1,
            max_concurrent
            if max_concurrent is not None
            else env.env_int("HYPERSPACE_MAX_CONCURRENT_QUERIES"),
        )
        self.queue_depth = max(
            1,
            queue_depth
            if queue_depth is not None
            else env.env_int("HYPERSPACE_SERVE_QUEUE_DEPTH"),
        )
        self._lock = TrackedLock("serve.scheduler")
        # per-tenant (-priority, seq, handle) heaps drained by weighted-
        # fair scheduling over delivered cost (serve/qos.py); one tenant
        # degenerates to exactly the old single FIFO+priority queue
        self._queues = qos.TenantQueues()
        self._aging_ms = env.env_float("HYPERSPACE_SERVE_AGING_MS")
        self._aging_cap = env.env_int("HYPERSPACE_SERVE_AGING_CAP")
        self._seq = itertools.count()
        self._queued = 0  # live (non-cancelled) queued entries, all tenants
        self._active: dict[int, QueryHandle] = {}
        self._handles: set = set()  # every non-terminal handle (drain())
        self._totals = {
            "admitted": 0, "done": 0, "failed": 0,
            "cancelled": 0, "rejected": 0,
        }
        self._down = False
        self._unrun: list = []  # ctx of queued-cancelled queries, drained
        # outside the lock into the query log (_flush_unrun)
        self._pool = io_pool(self.max_concurrent, "hs-serve")
        # knob-gated observability plane (HYPERSPACE_METRICS_PORT /
        # HYPERSPACE_SNAPSHOT_FILE): a serving process is exactly where the
        # exporter should come up; completely off otherwise
        from ..telemetry import exporter as _exporter

        _exporter.maybe_start_from_env()

    # --- submission -------------------------------------------------------

    def submit(
        self,
        fn: Callable,
        *,
        priority: Optional[int] = None,
        label: str = "query",
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
        allow_approx: bool = True,
    ) -> QueryHandle:
        """Enqueue a zero-arg callable (typically ``df.collect``) and
        return its handle. ``tenant`` names the owning tenant ("default"
        when unset — the zero-config path). Door checks in order: the
        tenant's token bucket and ``max_in_flight`` quota (typed
        ``TenantQuotaExceeded``), the global queue bound
        (``AdmissionRejected``), then — only for queries carrying a
        ``deadline_s`` — the SLO feasibility check. An unmeetable deadline
        degrades to the sampled tier (``ctx.approx_fraction`` set, tier
        chosen to fit the deadline; serve/qos.choose_degrade_tier) when
        ``allow_approx`` and ``HYPERSPACE_APPROX`` are on, and rejects
        with the typed ``DeadlineUnmeetable`` otherwise.
        ``SchedulerShutdown`` after shutdown."""
        if priority is None:
            priority = env.env_int("HYPERSPACE_SERVE_DEFAULT_PRIORITY")
        tenant_name = tenant if tenant else DEFAULT_TENANT
        ten = TENANTS.get(tenant_name)
        ctx = QueryContext(label=label, priority=priority,
                           tenant=tenant_name, deadline_s=deadline_s)
        h = QueryHandle(ctx, fn, self)
        now = time.perf_counter()
        # the token bucket is checked lock-free at the very door: a
        # rate-limited submission never contends on the scheduler lock
        rate_ok = ten.try_acquire_token()
        reject: Optional[tuple] = None  # (kind, exception to raise)
        degraded: Optional[dict] = None  # chosen sampled tier, if any
        with trace.span(
            "serve:admit", query_id=ctx.query_id, label=label,
            priority=priority, tenant=tenant_name,
        ) as sp:
            with trace.span("qos:admit", tenant=tenant_name) as qsp:
                with self._lock:
                    if self._down:
                        raise SchedulerShutdown("scheduler is shut down")
                    tq_queued, tq_active = self._queues.counts(tenant_name)
                    if not rate_ok:
                        self._queues.note_rejection(tenant_name, "rate")
                        self._totals["rejected"] += 1
                        reject = ("rate", TenantQuotaExceeded(
                            f"tenant {tenant_name!r} over its rate limit "
                            f"({ten.rate_qps} qps, burst {ten.burst}); "
                            f"query {ctx.query_id} ({label}) rejected"
                        ))
                    elif (
                        ten.max_in_flight is not None
                        and tq_queued + tq_active >= ten.max_in_flight
                    ):
                        self._queues.note_rejection(tenant_name, "quota")
                        self._totals["rejected"] += 1
                        reject = ("quota", TenantQuotaExceeded(
                            f"tenant {tenant_name!r} at its in-flight quota "
                            f"({ten.max_in_flight}); query {ctx.query_id} "
                            f"({label}) rejected"
                        ))
                    elif self._queued >= self.queue_depth:
                        self._totals["rejected"] += 1
                        reject = ("depth", AdmissionRejected(
                            f"run queue full ({self.queue_depth} queued); "
                            f"query {ctx.query_id} ({label}) rejected"
                        ))
                    else:
                        verdict = None
                        if deadline_s is not None:
                            verdict = qos.deadline_verdict(
                                label, deadline_s, self._queued,
                                self.max_concurrent,
                            )
                        if verdict is not None and not verdict["admit"]:
                            # degrade before rejecting: an unmeetable exact
                            # deadline is degraded when the submitter
                            # allowed it and the approximate tier is on
                            if allow_approx:
                                degraded = qos.choose_degrade_tier(
                                    label, deadline_s, self._queued,
                                    self.max_concurrent,
                                )
                            if degraded is None:
                                self._queues.note_rejection(
                                    tenant_name, "deadline"
                                )
                                self._totals["rejected"] += 1
                                reject = ("deadline", DeadlineUnmeetable(
                                    f"query {ctx.query_id} ({label}) "
                                    f"deadline {deadline_s:.3f}s unmeetable:"
                                    f" expected completion "
                                    f"{verdict['expected_s']:.3f}s given "
                                    f"{self._queued} queued"
                                ))
                            else:
                                ctx.approx_fraction = degraded["fraction"]
                                self._queues.note_degrade(tenant_name)
                        if reject is None:
                            if degraded is not None:
                                h._predicted_s = degraded["predicted_s"]
                            elif verdict is not None:
                                h._predicted_s = verdict["predicted_s"]
                            h._submit_t = now
                            self._queues.push(
                                tenant_name,
                                (-priority, next(self._seq), h),
                            )
                            self._queued += 1
                            self._totals["admitted"] += 1
                            self._handles.add(h)
                            self._dispatch_locked()
                    queued, active = self._queued, len(self._active)
                qsp.set_attr(
                    "decision",
                    reject[0] if reject
                    else ("degraded" if degraded is not None else "admitted"),
                )
                if degraded is not None:
                    qsp.set_attr("fraction", degraded["fraction"])
                    qsp.set_attr(
                        "predicted_s", round(degraded["predicted_s"], 6)
                    )
            sp.set_attr("rejected", reject is not None)
            sp.set_attr("queued", queued)
        from ..telemetry.metrics import REGISTRY

        if reject is not None:
            kind, exc = reject
            REGISTRY.counter("serve.rejected").inc()
            if kind != "depth":
                REGISTRY.counter(f"serve.tenant.rejected.{kind}").inc()
            if kind == "deadline":
                # a deadline rejection used to vanish from the query log /
                # workload journal entirely — the drift detector then never
                # saw the rejected workload. Zero-charge "rejected" record,
                # appended OUTSIDE the lock like every ledger write.
                from ..telemetry.attribution import LEDGER

                LEDGER.record_unrun(ctx, outcome="rejected")
            raise exc
        if degraded is not None:
            from ..plan.sampling import APPROX

            APPROX.note_degrade()
            REGISTRY.counter("approx.degrades").inc()
        REGISTRY.counter("serve.admitted").inc()
        REGISTRY.gauge("serve.queue_depth").set(queued)
        REGISTRY.gauge("serve.active_queries").set(active)
        self._flush_unrun()
        return h

    def submit_query(self, df, *, priority: Optional[int] = None,
                     label: str = "query", tenant: Optional[str] = None,
                     deadline_s: Optional[float] = None,
                     allow_approx: bool = True) -> QueryHandle:
        """Convenience: submit a DataFrame's collect()."""
        return self.submit(df.collect, priority=priority, label=label,
                           tenant=tenant, deadline_s=deadline_s,
                           allow_approx=allow_approx)

    # --- dispatch (lock held) ---------------------------------------------

    def _dispatch_locked(self) -> None:
        while len(self._active) < self.max_concurrent:
            popped = self._queues.pop_locked(self._aging_ms, self._aging_cap)
            if popped is None:
                return
            tenant_name, h = popped
            if h.ctx.cancelled:
                # context cancelled without going through scheduler.cancel
                # (direct ctx.cancel()): resolve without running
                self._finish_locked(h, _CANCELLED, None,
                                    QueryCancelledError(
                                        f"query {h.query_id} cancelled"))
                h._done.set()
                # hslint: HS302 — caller holds self._lock (_locked contract)
                self._unrun.append(h.ctx)
                continue
            self._queued -= 1
            self._queues.on_dequeue(tenant_name)
            h.status = _RUNNING
            h._admit_t = time.perf_counter()
            h.ctx.device_home = self._home_device_locked()
            self._active[h.query_id] = h
            self._queues.on_activate(tenant_name)
            self._pool.submit(self._run, h)

    def _home_device_locked(self) -> "Optional[int]":
        """Whole-query device placement. The port has one card and no mesh
        tier, so there is nothing to place: None, as the JAX package
        answers with fewer than two mesh devices."""
        return None

    def _finish_locked(self, h: QueryHandle, status: str, result,
                       error) -> None:
        if h.status == _QUEUED:
            self._queued -= 1
            self._queues.on_dequeue(h.ctx.tenant)
        if h.query_id in self._active:
            self._queues.on_deactivate(h.ctx.tenant)
        h.status = status
        h._result = result
        h._error = error
        h._finish_t = time.perf_counter()
        self._active.pop(h.query_id, None)
        self._handles.discard(h)
        # hslint: HS302 — every caller holds self._lock (_locked contract)
        self._totals[status] += 1
        self._queues.note_outcome(h.ctx.tenant, status)

    def _flush_unrun(self) -> None:
        """Append query-log records for queries resolved inside the lock
        without ever running (queued-cancel): the ledger append and metric
        emission must happen outside the scheduler lock."""
        with self._lock:
            pending, self._unrun = self._unrun, []
        if pending:
            from ..telemetry.attribution import LEDGER

            for ctx in pending:
                LEDGER.record_unrun(ctx)

    # --- worker -----------------------------------------------------------

    def _run(self, h: QueryHandle) -> None:
        from ..telemetry import attribution
        from ..telemetry.metrics import REGISTRY

        REGISTRY.histogram("serve.queue_wait_ms").observe(
            h.queue_wait_s * 1000
        )
        # open the per-query attribution entry and install it for the whole
        # execution: every counter/histogram write on this thread — and on
        # IO-pool tasks bound via attribution.bound() — charges this query
        stats = attribution.LEDGER.begin(h.ctx, queue_wait_s=h.queue_wait_s)
        if h.ctx.approx_fraction is not None:
            # stamp the admission-time degrade decision on the query-log
            # record; plan/sampling.py merges engagement details on top
            stats.note_approx({
                "degraded": True,
                "requested_f": h.ctx.approx_fraction,
                "deadline_s": h.ctx.deadline_s,
            })
        try:
            with query_scope(h.ctx), attribution.scope(stats):
                with trace.span(
                    "serve:query", query_id=h.query_id, label=h.label,
                    priority=h.priority, tenant=h.ctx.tenant,
                ) as sp:
                    out = h._fn()
                    sp.set_attr("status", "done")
                    if (h._predicted_s is not None
                            and h.ctx.approx_fraction is None):
                        # observe the SLO prediction against the actual run
                        # wall INSIDE the attribution scope so the
                        # estimator.qerror.serve.wall histogram stays
                        # conserved (per-query sums == global deltas).
                        # Degraded runs are skipped: a sampled wall scored
                        # against the exact label would corrupt the
                        # serve.wall correction factor
                        qos.observe_wall(
                            h.label, h._predicted_s,
                            time.perf_counter() - h._admit_t,
                        )
            status, result, error = _DONE, out, None
        except QueryCancelledError as e:
            status, result, error = _CANCELLED, None, e
        except BaseException as e:  # noqa: BLE001 - stored, re-raised in result()
            status, result, error = _FAILED, None, e
        # finish AFTER the scope exited so the rollup metrics are not
        # charged back to the query they describe; the record is also the
        # WFQ cost source, so it must exist before the next dispatch pick
        record = attribution.LEDGER.finish(stats, outcome=status, error=error)
        # degraded runs feed the cost model under their TIER label only, so
        # the exact label's EWMA never learns from a sampled wall — but only
        # when the sampled tier actually ENGAGED. A degrade the collect path
        # declined (plan ineligible, missing twins) ran exact and feeds the
        # exact label: an exact wall under the tier label would inflate the
        # tier EWMA and skew future choose_degrade_tier picks. Engagement
        # comes from the approx block plan/sampling.py merged onto the
        # query record.
        engaged = bool((record.get("approx") or {}).get("engaged"))
        cost_label = (
            qos.tier_label(h.label, h.ctx.approx_fraction)
            if h.ctx.approx_fraction is not None and engaged
            else h.label
        )
        qos.COST_MODEL.update(cost_label, record["total_ms"] / 1000.0)
        cost = qos.query_cost(record)
        with trace.span(
            "qos:charge", query_id=h.query_id, tenant=h.ctx.tenant,
            cost_s=round(cost, 6),
        ):
            with self._lock:
                self._finish_locked(h, status, result, error)
                self._queues.charge(h.ctx.tenant, cost)
                self._dispatch_locked()
                queued, active = self._queued, len(self._active)
        h._done.set()
        self._flush_unrun()
        REGISTRY.counter(f"serve.{status}").inc()
        REGISTRY.gauge("serve.queue_depth").set(queued)
        REGISTRY.gauge("serve.active_queries").set(active)

    # --- control ----------------------------------------------------------

    def cancel(self, h: QueryHandle) -> None:
        """Handle-level cancel with immediate resolution for queued
        queries (running ones resolve at their next chunk boundary)."""
        h.ctx.cancel()
        notify = False
        with self._lock:
            if h.status == _QUEUED:
                self._finish_locked(
                    h, _CANCELLED, None,
                    QueryCancelledError(f"query {h.query_id} cancelled"),
                )
                self._dispatch_locked()
                notify = True
            queued, active = self._queued, len(self._active)
        if notify:
            from ..telemetry.attribution import LEDGER
            from ..telemetry.metrics import REGISTRY

            h._done.set()
            LEDGER.record_unrun(h.ctx, queue_wait_s=h.queue_wait_s)
            REGISTRY.counter("serve.cancelled").inc()
            REGISTRY.gauge("serve.queue_depth").set(queued)
            REGISTRY.gauge("serve.active_queries").set(active)
        self._flush_unrun()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted query reached a terminal state."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                pending = list(self._handles)
            if not pending:
                return True
            remaining = None
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
            pending[0]._done.wait(remaining)

    def shutdown(self, wait: bool = True, cancel: bool = False) -> None:
        """Stop admitting; optionally cancel everything in flight. With
        ``wait`` the worker pool joins (running queries finish or unwind)."""
        with self._lock:
            self._down = True
            pending = list(self._handles) if cancel else []
        for h in pending:
            self.cancel(h)
        self._pool.shutdown(wait=wait)

    # --- introspection ----------------------------------------------------

    def state(self) -> dict:
        """Aggregate serving state for the profile and the exporter: active + queued
        queries with their waits, totals, and the global budget ledger."""
        now = time.perf_counter()
        with self._lock:
            active = [
                {
                    "query_id": h.query_id,
                    "label": h.label,
                    "priority": h.priority,
                    "tenant": h.ctx.tenant,
                    "queue_wait_ms": round(h.queue_wait_s * 1000, 3),
                    "running_ms": round((now - h._admit_t) * 1000, 3),
                }
                for h in self._active.values()
            ]
            queued = [
                {
                    "query_id": h.query_id,
                    "label": h.label,
                    "priority": h.priority,
                    "tenant": tname,
                    "waited_ms": round((now - h._submit_t) * 1000, 3),
                }
                for tname, pri_neg, seq, h in sorted(
                    self._queues.queued_entries(),
                    key=lambda e: (e[1], e[2]),
                )
            ]
            totals = dict(self._totals)
            tenants = self._queues.state()
        return {
            "max_concurrent": self.max_concurrent,
            "queue_depth_limit": self.queue_depth,
            "active": active,
            "queued": queued,
            "totals": totals,
            "tenants": tenants,
            "budget": global_budget().state(),
            "device_budget": _device_budget_state(),
        }


# --- process-default scheduler ----------------------------------------------

_default_lock = TrackedLock("serve.scheduler_singleton")
_DEFAULT: Optional[QueryScheduler] = None


def get_scheduler() -> QueryScheduler:
    """The process-default scheduler (knob-configured), created on first
    use — the REPL/server entry point; tests build their own instances."""
    global _DEFAULT
    with _default_lock:
        if _DEFAULT is None:
            _DEFAULT = QueryScheduler()
        return _DEFAULT


def reset_scheduler(wait: bool = True) -> None:
    """Shut the default scheduler down and forget it (tests)."""
    global _DEFAULT
    with _default_lock:
        sched, _DEFAULT = _DEFAULT, None
    if sched is not None:
        sched.shutdown(wait=wait, cancel=True)


def submit(fn: Callable, *, priority: Optional[int] = None,
           label: str = "query", tenant: Optional[str] = None,
           deadline_s: Optional[float] = None) -> QueryHandle:
    """Module-level convenience on the default scheduler."""
    return get_scheduler().submit(fn, priority=priority, label=label,
                                  tenant=tenant, deadline_s=deadline_s)


def serve_state() -> dict:
    """Serving state without forcing a scheduler into existence: the
    default scheduler's state when one exists, else an idle snapshot with
    the budget ledger (the profile renders this)."""
    with _default_lock:
        sched = _DEFAULT
    if sched is not None:
        return sched.state()
    return {
        "max_concurrent": None,
        "queue_depth_limit": None,
        "active": [],
        "queued": [],
        "totals": {},
        "tenants": {},
        "budget": global_budget().state(),
        "device_budget": _device_budget_state(),
    }


def _device_budget_state() -> dict:
    """Device-ledger occupancy + spill counters: the device-memory block
    rendered by the profile and the exporter /snapshot (one card, so one
    ledger and no per-device rollup)."""
    from ..telemetry.metrics import REGISTRY
    from .budget import device_budget

    st = device_budget().state()
    for name in ("parks", "spills", "resumes"):
        st[name] = REGISTRY.counter(f"join.spill.{name}").value
    return st
