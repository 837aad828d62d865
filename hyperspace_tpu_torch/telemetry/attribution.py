"""Per-query resource attribution: the serving telemetry ledger
(counterpart of hyperspace_tpu/telemetry/attribution.py).

The metrics registry (metrics.py) aggregates globally — `io.chunks`,
`cache.*`, `serve.budget.*` count everything every in-flight query did,
which cannot answer "which query is eating the IO budget". This module
adds the per-query dimension: the scheduler opens a ``QueryStats`` entry
in the process-wide ``QueryStatsLedger`` for every admitted query and
installs it as the thread's *attribution target* (a contextvar owned by
metrics.py); every ``Counter.inc`` / ``Histogram.observe`` that fires
while the target is installed charges the same delta to that query.

Conservation invariant (held by the tests and chip_smoke.py): for any
metric name, the sum over per-query ledger entries equals the global
counter's delta over the serving window — attribution is a second ledger
over the SAME increments, never a separate estimate.

Worker propagation: streamers hand decode tasks to shared IO pools, so
increments fire on pool threads. ``bound(fn)`` wraps a task at submit
time, capturing the submitting thread's target and installing it in the
worker for the task's duration (cheap identity passthrough when no query
is running). Single-flight caches charge whichever query ran the factory
— the sum still balances.

Phase accounting: spans need tracing enabled, but the serving query log
must work on an untraced server, so the engine's phase chokepoints charge
wall time directly via ``phase(name)`` / ``charge_phase``:

    plan      optimizer + index rewrite       (plan/dataframe.py)
    io        chunk / bucket-pair decode      (columnar/io.py, bucket_join)
    upload    host->device transfers          (utils/device_cache)
    dispatch  device kernel dispatch          (gpu_exec._observe_dispatch)
    fetch     blocking device_get round trips (utils/rpc_meter.device_get)
    fold      host folds of fetched partials  (gpu_exec, device_join)
    park      device-ledger admission waits   (plan/join_memory.DeviceLedger)

Phases are *resource* times: io runs on pool threads concurrently with
dispatch, so phases can overlap and need not sum to wall time. When
tracing IS enabled the same breakdown is recoverable from the query's
``serve:query`` span tree.

Every finished query (done / failed / cancelled — including cancelled
while still queued) appends a structured record to a rolling in-memory
window (``HYPERSPACE_QUERY_LOG_WINDOW``) rendered by the profile and the
exporter's /snapshot; records slower than
``HYPERSPACE_SLOW_QUERY_MS`` additionally append to the JSONL slow-query
log at ``HYPERSPACE_SLOW_QUERY_FILE``. Every record carries its owning
``tenant`` (the QoS dimension), and ``tenant_rollups`` /
``aggregate_counters_by_tenant`` extend the conservation invariant to the
tenant plane: sum over tenants == sum over queries == global deltas.

The ledger's map lock is a ``TrackedLock``; each attribution scope is a
lifecycle-audit handle (``attribution.scope``).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Optional

from ..staticcheck.concurrency import TrackedLock
from ..staticcheck.lifecycle import release_resource, tracked_resource
from ..utils import env
from .metrics import _attr_target

PHASES = ("plan", "io", "upload", "dispatch", "fetch", "fold", "park")

# global-counter names surfaced as first-class query-record fields
_BYTES_DECODED = "io.bytes_decoded"
_ROWS_DECODED = "io.rows_decoded"


class QueryStats:
    """One query's attribution entry: counters, histogram rollups, and
    phase times charged while the query's target is installed. Charged
    from several threads at once (the query worker plus bound IO-pool
    tasks), so all mutation sits under one plain leaf lock — like the
    per-metric value locks, nothing is ever acquired while holding it."""

    __slots__ = (
        "query_id", "label", "priority", "tenant", "seq", "started_s",
        "finished_s", "outcome", "error", "queue_wait_s", "duration_s",
        "_lock", "_counters", "_hists", "_phases", "_wl", "_approx",
    )

    def __init__(self, query_id: int, label: str = "query",
                 priority: int = 0, queue_wait_s: float = 0.0,
                 tenant: str = "default"):
        self.query_id = query_id
        self.label = label
        self.priority = priority
        self.tenant = tenant
        self.seq = 0  # ledger-assigned monotonic id (windows of records)
        self.started_s = time.time()
        self.finished_s = 0.0
        self.outcome: Optional[str] = None  # None while running
        self.error: Optional[str] = None
        self.queue_wait_s = queue_wait_s
        self.duration_s = 0.0
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._hists: dict[str, tuple] = {}  # name -> (count, sum)
        self._phases: dict[str, float] = {}
        self._wl: "dict[str, list] | None" = None  # workload-plane notes
        self._approx: "dict | None" = None  # approximate-tier decision/CIs

    # --- charge paths (called from metrics.py and the phase chokepoints) --

    def charge_counter(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def charge_observation(self, name: str, v: float) -> None:
        with self._lock:
            c, s = self._hists.get(name, (0, 0.0))
            self._hists[name] = (c + 1, s + v)

    def charge_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            self._phases[name] = self._phases.get(name, 0.0) + seconds

    def note_workload(self, key: str, item, cap: int = 64) -> None:
        """Append one workload-plane note (telemetry/workload.py chokepoints:
        shapes, candidates, chosen indexes, prune deltas). Lazily allocated
        and bounded, so queries outside the plane pay one None check."""
        with self._lock:
            if self._wl is None:
                self._wl = {}
            items = self._wl.setdefault(key, [])
            if len(items) < cap:
                items.append(item)

    def note_approx(self, info: dict) -> None:
        """Merge approximate-tier facts onto the query (the QoS degrade
        decision, and whether a sampled tier engaged). The merged dict
        rides the query-log record into the journal and the exporter."""
        with self._lock:
            if self._approx is None:
                self._approx = {}
            self._approx.update(info)

    def workload_notes(self) -> dict:
        with self._lock:
            if self._wl is None:
                return {}
            return {k: list(v) for k, v in self._wl.items()}

    # --- reads ------------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def phases_s(self) -> dict:
        with self._lock:
            return dict(self._phases)

    def record(self) -> dict:
        """The structured query-log record (also the /snapshot
        row). Materialized on read so charges from straggler pool tasks
        that outlive the query still land in later snapshots."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            phases = dict(self._phases)
            approx = dict(self._approx) if self._approx is not None else None
        cache_hits = sum(
            v for k, v in counters.items()
            if k.startswith("cache.") and k.endswith(".hits")
        )
        cache_misses = sum(
            v for k, v in counters.items()
            if k.startswith("cache.") and k.endswith(".misses")
        )
        looked = cache_hits + cache_misses
        running = self.outcome is None
        dur = self.duration_s if not running else time.time() - self.started_s
        return {
            "seq": self.seq,
            "query_id": self.query_id,
            "label": self.label,
            "priority": self.priority,
            "tenant": self.tenant,
            "outcome": self.outcome or "running",
            "error": self.error,
            "started_s": round(self.started_s, 3),
            "queue_wait_ms": round(self.queue_wait_s * 1000, 3),
            "total_ms": round(dur * 1000, 3),
            # zero-filled over the full phase vocabulary so every outcome
            # path (done / failed / cancelled-unrun) emits the same record
            # shape and journal consumers never special-case
            "phases_ms": {
                p: round(phases.get(p, 0.0) * 1000, 3) for p in PHASES
            },
            "bytes_read": int(counters.get(_BYTES_DECODED, 0)),
            "rows_decoded": int(counters.get(_ROWS_DECODED, 0)),
            "chunks": int(counters.get("io.chunks", 0)),
            "cache_hits": int(cache_hits),
            "cache_misses": int(cache_misses),
            "cache_hit_ratio": round(cache_hits / looked, 4) if looked else None,
            "upload_bytes": int(counters.get("rpc.upload_bytes", 0)),
            "fetch_bytes": int(counters.get("rpc.fetch_bytes", 0)),
            "budget_stalls": int(counters.get("serve.budget.stalls", 0)),
            "budget_force_grants": int(
                counters.get("serve.budget.force_grants", 0)
            ),
            "retries": int(counters.get("io.retry.attempts", 0)),
            "faults_injected": int(counters.get("faults.injected", 0)),
            "degrades": int(counters.get("device.degrades", 0)),
            "approx": approx,
            "counters": counters,
            "histograms": {
                k: {"count": c, "sum": round(s, 3)}
                for k, (c, s) in sorted(hists.items())
            },
        }


# ---------------------------------------------------------------------------
# attribution scope (installs the target metrics.py charges through)
# ---------------------------------------------------------------------------

def current_stats() -> Optional[QueryStats]:
    """The QueryStats the current thread/context is charging, or None."""
    return _attr_target.get()


class scope:
    """Install ``stats`` as the attribution target for the duration."""

    __slots__ = ("_stats", "_token", "_lc")

    def __init__(self, stats: QueryStats):
        self._stats = stats
        self._token = None
        self._lc = 0

    def __enter__(self) -> QueryStats:
        self._lc = tracked_resource(
            "attribution.scope", self._stats.label,
            query=self._stats.query_id, tenant=self._stats.tenant,
        )
        self._token = _attr_target.set(self._stats)
        return self._stats

    def __exit__(self, *exc) -> bool:
        _attr_target.reset(self._token)
        release_resource(self._lc)
        return False


def bound(fn):
    """Wrap a pool task so it carries the SUBMITTING thread's attribution
    target: the streamers decode on shared IO pools, and without this the
    worker-side increments (chunk cache hits, decode latencies, retries)
    would escape the query's ledger and break conservation. Identity when
    no target is installed — the non-serving path stays allocation-free."""
    stats = _attr_target.get()
    if stats is None:
        return fn

    def run(*args, **kwargs):
        token = _attr_target.set(stats)
        try:
            return fn(*args, **kwargs)
        finally:
            _attr_target.reset(token)

    return run


def charge_phase(name: str, seconds: float) -> None:
    """Charge ``seconds`` of ``name`` phase time to the running query, if
    any. One contextvar read when idle — cheap enough for per-chunk and
    per-dispatch chokepoints."""
    stats = _attr_target.get()
    if stats is not None:
        stats.charge_phase(name, seconds)


class phase:
    """Context manager charging the block's wall time to a phase. The
    clock is only read when a query is actually being attributed."""

    __slots__ = ("_name", "_stats", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._stats = None
        self._t0 = 0.0

    def __enter__(self) -> "phase":
        self._stats = _attr_target.get()
        if self._stats is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._stats is not None:
            self._stats.charge_phase(
                self._name, time.perf_counter() - self._t0
            )
        return False


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class QueryStatsLedger:
    """Process-wide registry of active + recently finished query stats.
    All map mutation under one lock; metric emission and slow-log
    writes happen outside it (the repo's lock discipline)."""

    def __init__(self, window: Optional[int] = None):
        self._lock = TrackedLock("telemetry.attribution")
        self._window = max(
            1,
            window if window is not None
            else env.env_int("HYPERSPACE_QUERY_LOG_WINDOW"),
        )
        self._active: dict[int, QueryStats] = {}
        self._recent: collections.deque = collections.deque(
            maxlen=self._window
        )
        self._seq = itertools.count(1)
        self._totals = {"recorded": 0, "slow": 0}

    # --- lifecycle (scheduler integration) --------------------------------

    def begin(self, ctx, queue_wait_s: float = 0.0) -> QueryStats:
        """Open the ledger entry for an admitted query (its QueryContext)."""
        stats = QueryStats(
            ctx.query_id, label=ctx.label, priority=ctx.priority,
            queue_wait_s=queue_wait_s,
            tenant=getattr(ctx, "tenant", "default"),
        )
        with self._lock:
            stats.seq = next(self._seq)
            self._active[stats.query_id] = stats
        return stats

    def finish(self, stats: QueryStats, outcome: str,
               error: Optional[BaseException] = None) -> dict:
        """Move a query to the recent window and emit its rollup metrics.
        Call AFTER the attribution scope exited, so the rollups themselves
        are not charged back to the query."""
        stats.outcome = outcome
        stats.finished_s = time.time()
        stats.duration_s = max(0.0, stats.finished_s - stats.started_s)
        if error is not None:
            stats.error = repr(error)
        with self._lock:
            self._active.pop(stats.query_id, None)
            self._recent.append(stats)
            self._totals["recorded"] += 1
        record = stats.record()
        slow = _maybe_log_slow(record)
        from .metrics import REGISTRY

        REGISTRY.counter("serve.query.records").inc()
        REGISTRY.counter(f"serve.query.outcome.{outcome}").inc()
        REGISTRY.histogram("serve.query.total_ms").observe(record["total_ms"])
        # phase histograms observe only the phases the query actually
        # entered (the record map is zero-filled for shape uniformity;
        # observing the padding zeros would skew the global percentiles)
        for p, s in stats.phases_s().items():
            REGISTRY.histogram(f"serve.query.phase.{p}_ms").observe(
                round(s * 1000, 3)
            )
        if record["bytes_read"]:
            REGISTRY.histogram("serve.query.bytes_read").observe(
                record["bytes_read"]
            )
        if slow:
            with self._lock:
                self._totals["slow"] += 1
            REGISTRY.counter("serve.query.slow").inc()
        from . import workload

        try:
            workload.on_query_finished(stats, record)
        except Exception:  # hslint: HS402 — the workload plane must never fail finish
            pass
        return record

    def record_unrun(self, ctx, outcome: str = "cancelled",
                     queue_wait_s: float = 0.0) -> dict:
        """Query-log completeness for queries that never ran (cancelled
        while queued): zero-charge entry straight to the recent window."""
        stats = self.begin(ctx, queue_wait_s=queue_wait_s)
        return self.finish(stats, outcome)

    # --- reads ------------------------------------------------------------

    def active_records(self) -> list[dict]:
        with self._lock:
            stats = list(self._active.values())
        return [s.record() for s in sorted(stats, key=lambda s: s.seq)]

    def recent_records(self, since_seq: int = 0, limit: Optional[int] = None
                       ) -> list[dict]:
        with self._lock:
            stats = [s for s in self._recent if s.seq > since_seq]
        if limit is not None:
            stats = stats[-limit:]
        return [s.record() for s in stats]

    def snapshot(self, limit: int = 64) -> dict:
        with self._lock:
            totals = dict(self._totals)
        return {
            "window": self._window,
            "totals": totals,
            "active": self.active_records(),
            "recent": self.recent_records(limit=limit),
        }

    def aggregate_counters(self) -> dict:
        """Sum of every attributed counter across active + recent entries
        — the per-query side of the conservation invariant."""
        with self._lock:
            stats = list(self._active.values()) + list(self._recent)
        out: dict[str, float] = {}
        for s in stats:
            for k, v in s.counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def aggregate_counters_by_tenant(self) -> dict:
        """Per-tenant sum of every attributed counter across active +
        recent entries. Because each query belongs to exactly one tenant,
        summing these rollups over tenants reproduces
        ``aggregate_counters()`` exactly — the per-TENANT extension of the
        conservation invariant (sum over tenant
        rollups == global counter deltas)."""
        with self._lock:
            stats = list(self._active.values()) + list(self._recent)
        out: dict[str, dict[str, float]] = {}
        for s in stats:
            bucket = out.setdefault(s.tenant, {})
            for k, v in s.counters().items():
                bucket[k] = bucket.get(k, 0) + v
        return out

    def tenant_rollups(self) -> dict:
        """Per-tenant serving rollups over active + recent entries — the
        exporter /snapshot ``tenants`` block and
        the per-tenant Prometheus label source. Window-scoped like every
        other ledger read (``HYPERSPACE_QUERY_LOG_WINDOW``)."""
        with self._lock:
            stats = list(self._active.values()) + list(self._recent)
        out: dict[str, dict] = {}
        for s in stats:
            r = out.setdefault(s.tenant, {
                "queries": 0, "outcomes": {}, "total_ms": 0.0,
                "queue_wait_ms": 0.0, "bytes_read": 0, "rows_decoded": 0,
                "budget_stalls": 0, "approx_degraded": 0, "approx_sampled": 0,
            })
            rec = s.record()
            approx = rec.get("approx") or {}
            if approx.get("degraded"):
                r["approx_degraded"] += 1
            if approx.get("engaged"):
                r["approx_sampled"] += 1
            r["queries"] += 1
            r["outcomes"][rec["outcome"]] = (
                r["outcomes"].get(rec["outcome"], 0) + 1
            )
            r["total_ms"] = round(r["total_ms"] + rec["total_ms"], 3)
            r["queue_wait_ms"] = round(
                r["queue_wait_ms"] + rec["queue_wait_ms"], 3
            )
            r["bytes_read"] += rec["bytes_read"]
            r["rows_decoded"] += rec["rows_decoded"]
            r["budget_stalls"] += rec["budget_stalls"]
        return out

    def health_window(self) -> dict:
        """Rolling outcome/degrade rates over the recent window (the
        /healthz inputs)."""
        with self._lock:
            stats = list(self._recent)
        total = len(stats)
        failed = sum(1 for s in stats if s.outcome == "failed")
        cancelled = sum(1 for s in stats if s.outcome == "cancelled")
        degraded = sum(
            1 for s in stats if s.counters().get("device.degrades", 0)
        )
        return {
            "window_records": total,
            "failed": failed,
            "cancelled": cancelled,
            "degraded": degraded,
            "error_rate": round(failed / total, 4) if total else 0.0,
            "degrade_rate": round(degraded / total, 4) if total else 0.0,
        }

    def reset_for_testing(self) -> None:
        with self._lock:
            self._active.clear()
            self._recent.clear()
            self._totals = {"recorded": 0, "slow": 0}


# --- slow-query JSONL log ---------------------------------------------------

_slow_lock = TrackedLock("telemetry.slow_query_log")


def _slow_query_config() -> tuple:
    """(path | None, threshold_ms) — the log is enabled iff a file path is
    configured; the threshold defaults to 0 (log every finished query)."""
    path = env.env_str("HYPERSPACE_SLOW_QUERY_FILE")
    if not path:
        return None, 0.0
    return path, env.env_float("HYPERSPACE_SLOW_QUERY_MS")


def _maybe_log_slow(record: dict) -> bool:
    path, threshold_ms = _slow_query_config()
    if path is None or record["total_ms"] < threshold_ms:
        return False
    line = json.dumps(record, default=str)
    d = os.path.dirname(os.path.abspath(path))
    with _slow_lock:
        os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    return True


# --- batch summaries --------------------------------------------------------

def phase_percentiles(records: list) -> dict:
    """{phase: {count, mean_ms, p99_ms}} over a record batch, including a
    synthetic "total" and "queue" phase — the per-phase breakdown of a
    served batch."""
    series: dict[str, list] = {}
    for r in records:
        series.setdefault("total", []).append(r["total_ms"])
        series.setdefault("queue", []).append(r["queue_wait_ms"])
        for p, ms in r.get("phases_ms", {}).items():
            series.setdefault(p, []).append(ms)
    out = {}
    for name, xs in sorted(series.items()):
        xs = sorted(xs)
        out[name] = {
            "count": len(xs),
            "mean_ms": round(sum(xs) / len(xs), 3),
            "p99_ms": round(xs[min(len(xs) - 1, int(0.99 * len(xs)))], 3),
        }
    return out


LEDGER = QueryStatsLedger()
