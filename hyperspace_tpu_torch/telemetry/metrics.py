"""Process-wide metrics registry: named counters, gauges, and histograms
(counterpart of hyperspace_tpu/telemetry/metrics.py).

Always on (unlike tracing): every instrumented site pays a dict lookup plus
a per-metric lock — and every site sits on per-query or per-chunk paths, so
there is no per-row cost. The registry is the accumulation layer the span
tree (trace.py) and the bench artifact both read.

Canonical metric names (see docs/observability.md for the full catalog):

    rules.<Rule>.applied / rules.<Rule>.rejected   rule hit/miss counts
    rules.reject.<CODE>                            structured reject reasons
    rules.candidate_score                          scores of winning rewrites
    cache.index_chunk.{hits,misses,evictions}      decoded-chunk cache
    cache.source_col.{hits,misses,evictions}       maintenance column cache
    cache.device.{hits,misses,evictions}           device-resident arrays
    cache.<name>.evicted_bytes                     bytes evicted (not counts)
    cache.<name>.bytes                             occupancy gauge
    cache.kernel.{hits,misses,evictions}           compiled-kernel cache
    cache.kernel_join.{hits,misses,evictions}      bucketed-join kernel cache
    kernel.retrace                                 kernel builds (cache misses)
    pipeline.{chunks,queries,aborted,declined}     streaming executor
    pipeline.query_ms                              streamed-query latencies
    pipeline.join.{pairs,bands,buckets,splits}     streamed bucketed join
    pipeline.join.{queries,aborted}                join pipeline outcomes
    pipeline.join.pad_rows_saved                   padding avoided by banding
    pipeline.join.query_ms                         banded-join latencies
    join.strategy.{broadcast,banded,split}         per-bucket strategy picks
    join.spill.{parks,spills,resumes}              device-ledger admission
    join.spill.park_ms                             parked-wave wait latencies
    serve.device_budget.{reservations,stalls,force_grants} device ledger
    serve.device_budget_bytes                      device-ledger occupancy
    io.chunks / io.parallel_reads                  parallel reader activity
    io.chunk_decode_ms                             per-chunk decode latencies
    dataskipping.files_pruned / files_scanned      data-skipping effect
    dataskipping.bytes_pruned                      bytes never read
    pruning.{files_total,files_kept}               index-scan file pruning
    pruning.{rowgroups_total,rowgroups_kept}       row-group skipping effect
    pruning.bytes_skipped                          index bytes never decoded
    pruning.verified                               PRUNE=verify passes
    cache.rowgroup_stats.{hits,misses,evictions}   parquet footer-stats cache
    kernel.dispatch_ms                             device kernel latencies
    rpc.upload_bytes / rpc.fetch_bytes             transfer volume
    io.bytes_decoded / io.rows_decoded             decoded scan volume

Attributed write path: while a query runs (served by the scheduler, or a
direct ``collect()``), its per-query ledger entry (telemetry/attribution.
QueryStats) sits in the ``_attr_target`` contextvar, and every
``Counter.inc`` / ``Histogram.observe`` charges the same delta to that
entry as well as to the global value. IO-pool tasks carry the target over
through ``attribution.bound``. Outside a query the path costs one
contextvar read returning None.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Iterable, Optional

from ..staticcheck.concurrency import TrackedLock

# The active per-query attribution target of the current context (an
# object with charge_counter/charge_observation), or None.
_attr_target: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_attribution_target", default=None
)

# Per-metric value locks below stay PLAIN threading.Locks on purpose: they
# are leaves (an inc/observe never acquires anything else while holding
# one) and sit on every instrumented path, so they skip the lock-order
# audit by design. The registry map lock, which is held while metrics are
# constructed, is tracked.


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
        # attributed write path: charge the same delta to the running
        # query's ledger entry (outside our leaf lock — QueryStats has its
        # own leaf lock and leaves never nest)
        stats = _attr_target.get()
        if stats is not None:
            stats.charge_counter(self.name, n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


# default bucket bounds tuned for latencies in milliseconds
_DEFAULT_BOUNDS = (0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000)


class Histogram:
    """Fixed-bound histogram with count/sum/min/max."""

    __slots__ = ("name", "bounds", "_lock", "count", "sum", "min", "max", "buckets")

    def __init__(self, name: str, bounds: Optional[Iterable[float]] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else _DEFAULT_BOUNDS
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * (len(self.bounds) + 1)  # last = overflow

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self.buckets[i] += 1
                    break
            else:
                self.buckets[-1] += 1
        stats = _attr_target.get()
        if stats is not None:
            stats.charge_observation(self.name, v)

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": round(self.sum, 3),
                "mean": round(self.sum / self.count, 3),
                "min": round(self.min, 3),
                "max": round(self.max, 3),
            }

    def full(self) -> dict:
        """Summary PLUS the bucket counts, all read under ONE lock
        acquisition — the consistent cut the Prometheus exporter renders
        (`sum(buckets) == count` holds for every reader, never a torn
        bucket/count pair mid-observe)."""
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "bounds": list(self.bounds),
                "buckets": list(self.buckets),
            }

    @property
    def value(self) -> dict:
        return self.summary()

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = float("-inf")
            self.buckets = [0] * (len(self.bounds) + 1)


class MetricsRegistry:
    """Get-or-create registry; one instance (REGISTRY) serves the process."""

    def __init__(self):
        self._lock = TrackedLock("metrics.registry")
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, bounds: Optional[Iterable[float]] = None) -> Histogram:
        if bounds is not None:
            return self._get_or_create(name, Histogram, bounds)
        return self._get_or_create(name, Histogram)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """{name: value} for every metric with signal (zero counters are
        skipped so reports stay readable). Internally consistent per
        metric even mid-update: one pass, each value read under its own
        metric lock (a Histogram summary is one lock acquisition — its
        count/sum/mean/min/max always agree with each other)."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            v = m.value
            if isinstance(m, Counter) and v == 0:
                continue
            if isinstance(m, Histogram) and v.get("count", 0) == 0:
                continue
            out[name] = v
        return out

    def export(self) -> list[tuple]:
        """``[(name, kind, value)]`` for EVERY registered metric (zeros
        included), sorted by name — the exporter's read path. Kind is
        "counter" | "gauge" | "histogram"; histogram values come from
        ``Histogram.full()`` so bucket counts and count/sum are one
        consistent cut per metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for name, m in items:
            if isinstance(m, Counter):
                out.append((name, "counter", m.value))
            elif isinstance(m, Gauge):
                out.append((name, "gauge", m.value))
            else:
                out.append((name, "histogram", m.full()))
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


REGISTRY = MetricsRegistry()
