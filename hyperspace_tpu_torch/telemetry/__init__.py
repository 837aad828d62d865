"""Telemetry: action events, query-scoped tracing, the metrics registry and
plan statistics (counterpart of hyperspace_tpu/telemetry/__init__.py,
exporting what the port has).

- events/logger (action level): `EventLogger`, `NoOpEventLogger`,
  `PythonLoggingEventLogger`, `event_logger_for`, and the event classes.
- trace (query level): the `trace` module — `trace.span`, `trace.enable`,
  `trace.capture`, `trace.profile_string`, `JsonlTraceSink`.
- metrics (process level): the `metrics` module and its `REGISTRY`.
- plan_stats (operator level): the `plan_stats` module — `ACCURACY` (the
  estimator-accuracy ledger), `PlanStatsCollector`, `collect_scope`,
  `render_annotated` — the EXPLAIN ANALYZE / q-error plane.

The JAX package's per-query attribution, exporter, workload journal and
index ledger are not ported yet.
"""

from . import metrics, plan_stats, trace
from .events import (
    AppInfo,
    CancelActionEvent,
    CreateActionEvent,
    DeleteActionEvent,
    HyperspaceEvent,
    HyperspaceIndexCRUDEvent,
    HyperspaceIndexUsageEvent,
    OptimizeActionEvent,
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
    VacuumOutdatedActionEvent,
)
from .logger import (
    EventLogger,
    NoOpEventLogger,
    PythonLoggingEventLogger,
    clear_event_logger_cache,
    event_logger_for,
)
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .plan_stats import ACCURACY, EstimatorAccuracy, PlanStatsCollector
from .trace import JsonlTraceSink, ListTraceSink, Span, TraceSink, profile_string

__all__ = [
    # events
    "AppInfo",
    "HyperspaceEvent",
    "HyperspaceIndexCRUDEvent",
    "HyperspaceIndexUsageEvent",
    "CreateActionEvent",
    "DeleteActionEvent",
    "RestoreActionEvent",
    "VacuumActionEvent",
    "VacuumOutdatedActionEvent",
    "RefreshActionEvent",
    "RefreshIncrementalActionEvent",
    "RefreshQuickActionEvent",
    "OptimizeActionEvent",
    "CancelActionEvent",
    # logging
    "EventLogger",
    "NoOpEventLogger",
    "PythonLoggingEventLogger",
    "event_logger_for",
    "clear_event_logger_cache",
    # tracing
    "trace",
    "Span",
    "TraceSink",
    "JsonlTraceSink",
    "ListTraceSink",
    "profile_string",
    # metrics
    "metrics",
    "REGISTRY",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    # plan statistics / estimator accuracy
    "plan_stats",
    "ACCURACY",
    "EstimatorAccuracy",
    "PlanStatsCollector",
]
