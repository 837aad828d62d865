"""Telemetry: action events, query-scoped tracing, the metrics registry,
plan statistics, per-query attribution, the exporter and the workload
plane (counterpart of hyperspace_tpu/telemetry/__init__.py).

- events/logger (action level): `EventLogger`, `NoOpEventLogger`,
  `PythonLoggingEventLogger`, `event_logger_for`, and the event classes.
- trace (query level): the `trace` module — `trace.span`, `trace.enable`,
  `trace.capture`, `trace.profile_string`, `JsonlTraceSink`.
- metrics (process level): the `metrics` module and its `REGISTRY`.
- attribution (query level, serving): `QueryStatsLedger` / the process
  `LEDGER`, `scope`, `bound`, `phase` — the per-query resource ledger.
- exporter (process level, opt-in): `start_exporter`, `prometheus_text`,
  `snapshot_dict`, `health_dict`, `start_snapshot_sink`.
- plan_stats (operator level): the `plan_stats` module — `ACCURACY` (the
  estimator-accuracy ledger), `PlanStatsCollector`, `collect_scope`,
  `render_annotated` — the EXPLAIN ANALYZE / q-error plane.
- workload (process level, opt-in): the `workload` module — `JOURNAL`
  (the durable JSONL workload journal), `DRIFT` (rolling-window drift
  detection), and `index_ledger.INDEX_LEDGER` (per-index benefit vs
  maintenance attribution) — enabled by `HYPERSPACE_WORKLOAD_DIR`.
"""

from . import attribution, exporter, index_ledger, metrics, plan_stats, trace, workload
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
from .attribution import LEDGER, QueryStats, QueryStatsLedger
from .exporter import (
    health_dict,
    prometheus_text,
    snapshot_dict,
    start_exporter,
    start_snapshot_sink,
    stop_exporter,
    stop_snapshot_sink,
)
from .index_ledger import INDEX_LEDGER, IndexUtilityLedger
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .plan_stats import ACCURACY, EstimatorAccuracy, PlanStatsCollector
from .workload import DRIFT, JOURNAL, DriftDetector, WorkloadJournal
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
    # per-query attribution
    "attribution",
    "LEDGER",
    "QueryStats",
    "QueryStatsLedger",
    # plan statistics / estimator accuracy
    "plan_stats",
    "ACCURACY",
    "EstimatorAccuracy",
    "PlanStatsCollector",
    # workload intelligence plane
    "workload",
    "index_ledger",
    "JOURNAL",
    "WorkloadJournal",
    "DRIFT",
    "DriftDetector",
    "INDEX_LEDGER",
    "IndexUtilityLedger",
    # exporter / health plane
    "exporter",
    "start_exporter",
    "stop_exporter",
    "start_snapshot_sink",
    "stop_snapshot_sink",
    "prometheus_text",
    "snapshot_dict",
    "health_dict",
]
