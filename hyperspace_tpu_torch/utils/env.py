"""The typed registry of every ``HYPERSPACE_*`` environment knob the port
reads (counterpart of hyperspace_tpu/utils/env.py).

Each knob is registered once below with its name, kind, default, effect
and the port module that reads it; ``python -m hyperspace_tpu_torch.utils.env``
prints the table. The names, kinds and defaults are the JAX package's, and
every read happens through the accessors below at the moment the JAX
package reads the knob, so one environment setting steers both packages.
The JAX registry's four breaker knobs (``HYPERSPACE_BACKEND_TIMEOUT``,
``_BREAKER_COOLDOWN``, ``_DEVICE_STRICT``, ``_FORCE_PALLAS``) are not
registered: the port has no breaker and no Pallas route.

The accessors parse as the JAX package's do: ``int(s)``, ``float(s)``, and
a boolean is on only for the literal string ``1``. A registered name read
without an explicit default falls back to the registry's default; an
unregistered name raises ``KeyError`` unless the caller gives a default.
Sites with a parsing of their own (an unparseable value meaning serial,
an unset value meaning "decide elsewhere") read the raw string through
``read_raw`` and stay registered. ``CUDA_HOME`` (the CUDA toolkit the
kernels build with) is read raw and is no knob of the system.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class EnvKnob:
    """One environment knob: its contract, not its current value."""

    name: str
    kind: str  # "int" | "float" | "str" | "bool" | "mode"
    default: object  # the value when unset (None: unset)
    doc: str
    owner: str  # the port module that reads it
    choices: tuple = ()  # the accepted values of a "mode" knob

    def raw(self, default: "str | None" = None) -> "str | None":
        return os.environ.get(self.name, default)


# filled by the _register calls below, at import, and never after; env.py
# sits under staticcheck/concurrency in the import graph, so it cannot use
# guarded_by without a cycle
_REGISTRY: dict[str, EnvKnob] = {}  # hslint: HS305 — import-time only


def _register(name, kind, default, doc, owner, choices=()) -> EnvKnob:
    k = EnvKnob(name, kind, default, doc, owner, tuple(choices))
    _REGISTRY[name] = k
    return k


def knob(name: str) -> EnvKnob:
    """The registered knob; KeyError for a name the registry lacks."""
    return _REGISTRY[name]


def all_knobs() -> list[EnvKnob]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# --- typed accessors --------------------------------------------------------

def _default(name: str, explicit):
    if explicit is not None:
        return explicit
    return _REGISTRY[name].default  # KeyError: unregistered and no default


def read_raw(name: str, default: "str | None" = None) -> "str | None":
    """The variable's raw string, or ``default`` when it is unset."""
    return os.environ.get(name, default)


def env_str(name: str, default: "str | None" = None) -> "str | None":
    v = os.environ.get(name)
    return v if v is not None else _default(name, default)


def env_int(name: str, default: "int | None" = None) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else _default(name, default)


def env_float(name: str, default: "float | None" = None) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else _default(name, default)


def env_bool(name: str) -> bool:
    """Only the literal string "1" turns a boolean knob on."""
    return os.environ.get(name) == "1"


def cache_bytes(name: str) -> int:
    """A cache budget knob (MB) in bytes; the integer knobs truncate as
    the JAX package's ``env_int`` does."""
    mb = env_int(name) if knob(name).kind == "int" else env_float(name)
    return int(mb * 1024 * 1024)


# ---------------------------------------------------------------------------
# the catalogue, grouped by subsystem
# ---------------------------------------------------------------------------

# IO and caches
_register("HYPERSPACE_BUILD_CACHE_MB", "int", 2048,
          "Byte budget (MB) of the decoded source columns kept inside index "
          "actions; process-wide, resized by every new session.",
          "columnar/io.py")
_register("HYPERSPACE_DEVICE_CACHE_MB", "float", 6144.0,
          "Byte budget (MB) of the device-resident columns of a session; 0 "
          "keeps nothing.",
          "session.py")
_register("HYPERSPACE_HOST_DERIVED_CACHE_MB", "float", 512.0,
          "Byte budget (MB) of a session's host-side derivations (group-key "
          "factorizations).",
          "session.py")
_register("HYPERSPACE_INDEX_CACHE_MB", "int", 1024,
          "Byte budget (MB) of a session's decoded index chunks.",
          "session.py")
_register("HYPERSPACE_IO_BUDGET_MB", "float", 512.0,
          "Decoded bytes (MB) a stream may hold undelivered; the fallback of "
          "HYPERSPACE_GLOBAL_BUDGET_MB when that is unset.",
          "serve/budget.py")
_register("HYPERSPACE_IO_THREADS", "int", None,
          "Width of the IO pools; unset min(8, nproc), <= 1 or unparseable "
          "means serial.",
          "utils/workers.py")
_register("HYPERSPACE_SKETCH_CACHE_MB", "int", 64,
          "Byte budget (MB) of the decoded sketch sidecars (cache.sketch.*), "
          "read at import; 0 parses the sidecars on every read.",
          "models/dataskipping/sketch_store.py")
_register("HYPERSPACE_STATS_CACHE_MB", "int", 64,
          "Byte budget (MB) of the parquet footer statistics; process-wide, "
          "resized by every new session.",
          "columnar/io.py")
_register("HYPERSPACE_STREAM_CHUNK_MB", "float", 64.0,
          "File bytes (MB) per streamed chunk of a multi-file scan.",
          "columnar/io.py")

# execution
_register("HYPERSPACE_ADAPTIVE", "mode", "0",
          "Mid-query adaptive re-planning: 0 off, 1 adapts mid-query, verify "
          "adapts and reruns the final plan statically, comparing bits.",
          "plan/adaptive.py", choices=("0", "1", "verify"))
_register("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", "float", 4.0,
          "Prune under-delivery (actual over predicted kept data) that aborts "
          "a streamed index scan at a chunk boundary.",
          "plan/adaptive.py")
_register("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "int", 2,
          "Chunks or bucket pairs the adaptive executor observes before a "
          "switch.",
          "plan/adaptive.py")
_register("HYPERSPACE_JOIN_BROADCAST_ROWS", "int", 4096,
          "Estimated build-side rows at or below which a bucket pair takes "
          "the broadcast strategy.",
          "plan/join_memory.py")
_register("HYPERSPACE_JOIN_SPLIT_ROWS", "int", 1 << 18,
          "Left-side rows above which a bucket splits into probe chunks; set, "
          "it overrides the grant-derived count.",
          "plan/device_join.py")
_register("HYPERSPACE_PARK_WAIT_MS", "float", 50.0,
          "How long (ms) a parked join wave waits for other joins' releases "
          "before it is granted past the device budget.",
          "plan/join_memory.py")
_register("HYPERSPACE_PIPELINE", "mode", "1",
          "1 streams multi-file scans, serial streams without overlap, 0 "
          "takes the monolithic path.",
          "plan/gpu_exec.py", choices=("1", "serial", "0"))
_register("HYPERSPACE_PIPELINE_DEPTH", "int", 2,
          "Chunk results in flight before the consumer folds one.",
          "plan/gpu_exec.py")
_register("HYPERSPACE_PRUNE", "mode", "1",
          "Index scan pruning by the query's predicate: 1 on, 0 reads whole, "
          "verify reads both and compares.",
          "plan/pruning.py", choices=("1", "0", "verify"))
_register("HYPERSPACE_APPROX", "mode", "0",
          "The approximate tier: 0 off, 1 on, verify holds every sampled "
          "answer's intervals to the exact run.",
          "models/sample_store.py", choices=("0", "1", "verify"))
_register("HYPERSPACE_APPROX_FRACTIONS", "str", "0.01,0.1",
          "The sample twins' fractions written beside each index data file.",
          "models/sample_store.py")
_register("HYPERSPACE_APPROX_CI_SAFETY", "float", 2.0,
          "The factor on every reported half-width of the sampled tier.",
          "plan/sampling.py")
_register("HYPERSPACE_APPROX_MAX_KEY_SHARE", "float", 0.05,
          "A key holding this share of an index's rows that the sample drops "
          "declines the tier.",
          "plan/sampling.py")
_register("HYPERSPACE_APPROX_MIN_KEYS", "int", 8,
          "A fraction expected to keep fewer distinct keys is declined.",
          "plan/sampling.py")
_register("HYPERSPACE_SKETCHES", "str", None,
          "The per-row-group sketch sidecars: unset or 0 off, 1 or all every "
          "kind, or a comma list of bloom, valuelist, zregion.",
          "models/dataskipping/sketch_store.py")
_register("HYPERSPACE_SKETCH_BLOOM_FPP", "float", 0.01,
          "Target false-positive rate of a sidecar bloom filter, and the "
          "floor of the pruning estimate of the sketch stage.",
          "models/dataskipping/sketch_store.py")
_register("HYPERSPACE_SKETCH_BLOOM_NDV", "int", 8192,
          "Cap on the distinct count a sidecar bloom filter is sized for.",
          "models/dataskipping/sketch_store.py")

# the mesh tier
_register("HYPERSPACE_MESH", "bool", False,
          "1 places bucketed-join band waves and streamed chunks across every "
          "visible device.",
          "parallel/placement.py")
_register("HYPERSPACE_MESH_DEVICES", "int", 0,
          "Cap on the devices placement targets (0: all).",
          "parallel/placement.py")

# the result cache
_register("HYPERSPACE_RESULT_CACHE", "mode", "0",
          "The cross-query result cache: 0 off, 1 on, verify recomputes and "
          "compares every hit and fold.",
          "cache/result_cache.py", choices=("1", "0", "verify"))
_register("HYPERSPACE_RESULT_CACHE_FOLD_DEPTH", "int", 32,
          "Folds an entry may stack before a miss recomputes it.",
          "cache/view_maintenance.py")
_register("HYPERSPACE_RESULT_CACHE_MB", "float", 256.0,
          "Byte budget (MB) of the result cache.",
          "cache/result_cache.py")

# the serving plane
_register("HYPERSPACE_QOS_COST_MBPS", "float", 256.0,
          "The rate (MB/s) that turns a query's bytes into seconds of "
          "delivered cost.",
          "serve/qos.py")
_register("HYPERSPACE_SERVE_AGING_MS", "float", 0.0,
          "Queue wait (ms) per level of aging boost; 0 no aging.",
          "serve/scheduler.py")
_register("HYPERSPACE_SERVE_AGING_CAP", "int", 100,
          "Upper bound on the aging boost (levels).",
          "serve/scheduler.py")
_register("HYPERSPACE_TENANTS", "str", None,
          "The tenant spec (name:key=value,...;...).",
          "serve/tenant.py")
_register("HYPERSPACE_DEVICE_BUDGET_MB", "float", 4096.0,
          "The device ledger of the bucketed joins (MB); 0 disables it.",
          "serve/budget.py")
_register("HYPERSPACE_GLOBAL_BUDGET_MB", "float", 1024.0,
          "The process-wide read-ahead ledger (MB).",
          "serve/budget.py")
_register("HYPERSPACE_MAX_CONCURRENT_QUERIES", "int", 4,
          "Worker slots of the scheduler.",
          "serve/scheduler.py")
_register("HYPERSPACE_SERVE_DEFAULT_PRIORITY", "int", 0,
          "Priority of a query submitted without one.",
          "serve/scheduler.py")
_register("HYPERSPACE_SERVE_QUEUE_DEPTH", "int", 32,
          "Queued queries past which submissions are rejected.",
          "serve/scheduler.py")

# ingest and maintenance
_register("HYPERSPACE_COMPACT_RUNS", "int", 8,
          "Runs a bucket of an ingested index holds before an append "
          "schedules a background compaction.",
          "ingest/compaction.py")
_register("HYPERSPACE_VACUUM_GRACE_S", "float", 0.0,
          "Seconds a superseded data version stays observed before vacuum "
          "retires it (0: the refcount alone).",
          "actions/lifecycle.py")

# robustness
_register("HYPERSPACE_ACTION_RETRIES", "int", 3,
          "Attempts of an action that loses the optimistic-concurrency race.",
          "actions/base.py")
_register("HYPERSPACE_FAULTS", "str", None,
          "The fault-injection spec armed at import (unset: disarmed).",
          "utils/faults.py")
_register("HYPERSPACE_IO_RETRIES", "int", 3,
          "Attempts of a file's decode or footer read; 1 turns retrying off.",
          "utils/retry.py")
_register("HYPERSPACE_STALE_TX_S", "float", 3600.0,
          "Age (s) past which recovery treats a transient log entry as a dead "
          "transaction.",
          "index_manager.py")

# telemetry
_register("HYPERSPACE_ESTIMATOR_FEEDBACK", "bool", False,
          "1 makes the filter ranker and the join memory planner multiply "
          "their estimates by the accuracy ledger's correction.",
          "telemetry/plan_stats.py")
_register("HYPERSPACE_PLAN_STATS", "bool", False,
          "1 collects per-node plan statistics on every collect().",
          "telemetry/plan_stats.py")
_register("HYPERSPACE_METRICS_PORT", "int", None,
          "Port of the metrics exporter (unset: off; 0 an ephemeral port).",
          "telemetry/exporter.py")
_register("HYPERSPACE_QUERY_LOG_WINDOW", "int", 256,
          "Finished served queries kept in the query log.",
          "telemetry/attribution.py")
_register("HYPERSPACE_SLOW_QUERY_FILE", "str", None,
          "The slow-query JSONL (unset: off).",
          "telemetry/attribution.py")
_register("HYPERSPACE_SLOW_QUERY_MS", "float", 0.0,
          "Latency (ms) a finished query must exceed to enter the slow-query "
          "log (0: every query).",
          "telemetry/attribution.py")
_register("HYPERSPACE_SNAPSHOT_FILE", "str", None,
          "JSONL the periodic snapshot sink appends to (unset: off).",
          "telemetry/exporter.py")
_register("HYPERSPACE_SNAPSHOT_INTERVAL_S", "float", 10.0,
          "Seconds between snapshots of the sink.",
          "telemetry/exporter.py")
_register("HYPERSPACE_WORKLOAD_DIR", "str", None,
          "Directory of the workload journal and index ledger (unset: off).",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_ROTATE_MB", "float", 64.0,
          "Size (MB) at which the workload journal rotates.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_RETAIN", "int", 8,
          "Rotated journal segments kept.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_WINDOW", "int", 64,
          "Rolling window (samples) of the drift detector.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_BASELINE", "int", 64,
          "Samples frozen as the drift baseline.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_DRIFT_FACTOR", "float", 2.0,
          "Ratio of window over baseline at which drift fires.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_DRIFT_MIN", "int", 8,
          "Samples needed on both sides before a series is compared.",
          "telemetry/workload.py")
_register("HYPERSPACE_WORKLOAD_DRIFT_ABS_MS", "float", 1.0,
          "Absolute floor (ms) of latency drift.",
          "telemetry/workload.py")
_register("HYPERSPACE_TRACE", "bool", False,
          "1 turns query tracing on when telemetry/trace.py is imported.",
          "telemetry/trace.py")
_register("HYPERSPACE_TRACE_FILE", "str", None,
          "JSONL every completed span is appended to while tracing is forced "
          "on.",
          "telemetry/trace.py")

# the static checks
_register("HYPERSPACE_LOCK_AUDIT", "bool", False,
          "The acquisition-order audit of every TrackedLock.",
          "staticcheck/concurrency.py")
_register("HYPERSPACE_KERNEL_AUDIT", "bool", False,
          "The hazard audit of every built kernel's first call.",
          "staticcheck/kernel_audit.py")
_register("HYPERSPACE_RETRACE_WARN", "int", 8,
          "Distinct fingerprints of one kernel kind and dtype signature "
          "before the retrace watchdog warns.",
          "staticcheck/kernel_audit.py")
_register("HYPERSPACE_VERIFY_PLAN", "bool", False,
          "The plan invariant verifier on every optimized plan.",
          "staticcheck/plan_verifier.py")
_register("HYPERSPACE_LIFECYCLE_AUDIT", "bool", False,
          "Live resource handles recorded for check_quiescent().",
          "staticcheck/lifecycle.py")


def markdown_table() -> str:
    """The knob table in markdown, from the registry."""
    rows = ["| Variable | Type | Default | Owner | Effect |", "|---|---|---|---|---|"]
    for k in all_knobs():
        if k.kind == "bool":
            default = "1" if k.default else "unset"
        elif k.default is None:
            default = "unset"
        else:
            default = str(k.default)
        kind = k.kind if not k.choices else "/".join(k.choices)
        rows.append(f"| `{k.name}` | {kind} | {default} | `{k.owner}` | {k.doc} |")
    return "\n".join(rows)


if __name__ == "__main__":  # pragma: no cover - tooling entry
    print(markdown_table())
