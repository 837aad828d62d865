"""The ``HYPERSPACE_*`` environment knobs the port reads (counterpart of
hyperspace_tpu/utils/env.py, lean: these knobs only).

The names and defaults are the JAX package's, and every read happens at
call time, as there, so one environment setting steers both packages:

- ``HYPERSPACE_PIPELINE``: ``1`` streams multi-file scans (the default),
  ``serial`` streams without overlap, ``0`` takes the monolithic path;
- ``HYPERSPACE_PIPELINE_DEPTH``: chunk results in flight before the
  consumer folds one (2);
- ``HYPERSPACE_STREAM_CHUNK_MB``: file bytes per streamed chunk (64);
- ``HYPERSPACE_IO_THREADS``: width of the IO pools (``min(8, nproc)``;
  ``<= 1`` or unparseable means serial);
- ``HYPERSPACE_IO_BUDGET_MB``: decoded bytes a stream may hold undelivered
  (512), the fallback of ``HYPERSPACE_GLOBAL_BUDGET_MB``, the process-wide
  read-ahead ledger (1024);
- the cache budgets, in MB: ``HYPERSPACE_INDEX_CACHE_MB`` (decoded index
  chunks, 1024), ``HYPERSPACE_DEVICE_CACHE_MB`` (device-resident columns,
  6144), ``HYPERSPACE_HOST_DERIVED_CACHE_MB`` (host-side derivations such
  as group-key factorizations, 512), ``HYPERSPACE_BUILD_CACHE_MB``
  (decoded source columns inside index actions, 2048) and
  ``HYPERSPACE_STATS_CACHE_MB`` (parquet footer statistics, 64); 0 turns a
  cache off;
- ``HYPERSPACE_PRUNE``: ``1`` prunes index scans by the query's predicate
  (the default), ``0`` reads them whole, ``verify`` reads both and
  compares;
- ``HYPERSPACE_PARK_WAIT_MS``: how long a parked join wave waits for other
  joins' releases before it is granted past the device budget (50);
- ``HYPERSPACE_TRACE``: ``1`` turns query tracing on when
  ``telemetry/trace.py`` is imported, and ``HYPERSPACE_TRACE_FILE`` then
  names a JSONL file every completed span is appended to;
- ``HYPERSPACE_PLAN_STATS``: ``1`` collects per-node plan statistics on
  every ``collect()``, not only under EXPLAIN ANALYZE;
- ``HYPERSPACE_ESTIMATOR_FEEDBACK``: ``1`` makes the filter ranker and the
  join memory planner multiply their estimates by the accuracy ledger's
  observed correction;
- ``HYPERSPACE_RESULT_CACHE``: the cross-query result cache, ``0`` off
  (the default), ``1`` on, ``verify`` on with every hit and fold
  recomputed and compared; ``HYPERSPACE_RESULT_CACHE_MB`` its byte budget
  (256) and ``HYPERSPACE_RESULT_CACHE_FOLD_DEPTH`` the folds an entry may
  stack before a miss recomputes it (32);
- ``HYPERSPACE_COMPACT_RUNS``: the runs a bucket of an ingested index
  holds before an append schedules a background compaction (8), and
  ``HYPERSPACE_VACUUM_GRACE_S`` the seconds a superseded data version must
  stay observed before vacuum retires it (0: the refcount alone);
- ``HYPERSPACE_FAULTS``: the fault-injection spec armed when
  ``utils/faults.py`` is imported (unset: disarmed), and
  ``HYPERSPACE_IO_RETRIES`` the attempts of a file's decode or footer read
  (3; 1 turns retrying off);
- ``HYPERSPACE_STALE_TX_S``: the age in seconds past which recovery treats
  a transient log entry as a dead transaction (3600), and
  ``HYPERSPACE_ACTION_RETRIES`` the attempts of an action that loses the
  optimistic-concurrency race (3);
- the serving plane (serve/): ``HYPERSPACE_MAX_CONCURRENT_QUERIES`` (4
  worker slots), ``HYPERSPACE_SERVE_QUEUE_DEPTH`` (32 queued queries),
  ``HYPERSPACE_SERVE_DEFAULT_PRIORITY`` (0), ``HYPERSPACE_SERVE_AGING_MS``
  (0: no aging) and ``HYPERSPACE_SERVE_AGING_CAP`` (100 levels),
  ``HYPERSPACE_TENANTS`` (the tenant spec, unset) and
  ``HYPERSPACE_QOS_COST_MBPS`` (256: the rate that turns a query's bytes
  into seconds of delivered cost);
- the query log (telemetry/attribution.py): ``HYPERSPACE_QUERY_LOG_WINDOW``
  (256 records), ``HYPERSPACE_SLOW_QUERY_FILE`` (the slow-query JSONL,
  unset) and ``HYPERSPACE_SLOW_QUERY_MS`` (0: every finished query);
- the exporter (telemetry/exporter.py): ``HYPERSPACE_METRICS_PORT`` (unset:
  off; 0 binds an ephemeral port), ``HYPERSPACE_SNAPSHOT_FILE`` (unset:
  off) and ``HYPERSPACE_SNAPSHOT_INTERVAL_S`` (10);
- the workload plane (telemetry/workload.py): ``HYPERSPACE_WORKLOAD_DIR``
  (unset: off), ``_ROTATE_MB`` (64), ``_RETAIN`` (8), ``_WINDOW`` (64),
  ``_BASELINE`` (64), ``_DRIFT_FACTOR`` (2.0), ``_DRIFT_MIN`` (8) and
  ``_DRIFT_ABS_MS`` (1.0);
- the approximate tier (models/sample_store.py, plan/sampling.py):
  ``HYPERSPACE_APPROX`` (``0`` off, ``1`` on, ``verify`` with every
  sampled answer's intervals held to the exact run),
  ``HYPERSPACE_APPROX_FRACTIONS`` (``0.01,0.1``: the sample twins written
  beside each index data file), ``HYPERSPACE_APPROX_CI_SAFETY`` (2.0: the
  factor on every reported half-width), ``HYPERSPACE_APPROX_MAX_KEY_SHARE``
  (0.05: a key holding this share of an index's rows that the sample drops
  declines the tier) and ``HYPERSPACE_APPROX_MIN_KEYS`` (8: a fraction
  expected to keep fewer distinct keys is declined);
- the adaptive executor (plan/adaptive.py): ``HYPERSPACE_ADAPTIVE`` (``0``
  off, ``1`` adapts mid-query, ``verify`` adapts and reruns the final plan
  statically, comparing bits), ``HYPERSPACE_ADAPTIVE_ABORT_FACTOR`` (4.0:
  the prune under-delivery that aborts a streamed index scan) and
  ``HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS`` (2: chunks or bucket pairs observed
  before a switch);
- the static checks (staticcheck/): ``HYPERSPACE_LOCK_AUDIT`` (the
  acquisition-order audit of every TrackedLock), ``HYPERSPACE_LIFECYCLE_
  AUDIT`` (live resource handles and ``check_quiescent()``),
  ``HYPERSPACE_VERIFY_PLAN`` (the plan invariant verifier on every
  optimized plan), ``HYPERSPACE_KERNEL_AUDIT`` (the hazard audit of every
  built kernel's first call), all off by default, and
  ``HYPERSPACE_RETRACE_WARN`` (8: the distinct fingerprints of one kernel
  kind and dtype signature before the retrace watchdog warns);
- ``HYPERSPACE_SKETCHES`` (the per-row-group sketch store, unset: off) and
  ``HYPERSPACE_DEVICE_BUDGET_MB`` (the device ledger of the bucketed joins,
  4096; 0 disables it); ``CUDA_HOME`` (the CUDA toolkit the kernels build
  with) is read raw through ``read_raw``.

A boolean knob is on only for the literal string ``1``, as in the JAX
package.
"""

from __future__ import annotations

import os

DEFAULTS = {
    "HYPERSPACE_PIPELINE": "1",
    "HYPERSPACE_PIPELINE_DEPTH": 2,
    "HYPERSPACE_STREAM_CHUNK_MB": 64.0,
    "HYPERSPACE_IO_THREADS": None,
    "HYPERSPACE_IO_BUDGET_MB": 512.0,
    "HYPERSPACE_GLOBAL_BUDGET_MB": 1024.0,
    "HYPERSPACE_INDEX_CACHE_MB": 1024,
    "HYPERSPACE_DEVICE_CACHE_MB": 6144.0,
    "HYPERSPACE_HOST_DERIVED_CACHE_MB": 512.0,
    "HYPERSPACE_BUILD_CACHE_MB": 2048,
    "HYPERSPACE_STATS_CACHE_MB": 64,
    "HYPERSPACE_PRUNE": "1",
    "HYPERSPACE_PARK_WAIT_MS": 50.0,
    "HYPERSPACE_TRACE_FILE": None,
    "HYPERSPACE_RESULT_CACHE": "0",
    "HYPERSPACE_RESULT_CACHE_MB": 256.0,
    "HYPERSPACE_RESULT_CACHE_FOLD_DEPTH": 32,
    "HYPERSPACE_COMPACT_RUNS": 8,
    "HYPERSPACE_VACUUM_GRACE_S": 0.0,
    "HYPERSPACE_IO_RETRIES": 3,
    "HYPERSPACE_STALE_TX_S": 3600.0,
    "HYPERSPACE_ACTION_RETRIES": 3,
    "HYPERSPACE_MAX_CONCURRENT_QUERIES": 4,
    "HYPERSPACE_SERVE_QUEUE_DEPTH": 32,
    "HYPERSPACE_SERVE_DEFAULT_PRIORITY": 0,
    "HYPERSPACE_SERVE_AGING_MS": 0.0,
    "HYPERSPACE_SERVE_AGING_CAP": 100,
    "HYPERSPACE_TENANTS": None,
    "HYPERSPACE_QOS_COST_MBPS": 256.0,
    "HYPERSPACE_QUERY_LOG_WINDOW": 256,
    "HYPERSPACE_SLOW_QUERY_FILE": None,
    "HYPERSPACE_SLOW_QUERY_MS": 0.0,
    "HYPERSPACE_METRICS_PORT": None,
    "HYPERSPACE_SNAPSHOT_FILE": None,
    "HYPERSPACE_SNAPSHOT_INTERVAL_S": 10.0,
    "HYPERSPACE_WORKLOAD_DIR": None,
    "HYPERSPACE_WORKLOAD_ROTATE_MB": 64.0,
    "HYPERSPACE_WORKLOAD_RETAIN": 8,
    "HYPERSPACE_WORKLOAD_WINDOW": 64,
    "HYPERSPACE_WORKLOAD_BASELINE": 64,
    "HYPERSPACE_WORKLOAD_DRIFT_FACTOR": 2.0,
    "HYPERSPACE_WORKLOAD_DRIFT_MIN": 8,
    "HYPERSPACE_WORKLOAD_DRIFT_ABS_MS": 1.0,
    "HYPERSPACE_APPROX": "0",
    "HYPERSPACE_APPROX_FRACTIONS": "0.01,0.1",
    "HYPERSPACE_APPROX_CI_SAFETY": 2.0,
    "HYPERSPACE_APPROX_MAX_KEY_SHARE": 0.05,
    "HYPERSPACE_APPROX_MIN_KEYS": 8,
    "HYPERSPACE_ADAPTIVE": "0",
    "HYPERSPACE_ADAPTIVE_ABORT_FACTOR": 4.0,
    "HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS": 2,
    "HYPERSPACE_LOCK_AUDIT": False,
    "HYPERSPACE_LIFECYCLE_AUDIT": False,
    "HYPERSPACE_VERIFY_PLAN": False,
    "HYPERSPACE_KERNEL_AUDIT": False,
    "HYPERSPACE_RETRACE_WARN": 8,
    "HYPERSPACE_SKETCHES": None,
    "HYPERSPACE_DEVICE_BUDGET_MB": 4096.0,
}


def read_raw(name: str, default: str | None = None) -> str | None:
    """The variable's raw string, or ``default`` when it is unset."""
    return os.environ.get(name, default)


def env_str(name: str) -> str:
    v = os.environ.get(name)
    return v if v is not None else DEFAULTS[name]


def env_bool(name: str) -> bool:
    """Only the literal string "1" turns a boolean knob on."""
    return os.environ.get(name) == "1"


def env_int(name: str) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else DEFAULTS[name]


def env_float(name: str) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else DEFAULTS[name]


def cache_bytes(name: str) -> int:
    """A cache budget knob (MB) in bytes; the integer knobs truncate as
    the JAX package's ``env_int`` does."""
    mb = env_int(name) if isinstance(DEFAULTS[name], int) else env_float(name)
    return int(mb * 1024 * 1024)
