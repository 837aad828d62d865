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
  observed correction.

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
