"""Snapshot-keyed result caching (counterpart of hyperspace_tpu/cache/):

- ``result_cache``: the process-wide, byte-bounded cross-query result
  store, keyed by (canonical plan fingerprint, pinned snapshot versions),
  with exact invalidation, single-flight population and a verify mode;
- ``view_maintenance``: incremental maintenance of cached aggregates over
  the ingest log: an exactly-foldable fragment answers after an append as
  ``cached_result (+) agg(delta runs)``, and a background refresh re-anchors
  the foldable entries after a version advance.
"""

from __future__ import annotations

from .result_cache import (
    RESULT_CACHE,
    CachedResult,
    ResultCache,
    batch_nbytes,
    enabled,
    is_verify,
    result_cache_state_string,
    serve_collect,
)
from .view_maintenance import (
    FoldSpec,
    classify_plan,
    fold_results,
    maybe_refresh,
    refresh_idle,
    try_fold,
)

__all__ = [
    "RESULT_CACHE",
    "CachedResult",
    "FoldSpec",
    "ResultCache",
    "batch_nbytes",
    "classify_plan",
    "enabled",
    "fold_results",
    "is_verify",
    "maybe_refresh",
    "refresh_idle",
    "result_cache_state_string",
    "serve_collect",
    "try_fold",
]
