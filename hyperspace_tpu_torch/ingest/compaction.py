"""Background compaction and the writer mutex of ingested indexes
(counterpart of hyperspace_tpu/ingest/compaction.py).

Every committed append reads the entry's runs per bucket
(``runs_per_bucket``); once a bucket holds ``HYPERSPACE_COMPACT_RUNS``
runs, one maintenance task goes to the process-wide shared IO pool
(``utils/workers.shared_io_pool``). It runs
:class:`~.actions.IngestCompactAction` and then a pin-aware
``vacuum_outdated``, which retires only the superseded versions whose pins
have drained and whose ``HYPERSPACE_VACUUM_GRACE_S`` has passed
(actions/lifecycle.VacuumOutdatedAction); the others wait for a later
cycle. At most one task per index is in flight; losing a cycle is always
safe, since compaction is only a layout optimization and vacuum starts
afresh each pass.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from typing import TYPE_CHECKING, Optional

from ..staticcheck.concurrency import TrackedLock, guarded_by
from ..utils import env

if TYPE_CHECKING:
    from ..session import HyperspaceSession

logger = logging.getLogger(__name__)

_INFLIGHT_LOCK = TrackedLock("ingest.compaction_inflight")
_INFLIGHT: set = guarded_by(
    set(),  # abspath(index_path) with a task scheduled or running
    _INFLIGHT_LOCK,
    name="ingest.compaction._INFLIGHT",
    note="one background maintenance task per index at a time",
)

# the per-index writer mutex: in-process writers (append, compact, vacuum)
# serialize on it, so the ingest stream never collides with its own
# background maintenance mid-transaction; writers in other processes go
# through the log's optimistic concurrency
_WRITER_LOCKS_LOCK = TrackedLock("ingest.writer_locks")
_WRITER_LOCKS: dict = guarded_by(
    {},  # abspath(index_path) -> TrackedLock
    _WRITER_LOCKS_LOCK,
    name="ingest.compaction._WRITER_LOCKS",
    note="lazily created per-index writer mutexes",
)


def writer_lock(index_path: str) -> TrackedLock:
    """The index's writer mutex, made on first use. It is held across one
    whole maintenance transaction; queries never take it."""
    key = os.path.abspath(index_path)
    with _WRITER_LOCKS_LOCK:
        lock = _WRITER_LOCKS.get(key)
        if lock is None:
            lock = TrackedLock(f"ingest.writer:{os.path.basename(key)}")
            _WRITER_LOCKS[key] = lock
        return lock


def runs_per_bucket(entry) -> dict:
    """bucket id -> file (run) count of the entry's index content; a file
    whose name carries no bucket id is left out (it never compacts)."""
    from ..models.covering import bucket_id_from_filename

    counts: Counter = Counter()
    for f in entry.index_data_files():
        b = bucket_id_from_filename(f.name)
        if b is not None:
            counts[b] += 1
    return dict(counts)


def needs_compaction(entry, min_runs: Optional[int] = None) -> bool:
    threshold = max(2, min_runs if min_runs is not None
                    else env.env_int("HYPERSPACE_COMPACT_RUNS"))
    counts = runs_per_bucket(entry)
    return bool(counts) and max(counts.values()) >= threshold


def maybe_schedule(session: "HyperspaceSession", index_name: str) -> bool:
    """Schedule one background maintenance task (compact, then vacuum) of
    ``index_name`` when its latest entry crossed the run threshold and no
    task of it is in flight. True when one was scheduled."""
    from ..index_manager import index_manager_for
    from ..telemetry.metrics import REGISTRY
    from ..utils.workers import shared_io_pool

    manager = index_manager_for(session)
    entry = manager.get_index(index_name)
    if entry is None or not needs_compaction(entry):
        return False
    key = os.path.abspath(manager.resolver.get_index_path(index_name))
    with _INFLIGHT_LOCK:
        if key in _INFLIGHT:
            return False
        _INFLIGHT.add(key)
    REGISTRY.counter("ingest.compact.scheduled").inc()
    shared_io_pool().submit(_run_maintenance, session, index_name, key)
    return True


def _run_maintenance(session: "HyperspaceSession", index_name: str, key: str) -> None:
    """One cycle: compact the eligible buckets, vacuum the superseded
    versions whose pins drained, then re-anchor the foldable cached results.
    A failure is logged and given up: the next append past the threshold
    schedules again."""
    from ..exceptions import HyperspaceError
    from ..index_manager import index_manager_for
    from ..telemetry import trace

    try:
        manager = index_manager_for(session)
        with trace.span("compact:maintenance", index=index_name):
            manager.compact(index_name)
            manager.vacuum_outdated(index_name)
        from ..cache.view_maintenance import maybe_refresh

        maybe_refresh(session, index_name)
    except HyperspaceError as e:
        # lost the race to the ingest stream, or the preconditions moved
        logger.info("background maintenance of %r yielded: %s", index_name, e)
    except Exception:
        logger.warning("background maintenance of %r failed", index_name, exc_info=True)
    finally:
        with _INFLIGHT_LOCK:
            _INFLIGHT.discard(key)


def maintenance_idle() -> bool:
    """True when no background maintenance task is scheduled or running."""
    with _INFLIGHT_LOCK:
        return not _INFLIGHT
