"""Index collection manager (counterpart of hyperspace_tpu/index_manager.py).

Enumerates the per-index logs under the system path and runs the actions:
create, delete, restore, vacuum, vacuum-outdated, refresh, optimize and
cancel. An index of a kind this package does not load is skipped with a
warning, so the others still serve. The caching manager keeps the entry
list for ``hyperspace.index.cache.expiryDurationInSeconds`` and every
action clears it, so a query is never rewritten to a stale entry.

``recover()`` repairs what a process that died mid-action leaves behind:

- a transient latest entry (CREATING, REFRESHING, ...) whose owner is dead
  is rolled back to the last stable state through CancelAction. An entry
  younger than ``HYPERSPACE_STALE_TX_S`` (3600 s, read at every pass) may
  be another process's live transaction and is left alone unless
  ``force``; an in-process one is never touched;
- staged builds, stale log spool files and data versions no committed
  entry references are removed (all data, under a DOESNOTEXIST tail: a
  crashed vacuum is finished), except a version an in-flight query pinned
  or a live action protects (ingest/snapshots.py);
- a latestStable pointer that lags the log is fixed forward.

The pass runs once when a session's manager is built, and counts
``recovery.runs``, ``recovery.rolled_back``, ``recovery.pointer_fixed``,
``recovery.staging_removed``, ``recovery.orphan_versions`` and
``recovery.temp_files`` in the metrics registry. Every action runs with
the session's event logger (``hyperspace.telemetry.eventLoggerClass``).

The ingest verbs: ``append`` indexes a batch's new source files as delta
runs (ingest/actions.py), then schedules a background compaction past
``HYPERSPACE_COMPACT_RUNS`` and a refresh of the foldable cached results;
``compact`` merges the delta runs. In-process writers (append, compact,
vacuum-outdated) serialize on the index's writer mutex
(``ingest/compaction.writer_lock``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import TYPE_CHECKING, Optional

from . import constants as C
from .actions import states as S
from .actions.base import action_in_progress
from .actions.create import CreateAction
from .actions.lifecycle import (
    CancelAction,
    DeleteAction,
    RestoreAction,
    VacuumAction,
    VacuumOutdatedAction,
)
from .actions.optimize import OptimizeAction
from .actions.refresh import RefreshAction, RefreshIncrementalAction, RefreshQuickAction
from .exceptions import HyperspaceError, UnknownIndexKindError
from .meta.cache import CreationTimeBasedCache
from .meta.data_manager import IndexDataManager
from .meta.entry import IndexLogEntry
from .meta.log_manager import IndexLogManager
from .meta.path_resolver import PathResolver
from .telemetry import logger as event_logs
from .telemetry.metrics import REGISTRY
from .utils import env

if TYPE_CHECKING:
    from .models.base import IndexConfig
    from .plan.dataframe import DataFrame
    from .session import HyperspaceSession

logger = logging.getLogger(__name__)

class IndexCollectionManager:
    def __init__(self, session: "HyperspaceSession", auto_recover: bool = True):
        self.session = session
        self.resolver = PathResolver(session.conf, session.warehouse_dir)
        if auto_recover:
            self._auto_recover()

    def _managers(self, name: str) -> tuple[str, IndexLogManager, IndexDataManager]:
        path = self.resolver.get_index_path(name)
        return path, IndexLogManager(path), IndexDataManager(path)

    def _existing_log_manager(self, name: str) -> tuple[str, IndexLogManager, IndexDataManager]:
        path, lm, dm = self._managers(name)
        if lm.get_latest_id() is None:
            raise HyperspaceError(f"Index with name {name!r} could not be found")
        return path, lm, dm

    # --- actions ---
    def create(self, df: "DataFrame", config: "IndexConfig") -> None:
        path, lm, dm = self._managers(config.index_name)
        CreateAction(self.session, df, config, path, lm, dm,
                     event_logs.event_logger_for(self.session)).run()

    def delete(self, name: str) -> None:
        _, lm, _ = self._existing_log_manager(name)
        DeleteAction(lm, event_logs.event_logger_for(self.session)).run()

    def restore(self, name: str) -> None:
        _, lm, _ = self._existing_log_manager(name)
        RestoreAction(lm, event_logs.event_logger_for(self.session)).run()

    def vacuum(self, name: str) -> None:
        path, lm, _ = self._existing_log_manager(name)
        VacuumAction(path, lm, event_logs.event_logger_for(self.session)).run()

    def vacuum_outdated(self, name: str) -> None:
        from .ingest.compaction import writer_lock

        path, lm, dm = self._existing_log_manager(name)
        with writer_lock(path):
            VacuumOutdatedAction(path, lm, dm, event_logs.event_logger_for(self.session)).run()

    def refresh(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        path, lm, dm = self._existing_log_manager(name)
        cls = {
            C.REFRESH_MODE_FULL: RefreshAction,
            C.REFRESH_MODE_INCREMENTAL: RefreshIncrementalAction,
            C.REFRESH_MODE_QUICK: RefreshQuickAction,
        }.get(mode)
        if cls is None:
            raise HyperspaceError(f"Invalid refresh mode {mode!r}; valid: {C.REFRESH_MODES}")
        cls(self.session, path, lm, dm, event_logs.event_logger_for(self.session)).run()

    def optimize(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        path, lm, dm = self._existing_log_manager(name)
        OptimizeAction(self.session, path, lm, dm, mode,
                       event_logs.event_logger_for(self.session)).run()

    def append(self, name: str, df: "DataFrame") -> None:
        """Index ``df``'s new source files as append-only delta runs in a
        fresh data version (no rebuild), then schedule a background
        compaction when a bucket crossed the run threshold, and a
        background refresh of the foldable cached results over the index."""
        from .cache.view_maintenance import maybe_refresh
        from .ingest.actions import IngestAppendAction
        from .ingest.compaction import maybe_schedule, writer_lock

        path, lm, dm = self._existing_log_manager(name)
        with writer_lock(path):
            IngestAppendAction(self.session, path, lm, dm, df,
                               event_logs.event_logger_for(self.session)).run()
        maybe_schedule(self.session, name)
        maybe_refresh(self.session, name)

    def compact(self, name: str, min_runs: int | None = None) -> None:
        """Merge the delta runs of the buckets holding ``min_runs`` files or
        more (``HYPERSPACE_COMPACT_RUNS`` by default) into one sorted file
        each."""
        from .ingest.actions import IngestCompactAction
        from .ingest.compaction import writer_lock

        path, lm, dm = self._existing_log_manager(name)
        with writer_lock(path):
            IngestCompactAction(self.session, path, lm, dm, min_runs,
                                event_logs.event_logger_for(self.session)).run()

    def cancel(self, name: str) -> None:
        _, lm, _ = self._existing_log_manager(name)
        CancelAction(lm, event_logs.event_logger_for(self.session)).run()

    # --- reads ---
    def get_indexes(self, states: list[str] | None = None) -> list[IndexLogEntry]:
        root = self.resolver.system_path
        out: list[IndexLogEntry] = []
        if not os.path.isdir(root):
            return out
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if not os.path.isdir(path):
                continue
            lm = IndexLogManager(path)
            try:
                entry = lm.get_latest_log()
                if entry is not None and (
                    not isinstance(entry, IndexLogEntry) or entry.state not in S.STABLE_STATES
                ):
                    # another writer's transaction is in flight: serve the
                    # last stable entry
                    stable = lm.get_latest_stable_log()
                    if isinstance(stable, IndexLogEntry):
                        entry = stable
            except UnknownIndexKindError as e:
                logger.warning("Skipping index %r of kind %r, which this package "
                               "cannot load", name, e.kind)
                continue
            if isinstance(entry, IndexLogEntry) and (states is None or entry.state in states):
                out.append(entry)
        return out

    def get_index(self, name: str, log_version: int | None = None) -> Optional[IndexLogEntry]:
        _, lm, _ = self._managers(name)
        e = lm.get_log(log_version) if log_version is not None else lm.get_latest_log()
        return e if isinstance(e, IndexLogEntry) else None

    def get_index_versions(self, name: str, states: list[str] | None = None) -> list[int]:
        _, lm, _ = self._managers(name)
        return lm.get_index_versions(states)

    # --- crash recovery ---
    def _auto_recover(self) -> None:
        """Must never block session start: a failed repair is logged and
        left for an explicit recover()."""
        try:
            report = self.recover()
            if report["repaired"]:
                logger.warning("index recovery repaired crash debris: %s", report)
        except Exception as e:
            logger.warning("automatic index recovery failed: %s", e)

    def recover(self, name: str | None = None, force: bool = False) -> dict:
        """Repair crash debris across the warehouse, or of one index.
        ``force`` rolls back any transient entry whatever its age: safe only
        when no other process maintains this warehouse."""
        root = self.resolver.system_path
        report: dict = {"indexes_scanned": 0, "repaired": False, "per_index": {}}
        if name is not None:
            names = [name]
        elif os.path.isdir(root):
            names = sorted(n for n in os.listdir(root) if os.path.isdir(os.path.join(root, n)))
        else:
            names = []
        REGISTRY.counter("recovery.runs").inc()
        for n in names:
            r = self._recover_index(n, force)
            report["indexes_scanned"] += 1
            repaired = bool(r["rolled_back"] or r["pointer_fixed"] or r["staging_removed"]
                            or r["orphan_versions"] or r["temp_files"])
            if repaired or r["skipped"]:
                report["per_index"][n] = r
            report["repaired"] = report["repaired"] or repaired
            if r["rolled_back"]:
                REGISTRY.counter("recovery.rolled_back").inc()
            if r["pointer_fixed"]:
                REGISTRY.counter("recovery.pointer_fixed").inc()
            REGISTRY.counter("recovery.staging_removed").inc(r["staging_removed"])
            REGISTRY.counter("recovery.orphan_versions").inc(len(r["orphan_versions"]))
            REGISTRY.counter("recovery.temp_files").inc(r["temp_files"])
        return report

    def _recover_index(self, name: str, force: bool) -> dict:
        path, lm, dm = self._managers(name)
        r: dict = {"rolled_back": None, "pointer_fixed": False, "staging_removed": 0,
                   "orphan_versions": [], "temp_files": 0, "skipped": None}
        if action_in_progress(path):
            r["skipped"] = "live-transaction"
            return r
        try:
            latest_id = lm.get_latest_id()
            latest = lm.get_log(latest_id) if latest_id is not None else None
            if latest is not None and latest.state not in S.STABLE_STATES:
                age_ms = time.time() * 1000 - (latest.timestamp or 0)
                if not force and age_ms < env.env_float("HYPERSPACE_STALE_TX_S") * 1000:
                    # possibly another process's live transaction: leave the
                    # entry and its staging and spool files alone
                    r["skipped"] = f"fresh-transient:{latest.state}"
                    return r
                CancelAction(lm, event_logs.event_logger_for(self.session)).run()
                r["rolled_back"] = latest.state
                latest_id = lm.get_latest_id()
                latest = lm.get_log(latest_id) if latest_id is not None else None
            referenced = self._referenced_versions(lm)
        except UnknownIndexKindError as e:
            r["skipped"] = f"unknown-kind:{e.kind}"
            return r
        # the log tail is stable (or empty): every staged build and spool
        # file is a dead transaction's
        r["staging_removed"] = dm.clear_staging()
        r["temp_files"] = lm.clear_temp_files(0.0 if force else 60.0)
        if latest is None:  # no committed entry: an aborted create
            for v in dm.orphan_version_dirs(set()):
                dm.delete_version(v)
                r["orphan_versions"].append(v)
            self._rmdir_if_empty(lm.log_dir)
            self._rmdir_if_empty(path)
            return r
        # a DOESNOTEXIST tail finishes a crashed vacuum: all data goes
        doomed = dm.orphan_version_dirs(set() if latest.state == S.DOESNOTEXIST else referenced)
        for v in doomed:
            dm.delete_version(v)
            r["orphan_versions"].append(v)
        if latest.state in S.STABLE_STATES and lm.stable_pointer_id() != latest_id:
            # a crash between the final log write and the pointer rewrite
            lm.delete_latest_stable_log()
            if lm.create_latest_stable_log(latest_id):
                r["pointer_fixed"] = True
        return r

    @staticmethod
    def _referenced_versions(lm: IndexLogManager) -> set:
        """Data versions any committed entry references (recovery removes
        true orphans only; older entries' versions are vacuum-outdated's)."""
        refs: set = set()
        if not os.path.isdir(lm.log_dir):
            return refs
        for n in os.listdir(lm.log_dir):
            if not n.isdigit():
                continue
            e = lm.get_log(int(n))
            if isinstance(e, IndexLogEntry):
                for d in e.index_version_dirs():
                    try:
                        refs.add(int(d.split("=")[1]))
                    except (IndexError, ValueError):
                        continue
        return refs

    @staticmethod
    def _rmdir_if_empty(path: str) -> None:
        try:
            os.rmdir(path)  # succeeds only when empty
        except OSError:
            pass  # hslint: HS402 — non-empty or absent dir stays put


class CachingIndexCollectionManager(IndexCollectionManager):
    """get_indexes cached with creation-time expiry; every action clears
    the cache before and after it runs."""

    def __init__(self, session: "HyperspaceSession"):
        # the cache first: the recovery pass in super().__init__ clears it
        self._cache: CreationTimeBasedCache[list[IndexLogEntry]] = CreationTimeBasedCache(
            lambda: session.conf.cache_expiry_seconds
        )
        super().__init__(session)

    def clear_cache(self) -> None:
        self._cache.clear()

    def get_indexes(self, states: list[str] | None = None) -> list[IndexLogEntry]:
        cached = self._cache.get()
        if cached is None:
            cached = super().get_indexes(None)
            self._cache.set(cached)
        return [e for e in cached if states is None or e.state in states]

    def _mutating(fn):  # type: ignore[misc]
        def wrapper(self, *a, **kw):
            self.clear_cache()
            try:
                return fn(self, *a, **kw)
            finally:
                self.clear_cache()

        wrapper.__name__ = fn.__name__
        return wrapper

    create = _mutating(IndexCollectionManager.create)
    delete = _mutating(IndexCollectionManager.delete)
    restore = _mutating(IndexCollectionManager.restore)
    vacuum = _mutating(IndexCollectionManager.vacuum)
    vacuum_outdated = _mutating(IndexCollectionManager.vacuum_outdated)
    refresh = _mutating(IndexCollectionManager.refresh)
    optimize = _mutating(IndexCollectionManager.optimize)
    append = _mutating(IndexCollectionManager.append)
    compact = _mutating(IndexCollectionManager.compact)
    cancel = _mutating(IndexCollectionManager.cancel)
    recover = _mutating(IndexCollectionManager.recover)


def index_manager_for(session: "HyperspaceSession") -> CachingIndexCollectionManager:
    m = getattr(session, "_index_manager", None)
    if m is None:
        m = CachingIndexCollectionManager(session)
        session._index_manager = m
    return m
