"""Lifecycle actions: delete, restore, vacuum, vacuum-outdated, cancel
(counterpart of hyperspace_tpu/actions/lifecycle.py).

- delete: ACTIVE -> DELETED, a soft delete (the data stays);
- restore: DELETED -> ACTIVE;
- vacuum: DELETED -> DOESNOTEXIST, removing all index data (the log stays);
- vacuum-outdated: on an ACTIVE index, remove the data versions and files
  the latest entry no longer references, except what an in-flight query
  pinned or a live action protects (ingest/snapshots.py), and a version
  superseded for less than ``HYPERSPACE_VACUUM_GRACE_S``: those wait for a
  later pass (``ingest.vacuum.deferred``); a removed version's cached
  results leave the result cache (``ingest.vacuum.versions_removed``);
- cancel: roll a transient state back to the last stable one (an index
  being created or vacuumed has none, and ends at DOESNOTEXIST).
"""

from __future__ import annotations

import os
import shutil

from . import states as S
from .base import Action, IndexMutationAction
from ..exceptions import HyperspaceError
from ..meta.data_manager import IndexDataManager
from ..meta.entry import IndexLogEntry, LogEntry
from ..meta.log_manager import IndexLogManager
from ..models import sample_store
from ..models.dataskipping import sketch_store
from ..sources.delta import VERSION_HISTORY_PROPERTY
from ..sources.iceberg import SNAPSHOT_ID_HISTORY_PROPERTY
from ..telemetry.events import (
    CancelActionEvent,
    DeleteActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
    VacuumOutdatedActionEvent,
)

# the snapshot providers' table-version history; after vacuum-outdated
# only the latest table version remains valid for time travel
_HISTORY_PROPERTIES = (VERSION_HISTORY_PROPERTY, SNAPSHOT_ID_HISTORY_PROPERTY)


def _derived_base(file_name: str):
    """The data file a derived file belongs to (a sample twin or meta, a
    sketch sidecar), None for any other file."""
    base = sample_store.derived_base(file_name)
    return base if base is not None else sketch_store.derived_base(file_name)


def _copy_entry(e: LogEntry, state: str) -> LogEntry:
    if isinstance(e, IndexLogEntry):
        return IndexLogEntry(e.name, e.derived_dataset, e.content, e.source, dict(e.properties))
    return LogEntry(state=state)


class _CopyStateAction(IndexMutationAction):
    """Delete/restore: the previous entry again, under a new state."""

    def op(self) -> None:
        pass

    def log_entry(self) -> LogEntry:
        return _copy_entry(self.previous_entry, self.final_state)


class DeleteAction(_CopyStateAction):
    transient_state = S.DELETING
    final_state = S.DELETED
    event_class = DeleteActionEvent
    allowed_prior_states = frozenset({S.ACTIVE})


class RestoreAction(_CopyStateAction):
    transient_state = S.RESTORING
    final_state = S.ACTIVE
    event_class = RestoreActionEvent
    allowed_prior_states = frozenset({S.DELETED})


class VacuumAction(IndexMutationAction):
    """Hard delete of a soft-deleted index's data."""

    transient_state = S.VACUUMING
    final_state = S.DOESNOTEXIST
    event_class = VacuumActionEvent
    allowed_prior_states = frozenset({S.DELETED})

    def __init__(self, index_path: str, log_manager: IndexLogManager, event_logger=None):
        super().__init__(log_manager, event_logger)
        self.index_path = index_path

    def op(self) -> None:
        for name in os.listdir(self.index_path):
            if name == os.path.basename(self.log_manager.log_dir):
                continue  # the log records the DOESNOTEXIST terminal state
            p = os.path.join(self.index_path, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)

    def log_entry(self) -> LogEntry:
        return LogEntry(state=self.final_state)


class VacuumOutdatedAction(IndexMutationAction):
    """Remove the data versions of an ACTIVE index that its latest entry
    does not reference, and the unreferenced files inside the ones it does."""

    transient_state = S.VACUUMINGOUTDATED
    final_state = S.ACTIVE
    event_class = VacuumOutdatedActionEvent
    allowed_prior_states = frozenset({S.ACTIVE})

    def __init__(self, index_path: str, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, event_logger=None):
        super().__init__(log_manager, event_logger)
        self.index_path = index_path
        self.data_manager = data_manager
        self.entry: IndexLogEntry = self.previous_entry

    def op(self) -> None:
        from ..cache.result_cache import RESULT_CACHE
        from ..ingest.snapshots import REGISTRY as SNAPSHOTS
        from ..telemetry.metrics import REGISTRY as METRICS
        from ..utils import env

        if not isinstance(self.entry, IndexLogEntry):
            raise HyperspaceError("Latest log entry has no index metadata")
        referenced_files = set(self.entry.content.files())
        referenced_dirs = {int(d.split("=")[1]) for d in self.entry.index_version_dirs()}
        grace = env.env_float("HYPERSPACE_VACUUM_GRACE_S")
        path = os.path.abspath(self.index_path)
        for v in self.data_manager.get_all_versions():
            # retirement follows the refcount: a version an in-flight query
            # pinned, or a live action protects, waits for a later pass
            pinned = SNAPSHOTS.is_pinned(path, v) or SNAPSHOTS.is_protected(path, v)
            if v not in referenced_dirs:
                if pinned or not SNAPSHOTS.grace_elapsed(path, v, grace):
                    METRICS.counter("ingest.vacuum.deferred").inc()
                    continue
                self.data_manager.delete_version(v)
                SNAPSHOTS.forget_version(path, v)
                # its bytes are gone: so are the results cached over it
                RESULT_CACHE.invalidate_version(path, v)
                METRICS.counter("ingest.vacuum.versions_removed").inc()
                continue
            if pinned:
                # a pinned older entry may reference files of this dir that
                # the latest no longer does: the dir stays whole
                METRICS.counter("ingest.vacuum.deferred").inc()
                continue
            # a referenced version directory loses its unreferenced files; a
            # derived file (a sample twin or meta, a sketch sidecar: no
            # content listing holds them) lives as long as its data file
            for dirpath, _dirs, names in os.walk(self.data_manager.version_path(v)):
                for fn in names:
                    full = os.path.join(dirpath, fn)
                    if full in referenced_files:
                        continue
                    base = _derived_base(fn)
                    if base is not None and os.path.join(dirpath, base) in referenced_files:
                        continue
                    os.unlink(full)

    def log_entry(self) -> IndexLogEntry:
        e = self.entry
        properties = dict(e.properties)
        for key in _HISTORY_PROPERTIES:
            if properties.get(key):
                properties[key] = properties[key].split(",")[-1]
        return IndexLogEntry(e.name, e.derived_dataset, e.content, e.source, properties)


class CancelAction(Action):
    """Roll a transient state back to the last stable one."""
    event_class = CancelActionEvent

    transient_state = S.CANCELLING

    def __init__(self, log_manager: IndexLogManager, event_logger=None):
        super().__init__(log_manager, event_logger)
        self._stable = None

    def validate(self) -> None:
        latest = self.log_manager.get_latest_log()
        if latest is None:
            raise HyperspaceError("Index does not exist")
        if latest.state in S.STABLE_STATES:
            raise HyperspaceError(
                f"Cancel is only supported for transient states, found {latest.state}"
            )
        self._stable = self.log_manager.get_latest_stable_log()

    def op(self) -> None:
        pass

    @property
    def final_state(self) -> str:  # type: ignore[override]
        return self._stable.state if self._stable is not None else S.DOESNOTEXIST

    def log_entry(self) -> LogEntry:
        if self._stable is None:
            return LogEntry(state=S.DOESNOTEXIST)
        return _copy_entry(self._stable, self._stable.state)
