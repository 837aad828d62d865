"""Lifecycle actions: delete, restore, vacuum, vacuum-outdated, cancel
(counterpart of hyperspace_tpu/actions/lifecycle.py).

- delete: ACTIVE -> DELETED, a soft delete (the data stays);
- restore: DELETED -> ACTIVE;
- vacuum: DELETED -> DOESNOTEXIST, removing all index data (the log stays);
- vacuum-outdated: on an ACTIVE index, remove the data versions and files
  the latest entry no longer references;
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
from ..models.dataskipping.sketch_store import derived_base

# the JAX package's snapshot sources record table-version history in these
# entry properties; after vacuum-outdated only the latest version is valid
_HISTORY_PROPERTIES = ("snapshotVersionHistory", "icebergSnapshotIdHistory")


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
    allowed_prior_states = frozenset({S.ACTIVE})


class RestoreAction(_CopyStateAction):
    transient_state = S.RESTORING
    final_state = S.ACTIVE
    allowed_prior_states = frozenset({S.DELETED})


class VacuumAction(IndexMutationAction):
    """Hard delete of a soft-deleted index's data."""

    transient_state = S.VACUUMING
    final_state = S.DOESNOTEXIST
    allowed_prior_states = frozenset({S.DELETED})

    def __init__(self, index_path: str, log_manager: IndexLogManager):
        super().__init__(log_manager)
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
    allowed_prior_states = frozenset({S.ACTIVE})

    def __init__(self, index_path: str, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(log_manager)
        self.index_path = index_path
        self.data_manager = data_manager
        self.entry: IndexLogEntry = self.previous_entry

    def op(self) -> None:
        if not isinstance(self.entry, IndexLogEntry):
            raise HyperspaceError("Latest log entry has no index metadata")
        referenced_files = set(self.entry.content.files())
        referenced_dirs = {int(d.split("=")[1]) for d in self.entry.index_version_dirs()}
        for v in self.data_manager.get_all_versions():
            if v not in referenced_dirs:
                self.data_manager.delete_version(v)
                continue
            # a referenced version directory loses its unreferenced files; a
            # derived file (a sketch sidecar, which no content listing holds)
            # lives as long as the data file it derives from
            for dirpath, _dirs, names in os.walk(self.data_manager.version_path(v)):
                for fn in names:
                    full = os.path.join(dirpath, fn)
                    if full in referenced_files:
                        continue
                    base = derived_base(fn)
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

    transient_state = S.CANCELLING

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)
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
