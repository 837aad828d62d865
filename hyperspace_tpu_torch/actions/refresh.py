"""Refresh actions: full, incremental, quick (counterpart of
hyperspace_tpu/actions/refresh.py).

Each reloads the source from the relation the entry recorded, through
the source provider that owns it (its roots, or its glob scope, listed
afresh; a snapshot table at its latest version); appended and deleted
files are the set differences between that listing and the recorded
files. A snapshot provider records the table version each refreshed log
version was built from. Deleted files keep their recorded ids,
which the lineage anti-filter needs, and the file-id tracker is seeded from
the entry, so ids survive every refresh.

- full: rebuild into a new data version;
- incremental: index only the appended files, and drop the rows of deleted
  ones by lineage; appends alone merge the new version with the old
  content, deletes overwrite it;
- quick: touch no data; record the delta and the current source's
  fingerprint in the entry, and let hybrid scan serve the delta at query
  time.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from . import states as S
from .base import IndexMutationAction
from .create import compute_fingerprint, content_of_version_dir
from .. import constants as C
from ..exceptions import HyperspaceError, NoChangesError
from ..meta.data_manager import IndexDataManager
from ..meta.entry import (
    Content,
    Directory,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    Source,
    SourcePlan,
)
from ..meta.log_manager import IndexLogManager
from ..models.base import IndexerContext, UpdateMode
from ..models.covering import _single_file_scan
from ..telemetry.events import (
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
)

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession


class RefreshActionBase(IndexMutationAction):
    transient_state = S.REFRESHING
    final_state = S.ACTIVE
    allowed_prior_states = frozenset({S.ACTIVE})

    def __init__(self, session: "HyperspaceSession", index_path: str,
                 log_manager: IndexLogManager, data_manager: IndexDataManager):
        super().__init__(log_manager)
        self.session = session
        self.index_path = index_path
        self.data_manager = data_manager
        prev = self.previous_entry
        if not isinstance(prev, IndexLogEntry):
            raise HyperspaceError("Latest log entry has no index metadata")
        self.entry: IndexLogEntry = prev
        self.tracker = FileIdTracker()
        self.tracker.add_file_info(self.entry.source_file_infos())
        self._df = None

    @property
    def df(self) -> "DataFrame":
        """The source DataFrame over the current files."""
        if self._df is None:
            from ..sources.manager import SourceProviderManager

            self._df = SourceProviderManager(self.session).reload_relation(self.entry.relation)
        return self._df

    def current_files(self) -> set[FileInfo]:
        return set(_single_file_scan(self.df).files)

    def appended_files(self) -> list[FileInfo]:
        return sorted(self.current_files() - self.entry.source_file_infos(),
                      key=lambda f: f.name)

    def deleted_files(self) -> list[FileInfo]:
        """Deleted files, with their recorded ids."""
        current = self.current_files()
        return sorted((f for f in self.entry.source_file_infos() if f not in current),
                      key=lambda f: f.name)

    def new_version(self) -> int:
        latest = self.data_manager.get_latest_version()
        return 0 if latest is None else latest + 1

    def _check_deletes_supported(self, deleted: list[FileInfo]) -> None:
        if deleted and not self.entry.derived_dataset.can_handle_deleted_files():
            raise HyperspaceError(
                "Index cannot handle deleted source files (no lineage column); "
                "use refresh mode 'full' instead"
            )

    def refreshed_relation_metadata(self):
        """(the source relation over the current files, its metadata as the
        refreshed entry records it)."""
        from ..sources.manager import SourceProviderManager

        relation = SourceProviderManager(self.session).get_relation(_single_file_scan(self.df))
        return relation, relation.create_relation_metadata(self.tracker)

    def _refreshed_entry(self, derived_dataset, content: Content) -> IndexLogEntry:
        relation, metadata = self.refreshed_relation_metadata()
        properties = dict(self.entry.properties)
        relation.record_version_history(properties, self.base_id + C.LOG_ID_FINAL_OFFSET)
        return IndexLogEntry(
            name=self.entry.name,
            derived_dataset=derived_dataset,
            content=content,
            source=Source(SourcePlan([metadata],
                                     self.df.plan.pretty(),
                                     compute_fingerprint(self.df.plan))),
            properties=properties,
        )


class RefreshAction(RefreshActionBase):
    """Full rebuild into a new data version."""
    event_class = RefreshActionEvent

    def __init__(self, *args):
        super().__init__(*args)
        self._new_index = None
        self._version = None

    def validate(self) -> None:
        super().validate()
        if not self.appended_files() and not self.deleted_files():
            raise NoChangesError("Refresh aborted as no source data changed")

    def op(self) -> None:
        from ..rules.apply import with_hyperspace_rule_disabled

        self._version = self.new_version()
        ctx = IndexerContext(self.session, self.tracker,
                             self.data_manager.stage_version(self._version))
        with with_hyperspace_rule_disabled():
            self._new_index, data = self.entry.derived_dataset.refresh_full(ctx, self.df)
            if data is not None:  # an out-of-core rebuild wrote as it went
                self._new_index.write(ctx, data)
        self.data_manager.publish(self._version)

    def log_entry(self) -> IndexLogEntry:
        return self._refreshed_entry(
            self._new_index, content_of_version_dir(self.data_manager.version_path(self._version)))


class RefreshIncrementalAction(RefreshActionBase):
    """Index the appended files; drop the deleted files' rows by lineage."""
    event_class = RefreshIncrementalActionEvent

    def __init__(self, *args):
        super().__init__(*args)
        self._new_index = None
        self._mode = None
        self._version = None

    def validate(self) -> None:
        super().validate()
        appended, deleted = self.appended_files(), self.deleted_files()
        if not appended and not deleted:
            raise NoChangesError("Refresh aborted as no source data changed")
        self._check_deletes_supported(deleted)

    def op(self) -> None:
        from ..plan.dataframe import DataFrame
        from ..rules.apply import with_hyperspace_rule_disabled

        appended, deleted = self.appended_files(), self.deleted_files()
        self._version = self.new_version()
        ctx = IndexerContext(self.session, self.tracker,
                             self.data_manager.stage_version(self._version))
        appended_df = None
        if appended:
            scan = _single_file_scan(self.df)
            appended_df = DataFrame(self.session, self.df.plan.transform_up(
                lambda n: n.copy(files=appended) if n is scan else n))
        with with_hyperspace_rule_disabled():
            self._new_index, self._mode = self.entry.derived_dataset.refresh_incremental(
                ctx, appended_df, deleted, self.entry.index_data_files())
        self.data_manager.publish(self._version)

    def log_entry(self) -> IndexLogEntry:
        content = content_of_version_dir(self.data_manager.version_path(self._version))
        if self._mode == UpdateMode.MERGE:
            content = Content(Directory.merge(self.entry.content.root, content.root))
        return self._refreshed_entry(self._new_index, content)


class RefreshQuickAction(RefreshActionBase):
    """Record the source delta in the entry; the index data stays."""
    event_class = RefreshQuickActionEvent

    def __init__(self, *args):
        super().__init__(*args)
        self._appended: list[FileInfo] = []
        self._deleted: list[FileInfo] = []

    def validate(self) -> None:
        super().validate()
        self._appended, self._deleted = self.appended_files(), self.deleted_files()
        if not self._appended and not self._deleted:
            raise NoChangesError("Refresh aborted as no source data changed")
        self._check_deletes_supported(self._deleted)

    def op(self) -> None:
        pass  # the delta rides in the log entry

    def log_entry(self) -> IndexLogEntry:
        return self.entry.with_update(self._appended, self._deleted,
                                      compute_fingerprint(self.df.plan))
