"""Log-structured index maintenance: append and compact (counterpart of
hyperspace_tpu/ingest/actions.py).

Both ride the two-phase transaction of every maintenance action
(actions/base.py: validate, begin, op, end, with the optimistic-concurrency
retry), so crash recovery covers them as it covers the others, and each
brackets its build with a fault point of its own:

- :class:`IngestAppendAction` (INGESTING -> ACTIVE) indexes only the new
  source files, as one append-only run per bucket in a fresh data version
  (``stage_version`` -> ``Index.ingest_delta`` -> ``publish``), under the
  ``ingest.append`` fault point. The committed entry's content is the old
  content merged with the delta version, and its fingerprint is signed
  over the extended source file set, so a query over the grown source
  matches the entry at once (no rebuild, no hybrid scan).
- :class:`IngestCompactAction` (COMPACTING -> ACTIVE) merges the runs of
  every bucket that holds ``min_runs`` or more files into one sorted file
  (``Index.optimize``), published as a version of its own, under the
  ``ingest.compact`` fault point. The superseded versions stay on disk
  until their pins drain: retiring them is vacuum's work.

Both protect the version they build (ingest/snapshots.py) from the
staging and orphan sweeps of this process until the final log commit, and
release the protection in a ``finally``, so an injected crash leaves the
debris a restarted process's recovery must repair. Counters, as in the JAX
package: ``ingest.appends``, ``ingest.rows_appended``,
``ingest.files_appended``, ``ingest.compact.runs``,
``ingest.compact.buckets`` and ``ingest.compact.files_in``; spans
``ingest:append`` and ``compact:run``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import TYPE_CHECKING, Optional

from .snapshots import protected_version
from ..actions import states as S
from ..actions.base import IndexMutationAction
from ..actions.create import content_of_version_dir
from ..exceptions import ConcurrentWriteError, HyperspaceError, NoChangesError
from ..meta.data_manager import IndexDataManager
from ..meta.entry import (
    Content,
    Directory,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlan,
)
from ..meta.log_manager import STABLE_STATES, IndexLogManager
from ..meta.signatures import DEFAULT_PROVIDER_NAME, get_provider
from ..models.base import IndexerContext
from ..models.covering import bucket_id_from_filename
from ..telemetry.events import IngestAppendActionEvent, IngestCompactActionEvent
from ..utils import env, faults

if TYPE_CHECKING:
    from ..session import HyperspaceSession


class _SourceFilesPlan:
    """The source relation after an append, as the signer sees it: the
    single-FileScan shape the create-time fingerprint and the query-time
    leaf sign, over the extended file set. The entry's recorded files (not
    a new listing) keep the fingerprint a function of what the transaction
    covers."""

    def __init__(self, files: list[FileInfo]):
        self._files = list(files)

    def preorder_kinds(self) -> list[str]:
        return ["FileScan"]

    def leaf_file_infos(self) -> list[list[FileInfo]]:
        return [self._files]


def _fingerprint_of_files(files: list[FileInfo]) -> LogicalPlanFingerprint:
    sig = get_provider(DEFAULT_PROVIDER_NAME).sign(_SourceFilesPlan(files))
    if sig is None:
        raise HyperspaceError("Cannot fingerprint the appended source file set")
    return LogicalPlanFingerprint([Signature(DEFAULT_PROVIDER_NAME, sig)])


class _IngestActionBase(IndexMutationAction):
    """Entry access that survives conflict retries, and version protection
    released even on an injected crash."""

    allowed_prior_states = frozenset({S.ACTIVE})

    def __init__(self, session: "HyperspaceSession", index_path: str,
                 log_manager: IndexLogManager, data_manager: IndexDataManager,
                 event_logger=None):
        super().__init__(log_manager, event_logger)
        self.session = session
        self.index_path = index_path
        self.data_manager = data_manager
        self._protected: list = []

    @property
    def entry(self) -> IndexLogEntry:
        prev = self.previous_entry
        if not isinstance(prev, IndexLogEntry):
            raise HyperspaceError("Latest log entry has no index metadata")
        return prev

    def validate(self) -> None:
        """The base check, except that another writer's transient state is
        a retryable conflict: the retry loop re-reads the log once that
        transaction commits or is rolled back."""
        prev = self.log_manager.get_latest_log()
        if prev is None:
            raise HyperspaceError("Index does not exist")
        if prev.state not in self.allowed_prior_states:
            if prev.state not in STABLE_STATES:
                raise ConcurrentWriteError(
                    f"{type(self).__name__} found in-flight transaction state "
                    f"{prev.state}; retrying after it settles"
                )
            raise HyperspaceError(
                f"{type(self).__name__} requires state in "
                f"{sorted(self.allowed_prior_states)}, found {prev.state}"
            )

    def _protect(self, version: int) -> None:
        guard = protected_version(self.index_path, version)
        guard.__enter__()
        self._protected.append(guard)

    def run(self) -> None:
        try:
            super().run()
        finally:
            # after the final commit the version is referenced; after a
            # crash it must look like debris to a recovering process
            guards, self._protected = self._protected, []
            for g in guards:
                g.__exit__(None, None, None)

    def new_version(self) -> int:
        latest = self.data_manager.get_latest_version()
        staged = self.data_manager.staged_versions()
        return max([latest if latest is not None else -1, *staged, -1]) + 1


class IngestAppendAction(_IngestActionBase):
    """Append-only ingest of new source files as per-bucket delta runs."""

    transient_state = S.INGESTING
    final_state = S.ACTIVE
    event_class = IngestAppendActionEvent

    def __init__(self, session: "HyperspaceSession", index_path: str,
                 log_manager: IndexLogManager, data_manager: IndexDataManager, df,
                 event_logger=None):
        super().__init__(session, index_path, log_manager, data_manager, event_logger)
        self._df = df
        self._new_files: list[FileInfo] = []
        self._version: Optional[int] = None
        self._tracker: Optional[FileIdTracker] = None
        self._rows = 0

    def validate(self) -> None:
        from ..models.covering import _single_file_scan, resolve_columns

        super().validate()
        entry = self.entry
        scan = _single_file_scan(self._df)
        logged = entry.source_file_infos()
        new = sorted((f for f in scan.files if f not in logged), key=lambda f: f.name)
        if not new:
            raise NoChangesError("Append aborted: every file is already covered by the index")
        if entry.source_update() is not None:
            # a quick refresh's delta rides the entry and is served by
            # hybrid scan; an append on top would serve an overlap twice
            raise HyperspaceError(
                "Index has a pending quick-refresh source delta; run "
                "refresh (incremental/full) before appending"
            )
        resolve_columns(self._df.schema, entry.derived_dataset.referenced_columns())
        self._new_files = new

    def op(self) -> None:
        from ..models.covering import _single_file_scan
        from ..plan.dataframe import DataFrame
        from ..rules.apply import with_hyperspace_rule_disabled
        from ..telemetry import trace
        from ..telemetry.metrics import REGISTRY

        entry = self.entry
        self._version = self.new_version()
        self._protect(self._version)
        self._tracker = FileIdTracker()
        self._tracker.add_file_info(entry.source_file_infos())
        staging = self.data_manager.stage_version(self._version)
        faults.fire("ingest.append", version=self._version)
        with trace.span("ingest:append", index=entry.name, version=self._version,
                        files=len(self._new_files)) as sp:
            ctx = IndexerContext(self.session, self._tracker, staging)
            scan = _single_file_scan(self._df)
            new = self._new_files
            sub = self._df.plan.transform_up(lambda n: n.copy(files=new) if n is scan else n)
            with with_hyperspace_rule_disabled():
                self._rows = entry.derived_dataset.ingest_delta(
                    ctx, DataFrame(self.session, sub), self._version)
            self.data_manager.publish(self._version)
            sp.set_attr("rows", self._rows)
        faults.fire_after("ingest.append", version=self._version)
        REGISTRY.counter("ingest.appends").inc()
        REGISTRY.counter("ingest.rows_appended").inc(self._rows)
        REGISTRY.counter("ingest.files_appended").inc(len(self._new_files))

    def log_entry(self) -> IndexLogEntry:
        entry = self.entry
        # the index content: the old snapshot and the delta version
        delta = content_of_version_dir(self.data_manager.version_path(self._version))
        content = Content(Directory.merge(entry.content.root, delta.root))
        # the source relation: the recorded files and the appended ones (ids
        # from the tracker), signed anew so queries over the grown source
        # match this entry
        rel = entry.relation
        appended = [
            FileInfo(f.name, f.size, f.modified_time,
                     self._tracker.add_file(f.name, f.size, f.modified_time))
            for f in self._new_files
        ]
        all_files = list(rel.content.file_infos()) + appended
        new_rel = Relation(rel.root_paths, Content.from_files(all_files), rel.schema,
                           rel.file_format, dict(rel.options), None)
        plan = SourcePlan([new_rel], entry.source.plan.raw_plan,
                          _fingerprint_of_files(all_files))
        return IndexLogEntry(
            name=entry.name,
            derived_dataset=entry.derived_dataset,
            content=content,
            source=Source(plan),
            properties=dict(entry.properties),
        )


class IngestCompactAction(_IngestActionBase):
    """Merge each eligible bucket's delta runs into one sorted file."""

    transient_state = S.COMPACTING
    final_state = S.ACTIVE
    event_class = IngestCompactActionEvent

    def __init__(self, session: "HyperspaceSession", index_path: str,
                 log_manager: IndexLogManager, data_manager: IndexDataManager,
                 min_runs: Optional[int] = None, event_logger=None):
        super().__init__(session, index_path, log_manager, data_manager, event_logger)
        self.min_runs = max(
            2, min_runs if min_runs is not None else env.env_int("HYPERSPACE_COMPACT_RUNS"))
        self._to_compact: list[FileInfo] = []
        self._ignored: list[FileInfo] = []
        self._buckets = 0
        self._version: Optional[int] = None

    def _partition_files(self) -> None:
        """Every file of a bucket holding ``min_runs`` runs or more compacts,
        all of its runs together, so that the output is one sorted file;
        files of another layout never compact."""
        by_bucket: dict[int, list[FileInfo]] = defaultdict(list)
        unknown: list[FileInfo] = []
        for f in self.entry.index_data_files():
            b = bucket_id_from_filename(f.name)
            if b is None:
                unknown.append(f)
            else:
                by_bucket[b].append(f)
        self._to_compact, self._ignored, self._buckets = [], list(unknown), 0
        for _b, fs in sorted(by_bucket.items()):
            if len(fs) >= self.min_runs:
                self._to_compact.extend(fs)
                self._buckets += 1
            else:
                self._ignored.extend(fs)

    def validate(self) -> None:
        super().validate()
        self._partition_files()
        if not self._to_compact:
            raise NoChangesError(
                f"Compaction aborted: no bucket holds >= {self.min_runs} delta runs")

    def op(self) -> None:
        from ..rules.apply import with_hyperspace_rule_disabled
        from ..telemetry import trace
        from ..telemetry.metrics import REGISTRY

        entry = self.entry
        self._version = self.new_version()
        self._protect(self._version)
        tracker = FileIdTracker()
        tracker.add_file_info(entry.source_file_infos())
        staging = self.data_manager.stage_version(self._version)
        faults.fire("ingest.compact", version=self._version)
        with trace.span("compact:run", index=entry.name, version=self._version,
                        buckets=self._buckets, files=len(self._to_compact)):
            ctx = IndexerContext(self.session, tracker, staging)
            with with_hyperspace_rule_disabled():
                entry.derived_dataset.optimize(ctx, self._to_compact)
            self.data_manager.publish(self._version)
        faults.fire_after("ingest.compact", version=self._version)
        REGISTRY.counter("ingest.compact.runs").inc()
        REGISTRY.counter("ingest.compact.buckets").inc(self._buckets)
        REGISTRY.counter("ingest.compact.files_in").inc(len(self._to_compact))

    def log_entry(self) -> IndexLogEntry:
        entry = self.entry
        content = content_of_version_dir(self.data_manager.version_path(self._version))
        if self._ignored:
            content = Content(Directory.merge(content.root,
                                              Content.from_files(self._ignored).root))
        return IndexLogEntry(
            name=entry.name,
            derived_dataset=entry.derived_dataset,
            content=content,
            source=entry.source,
            properties=dict(entry.properties),
        )
