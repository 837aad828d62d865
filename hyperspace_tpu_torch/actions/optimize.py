"""OptimizeAction: compact small index files bucket by bucket (counterpart
of hyperspace_tpu/actions/optimize.py).

Quick mode takes the files below ``hyperspace.index.optimize.fileSizeThreshold``
(256 MB by default), full mode takes them all. Files group by the bucket id
in their names; a bucket with one candidate file gains nothing and is left
alone. The new entry's content is the compacted version merged with the
files left alone.
"""

from __future__ import annotations

from collections import defaultdict
from typing import TYPE_CHECKING

from . import states as S
from .base import IndexMutationAction
from .create import content_of_version_dir
from .. import constants as C
from ..exceptions import HyperspaceError, NoChangesError
from ..meta.data_manager import IndexDataManager
from ..meta.entry import Content, Directory, FileIdTracker, FileInfo, IndexLogEntry
from ..meta.log_manager import IndexLogManager
from ..models.base import IndexerContext
from ..models.covering import bucket_id_from_filename
from ..telemetry.events import OptimizeActionEvent

if TYPE_CHECKING:
    from ..session import HyperspaceSession


class OptimizeAction(IndexMutationAction):
    transient_state = S.OPTIMIZING
    final_state = S.ACTIVE
    event_class = OptimizeActionEvent
    allowed_prior_states = frozenset({S.ACTIVE})

    def __init__(self, session: "HyperspaceSession", index_path: str,
                 log_manager: IndexLogManager, data_manager: IndexDataManager,
                 mode: str = C.OPTIMIZE_MODE_QUICK, event_logger=None):
        super().__init__(log_manager, event_logger)
        if mode not in C.OPTIMIZE_MODES:
            raise HyperspaceError(f"Invalid optimize mode {mode!r}; valid: {C.OPTIMIZE_MODES}")
        self.session = session
        self.mode = mode
        self.data_manager = data_manager
        self.entry: IndexLogEntry = self.previous_entry
        self._to_optimize: list[FileInfo] = []
        self._ignored: list[FileInfo] = []
        self._version = None

    def _partition_files(self) -> None:
        threshold = self.session.conf.optimize_file_size_threshold
        files = self.entry.index_data_files()
        if self.mode == C.OPTIMIZE_MODE_QUICK:
            candidates = [f for f in files if f.size < threshold]
            ignored = [f for f in files if f.size >= threshold]
        else:
            candidates, ignored = list(files), []
        by_bucket: dict[int, list[FileInfo]] = defaultdict(list)
        unknown: list[FileInfo] = []
        for f in candidates:
            b = bucket_id_from_filename(f.name)
            if b is None:
                unknown.append(f)
            else:
                by_bucket[b].append(f)
        self._to_optimize = []
        self._ignored = list(ignored) + unknown
        for fs in by_bucket.values():
            (self._to_optimize if len(fs) > 1 else self._ignored).extend(fs)

    def validate(self) -> None:
        super().validate()
        if not isinstance(self.entry, IndexLogEntry):
            raise HyperspaceError("Latest log entry has no index metadata")
        self._partition_files()
        if not self._to_optimize:
            raise NoChangesError(
                "Optimize aborted as no optimizable index files found "
                "(no bucket has more than one file under the size threshold)"
            )

    def op(self) -> None:
        from ..rules.apply import with_hyperspace_rule_disabled

        latest = self.data_manager.get_latest_version()
        self._version = 0 if latest is None else latest + 1
        tracker = FileIdTracker()
        tracker.add_file_info(self.entry.source_file_infos())
        ctx = IndexerContext(self.session, tracker,
                             self.data_manager.stage_version(self._version))
        with with_hyperspace_rule_disabled():
            self.entry.derived_dataset.optimize(ctx, self._to_optimize)
        self.data_manager.publish(self._version)

    def log_entry(self) -> IndexLogEntry:
        content = content_of_version_dir(self.data_manager.version_path(self._version))
        if self._ignored:
            content = Content(Directory.merge(content.root,
                                              Content.from_files(self._ignored).root))
        return IndexLogEntry(
            name=self.entry.name,
            derived_dataset=self.entry.derived_dataset,
            content=content,
            source=self.entry.source,
            properties=dict(self.entry.properties),
        )
