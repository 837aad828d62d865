"""CreateAction (counterpart of hyperspace_tpu/actions/create.py).

Builds the index data into _staging/0, publishes it as v__=0, and commits a
log entry recording the source relation (files with stable ids), the plan
fingerprint and the index content, in the JSON the JAX package writes. The
source must be a relation a source provider supports (sources/manager.py);
a snapshot provider records the table version the index was built from in
its properties.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

from . import states as S
from .base import Action
from .. import constants as C
from ..exceptions import HyperspaceError
from ..meta.data_manager import IndexDataManager
from ..meta.entry import (
    Content,
    FileIdTracker,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Signature,
    Source,
    SourcePlan,
)
from ..meta.log_manager import IndexLogManager
from ..meta.signatures import DEFAULT_PROVIDER_NAME, get_provider
from ..models.base import IndexerContext
from ..models.covering import _single_file_scan, resolve_columns
from ..telemetry.events import CreateActionEvent

if TYPE_CHECKING:
    from ..models.base import IndexConfig
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession


def compute_fingerprint(plan) -> LogicalPlanFingerprint:
    sig = get_provider(DEFAULT_PROVIDER_NAME).sign(plan)
    if sig is None:
        raise HyperspaceError("Cannot compute signature for the source plan")
    return LogicalPlanFingerprint([Signature(DEFAULT_PROVIDER_NAME, sig)])


def index_content_from_path(index_path: str) -> Content:
    """Content tree of all written index data files (all v__=* dirs)."""
    return Content.from_directory_path(
        index_path,
        None,
        path_filter=lambda p: (C.INDEX_VERSION_DIR_PREFIX + "=") in p
        and not os.path.basename(p).startswith(("_", ".")),
    )


def content_of_version_dir(version_path: str) -> Content:
    """Content tree of one data version's files."""
    return Content.from_directory_path(
        version_path, None,
        path_filter=lambda p: not os.path.basename(p).startswith(("_", ".")),
    )


class CreateAction(Action):
    transient_state = S.CREATING
    final_state = S.ACTIVE
    event_class = CreateActionEvent

    def __init__(self, session: "HyperspaceSession", df: "DataFrame", config: "IndexConfig",
                 index_path: str, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, event_logger=None):
        super().__init__(log_manager, event_logger)
        self.session = session
        self.df = df
        self.config = config
        self.index_path = index_path
        self.data_manager = data_manager
        self.tracker = FileIdTracker()
        self._index = None
        self._relation = None

    def event_index_name(self) -> str:
        return self.config.index_name

    def validate(self) -> None:
        from ..sources.manager import SourceProviderManager

        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != S.DOESNOTEXIST:
            raise HyperspaceError(
                f"Another index with name {self.config.index_name!r} already "
                f"exists in state {latest.state}"
            )
        scan = _single_file_scan(self.df)
        manager = SourceProviderManager(self.session)
        if not manager.is_supported_relation(scan):
            raise HyperspaceError(f"Relation format {scan.fmt!r} is not supported for indexing")
        self._relation = manager.get_relation(scan)
        resolve_columns(self.df.schema, self.config.referenced_columns())

    def op(self) -> None:
        from ..rules.apply import with_hyperspace_rule_disabled

        ctx = IndexerContext(self.session, self.tracker, self.data_manager.stage_version(0))
        props = {"lineage": "true"} if self.session.conf.lineage_enabled else {}
        with with_hyperspace_rule_disabled():
            self._index, data = self.config.create_index(ctx, self.df, props)
            if data is not None:  # an out-of-core build wrote as it went
                self._index.write(ctx, data)
        self.data_manager.publish(0)

    def log_entry(self) -> IndexLogEntry:
        rel = self._relation.create_relation_metadata(self.tracker)
        properties = dict(self._index.properties())
        self._relation.record_version_history(properties,
                                              self.base_id + C.LOG_ID_FINAL_OFFSET)
        if properties != self._index.properties():
            self._index._properties = properties  # persisted with the index
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=self._index,
            content=index_content_from_path(self.index_path),
            source=Source(SourcePlan([rel], self.df.plan.pretty(),
                                     compute_fingerprint(self.df.plan))),
            properties=properties,
        )
