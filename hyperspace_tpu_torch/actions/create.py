"""CreateAction (counterpart of hyperspace_tpu/actions/create.py).

Builds the index data into _staging/0, publishes it as v__=0, and commits a
log entry recording the source relation (files with stable ids), the plan
fingerprint and the index content, in the JSON the JAX package writes.
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
    FileInfo,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlan,
)
from ..meta.log_manager import IndexLogManager
from ..meta.signatures import DEFAULT_PROVIDER_NAME, get_provider
from ..models.base import IndexerContext
from ..models.covering import _single_file_scan, resolve_columns

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


def relation_metadata(scan, tracker: FileIdTracker) -> Relation:
    """Serialized source relation with stable file ids."""
    infos = [
        FileInfo(f.name, f.size, f.modified_time,
                 tracker.add_file(f.name, f.size, f.modified_time))
        for f in scan.files
    ]
    return Relation(
        root_paths=scan.root_paths,
        content=Content.from_files(infos),
        schema=scan.full_schema.to_list(),
        file_format=scan.fmt,
        options=dict(scan.options),
    )


class CreateAction(Action):
    transient_state = S.CREATING
    final_state = S.ACTIVE

    def __init__(self, session: "HyperspaceSession", df: "DataFrame", config: "IndexConfig",
                 index_path: str, log_manager: IndexLogManager,
                 data_manager: IndexDataManager):
        super().__init__(log_manager)
        self.session = session
        self.df = df
        self.config = config
        self.index_path = index_path
        self.data_manager = data_manager
        self.tracker = FileIdTracker()
        self._index = None

    def validate(self) -> None:
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state != S.DOESNOTEXIST:
            raise HyperspaceError(
                f"Another index with name {self.config.index_name!r} already "
                f"exists in state {latest.state}"
            )
        scan = _single_file_scan(self.df)
        if scan.fmt != "parquet" or scan.index_info is not None:
            raise HyperspaceError(f"Relation format {scan.fmt!r} is not supported for indexing")
        resolve_columns(self.df.schema, self.config.referenced_columns())

    def op(self) -> None:
        from ..rules.apply import with_hyperspace_rule_disabled

        ctx = IndexerContext(self.session, self.tracker, self.data_manager.stage_version(0))
        with with_hyperspace_rule_disabled():
            self._index, data = self.config.create_index(ctx, self.df, {})
            self._index.write(ctx, data)
        self.data_manager.publish(0)

    def log_entry(self) -> IndexLogEntry:
        rel = relation_metadata(_single_file_scan(self.df), self.tracker)
        fingerprint = compute_fingerprint(self.df.plan)
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=self._index,
            content=index_content_from_path(self.index_path),
            source=Source(SourcePlan([rel], self.df.plan.pretty(), fingerprint)),
            properties=dict(self._index.properties()),
        )
