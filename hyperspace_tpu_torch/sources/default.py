"""The default provider: parquet, CSV, JSON, ORC, text and avro
directories (counterpart of hyperspace_tpu/sources/default.py).

The formats it takes are the session's
``hyperspace.index.sources.defaultFileBasedSource.supportedFileFormats``
(default ``avro,csv,json,orc,parquet,text``). Snapshot tables answer
through their own providers, and an index scan is no source.
"""

from __future__ import annotations

from typing import Optional

from .interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
    decode_glob_paths,
    expand_glob_roots,
    relist_files,
)
from .. import constants as C
from ..columnar.table import Schema
from ..meta.entry import Relation
from ..plan.nodes import FileScan, LogicalPlan

DEFAULT_SUPPORTED_FORMATS = tuple(C.DEFAULT_SOURCE_FORMATS_DEFAULT.split(","))
# the scan formats of the snapshot providers (sources/delta.py, iceberg.py)
SNAPSHOT_SCAN_FORMATS = ("snapshot-parquet", "iceberg-parquet")


class DefaultFileBasedSource(FileBasedSourceProvider):
    def __init__(self, session=None):
        self._session = session

    def _formats(self) -> tuple[str, ...]:
        if self._session is None:
            return DEFAULT_SUPPORTED_FORMATS
        return self._session.conf.default_source_formats

    def _supported(self, node: LogicalPlan) -> bool:
        return (
            isinstance(node, FileScan)
            and node.fmt in self._formats()
            and node.index_info is None
            and node.options.get("format") not in SNAPSHOT_SCAN_FORMATS
        )

    def is_supported_relation(self, node: LogicalPlan) -> Optional[bool]:
        return True if self._supported(node) else None

    def get_relation(self, session, node: LogicalPlan) -> Optional[FileBasedRelation]:
        return FileBasedRelation(session, node) if self._supported(node) else None

    def reload_relation(self, session, metadata: Relation):
        """The relation over its current files: a recorded glob scope is
        expanded anew (a component that matches nothing now is allowed),
        and the hive partition columns are derived again from the paths."""
        from ..plan.dataframe import DataFrame
        from ..utils.partitions import infer_partition_fields

        if metadata.file_format not in self._formats():
            return None
        glob_paths = metadata.options.get(C.OPT_GLOB_PATHS)
        if glob_paths:
            roots = expand_glob_roots(decode_glob_paths(glob_paths), allow_empty=True)
        else:
            roots = metadata.root_paths
        files = relist_files(roots)
        schema = Schema.from_list(metadata.schema)
        part_cols = [f.name for f in infer_partition_fields([fi.name for fi in files], roots)
                     if f.name in schema]
        scan = FileScan(roots, metadata.file_format, schema, files,
                        options=dict(metadata.options), partition_columns=part_cols)
        return DataFrame(session, scan)
