"""IndexStatistics — the hs.indexes / hs.index(name) projection
(counterpart of hyperspace_tpu/analysis/statistics.py).

Reference parity: index/IndexStatistics.scala:40-164 (INDEX_SUMMARY_COLUMNS:
name, indexedColumns, includedColumns, numBuckets, schema, indexLocation,
state; extended adds file counts/sizes, appended/deleted files, the log
version and per-kind additionalStats). The count columns are int64, and an
empty listing still has the summary columns.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np

from ..columnar.table import Column, ColumnBatch
from ..meta.entry import IndexLogEntry

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession

_INT_COLUMNS = ("numBuckets", "numIndexFiles", "indexSizeInBytes", "numSourceFiles",
                "sourceSizeInBytes", "numAppendedFiles", "numDeletedFiles", "logVersion")
_SUMMARY_COLUMNS = ("name", "indexedColumns", "includedColumns", "numBuckets", "schema",
                    "indexLocation", "state", "kind")


def _row(entry: IndexLogEntry, extended: bool) -> dict:
    """The reference's statistics row: the summary columns, and with
    ``extended`` the file counts and sizes, the recorded delta and the log
    version."""
    dd = entry.derived_dataset
    files = entry.content.files()
    row = {
        "name": entry.name,
        "indexedColumns": ",".join(dd.indexed_columns()),
        # a data-skipping index has no included columns and no schema
        "includedColumns": ",".join(getattr(dd, "included_columns", lambda: [])()),
        "numBuckets": getattr(dd, "num_buckets", 0),
        "schema": json.dumps(getattr(dd, "_schema", [])),
        "indexLocation": os.path.commonpath(files) if files else "",
        "state": entry.state,
        "kind": dd.kind,
    }
    if extended:
        row.update({
            "numIndexFiles": len(files),
            "indexSizeInBytes": entry.index_data_size_in_bytes(),
            "numSourceFiles": len(entry.source_file_infos()),
            "sourceSizeInBytes": entry.source_files_size_in_bytes(),
            "numAppendedFiles": len(entry.appended_files()),
            "numDeletedFiles": len(entry.deleted_files()),
            "logVersion": entry.id,
            "additionalStats": json.dumps(dd.statistics(), default=str),
        })
    return row


def index_statistics_df(
    session: "HyperspaceSession", entries: list[IndexLogEntry], extended: bool = False
) -> "DataFrame":
    from ..plan.dataframe import DataFrame
    from ..plan.nodes import InMemoryScan

    rows = [_row(e, extended) for e in entries]
    names = list(rows[0]) if rows else list(_SUMMARY_COLUMNS)
    cols = {
        k: (Column(np.asarray([r[k] for r in rows], dtype=np.int64), "int64")
            if k in _INT_COLUMNS
            else Column.from_values([r[k] for r in rows], "string") if rows
            else Column(np.zeros(0, np.int32), "string", None, [""]))
        for k in names
    }
    return DataFrame(session, InMemoryScan(ColumnBatch(cols)))
