"""Hyperspace, the user-facing facade (counterpart of
hyperspace_tpu/hyperspace.py): create, the lifecycle actions (delete,
restore, vacuum, vacuum-outdated, refresh, optimize, cancel, recover) and
introspection. The JAX package's ingest verbs (``append``,
``compact_index``) and its explain, whyNot and profiling views are not
ported."""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Optional

import numpy as np

from . import constants as C
from .columnar.table import Column, ColumnBatch
from .exceptions import HyperspaceError
from .index_manager import index_manager_for
from .meta.entry import IndexLogEntry

if TYPE_CHECKING:
    from .models.base import IndexConfig
    from .plan.dataframe import DataFrame
    from .session import HyperspaceSession

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


def _statistics_df(session, entries: list[IndexLogEntry], extended: bool) -> "DataFrame":
    from .plan.dataframe import DataFrame
    from .plan.nodes import InMemoryScan

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


class Hyperspace:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session
        self._manager = index_manager_for(session)

    # --- index lifecycle ---
    def create_index(self, df: "DataFrame", config: "IndexConfig") -> None:
        self._manager.create(df, config)

    def delete_index(self, name: str) -> None:
        self._manager.delete(name)

    def restore_index(self, name: str) -> None:
        self._manager.restore(name)

    def vacuum_index(self, name: str) -> None:
        self._manager.vacuum(name)

    def vacuum_outdated_index(self, name: str) -> None:
        self._manager.vacuum_outdated(name)

    def refresh_index(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        self._manager.refresh(name, mode)

    def optimize_index(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        self._manager.optimize(name, mode)

    def cancel(self, name: str) -> None:
        self._manager.cancel(name)

    def recover(self, name: str | None = None, force: bool = False) -> dict:
        """Repair crash debris (index_manager's module docstring has the
        list); it also runs when a session's manager is built."""
        return self._manager.recover(name, force=force)

    # --- introspection ---
    def indexes(self) -> "DataFrame":
        """One row per index: the reference's summary columns."""
        return _statistics_df(self.session, self._manager.get_indexes(), extended=False)

    def index(self, name: str) -> "DataFrame":
        """The detailed statistics row of one index."""
        entry = self._manager.get_index(name)
        if entry is None:
            raise HyperspaceError(f"Index with name {name!r} could not be found")
        return _statistics_df(self.session, [entry], extended=True)

    def get_index_versions(self, name: str, states: list[str] | None = None) -> list[int]:
        return self._manager.get_index_versions(name, states)

    def get_index(self, name: str, log_version: int | None = None) -> Optional[IndexLogEntry]:
        return self._manager.get_index(name, log_version)
