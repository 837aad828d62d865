"""Hyperspace, the user-facing facade (counterpart of
hyperspace_tpu/hyperspace.py: create and list)."""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Optional

import numpy as np

from .columnar.table import Column, ColumnBatch
from .index_manager import index_manager_for
from .meta.entry import IndexLogEntry

if TYPE_CHECKING:
    from .models.base import IndexConfig
    from .plan.dataframe import DataFrame
    from .session import HyperspaceSession

_SUMMARY_COLUMNS = (
    "name", "indexedColumns", "includedColumns", "numBuckets", "schema",
    "indexLocation", "state",
)


class Hyperspace:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session
        self._manager = index_manager_for(session)

    def create_index(self, df: "DataFrame", config: "IndexConfig") -> None:
        self._manager.create(df, config)

    def get_index(self, name: str) -> Optional[IndexLogEntry]:
        return self._manager.get_index(name)

    def indexes(self) -> "DataFrame":
        """One row per index: the reference's summary columns."""
        from .plan.dataframe import DataFrame
        from .plan.nodes import InMemoryScan

        rows: dict[str, list] = {k: [] for k in _SUMMARY_COLUMNS}
        for e in self._manager.get_indexes():
            dd = e.derived_dataset
            rows["name"].append(e.name)
            rows["indexedColumns"].append(",".join(dd.indexed_columns()))
            rows["includedColumns"].append(",".join(dd.included_columns()))
            rows["numBuckets"].append(dd.num_buckets)
            rows["schema"].append(json.dumps(dd._schema))
            files = e.content.files()
            rows["indexLocation"].append(files[0].rsplit("/", 2)[0] if files else "")
            rows["state"].append(e.state)
        cols = {
            k: (Column(np.asarray(v, dtype=np.int64), "int64") if k == "numBuckets"
                else Column.from_values(v, "string") if v
                else Column(np.zeros(0, np.int32), "string", None, [""]))
            for k, v in rows.items()
        }
        return DataFrame(self.session, InMemoryScan(ColumnBatch(cols)))
