"""DataSkippingIndex, kind "DS" (counterpart of
hyperspace_tpu/models/dataskipping/index.py).

The index data is one small parquet table, ``sketches-0.parquet``: a row
per source file, its stable file id and each sketch's aggregate columns.
At query time the filter condition, in negation normal form, becomes a
keep-mask over that table (``translate_filter``), and
ApplyDataSkippingIndex (rule.py) drops the source files the mask rejects
before anything is read. Incremental refresh drops the rows of deleted
files by id and appends the appended files' sketches, overwriting the
table; full refresh rebuilds it. The kind has no optimize.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from ..base import Index, IndexConfig, IndexerContext, UpdateMode, register_index_kind
from ... import constants as C
from ...columnar import io as cio
from ...columnar.table import Column, ColumnBatch
from ...exceptions import HyperspaceError
from ...meta.entry import FileInfo
from ...plan import expr as X
from ...plan.expr import Expr, to_nnf
from .sketches import Sketch, SketchPredicate, sketch_from_dict

if TYPE_CHECKING:
    from ...plan.dataframe import DataFrame
    from ...plan.nodes import FileScan

FILE_ID_COLUMN = C.DATA_FILE_NAME_ID
SKETCH_FILE = "sketches-0.parquet"


def read_source_files_parallel(ctx: IndexerContext, df: "DataFrame", scan: "FileScan",
                               cols: list[str]) -> tuple[list[int], list[ColumnBatch]]:
    """One read per source file, in the scan's order: file ids assigned in
    that order, the reads on a thread pool. Each worker disables the
    rewrite again (the guard is per thread): a build read served through
    an index would give wrong per-file rows."""
    from ...plan.dataframe import DataFrame as DF
    from ...rules.apply import with_hyperspace_rule_disabled

    fids = [ctx.file_id_tracker.add_file(f.name, f.size, f.modified_time) for f in scan.files]

    def read_one(f):
        with with_hyperspace_rule_disabled():
            sub = df.plan.transform_up(lambda n: n.copy(files=[f]) if n is scan else n)
            return DF(ctx.session, sub).select(*cols).collect()

    with ThreadPoolExecutor(max_workers=max(1, min(len(scan.files), 8))) as pool:
        batches = list(pool.map(read_one, scan.files))
    return fids, batches


class DataSkippingIndex(Index):
    kind = "DS"
    kind_abbr = "DS"

    def __init__(self, sketches: Sequence[Sketch], properties: dict[str, str] | None = None):
        if not sketches:
            raise HyperspaceError("DataSkippingIndex requires at least one sketch")
        self.sketches = list(sketches)
        self._properties = dict(properties or {})

    def indexed_columns(self) -> list[str]:
        return sorted({c for s in self.sketches for c in s.indexed_columns()})

    def referenced_columns(self) -> list[str]:
        return sorted({c for s in self.sketches for c in s.referenced_columns()})

    def properties(self) -> dict[str, str]:
        return dict(self._properties)

    def statistics(self) -> dict:
        return {"sketches": [repr(s) for s in self.sketches]}

    def can_handle_deleted_files(self) -> bool:
        return True  # rows are keyed by file id: a delete drops rows

    # --- build ---
    @staticmethod
    def build_sketch_table(ctx: IndexerContext, df: "DataFrame",
                           sketches: Sequence[Sketch]) -> ColumnBatch:
        """Each source file's rows reduced by every sketch: one row per
        file, in the scan's file order."""
        from ..covering import _single_file_scan

        scan = _single_file_scan(df)
        needed = sorted({c for s in sketches for c in s.referenced_columns()})
        file_ids, parts = read_source_files_parallel(ctx, df, scan, needed)
        segments = (np.concatenate([np.full(b.num_rows, seg, dtype=np.int64)
                                    for seg, b in enumerate(parts)])
                    if parts else np.empty(0, np.int64))
        all_rows = ColumnBatch.concat(parts)
        cols: dict[str, Column] = {
            FILE_ID_COLUMN: Column(np.asarray(file_ids, dtype=np.int64), "int64")
        }
        for sketch in sketches:
            cols.update(sketch.aggregate(all_rows.column(sketch.expr), segments,
                                         len(scan.files)))
        return ColumnBatch(cols)

    def write(self, ctx: IndexerContext, index_data: ColumnBatch) -> None:
        cio.write_parquet(
            index_data, os.path.join(ctx.index_data_path, SKETCH_FILE),
            compression=ctx.session.conf.index_compression, keep_dictionary=True,
        )

    # --- refresh ---
    def refresh_incremental(self, ctx: IndexerContext, appended_df: "DataFrame | None",
                            deleted_files: list[FileInfo],
                            index_content_files: list[FileInfo]
                            ) -> tuple["DataSkippingIndex", UpdateMode]:
        old = cio.read_parquet([f.name for f in index_content_files])
        if deleted_files:
            deleted_ids = np.asarray([f.id for f in deleted_files], dtype=np.int64)
            old = old.filter(~np.isin(old.column(FILE_ID_COLUMN).data, deleted_ids))
        parts = [old]
        if appended_df is not None:
            parts.append(DataSkippingIndex.build_sketch_table(ctx, appended_df, self.sketches))
        merged = ColumnBatch.concat([p.select(old.schema.names) for p in parts])
        new_index = DataSkippingIndex(self.sketches, self._properties)
        new_index.write(ctx, merged)
        return new_index, UpdateMode.OVERWRITE

    def refresh_full(self, ctx: IndexerContext, df: "DataFrame"
                     ) -> tuple["DataSkippingIndex", ColumnBatch]:
        return (DataSkippingIndex(self.sketches, self._properties),
                DataSkippingIndex.build_sketch_table(ctx, df, self.sketches))

    # --- query-time translation ---
    def translate_filter(self, condition: Expr) -> Optional[SketchPredicate]:
        """The condition as a keep-mask closure over the sketch table; None
        when no part of it can be bounded."""
        return _translate(to_nnf(condition), self.sketches)

    # --- serialization ---
    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {
                "sketches": [s.to_dict() for s in self.sketches],
                "properties": self._properties,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DataSkippingIndex":
        p = d["properties"]
        return cls([sketch_from_dict(s) for s in p["sketches"]], p.get("properties", {}))


register_index_kind(DataSkippingIndex.kind, DataSkippingIndex.from_dict)


def _translate(pred: Expr, sketches: Sequence[Sketch]) -> Optional[SketchPredicate]:
    """NNF recursion with constant folding: an And with one unknown side is
    its known side; an Or with an unknown side is unknown."""
    if isinstance(pred, X.And):
        left = _translate(pred.left, sketches)
        right = _translate(pred.right, sketches)
        if left is None:
            return right
        if right is None:
            return left
        return lambda b: left(b) & right(b)
    if isinstance(pred, X.Or):
        left = _translate(pred.left, sketches)
        right = _translate(pred.right, sketches)
        if left is None or right is None:
            return None
        return lambda b: left(b) | right(b)
    for sketch in sketches:
        converted = sketch.convert_predicate(pred)
        if converted is not None:
            return converted
    return None


class DataSkippingIndexConfig(IndexConfig):
    """A name and its sketches; two sketches of one kind on one column are
    refused. The JAX package adds a PartitionSketch per partition column
    of a partitioned source; the port reads no partitioned sources, so its
    scans have no partition column to add one for."""

    def __init__(self, index_name: str, sketches: Sequence[Sketch]):
        if not index_name:
            raise HyperspaceError("Index name must not be empty")
        if not sketches:
            raise HyperspaceError("At least one sketch is required")
        seen = set()
        for s in sketches:
            key = (s.kind, s.expr.lower())
            if key in seen:
                raise HyperspaceError(f"Duplicate sketch: {s!r}")
            seen.add(key)
        self._name = index_name
        self.sketches = list(sketches)

    @property
    def index_name(self) -> str:
        return self._name

    def referenced_columns(self) -> list[str]:
        return sorted({c for s in self.sketches for c in s.referenced_columns()})

    def create_index(self, ctx: IndexerContext, df: "DataFrame", properties: dict[str, str]
                     ) -> tuple[DataSkippingIndex, ColumnBatch]:
        from ..covering import resolve_columns

        resolve_columns(df.schema, self.referenced_columns())
        index = DataSkippingIndex(self.sketches, properties)
        return index, DataSkippingIndex.build_sketch_table(ctx, df, self.sketches)
