"""ZOrderCoveringIndex, kind "ZCI" (counterpart of
hyperspace_tpu/models/zorder/index.py, in-memory build and maintenance).

A covering index laid out along a z-order curve instead of hash buckets:
rows are sorted by the z-address of the indexed columns (by the column
itself when there is one) and cut into roughly equal parts, one data file
each, the part count being the slice's bytes over
``_TARGET_BYTES_PER_PARTITION``. Row-group
statistics cover every indexed column, so a range on any of them skips
groups. File names, row order and log-entry JSON equal the JAX package's
in-memory build. The JAX package streams the build when the source exceeds
``hyperspace.tpu.build.maxBytesInMemory`` (cut points from a sample); the
port always builds in memory, so above that size its parts differ.

Maintenance rewrites z-ordered parts: incremental refresh writes the
appended rows as parts of their own (Merge), or, with deleted source
files, rewrites the remaining and appended rows together (Overwrite);
full refresh rebuilds, fields included; optimize re-sorts the files it is
given into new parts (OptimizeAction picks files by the bucket id in their
names, which z-order parts lack, so it leaves them alone, as the
reference's does).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..base import (
    Index,
    IndexConfig,
    IndexerContext,
    UpdateMode,
    register_index_kind,
    validate_column_names,
)
from ..covering import (
    INDEX_ROW_GROUP_SIZE,
    CoveringIndex,
    _drop_deleted_rows,
    _single_file_scan,
    index_write_opts,
    resolve_columns,
)
from ...columnar import io as cio
from ...columnar.table import ColumnBatch, Schema, sort_key_values
from ...exceptions import HyperspaceError
from ...meta.entry import FileInfo
from ...ops.zorder import interleave_bits
from .fields import ZOrderField, build_field

if TYPE_CHECKING:
    from ...plan.dataframe import DataFrame

# Source bytes per data file, and whether fields are percentile ones (else
# min-max): the defaults of the JAX package's
# ``hyperspace.index.zorder.targetSourceBytesPerPartition`` and
# ``hyperspace.index.zorder.quantile.enabled``. Module constants, which tests
# monkeypatch to match a JAX build made with other settings.
_TARGET_BYTES_PER_PARTITION = 1 << 30
_QUANTILE = False


class ZOrderCoveringIndex(Index):
    kind = "ZCI"
    kind_abbr = "ZCI"

    def __init__(self, indexed_columns, included_columns, schema,
                 fields: Sequence[ZOrderField], properties=None):
        self._indexed = list(indexed_columns)
        self._included = list(included_columns)
        self._schema = list(schema)
        self.fields = list(fields)
        self._properties = dict(properties or {})

    def indexed_columns(self) -> list[str]:
        return list(self._indexed)

    def included_columns(self) -> list[str]:
        return list(self._included)

    def referenced_columns(self) -> list[str]:
        return self._indexed + self._included

    def schema(self) -> Schema:
        return Schema.from_list(self._schema)

    def properties(self) -> dict[str, str]:
        return dict(self._properties)

    def has_lineage(self) -> bool:
        return self._properties.get("lineage", "false") == "true"

    def can_handle_deleted_files(self) -> bool:
        return self.has_lineage()

    def statistics(self) -> dict:
        """The kind's extra statistics, for Hyperspace.index(name)."""
        return {"zOrderFields": [f.to_dict() for f in self.fields],
                "includedColumns": ",".join(self._included)}

    def write(self, ctx: IndexerContext, index_data: ColumnBatch) -> None:
        write_zordered(
            index_data, ctx.index_data_path, self._indexed, self.fields,
            _TARGET_BYTES_PER_PARTITION, session=ctx.session,
        )

    def optimize(self, ctx: IndexerContext, files_to_optimize: list[FileInfo]) -> None:
        self.write(ctx, cio.read_parquet([f.name for f in files_to_optimize]))

    def refresh_incremental(self, ctx: IndexerContext, appended_df: "DataFrame | None",
                            deleted_files: list[FileInfo],
                            index_content_files: list[FileInfo]
                            ) -> tuple["ZOrderCoveringIndex", UpdateMode]:
        parts: list[ColumnBatch] = []
        if appended_df is not None:
            parts.append(CoveringIndex.create_index_data(
                ctx, appended_df, self._indexed, self._included, self.has_lineage()))
        mode = UpdateMode.MERGE
        if deleted_files:
            if not self.has_lineage():
                raise HyperspaceError(
                    "Index has no lineage column; cannot handle deleted source files"
                )
            parts.append(_drop_deleted_rows(index_content_files, deleted_files))
            mode = UpdateMode.OVERWRITE
        merged = ColumnBatch.concat([p.select(parts[0].schema.names) for p in parts])
        new_index = ZOrderCoveringIndex(self._indexed, self._included, self._schema,
                                        self.fields, self._properties)
        new_index.write(ctx, merged)
        return new_index, mode

    def refresh_full(self, ctx: IndexerContext, df: "DataFrame"
                     ) -> tuple["ZOrderCoveringIndex", ColumnBatch]:
        data = CoveringIndex.create_index_data(ctx, df, self._indexed, self._included,
                                               self.has_lineage())
        fields = [build_field(c, data.column(c), _QUANTILE) for c in self._indexed]
        return (ZOrderCoveringIndex(self._indexed, self._included, self._schema, fields,
                                    self._properties), data)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {"indexed": self._indexed, "included": self._included},
                "schema": self._schema,
                "zOrderFields": [f.to_dict() for f in self.fields],
                "properties": self._properties,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ZOrderCoveringIndex":
        p = d["properties"]
        return cls(
            p["columns"]["indexed"],
            p["columns"]["included"],
            p["schema"],
            [ZOrderField.from_dict(f) for f in p["zOrderFields"]],
            p.get("properties", {}),
        )


register_index_kind(ZOrderCoveringIndex.kind, ZOrderCoveringIndex.from_dict)


def compute_zaddresses(batch: ColumnBatch, indexed: list[str],
                       fields: Sequence[ZOrderField]) -> np.ndarray:
    by_name = {f.name: f for f in fields}
    return interleave_bits(
        [(by_name[c].codes(batch.column(c)), by_name[c].nbits) for c in indexed]
    )


def write_zordered(
    batch: ColumnBatch,
    path: str,
    indexed: list[str],
    fields: Sequence[ZOrderField],
    target_bytes_per_partition: int,
    version: int = 0,
    session=None,
) -> list[str]:
    """Sort rows stably by z-address (one indexed column: by its sort key)
    and split them into ``ceil(bytes / target)`` near-equal parts, one file
    ``part-<version>-z<part>.parquet`` each. A string column counts 64
    bytes per dictionary entry, as the JAX package counts it."""
    n = batch.num_rows
    if n == 0:
        os.makedirs(path, exist_ok=True)
        return []
    if len(indexed) == 1:
        key = sort_key_values(batch.column(indexed[0]), True)
    else:
        key = compute_zaddresses(batch, indexed, fields)
    sorted_batch = batch.take(np.argsort(key, kind="stable"))
    approx_bytes = sum(
        c.data.nbytes + (0 if c.dictionary is None else 64 * len(c.dictionary))
        for c in batch.columns.values()
    )
    num_parts = max(1, int(np.ceil(approx_bytes / max(1, target_bytes_per_partition))))
    num_parts = min(num_parts, n)
    bounds = np.linspace(0, n, num_parts + 1).astype(np.int64)
    # z-ordering clusters every indexed column, so all of them keep stats
    write_opts = index_write_opts(session, indexed)

    def write_part(i: int):
        part = sorted_batch.slice(int(bounds[i]), int(bounds[i + 1]))
        if part.num_rows == 0:
            return None
        fname = f"part-{version}-z{i:05d}.parquet"
        cio.write_index_file(part, os.path.join(path, fname),
                             row_group_size=INDEX_ROW_GROUP_SIZE, **write_opts)
        return fname

    # bounded so in-flight part copies stay under ~1 GB of extra memory
    per_part = max(1, approx_bytes // num_parts)
    workers = max(1, min(8, num_parts, (1 << 30) // per_part))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return [f for f in pool.map(write_part, range(num_parts)) if f]


class ZOrderCoveringIndexConfig(IndexConfig):
    def __init__(self, index_name: str, indexed_columns: Sequence[str],
                 included_columns: Sequence[str] = ()):
        if not index_name:
            raise HyperspaceError("Index name must not be empty")
        self._name = index_name
        self._indexed = validate_column_names(indexed_columns, "indexed")
        self._included = validate_column_names(included_columns, "included")
        overlap = {c.lower() for c in self._indexed} & {c.lower() for c in self._included}
        if overlap:
            raise HyperspaceError(f"Columns in both indexed and included: {overlap}")

    @property
    def index_name(self) -> str:
        return self._name

    def referenced_columns(self) -> list[str]:
        return self._indexed + self._included

    def create_index(self, ctx: IndexerContext, df: "DataFrame", properties: dict[str, str]):
        indexed = resolve_columns(df.schema, self._indexed)
        included = resolve_columns(df.schema, self._included)
        _single_file_scan(df)
        lineage = properties.get("lineage", "false") == "true"
        data = CoveringIndex.create_index_data(ctx, df, indexed, included, lineage)
        fields = [build_field(c, data.column(c), _QUANTILE) for c in indexed]
        index = ZOrderCoveringIndex(indexed, included, data.schema.to_list(), fields,
                                    properties)
        return index, data
