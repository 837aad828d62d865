"""CoveringIndex, kind "CI" (counterpart of hyperspace_tpu/models/covering.py).

A covering index is a vertical slice of the source (indexed + included
columns), hash-bucketed by the indexed columns (ops/hashing.py, the same
hash as the JAX package) and sorted by them within each bucket, written as
one parquet file per non-empty bucket whose name carries the bucket id.
The layout, file names and log-entry JSON equal the JAX package's, so
either package reads an index the other built. With lineage on, each row
also carries the stable id of its source file (``_data_file_id``), which
lets incremental refresh and hybrid scan drop the rows of deleted source
files.

Maintenance: incremental refresh writes the appended rows as a new run per
bucket beside the old data (Merge), or, when source files were deleted,
rewrites every bucket without their rows (Overwrite); full refresh
rebuilds; optimize compacts each bucket's files into one sorted file,
bucket by bucket, with no re-hash. The port builds and refreshes in
memory: the JAX package streams above ``hyperspace.tpu.build.maxBytesInMemory``
(2 GB by default), writing several runs per bucket, so above that size the
two packages' files differ (their rows do not).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from .base import (
    Index,
    IndexConfig,
    IndexerContext,
    UpdateMode,
    register_index_kind,
    validate_column_names,
)
from .. import constants as C
from ..columnar import io as cio
from ..columnar.table import Column, ColumnBatch, Schema, sort_key_values
from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo
from ..ops.bucketize import partition_batch
from ..plan.nodes import FileScan, Project

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame

# row groups: fine enough for sorted-bucket range pruning, at most ~64 per
# file (the JAX package's sizing, so both write the same layout)
INDEX_ROW_GROUP_SIZE = 16384


def index_row_group_size(n_rows: int) -> int:
    return max(INDEX_ROW_GROUP_SIZE, min(1 << 20, n_rows // 64))


def bucket_file_name(version: int, bucket: int, seq=None, ext: str = ".parquet") -> str:
    suffix = f"-{seq}" if seq is not None else ""
    return f"part-{version}-b{bucket:05d}{suffix}{ext}"


# the names bucket_file_name writes, with the JAX package's run suffixes
_BUCKET_FILE_RE = re.compile(r"^part-(\d+)-b(\d{5})(?:-\d+(?:s\d+)?)?\.(?:parquet|arrow)$")


def bucket_id_from_filename(name: str) -> Optional[int]:
    """Bucket id of an index data file, None for another name."""
    m = _BUCKET_FILE_RE.match(os.path.basename(name))
    return int(m.group(2)) if m else None


def index_write_opts(session, clustered_columns) -> dict:
    """Index file write options from the session conf: row-group statistics
    on the clustered (sort or z-order) columns only, the only ones whose
    min/max prune, and the index codec."""
    if session is None:
        return {}
    conf = session.conf
    stats = list(clustered_columns) if conf.index_stats_columns == "clustered" else None
    return {"stats_columns": stats, "compression": conf.index_compression}


def resolve_columns(schema: Schema, names: Sequence[str]) -> list[str]:
    """Case-insensitive column resolution."""
    by_lower = {f.name.lower(): f.name for f in schema}
    out = []
    for n in names:
        r = by_lower.get(n.lower())
        if r is None:
            raise HyperspaceError(
                f"Column {n!r} could not be resolved; available: {schema.names}"
            )
        out.append(r)
    return out


class CoveringIndex(Index):
    kind = "CI"
    kind_abbr = "CI"

    def __init__(self, indexed_columns, included_columns, schema, num_buckets,
                 properties=None):
        self._indexed = list(indexed_columns)
        self._included = list(included_columns)
        self._schema = list(schema)
        self.num_buckets = num_buckets
        self._properties = dict(properties or {})

    def indexed_columns(self) -> list[str]:
        return list(self._indexed)

    def referenced_columns(self) -> list[str]:
        return self._indexed + self._included

    def included_columns(self) -> list[str]:
        return list(self._included)

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
        return {"numBuckets": self.num_buckets, "includedColumns": ",".join(self._included)}

    @staticmethod
    def create_index_data(ctx: IndexerContext, df: "DataFrame", indexed: list[str],
                          included: list[str], lineage: bool) -> ColumnBatch:
        """The vertical slice; with lineage, each row carries the stable id
        of its source file, from the context's file-id tracker."""
        cols = indexed + [c for c in included if c not in indexed]
        if not lineage:
            return df.select(*cols).collect()
        scan = _single_file_scan(df)
        fast = _lineage_fast_path(ctx, df, scan, cols)
        if fast is not None:
            return fast
        return _lineage_per_file(ctx, df, scan, cols)

    def write(self, ctx: IndexerContext, index_data: ColumnBatch) -> None:
        write_bucketed(
            index_data, ctx.index_data_path, self._indexed, self.num_buckets,
            session=ctx.session,
        )

    def optimize(self, ctx: IndexerContext, files_to_optimize: list[FileInfo]) -> None:
        """Compact each bucket's files into one file sorted by the indexed
        columns; rows keep their bucket (it is in the file name), so
        nothing is re-hashed. Files of another layout re-bucket whole."""
        by_bucket: dict[Optional[int], list[FileInfo]] = {}
        for f in files_to_optimize:
            by_bucket.setdefault(bucket_id_from_filename(f.name), []).append(f)
        if None in by_bucket:
            batch = cio.read_parquet([f.name for f in files_to_optimize])
            write_bucketed(batch, ctx.index_data_path, self._indexed, self.num_buckets,
                           session=ctx.session)
            return
        write_opts = index_write_opts(ctx.session, self._indexed)

        def compact(item):
            b, files = item
            batch = cio.read_parquet([f.name for f in files])
            part = batch.take(sort_indices_within(batch, self._indexed))
            out_path = os.path.join(ctx.index_data_path, bucket_file_name(0, b))
            cio.write_index_file(part, out_path, row_group_size=INDEX_ROW_GROUP_SIZE,
                                 **write_opts)
            # the compacted file has new row groups: its sidecar is built
            # anew over the merged batch
            _write_sketch_sidecar(part, out_path, INDEX_ROW_GROUP_SIZE, self._indexed)

        with ThreadPoolExecutor(max_workers=max(1, min(len(by_bucket), 8))) as pool:
            list(pool.map(compact, by_bucket.items()))

    def refresh_incremental(self, ctx: IndexerContext, appended_df: "DataFrame | None",
                            deleted_files: list[FileInfo],
                            index_content_files: list[FileInfo]) -> tuple["CoveringIndex", UpdateMode]:
        """Index the appended rows; drop the rows of deleted source files by
        their lineage ids. Appends alone write only the new rows (Merge);
        with deletes every bucket is rewritten (Overwrite)."""
        if deleted_files and not self.has_lineage():
            raise HyperspaceError(
                "Index has no lineage column; cannot handle deleted source files"
            )
        new_index = CoveringIndex(self._indexed, self._included, self._schema,
                                  self.num_buckets, self._properties)
        parts: list[ColumnBatch] = []
        if appended_df is not None:
            parts.append(CoveringIndex.create_index_data(
                ctx, appended_df, self._indexed, self._included, self.has_lineage()))
        mode = UpdateMode.MERGE
        if deleted_files:
            parts.append(_drop_deleted_rows(index_content_files, deleted_files))
            mode = UpdateMode.OVERWRITE
        new_index.write(ctx, ColumnBatch.concat(parts))
        return new_index, mode

    def refresh_full(self, ctx: IndexerContext, df: "DataFrame") -> tuple["CoveringIndex", ColumnBatch]:
        new_index = CoveringIndex(self._indexed, self._included, self._schema,
                                  self.num_buckets, self._properties)
        data = CoveringIndex.create_index_data(ctx, df, self._indexed, self._included,
                                               self.has_lineage())
        return new_index, data

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {
                "columns": {"indexed": self._indexed, "included": self._included},
                "schema": self._schema,
                "numBuckets": self.num_buckets,
                "properties": self._properties,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CoveringIndex":
        p = d["properties"]
        return cls(
            p["columns"]["indexed"],
            p["columns"]["included"],
            p["schema"],
            p["numBuckets"],
            p.get("properties", {}),
        )


register_index_kind(CoveringIndex.kind, CoveringIndex.from_dict)


def sort_indices_within(batch: ColumnBatch, sort_columns: list[str]) -> np.ndarray:
    """Stable ascending order by the sort columns, with the query-time key
    encoding (NULLs first, strings by value)."""
    if not sort_columns:
        return np.arange(batch.num_rows)
    keys = [sort_key_values(batch.column(c), True) for c in reversed(sort_columns)]
    if len(keys) == 1:
        return np.argsort(keys[0], kind="stable")
    return np.lexsort(keys)


def _drop_deleted_rows(index_files: list[FileInfo], deleted_files: list[FileInfo]) -> ColumnBatch:
    """The old index rows, less those whose lineage id is a deleted file's."""
    deleted_ids = np.asarray([f.id for f in deleted_files], dtype=np.int64)
    old = cio.read_parquet([f.name for f in index_files])
    return old.filter(~np.isin(old.column(C.DATA_FILE_NAME_ID).data, deleted_ids))


def _lineage_fast_path(ctx: IndexerContext, df: "DataFrame", scan: FileScan,
                       cols: list[str]) -> Optional[ColumnBatch]:
    """Lineage from one multi-file read and each file's row count (from
    its footer), for a plan that is only projections over the scan, whose
    rows therefore arrive in file order; None for another plan."""
    from ..plan.dataframe import DataFrame as DF

    if scan.pushed_filter is not None:
        return None
    if not all(isinstance(n, (FileScan, Project)) for n in df.plan.preorder()):
        return None
    counts = [cio.file_num_rows(f.name) for f in scan.files]
    fids = [ctx.file_id_tracker.add_file(f.name, f.size, f.modified_time) for f in scan.files]
    batch = DF(ctx.session, df.plan).select(*cols).collect()
    if batch.num_rows != sum(counts):
        return None  # the files changed underfoot: read them one by one
    lineage = np.repeat(np.asarray(fids, dtype=np.int64), counts)
    return batch.with_column(C.DATA_FILE_NAME_ID, Column(lineage, "int64"))


def _lineage_per_file(ctx: IndexerContext, df: "DataFrame", scan: FileScan,
                      cols: list[str]) -> ColumnBatch:
    """Lineage by reading the plan once per source file."""
    from ..plan.dataframe import DataFrame as DF

    batches = []
    for f in scan.files:
        fid = ctx.file_id_tracker.add_file(f.name, f.size, f.modified_time)
        sub = df.plan.transform_up(lambda n, f=f: n.copy(files=[f]) if n is scan else n)
        b = DF(ctx.session, sub).select(*cols).collect()
        batches.append(b.with_column(
            C.DATA_FILE_NAME_ID, Column(np.full(b.num_rows, fid, dtype=np.int64), "int64")))
    return ColumnBatch.concat(batches)


def write_bucketed(
    batch: ColumnBatch,
    path: str,
    bucket_columns: list[str],
    num_buckets: int,
    version: int = 0,
    session=None,
) -> list[str]:
    """Partition rows by hash(bucket_columns) % num_buckets, sort each
    bucket stably by the bucket columns, and write one file per non-empty
    bucket with the bucket id in its name."""
    keys = [sort_key_values(batch.column(c), True) for c in reversed(bucket_columns)]
    write_opts = index_write_opts(session, bucket_columns)

    def write_bucket(item) -> str:
        bucket, rows = item
        if len(keys) == 1:
            order = np.argsort(keys[0][rows], kind="stable")
        else:
            order = np.lexsort([k[rows] for k in keys])
        part = batch.take(rows[order])
        fname = bucket_file_name(version, bucket)
        rgs = index_row_group_size(part.num_rows)
        cio.write_index_file(part, os.path.join(path, fname), row_group_size=rgs,
                             **write_opts)
        _write_sketch_sidecar(part, os.path.join(path, fname), rgs, bucket_columns)
        return fname

    work = partition_batch(batch, bucket_columns, num_buckets)
    # pyarrow's encoder releases the GIL: buckets write concurrently
    with ThreadPoolExecutor(max_workers=max(1, min(len(work), os.cpu_count() or 1))) as pool:
        return list(pool.map(write_bucket, work))


def _write_sketch_sidecar(batch: ColumnBatch, data_path: str, row_group_size: int,
                          key_columns: Sequence[str]) -> None:
    """The per-row-group sketch sidecar of a just-written index data file
    (models/dataskipping/sketch_store.py); nothing with sketches off, the
    default."""
    from .dataskipping import sketch_store

    sketch_store.maybe_write_sidecar(batch, data_path, row_group_size, key_columns)


def _single_file_scan(df: "DataFrame") -> FileScan:
    scans = [n for n in df.plan.preorder() if isinstance(n, FileScan)]
    if len(scans) != 1:
        raise HyperspaceError(
            f"Index source must contain exactly one file relation, found {len(scans)}"
        )
    return scans[0]


class CoveringIndexConfig(IndexConfig):
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

    def create_index(self, ctx, df, properties):
        indexed = resolve_columns(df.schema, self._indexed)
        included = resolve_columns(df.schema, self._included)
        _single_file_scan(df)
        lineage = properties.get("lineage", "false") == "true"
        data = CoveringIndex.create_index_data(ctx, df, indexed, included, lineage)
        index = CoveringIndex(
            indexed, included, data.schema.to_list(), ctx.session.conf.num_buckets,
            properties,
        )
        return index, data
