"""CoveringIndex, kind "CI" (counterpart of hyperspace_tpu/models/covering.py,
create path).

A covering index is a vertical slice of the source (indexed + included
columns), hash-bucketed by the indexed columns (ops/hashing.py, the same
hash as the JAX package) and sorted by them within each bucket, written as
one parquet file per non-empty bucket whose name carries the bucket id.
The layout, file names and log-entry JSON equal the JAX package's, so
either package reads an index the other built. This slice builds in memory
(the JAX package's out-of-core streaming build is not ported) and writes no
lineage column.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from .base import Index, IndexConfig, IndexerContext, register_index_kind, validate_column_names
from ..columnar import io as cio
from ..columnar.table import ColumnBatch, Schema, sort_key_values
from ..exceptions import HyperspaceError
from ..ops.bucketize import partition_batch
from ..plan.nodes import FileScan

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

    def write(self, ctx: IndexerContext, index_data: ColumnBatch) -> None:
        write_bucketed(
            index_data, ctx.index_data_path, self._indexed, self.num_buckets,
            session=ctx.session,
        )

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
        cio.write_index_file(
            part, os.path.join(path, fname),
            row_group_size=index_row_group_size(part.num_rows), **write_opts,
        )
        return fname

    work = partition_batch(batch, bucket_columns, num_buckets)
    # pyarrow's encoder releases the GIL: buckets write concurrently
    with ThreadPoolExecutor(max_workers=max(1, min(len(work), os.cpu_count() or 1))) as pool:
        return list(pool.map(write_bucket, work))


def _single_file_scan(df: "DataFrame") -> FileScan:
    scans = [n for n in df.plan.preorder() if isinstance(n, FileScan)]
    if len(scans) != 1:
        raise HyperspaceError("Only plans over a single relation can be indexed")
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
        cols = indexed + [c for c in included if c not in indexed]
        data = df.select(*cols).collect()
        index = CoveringIndex(
            indexed, included, data.schema.to_list(), ctx.session.conf.num_buckets,
            properties,
        )
        return index, data
