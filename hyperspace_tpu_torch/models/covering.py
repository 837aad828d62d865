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
bucket by bucket, with no re-hash; an ingest append (``ingest_delta``)
writes the batch's rows as one more run per bucket, named by the ingest
version (``part-<version>-b<bucket>``).

Out of core: a create or full refresh whose source exceeds
``hyperspace.tpu.build.maxBytesInMemory`` (2 GB by default) streams the
source in file groups of at most that many bytes (``_file_groups``); each
group is bucketed, sorted and written as one run per bucket, named
``part-0-b<bucket>-<seq>`` (``write_streaming_groups``). An incremental
refresh above it streams both slices: the appended files through the same
writer, and, with deletes, each old index file rewritten alone as a run
after the lineage filter. The files equal the JAX package's at the same
limit; a bucket then holds several sorted runs, which queries handle and
optimize compacts.
"""

from __future__ import annotations

import os
import re
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
from ..ops.bucketize import partition_batch, stable_argsort
from ..plan.nodes import FileScan, Project
from ..utils.workers import io_pool, io_worker_count

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
    """Bucket id of an index data file, None for another name. A sample
    twin (``_sample.r<ppm>.part-...``) carries its data file's bucket id, so
    a sampled scan groups and prunes by bucket as an exact one does."""
    base = os.path.basename(name)
    if base.startswith("_sample."):
        from .sample_store import strip_sample_prefix

        base = strip_sample_prefix(base)
    m = _BUCKET_FILE_RE.match(base)
    return int(m.group(2)) if m else None


def _session_index_ext(session) -> str:
    """The index data file extension the session's conf asks for."""
    return cio.index_file_ext(session.conf.index_format if session is not None else "parquet")


def index_write_opts(session, clustered_cols) -> dict:
    """Index file write options from the session conf: row-group statistics
    on the clustered (sort or z-order) columns only, the only ones whose
    min/max prune, and the index codec."""
    if session is None:
        return {}
    conf = session.conf
    stats = list(clustered_cols) if conf.index_stats_columns == "clustered" else None
    return {"stats_columns": stats, "compression": conf.index_compression}


def resolve_columns(schema: Schema, names: Sequence[str]) -> list[str]:
    """Case-insensitive column resolution; a dotted path resolves to its
    flattened nested column (``__hs_nested.a.b``)."""
    by_lower = {f.name.lower(): f.name for f in schema}
    out = []
    for n in names:
        r = by_lower.get(n.lower())
        if r is None:
            r = by_lower.get((C.NESTED_FIELD_PREFIX + n).lower())
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
        ext = _session_index_ext(ctx.session)
        write_opts = index_write_opts(ctx.session, self._indexed)

        def compact(item):
            b, files = item
            batch = cio.read_parquet([f.name for f in files])
            part = batch.take(sort_indices_within(batch, self._indexed))
            out_path = os.path.join(ctx.index_data_path, bucket_file_name(0, b, ext=ext))
            cio.write_index_file(part, out_path, row_group_size=INDEX_ROW_GROUP_SIZE,
                                 **write_opts)
            # the compacted file has new row groups: its sidecar is built
            # anew over the merged batch, and its twins are the merged
            # batch's (the keep mask is a pure function of the key)
            _write_sketch_sidecar(part, out_path, INDEX_ROW_GROUP_SIZE, self._indexed)
            _write_sample_runs(part, out_path, INDEX_ROW_GROUP_SIZE, self._indexed)

        # HYPERSPACE_IO_THREADS sizes the pool, further clamped so the
        # buckets in flight stay within the build budget
        biggest = max((sum(f.size for f in files) for files in by_bucket.values()),
                      default=1)
        budget = ctx.session.conf.build_max_bytes_in_memory
        workers = io_worker_count(len(by_bucket), cap=max(1, budget // max(1, biggest)))
        with io_pool(workers, "hs-compact") as pool:
            list(pool.map(compact, by_bucket.items()))

    def ingest_delta(self, ctx: IndexerContext, delta_df: "DataFrame", version: int) -> int:
        """Log-structured ingest: bucket only the delta rows and write them
        as append-only runs, one per bucket, into the staged version dir;
        the cost follows the batch, not the index. The file name's version
        field is the ingest data version, so the runs of successive batches
        never collide when their version dirs merge. Compaction
        (``ingest/actions.IngestCompactAction``) re-sorts a bucket's runs
        into one file. Returns rows written."""
        data = CoveringIndex.create_index_data(ctx, delta_df, self._indexed, self._included,
                                               self.has_lineage())
        write_bucketed(data, ctx.index_data_path, self._indexed, self.num_buckets,
                       version=version, session=ctx.session)
        return data.num_rows

    def refresh_incremental(self, ctx: IndexerContext, appended_df: "DataFrame | None",
                            deleted_files: list[FileInfo],
                            index_content_files: list[FileInfo]) -> tuple["CoveringIndex", UpdateMode]:
        """Index the appended rows; drop the rows of deleted source files by
        their lineage ids. Appends alone write only the new rows (Merge);
        with deletes every bucket is rewritten (Overwrite). Above the
        in-memory limit both slices stream (``_refresh_incremental_streaming``)."""
        if deleted_files and not self.has_lineage():
            raise HyperspaceError(
                "Index has no lineage column; cannot handle deleted source files"
            )
        new_index = CoveringIndex(self._indexed, self._included, self._schema,
                                  self.num_buckets, self._properties)
        limit = ctx.session.conf.build_max_bytes_in_memory
        appended_scan = _single_file_scan(appended_df) if appended_df is not None else None
        appended_bytes = sum(f.size for f in appended_scan.files) if appended_scan else 0
        old_bytes = sum(f.size for f in index_content_files) if deleted_files else 0
        n_pieces = ((len(appended_scan.files) if appended_scan else 0)
                    + (len(index_content_files) if deleted_files else 0))
        if appended_bytes + old_bytes > limit and n_pieces > 1:
            mode = self._refresh_incremental_streaming(
                ctx, appended_df, appended_scan, deleted_files, index_content_files, limit)
            return new_index, mode
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

    def _refresh_incremental_streaming(self, ctx, appended_df, appended_scan, deleted_files,
                                       index_content_files, limit) -> UpdateMode:
        """The appended files through the file-group writer (runs ``0..``),
        then, with deletes, each old index file rewritten alone after the
        lineage filter as the next run (of its bucket, by its file name)."""
        seq = 0
        if appended_scan is not None:
            _, seq = write_streaming_groups(
                ctx, appended_df, appended_scan, self._indexed, self._included,
                self.has_lineage(), self.num_buckets, limit)
        if not deleted_files:
            return UpdateMode.MERGE
        deleted_ids = np.asarray([f.id for f in deleted_files], dtype=np.int64)
        for f in index_content_files:
            b = cio.read_parquet([f.name])
            keep = ~np.isin(b.column(C.DATA_FILE_NAME_ID).data, deleted_ids)
            if keep.any():
                kept = b.filter(keep)
                bucket = bucket_id_from_filename(f.name)
                if bucket is None:
                    write_bucketed(kept, ctx.index_data_path, self._indexed, self.num_buckets,
                                   session=ctx.session, seq=seq)
                else:
                    out_path = os.path.join(ctx.index_data_path, bucket_file_name(
                        0, bucket, seq, _session_index_ext(ctx.session)))
                    cio.write_index_file(kept, out_path, row_group_size=INDEX_ROW_GROUP_SIZE,
                                         **index_write_opts(ctx.session, self._indexed))
                    _write_sketch_sidecar(kept, out_path, INDEX_ROW_GROUP_SIZE, self._indexed)
                    _write_sample_runs(kept, out_path, INDEX_ROW_GROUP_SIZE, self._indexed)
            seq += 1
        return UpdateMode.OVERWRITE

    def refresh_full(self, ctx: IndexerContext, df: "DataFrame"
                     ) -> tuple["CoveringIndex", Optional[ColumnBatch]]:
        """Full rebuild; a source above the in-memory limit streams through
        the file-group writer, and the data is then already written (None)."""
        new_index = CoveringIndex(self._indexed, self._included, self._schema,
                                  self.num_buckets, self._properties)
        scan = _single_file_scan(df)
        limit = ctx.session.conf.build_max_bytes_in_memory
        if sum(f.size for f in scan.files) > limit and len(scan.files) > 1:
            write_streaming_groups(ctx, df, scan, self._indexed, self._included,
                                   self.has_lineage(), self.num_buckets, limit)
            return new_index, None
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
        return stable_argsort(keys[0])
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
    rows therefore arrive in file order; None for another plan, for a
    partitioned scan (it reads by partition) and for a source with no
    parquet footers."""
    from ..plan.dataframe import DataFrame as DF

    if scan.fmt != "parquet" or scan.partition_columns or scan.pushed_filter is not None:
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
    seq: int | None = None,
    session=None,
) -> list[str]:
    """Partition rows by hash(bucket_columns) % num_buckets, sort each
    bucket stably by the bucket columns, and write one file per non-empty
    bucket with the bucket id in its name (and the run ``seq``, if any).

    With an active device mesh (``session``'s ``meshDevices``) the
    partition (hash, placement, exchange) runs on the mesh
    (parallel/exchange.partition_batch_mesh) and gives the host path's
    rows, so the files are the same bytes. On a hierarchical mesh the rows
    split across the slices and each slice exchanges on its own submesh,
    giving one sorted run per slice per bucket (seq ``<seq>s<slice>``, the
    streamed build's multi-run layout in its own namespace). A declined
    mesh partition (logged, and counted in the session's
    ``device_stats.declines``) leaves the host partition to run."""
    keys = [sort_key_values(batch.column(c), True) for c in reversed(bucket_columns)]
    ext = _session_index_ext(session)
    write_opts = index_write_opts(session, bucket_columns)

    def write_bucket(item) -> str:
        bucket, rows, seq = item
        if len(keys) == 1:
            order = stable_argsort(keys[0][rows])
        else:
            order = np.lexsort([k[rows] for k in keys])
        part = batch.take(rows[order])
        fname = bucket_file_name(version, bucket, seq, ext)
        rgs = index_row_group_size(part.num_rows)
        full_path = os.path.join(path, fname)
        cio.write_index_file(part, full_path, row_group_size=rgs, **write_opts)
        # one hook for creates, streamed builds and ingest runs: the sketch
        # sidecar and the sample twins
        _write_sketch_sidecar(part, full_path, rgs, bucket_columns)
        _write_sample_runs(part, full_path, rgs, bucket_columns)
        return fname

    work = _mesh_partition(batch, bucket_columns, num_buckets, session, seq)
    if work is None:
        work = [(b, rows, seq) for b, rows in partition_batch(batch, bucket_columns,
                                                              num_buckets)]
    # pyarrow's encoder releases the GIL: buckets write concurrently, on at
    # most as many threads as cores (the numpy half holds the GIL)
    workers = io_worker_count(max(1, len(work)), cap=os.cpu_count() or 1)
    with io_pool(workers, "hs-build-write") as pool:
        return list(pool.map(write_bucket, work))


def _mesh_partition(batch: ColumnBatch, bucket_columns: list[str], num_buckets: int,
                    session, seq) -> Optional[list]:
    """``(bucket, rows, seq)`` write work from the session's active mesh, or
    None (no mesh, or a declined partition: the host partitions)."""
    if session is None:
        return None
    from ..parallel.exchange import partition_batch_mesh
    from ..parallel.mesh import _log, active_mesh, is_hierarchical, slice_submeshes

    mesh = active_mesh(session)
    if mesh is None:
        return None
    if not is_hierarchical(mesh):
        p = partition_batch_mesh(batch, bucket_columns, num_buckets, mesh)
        if p is None:
            return _mesh_declined(session)
        return [(b, rows, seq) for b, rows in p]
    subs = slice_submeshes(mesh)
    bounds = np.linspace(0, batch.num_rows, len(subs) + 1).astype(np.int64)
    runs: list = []
    for si, sub in enumerate(subs):
        start, stop = int(bounds[si]), int(bounds[si + 1])
        if start == stop:
            continue
        p = partition_batch_mesh(batch.slice(start, stop), bucket_columns, num_buckets, sub)
        if p is None:
            # one declining slice sends the whole batch to the host partition
            _log.warning("hierarchical mesh exchange fell back to the host partitioner "
                         "(a slice declined); %d slices affected", len(subs))
            return _mesh_declined(session)
        # each slice's runs in an "s<slice>" sub-namespace of the caller's
        # seq: a host run of the same seq never collides with them
        seq_val = f"{seq if seq is not None else 0}s{si}"
        runs += [(b, rows + start, seq_val) for b, rows in p]
    return runs


def _mesh_declined(session) -> None:
    declines = session.device_stats.declines
    declines["mesh_partition"] = declines.get("mesh_partition", 0) + 1
    return None


def _file_groups(files: list[FileInfo], max_bytes: int) -> list[list[FileInfo]]:
    """``files`` cut, in order, into groups of at most ``max_bytes`` (at
    least one file a group)."""
    groups: list[list[FileInfo]] = []
    cur: list[FileInfo] = []
    size = 0
    for f in files:
        if cur and size + f.size > max_bytes:
            groups.append(cur)
            cur, size = [], 0
        cur.append(f)
        size += f.size
    if cur:
        groups.append(cur)
    return groups


def write_streaming_groups(ctx: IndexerContext, df: "DataFrame", scan: FileScan,
                           indexed: list[str], included: list[str], lineage: bool,
                           num_buckets: int, limit: int, start_seq: int = 0
                           ) -> tuple[Optional[list[dict]], int]:
    """The out-of-core bucketed build: the source's files in groups of at
    most ``limit`` bytes, each group sliced, bucketed, sorted and written
    as one run per bucket (run ``seq`` in the file names). Returns (the
    index schema as a list, the next free seq)."""
    from ..plan.dataframe import DataFrame as DF

    schema_list: Optional[list[dict]] = None
    seq = start_seq
    for group in _file_groups(scan.files, limit):
        sub = df.plan.transform_up(lambda n, g=group: n.copy(files=g) if n is scan else n)
        data = CoveringIndex.create_index_data(ctx, DF(ctx.session, sub), indexed, included,
                                               lineage)
        if schema_list is None:
            schema_list = data.schema.to_list()
        write_bucketed(data, ctx.index_data_path, indexed, num_buckets, session=ctx.session,
                       seq=seq)
        seq += 1
    return schema_list, seq


def _write_sketch_sidecar(batch: ColumnBatch, data_path: str, row_group_size: int,
                          key_columns: Sequence[str]) -> None:
    """The per-row-group sketch sidecar of a just-written index data file
    (models/dataskipping/sketch_store.py); nothing with sketches off, the
    default."""
    from .dataskipping import sketch_store

    sketch_store.maybe_write_sidecar(batch, data_path, row_group_size, key_columns)


def _write_sample_runs(batch: ColumnBatch, data_path: str, row_group_size: int,
                       key_columns: Sequence[str]) -> None:
    """The sample twins of a just-written index data file
    (models/sample_store.py); nothing with ``HYPERSPACE_APPROX`` off, the
    default."""
    from . import sample_store

    sample_store.maybe_write_samples(batch, data_path, row_group_size, key_columns)


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
        """(the index, its data); above the in-memory limit the build streams
        and writes as it goes, and the data is None (already written)."""
        indexed = resolve_columns(df.schema, self._indexed)
        included = resolve_columns(df.schema, self._included)
        scan = _single_file_scan(df)
        lineage = properties.get("lineage", "false") == "true"
        num_buckets = ctx.session.conf.num_buckets
        limit = ctx.session.conf.build_max_bytes_in_memory
        if sum(f.size for f in scan.files) > limit and len(scan.files) > 1:
            schema_list, _ = write_streaming_groups(ctx, df, scan, indexed, included, lineage,
                                                    num_buckets, limit)
            return CoveringIndex(indexed, included, schema_list or [], num_buckets,
                                 properties), None
        data = CoveringIndex.create_index_data(ctx, df, indexed, included, lineage)
        index = CoveringIndex(indexed, included, data.schema.to_list(), num_buckets,
                              properties)
        return index, data
