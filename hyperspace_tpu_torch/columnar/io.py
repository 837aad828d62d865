"""Parquet <-> ColumnBatch via pyarrow (counterpart of
hyperspace_tpu/columnar/io.py, reduced to what the covering-index query
path needs: whole-file and row-group-selected reads, footer-only row-group
statistics, index-file writes, the decoded index-chunk cache, and the
ordered chunk stream the pipelined executor consumes, ``iter_chunks``).

The chunk cache matters to the device tier: it hands repeated index scans
the SAME numpy buffers, and the device-resident column cache
(utils/device_cache.py) keys on buffer identity, so a warm query uploads
nothing. Raw source scans never use it.

Inside an index action (``maintenance_scope``), a multi-file read of named
source columns decodes file by file and concatenates the batches, as the
JAX package's maintenance reads do: a string column then carries the
sorted union of the files' dictionaries, so both packages write the same
index files.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from .table import Column, ColumnBatch, DATE32, Field, STRING, Schema
from ..exceptions import HyperspaceError
from ..serve import budget as serve_budget
from ..utils import env

_ARROW_TO_LOGICAL = {
    pa.int8(): "int8",
    pa.int16(): "int16",
    pa.int32(): "int32",
    pa.int64(): "int64",
    pa.float32(): "float32",
    pa.float64(): "float64",
    pa.bool_(): "bool",
    pa.date32(): DATE32,
    pa.string(): STRING,
    pa.large_string(): STRING,
}

_LOGICAL_TO_ARROW = {
    "int8": pa.int8(),
    "int16": pa.int16(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "bool": pa.bool_(),
    DATE32: pa.date32(),
    STRING: pa.string(),
}


def _leaf_logical(t: pa.DataType, name: str) -> str:
    if pa.types.is_dictionary(t):
        t = t.value_type
    logical = _ARROW_TO_LOGICAL.get(t)
    if logical is None:
        if pa.types.is_timestamp(t):
            return "int64"
        if pa.types.is_decimal(t):
            return "float64"
        raise HyperspaceError(f"Unsupported arrow type {t} for {name}")
    return logical


def arrow_schema_to_schema(sch: pa.Schema) -> Schema:
    return Schema([Field(f.name, _leaf_logical(f.type, f.name)) for f in sch])


def _chunked_to_column(arr, logical: str) -> Column:
    combined = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    validity = None
    if combined.null_count:
        validity = np.asarray(combined.is_valid())
    if logical == STRING:
        dict_arr = (
            combined
            if pa.types.is_dictionary(combined.type)
            else combined.dictionary_encode()
        )
        codes = np.asarray(dict_arr.indices.fill_null(0)).astype(np.int32)
        vocab = dict_arr.dictionary.to_pylist() or [""]
        return Column(codes, STRING, validity, [str(v) for v in vocab])
    if logical == DATE32:
        data = np.asarray(combined.cast(pa.int32()).fill_null(0))
        return Column(data.astype(np.int32), DATE32, validity)
    target = _LOGICAL_TO_ARROW[logical]
    if pa.types.is_timestamp(combined.type):
        combined = combined.cast(pa.int64())
    elif pa.types.is_decimal(combined.type):
        combined = combined.cast(pa.float64())
    if validity is None and combined.type == target:
        data = np.asarray(combined)  # zero-copy view of the arrow buffer
    else:
        data = np.asarray(combined.cast(target).fill_null(0))
    return Column(np.ascontiguousarray(data), logical, validity)


def table_to_batch(table: pa.Table) -> ColumnBatch:
    schema = arrow_schema_to_schema(table.schema)
    return ColumnBatch(
        {f.name: _chunked_to_column(table.column(f.name), f.dtype) for f in schema}
    )


def batch_to_table(batch: ColumnBatch) -> pa.Table:
    arrays = {}
    for name, col in batch.columns.items():
        mask = None if col.validity is None else ~col.validity
        if col.dtype == STRING:
            # dictionary codes go out as-is: no per-row python strings
            arrays[name] = pa.DictionaryArray.from_arrays(
                pa.array(col.data, mask=mask),
                pa.array([str(v) for v in col.dictionary], type=pa.string()),
            )
        elif col.dtype == DATE32:
            arrays[name] = pa.array(col.data, type=pa.int32(), mask=mask).cast(
                pa.date32()
            )
        else:
            arrays[name] = pa.array(
                col.data, type=_LOGICAL_TO_ARROW[col.dtype], mask=mask
            )
    return pa.table(arrays)


# --- readers -----------------------------------------------------------------


def _batch_nbytes(batch: ColumnBatch) -> int:
    total = 0
    for col in batch.columns.values():
        total += col.data.nbytes
        if col.validity is not None:
            total += col.validity.nbytes
    return total


class IndexChunkCache:
    """Bytes-bounded LRU of decoded index-file reads, keyed by the files'
    (path, mtime_ns, inode, size) and the requested columns, so a rewrite of
    any file invalidates its entries. Owned by a session; a budget of 0
    disables it."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def get_or_put(self, key, factory: Callable[[], ColumnBatch]) -> ColumnBatch:
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                return hit[0]
        batch = factory()
        nbytes = _batch_nbytes(batch)
        if nbytes > self.max_bytes:
            return batch
        with self._lock:
            if key in self._d:  # a concurrent reader stored it first
                return self._d[key][0]
            self._d[key] = (batch, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes:
                _, (_b, nb) = self._d.popitem(last=False)
                self._bytes -= nb
        return batch


def _read_one_table(path: str, cols, row_group_sel=None, arrow_filter=None) -> pa.Table:
    """One file. ``arrow_filter`` (a pyarrow.compute expression) skips row
    groups by their statistics and masks rows; on a row-group selection it
    masks the selected groups' rows."""
    if row_group_sel is not None:
        table = pq.ParquetFile(path).read_row_groups(list(row_group_sel), columns=cols)
        return table if arrow_filter is None else table.filter(arrow_filter)
    # partitioning=None: index data lives under v__=<n>/ and pyarrow's hive
    # inference would otherwise graft a v__ column onto the schema
    return pq.read_table(path, columns=cols, filters=arrow_filter, partitioning=None)


def _unify_string_encoding(tables: list[pa.Table]) -> list[pa.Table]:
    """Dictionary-encode plain string columns when a sibling table carries
    the same column dictionary-typed (concat cannot merge the two)."""
    dict_cols, plain_cols = set(), set()
    for t in tables:
        for f in t.schema:
            if pa.types.is_dictionary(f.type):
                dict_cols.add(f.name)
            elif pa.types.is_string(f.type) or pa.types.is_large_string(f.type):
                plain_cols.add(f.name)
    mixed = dict_cols & plain_cols
    if not mixed:
        return tables
    out = []
    for t in tables:
        for name in mixed:
            i = t.schema.get_field_index(name)
            if i >= 0 and not pa.types.is_dictionary(t.schema.field(i).type):
                enc = t.column(i).dictionary_encode()
                t = t.set_column(i, pa.field(name, enc.type), enc)
        out.append(t)
    return out


_MAINTENANCE_DEPTH = 0


class maintenance_scope:
    """Marks an index action's reads (reentrant; process-wide, as the JAX
    package's source-read scope is)."""

    def __enter__(self):
        global _MAINTENANCE_DEPTH
        _MAINTENANCE_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _MAINTENANCE_DEPTH
        _MAINTENANCE_DEPTH -= 1
        return False


def _read_per_file(paths, cols, row_groups) -> ColumnBatch | None:
    """Maintenance read: each file decoded alone, then concatenated; None
    when the files' dtypes differ (the arrow concat promotes them)."""
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        batches = list(pool.map(
            lambda p: table_to_batch(_read_one_table(p, cols, row_groups.get(p))), paths))
    try:
        return ColumnBatch.concat(batches)
    except HyperspaceError:
        return None


def read_parquet(
    paths: Sequence[str],
    columns: Sequence[str] | None = None,
    cache: IndexChunkCache | None = None,
    row_groups: dict[str, Sequence[int]] | None = None,
    arrow_filter=None,
    parallel: bool = True,
) -> ColumnBatch:
    """Read ``paths`` in order into one ColumnBatch. ``row_groups`` maps a
    path to the only row groups to read from it (other paths are read
    whole); ``arrow_filter`` is the reader's row filter. With ``cache``,
    repeats return the cached batch's Column objects; the selection and the
    filter are part of the key, so a pruned or filtered read and a full
    read of the same files never share an entry. ``parallel=False``
    decodes the files one after another on the calling thread (a chunk
    streamer's pool worker, whose pool already bounds the decode width);
    the result is the same either way."""
    cols = list(columns) if columns else None
    row_groups = row_groups or {}
    if (_MAINTENANCE_DEPTH > 0 and cols and cache is None and len(paths) > 1
            and arrow_filter is None):
        batch = _read_per_file(paths, cols, row_groups)
        if batch is not None:
            return batch

    def decode() -> ColumnBatch:
        if not paths:
            return ColumnBatch({})

        def one(p):
            return _read_one_table(p, cols, row_groups.get(p), arrow_filter)

        if parallel and len(paths) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
                tables = list(pool.map(one, paths))
        else:
            tables = [one(p) for p in paths]
        if len(tables) > 1:
            tables = _unify_string_encoding(tables)
        table = pa.concat_tables(tables, promote_options="permissive")
        batch = table_to_batch(table)
        if cols is not None and list(batch.columns) != cols:
            batch = batch.select(cols)
        return batch

    if cache is None or cache.max_bytes <= 0:
        return decode()
    stored = cache.get_or_put(_chunk_cache_key(paths, cols, row_groups, arrow_filter), decode)
    # shallow copy: callers may rebind columns; Column objects are shared
    return ColumnBatch(stored.columns)


def _chunk_cache_key(paths, cols, row_groups: dict, arrow_filter=None) -> tuple:
    """The chunk-cache key of a read: the files' versions, the columns, the
    row-group selection and the filter."""
    stats = tuple(
        (p, s.st_mtime_ns, s.st_ino, s.st_size)
        for p, s in ((p, os.stat(p)) for p in paths)
    )
    selection = tuple((p, tuple(row_groups[p])) for p in paths if p in row_groups)
    return (stats, tuple(cols) if cols else None, selection or None,
            None if arrow_filter is None else repr(arrow_filter))


def _all_cached(groups, columns, cache: IndexChunkCache | None, row_groups) -> bool:
    """Every group's read is in ``cache`` already (a warm index scan)."""
    if cache is None or cache.max_bytes <= 0:
        return False
    cols = list(columns) if columns else None
    try:
        return all(_chunk_cache_key(g, cols, row_groups or {}) in cache for g in groups)
    except OSError:
        return False


# --- the ordered chunk stream -------------------------------------------------
#
# The pipelined executor (plan/gpu_exec.py) consumes a multi-file scan as an
# ordered stream of file-group chunks: groups decode concurrently on an IO
# pool, ahead of the consumer, under the global read-ahead ledger, and come
# out in file order, so the concatenated chunks are the monolithic read.


def io_threads() -> int:
    """IO pool width: ``HYPERSPACE_IO_THREADS``, default ``min(8, nproc)``;
    an unparseable value means serial (1)."""
    try:
        return int(env.read_raw("HYPERSPACE_IO_THREADS", str(min(8, os.cpu_count() or 1))))
    except ValueError:
        return 1


def io_byte_budget() -> int:
    """Decoded bytes a stream may hold undelivered
    (``HYPERSPACE_IO_BUDGET_MB``, default 512): the legacy per-stream knob,
    which the global ledger inherits when it is the only one set."""
    try:
        return int(env.env_float("HYPERSPACE_IO_BUDGET_MB") * 2**20)
    except ValueError:
        return 512 * 2**20


def stream_chunk_bytes() -> int:
    """Target file bytes per streamed chunk (``HYPERSPACE_STREAM_CHUNK_MB``,
    default 64): consecutive small files share a chunk, a larger file is a
    chunk of its own."""
    try:
        return int(env.env_float("HYPERSPACE_STREAM_CHUNK_MB") * 2**20)
    except ValueError:
        return 64 * 2**20


class StreamChunk:
    """One decoded chunk of an ordered multi-file scan: its batch, its
    position in the stream, its files, the seconds its decode took and its
    decoded bytes."""

    __slots__ = ("batch", "index", "paths", "decode_s", "nbytes")

    def __init__(self, batch: ColumnBatch, index: int, paths: list[str],
                 decode_s: float, nbytes: int):
        self.batch = batch
        self.index = index
        self.paths = paths
        self.decode_s = decode_s
        self.nbytes = nbytes


def plan_chunk_groups(paths: Sequence[str], target_bytes: int | None = None) -> list[list[str]]:
    """``paths`` cut, in order, into groups of about ``target_bytes`` file
    bytes each (at least one file a group); a file that cannot be stat-ed
    is a group of its own."""
    target = target_bytes if target_bytes is not None else stream_chunk_bytes()
    groups: list[list[str]] = []
    cur: list[str] = []
    cur_bytes = 0
    for p in paths:
        try:
            size = os.path.getsize(p)
        except OSError:
            size = target
        if cur and cur_bytes + size > target:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(p)
        cur_bytes += size
    if cur:
        groups.append(cur)
    return groups


def count_chunk_groups(paths: Sequence[str], target_bytes: int | None = None) -> int:
    """How many chunks ``iter_chunks`` streams for ``paths`` (no IO)."""
    return len(plan_chunk_groups(paths, target_bytes))


class ChunkReadError(HyperspaceError):
    """A chunk's decode failed on an IO worker: a host read failure, which
    propagates like any scan error."""


def iter_chunks(
    paths: Sequence[str],
    columns: Sequence[str] | None = None,
    cache: IndexChunkCache | None = None,
    target_bytes: int | None = None,
    overlap: bool = True,
    row_groups: dict[str, Sequence[int]] | None = None,
) -> Iterator[StreamChunk]:
    """The chunks of a multi-file scan, in file order. Each chunk is one
    ``read_parquet`` call over its group, with ``cache`` and the group's
    part of the ``row_groups`` selection, so the concatenated chunks equal
    the monolithic read column for column (a dtype that differs between
    files is promoted there; the consumer aborts on it).

    With ``overlap``, groups decode on an IO pool of ``io_threads()``
    workers, each decoding its group's files one by one: at most width + 2
    groups in flight, each reserving twice its file bytes through the
    global read-ahead ledger before it is submitted (a stream that holds
    nothing is always granted). Without it, or with one group or one
    thread, each group decodes on the caller's thread when asked for; so
    it does when ``cache`` holds every group already (a warm index scan:
    nothing to decode ahead, and no pool to start)."""
    groups = plan_chunk_groups(paths, target_bytes)

    def decode(group: list[str], parallel: bool):
        t0 = time.perf_counter()
        try:
            batch = read_parquet(group, columns, cache=cache, row_groups=row_groups,
                                 parallel=parallel)
        except Exception as e:  # noqa: BLE001 - one type for every read failure
            raise ChunkReadError(f"chunk decode failed for {group}: {e}") from e
        return batch, time.perf_counter() - t0

    def emit(i: int, batch: ColumnBatch, dt: float) -> StreamChunk:
        return StreamChunk(batch, i, groups[i], dt, _batch_nbytes(batch))

    width = min(io_threads(), len(groups))
    if not overlap or width <= 1 or len(groups) < 2 or _all_cached(groups, columns, cache,
                                                                     row_groups):
        for i, g in enumerate(groups):
            batch, dt = decode(g, True)
            yield emit(i, batch, dt)
        return

    ests = [max(1, sum(os.path.getsize(p) for p in g if os.path.exists(p))) * 2
            for g in groups]
    max_inflight = width + 2
    pool = ThreadPoolExecutor(max_workers=width, thread_name_prefix="hs-scan-io")
    bstream = serve_budget.global_budget().stream("scan")
    futures: dict = {}
    nxt = 0

    def pump() -> None:
        nonlocal nxt
        while nxt < len(groups) and len(futures) < max_inflight \
                and bstream.try_reserve(ests[nxt]):
            futures[nxt] = pool.submit(decode, groups[nxt], False)
            nxt += 1

    try:
        pump()
        for i in range(len(groups)):
            batch, dt = futures.pop(i).result()
            bstream.release(ests[i])
            pump()
            yield emit(i, batch, dt)
    finally:
        try:
            for f in futures.values():
                f.cancel()
            pool.shutdown(wait=False)
        finally:
            bstream.close()


def read_parquet_schema(path: str) -> Schema:
    return arrow_schema_to_schema(pq.read_schema(path))


def file_num_rows(path: str) -> int:
    """Row count from file metadata only (no data pages), cached by the
    file's (mtime_ns, inode, size): the pipelined executor counts a scan's
    rows on every query, and a footer of a few thousand row groups takes
    milliseconds to parse."""
    st = os.stat(path)
    return _num_rows(path, (st.st_mtime_ns, st.st_ino, st.st_size))


@functools.lru_cache(maxsize=16384)
def _num_rows(path: str, _version: tuple) -> int:
    return pq.ParquetFile(path).metadata.num_rows


def read_rowgroup_stats(path: str, columns: Sequence[str]) -> list[dict] | None:
    """Per-row-group footer statistics of ``columns``, with each group's row
    and byte counts: ``[{"num_rows", "nbytes", "cols": {col: (min, max,
    null_count) or None}}]``. Reads the footer only, and caches it by the
    file's (mtime_ns, inode, size), so a rewrite invalidates it: point
    lookups consult the same footers on every query. None when the footer
    cannot be read (the caller keeps the file); that is not cached."""
    try:
        st = os.stat(path)
        return _footer_stats(path, (st.st_mtime_ns, st.st_ino, st.st_size),
                             tuple(sorted(set(columns))))
    except Exception:
        return None


@functools.lru_cache(maxsize=16384)
def _footer_stats(path: str, _version: tuple, columns: tuple[str, ...]) -> list[dict]:
    md = pq.ParquetFile(path).metadata
    out = []
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        entry: dict = {"num_rows": rg.num_rows, "nbytes": rg.total_byte_size, "cols": {}}
        for j in range(rg.num_columns):
            cmeta = rg.column(j)
            name = cmeta.path_in_schema
            if name not in columns:
                continue
            try:
                stats = cmeta.statistics if cmeta.is_stats_set else None
                if stats is not None and stats.has_min_max:
                    nulls = stats.null_count if stats.has_null_count else None
                    entry["cols"][name] = (stats.min, stats.max, nulls)
                else:
                    entry["cols"][name] = None
            except Exception:  # undecodable statistics count as absent
                entry["cols"][name] = None
        out.append(entry)
    return out


# --- writers -----------------------------------------------------------------


def write_index_file(
    batch: ColumnBatch,
    path: str,
    row_group_size: int | None = None,
    stats_columns: Sequence[str] | None = None,
    compression: str = "lz4",
) -> None:
    """One index data file: dictionary-typed strings kept, row-group
    statistics limited to ``stats_columns`` (the clustered columns, the only
    ones whose min/max prune), ``compression`` from the session conf."""
    write_parquet(
        batch, path, row_group_size=row_group_size, compression=compression,
        keep_dictionary=True, stats_columns=stats_columns,
    )


def write_parquet(
    batch: ColumnBatch,
    path: str,
    row_group_size: int | None = None,
    compression: str = "snappy",
    keep_dictionary: bool = False,
    stats_columns: Sequence[str] | None = None,
) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = batch_to_table(batch)
    if not keep_dictionary:
        for i, f in enumerate(table.schema):
            if pa.types.is_dictionary(f.type):
                plain = table.column(i).cast(f.type.value_type)
                table = table.set_column(i, pa.field(f.name, f.type.value_type), plain)
    str_cols = [
        f.name
        for f in table.schema
        if pa.types.is_string(f.type) or pa.types.is_dictionary(f.type)
    ]
    write_statistics: bool | list[str] = True
    if stats_columns is not None:
        present = [f.name for f in table.schema if f.name in set(stats_columns)]
        write_statistics = present if present else True
    pq.write_table(
        table, path, row_group_size=row_group_size, compression=compression,
        use_dictionary=str_cols if str_cols else False,
        write_statistics=write_statistics,
    )
