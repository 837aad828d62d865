"""Parquet, CSV, JSON, ORC and text <-> ColumnBatch via pyarrow
(counterpart of hyperspace_tpu/columnar/io.py): whole-file and
row-group-selected reads, footer-only row-group statistics, index-file
writes, the decoded index-chunk cache, and the ordered chunk stream the
pipelined executor consumes (``iter_chunks``). A struct column's leaves
read as flat columns named ``__hs_nested.a.b``, as in the JAX package.

The chunk cache matters to the device tier: it hands repeated index scans
the SAME numpy buffers, and the device-resident column cache
(utils/device_cache.py) keys on buffer identity, so a warm query uploads
nothing. Raw source scans never use it.

Inside an index action (``maintenance_scope``), a read of named source
columns goes through the process-wide source-column cache
(``HYPERSPACE_BUILD_CACHE_MB``): each file is decoded alone, per column,
and the files' batches concatenated, as the JAX package's maintenance
reads are: a string column then carries the sorted union of the files'
dictionaries, so both packages write the same index files. The footer
statistics cache (``HYPERSPACE_STATS_CACHE_MB``) is process-wide too;
the session sets both budgets when it is made (``configure_caches``).

The three caches count in the metrics registry as ``cache.index_chunk.*``,
``cache.source_col.*`` and ``cache.rowgroup_stats.*``; the chunk stream
counts ``io.chunks``, ``io.bytes_decoded``, ``io.rows_decoded`` and
``io.chunk_decode_ms``, and a read fanned out over files counts
``io.parallel_reads``, as in the JAX package. Every pool is sized by
``utils/workers`` (``HYPERSPACE_IO_THREADS``). Each file's decode and
footer read retries transient IO errors (``utils/retry.py``,
``HYPERSPACE_IO_RETRIES``) around the ``io.read_file`` and ``io.footer``
fault points (``utils/faults.py``).
"""

from __future__ import annotations

import functools
import os
import time
from collections import OrderedDict
from typing import Callable, Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as pq

from .table import Column, ColumnBatch, DATE32, Field, STRING, Schema
from ..constants import INDEX_COMPRESSION_DEFAULT, NESTED_FIELD_PREFIX
from ..exceptions import HyperspaceError
from ..serve import budget as serve_budget
from ..serve.context import check_cancelled, current_query
from ..staticcheck.concurrency import TrackedLock
from ..telemetry import attribution as _attr
from ..telemetry.metrics import REGISTRY
from ..utils import env, faults, retry
from ..utils.workers import io_pool, io_thread_cap

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


def _flatten_struct_field(f: pa.Field, prefix: str) -> list[Field]:
    """A struct's leaves as flat fields named ``<NESTED_FIELD_PREFIX>a.b.c``."""
    out: list[Field] = []
    for sub in f.type:
        path = f"{prefix}.{sub.name}"
        if pa.types.is_struct(sub.type):
            out.extend(_flatten_struct_field(sub, path))
        else:
            out.append(Field(NESTED_FIELD_PREFIX + path, _leaf_logical(sub.type, path)))
    return out


def arrow_schema_to_schema(sch: pa.Schema) -> Schema:
    fields: list[Field] = []
    for f in sch:
        if pa.types.is_struct(f.type):
            fields.extend(_flatten_struct_field(f, f.name))
        else:
            fields.append(Field(f.name, _leaf_logical(f.type, f.name)))
    return Schema(fields)


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


def _nested_leaf(table: pa.Table, flat_name: str):
    """The struct leaf behind a ``<NESTED_FIELD_PREFIX>a.b.c`` name; a null
    parent struct makes the leaf null."""
    import pyarrow.compute as pc

    path = flat_name[len(NESTED_FIELD_PREFIX):].split(".")
    arr = table.column(path[0])
    for seg in path[1:]:
        arr = pc.struct_field(arr, seg)
    return arr


def table_to_batch(table: pa.Table) -> ColumnBatch:
    schema = arrow_schema_to_schema(table.schema)
    top = set(table.schema.names)
    return ColumnBatch({
        f.name: _chunked_to_column(
            table.column(f.name) if f.name in top else _nested_leaf(table, f.name), f.dtype)
        for f in schema
    })


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


def _col_nbytes(col: Column) -> int:
    nbytes = col.data.nbytes + (col.validity.nbytes if col.validity is not None else 0)
    if col.dictionary:
        nbytes += sum(len(v) for v in col.dictionary)
    return nbytes


def _batch_nbytes(batch: ColumnBatch) -> int:
    """A decoded batch's bytes as the JAX package's caches count them (a
    dictionary's strings and 48 bytes of overhead per entry included)."""
    total = 0
    for col in batch.columns.values():
        total += col.data.nbytes
        if col.validity is not None:
            total += col.validity.nbytes
        if col.dictionary:
            total += sum(len(v) for v in col.dictionary) + 48 * len(col.dictionary)
    return total


class BytesBoundedLRU:
    """Bytes-bounded LRU with the JAX package's ``cache.<name>.*`` counts:
    ``hits``, ``misses`` (a build that stored or would have stored),
    ``evictions`` and ``evicted_bytes``, kept on the instance and, under
    ``metric_name``, in the metrics registry with the occupancy gauge
    ``cache.<name>.bytes``. A value larger than the budget is returned and
    not kept; a budget of 0 keeps nothing."""

    def __init__(self, max_bytes: int, metric_name: str = ""):
        self.max_bytes = max_bytes
        self.metric_name = metric_name
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = TrackedLock(f"io.cache.{metric_name or 'anon'}")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0

    def _count(self, event: str, n: int = 1) -> None:
        if self.metric_name:
            REGISTRY.counter(f"cache.{self.metric_name}.{event}").inc(n)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        self._count("hits" if hit is not None else "misses")
        return None if hit is None else hit[0]

    def set(self, key, value, nbytes: int) -> None:
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._d[key] = (value, nbytes)
            self._bytes += nbytes
            evicted = self._trim()
        self._note(evicted)

    def _trim(self) -> tuple:
        """Evict down to the budget (under the lock): (entries, bytes,
        occupancy)."""
        n = b = 0
        while self._bytes > self.max_bytes and self._d:
            _, (_v, nb) = self._d.popitem(last=False)
            self._bytes -= nb
            n += 1
            b += nb
        self.evictions += n
        self.evicted_bytes += b
        return n, b, self._bytes

    def _note(self, evicted: tuple) -> None:
        n, b, occupancy = evicted
        if n:
            self._count("evictions", n)
            self._count("evicted_bytes", b)
        if self.metric_name:
            REGISTRY.gauge(f"cache.{self.metric_name}.bytes").set(occupancy)

    def resize(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = max_bytes
            evicted = self._trim()
        self._note(evicted)

    def get_or_put(self, key, factory: Callable[[], tuple]):
        """The value under ``key``, else ``factory()``'s ``(value, nbytes)``
        stored; a concurrent builder of the same key may store it first."""
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                self.hits += 1
        if hit is not None:
            self._count("hits")
            return hit[0]
        value, nbytes = factory()
        with self._lock:
            self.misses += 1
            stored = self._d.get(key)  # a concurrent reader stored it first
        self._count("misses")
        if stored is not None:
            return stored[0]
        self.set(key, value, nbytes)
        return value

    def check_consistency(self) -> bool:
        with self._lock:
            return (self._bytes == sum(nb for _v, nb in self._d.values())
                    and self._bytes <= max(self.max_bytes, 0))

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes = 0
        if self.metric_name:
            REGISTRY.gauge(f"cache.{self.metric_name}.bytes").set(0)


class IndexChunkCache(BytesBoundedLRU):
    """Decoded index-file reads, keyed by the files' (path, mtime_ns,
    inode, size), the requested columns, the row-group selection and the
    filter, so a rewrite of any file invalidates its entries
    (``HYPERSPACE_INDEX_CACHE_MB``). Owned by a session; counted as
    ``cache.index_chunk.*``."""

    def __init__(self, max_bytes: int):
        super().__init__(max_bytes, "index_chunk")


# the process-wide caches of the JAX package's columnar/io.py: decoded
# source columns inside index actions, and parquet footer statistics; the
# session sets their budgets from the knobs (configure_caches)
_SOURCE_COL_CACHE = BytesBoundedLRU(env.cache_bytes("HYPERSPACE_BUILD_CACHE_MB"), "source_col")
_ROWGROUP_STATS_CACHE = BytesBoundedLRU(env.cache_bytes("HYPERSPACE_STATS_CACHE_MB"),
                                        "rowgroup_stats")


def configure_caches() -> None:
    """Set the process-wide caches' budgets from ``HYPERSPACE_BUILD_CACHE_MB``
    and ``HYPERSPACE_STATS_CACHE_MB`` (a smaller budget evicts at once)."""
    _SOURCE_COL_CACHE.resize(env.cache_bytes("HYPERSPACE_BUILD_CACHE_MB"))
    _ROWGROUP_STATS_CACHE.resize(env.cache_bytes("HYPERSPACE_STATS_CACHE_MB"))


def _read_one_table(path: str, cols, row_group_sel=None, arrow_filter=None) -> pa.Table:
    """One file. ``arrow_filter`` (a pyarrow.compute expression) skips row
    groups by their statistics and masks rows; on a row-group selection it
    masks the selected groups' rows. A ``__hs_nested.a.b`` column that the
    file holds inside its struct ``a`` reads the struct.

    This is the per-file retry boundary: the decode retries transient IO
    errors under ``utils/retry.py``'s bounded backoff, and the
    ``io.read_file`` fault point fires inside the retried unit, as in the
    JAX package."""
    return retry.retry_call(
        lambda: _read_one_table_once(path, cols, row_group_sel, arrow_filter),
        what="io.read_file",
    )


def _read_one_table_once(path: str, cols, row_group_sel=None, arrow_filter=None) -> pa.Table:
    faults.fire("io.read_file", path=os.path.basename(path))
    if path.endswith(ARROW_EXT):
        return _read_arrow_file(path, cols, arrow_filter)
    if cols is not None and any(c.startswith(NESTED_FIELD_PREFIX) for c in cols):
        phys = set(pq.read_schema(path).names)
        cols = list(dict.fromkeys(
            c[len(NESTED_FIELD_PREFIX):].split(".", 1)[0]
            if c not in phys and c.startswith(NESTED_FIELD_PREFIX) else c
            for c in cols))
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
    package's ``source_cache_scope`` is): reads of named source columns
    inside it serve and fill the source-column cache."""

    def __enter__(self):
        global _MAINTENANCE_DEPTH
        _MAINTENANCE_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _MAINTENANCE_DEPTH
        _MAINTENANCE_DEPTH -= 1
        return False


def _source_cached_read(paths, cols: list[str], arrow_filter=None,
                        row_groups=None) -> ColumnBatch | None:
    """A maintenance read through the source-column cache: per (file,
    column), and for several files also the concatenated column under the
    whole file set's key; a filter or a row-group selection extends the
    keys. None for a nested column or an unstattable file (the generic
    read takes it), and when the files' dtypes differ (the arrow concat
    promotes them)."""
    if any(c.startswith(NESTED_FIELD_PREFIX) for c in cols):
        return None
    try:
        stats = [(p, os.stat(p)) for p in paths]
    except OSError:
        return None
    filt = repr(arrow_filter) if arrow_filter is not None else None

    def extend(key, p=None):
        sel = tuple(row_groups[p]) if row_groups and p in row_groups else None
        return key if filt is None and sel is None else key + (filt, sel)

    fkeys = [(p, st.st_mtime_ns, st.st_ino, st.st_size) for p, st in stats]
    set_sel = (tuple((p, tuple(row_groups[p])) for p in paths if p in row_groups)
               if row_groups else None)
    set_key = None
    if len(fkeys) > 1:
        set_key = (tuple(fkeys) if filt is None and set_sel is None
                   else (tuple(fkeys), filt, set_sel))
    cache = _SOURCE_COL_CACHE
    whole: dict[str, Column] = {}
    todo = list(cols)
    if set_key is not None:
        for c in cols:
            hit = cache.get((set_key, c))
            if hit is not None:
                whole[c] = hit
        todo = [c for c in cols if c not in whole]
        if not todo:
            return ColumnBatch({c: whole[c] for c in cols})
    haves: list[dict[str, Column]] = []
    missings: list[list[str]] = []
    for (p, _st), fkey in zip(stats, fkeys):
        have: dict[str, Column] = {}
        for c in todo:
            hit = cache.get(extend((fkey, c), p))
            if hit is not None:
                have[c] = hit
        haves.append(have)
        missings.append([c for c in todo if c not in have])

    def decode(i: int) -> ColumnBatch | None:
        p = stats[i][0]
        if not missings[i]:
            return None
        sel = row_groups.get(p) if row_groups else None
        return table_to_batch(_read_one_table(p, missings[i], sel, arrow_filter))

    per_file: list[ColumnBatch] = []
    for i, batch in enumerate(_pmap_ordered(decode, range(len(stats)))):
        p, fkey, have = stats[i][0], fkeys[i], haves[i]
        for c in missings[i]:
            col = batch.column(c)
            cache.set(extend((fkey, c), p), col, _col_nbytes(col))
            have[c] = col
        per_file.append(ColumnBatch({c: have[c] for c in todo}))
    if len(per_file) == 1:
        merged = per_file[0]
    else:
        try:
            merged = ColumnBatch.concat(per_file)
        except HyperspaceError:
            return None
        if set_key is not None:
            for c in todo:
                col = merged.column(c)
                cache.set((set_key, c), col, _col_nbytes(col))
    return ColumnBatch({c: whole[c] if c in whole else merged.column(c) for c in cols})


def read_parquet(
    paths: Sequence[str],
    columns: Sequence[str] | None = None,
    arrow_filter=None,
    cache: "IndexChunkCache | bool" = False,
    row_groups: dict[str, Sequence[int]] | None = None,
) -> ColumnBatch:
    """Read ``paths`` in order into one ColumnBatch. ``arrow_filter`` is the
    reader's row filter; ``row_groups`` maps a path to the only row groups
    to read from it (other paths are read whole). ``cache`` is a session's
    decoded-chunk cache (``session.index_chunk_cache``), or False for none:
    the port keeps no process-wide chunk cache, so the JAX package's
    ``cache=True`` raises TypeError here. With a cache, repeats return the
    cached batch's Column objects; the selection and the filter are part of
    the key, so a pruned or filtered read and a full read of the same files
    never share an entry."""
    return _read_parquet(paths, columns, arrow_filter, _chunk_cache(cache), row_groups)


def _chunk_cache(cache) -> "IndexChunkCache | None":
    if cache is True:
        raise TypeError("cache=True names no cache in the port: pass the session's "
                        "index_chunk_cache")
    return None if cache is False else cache


def _read_parquet(paths, columns, arrow_filter, cache: "IndexChunkCache | None",
                  row_groups, parallel: bool = True) -> ColumnBatch:
    """``read_parquet``; ``parallel=False`` decodes the files one after
    another on the calling thread (a chunk streamer's pool worker, whose
    pool already bounds the decode width). The result is the same."""
    cols = list(columns) if columns else None
    row_groups = row_groups or {}
    if (_MAINTENANCE_DEPTH > 0 and cols and cache is None
            and _SOURCE_COL_CACHE.max_bytes > 0):
        batch = _source_cached_read(paths, cols, arrow_filter, row_groups)
        if batch is not None:
            return batch

    def decode() -> ColumnBatch:
        if not paths:
            return ColumnBatch({})

        def one(p):
            return _read_one_table(p, cols, row_groups.get(p), arrow_filter)

        tables = _pmap_ordered(one, paths) if parallel else [one(p) for p in paths]
        if len(tables) > 1:
            tables = _unify_string_encoding(tables)
        table = pa.concat_tables(tables, promote_options="permissive")
        batch = table_to_batch(table)
        if cols is not None and list(batch.columns) != cols:
            batch = batch.select(cols)
        return batch

    if cache is None or cache.max_bytes <= 0:
        return decode()
    def decode_for_cache():
        batch = decode()
        return ColumnBatch(batch.columns), _batch_nbytes(batch)

    stored = cache.get_or_put(_chunk_cache_key(paths, cols, row_groups, arrow_filter),
                              decode_for_cache)
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
    """IO pool width: ``utils/workers.io_thread_cap`` (``HYPERSPACE_IO_THREADS``,
    default ``min(8, nproc)``; an unparseable value means serial)."""
    return io_thread_cap()


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
    cache: "IndexChunkCache | bool" = False,
    target_bytes: int | None = None,
    overlap: bool = True,
    row_groups: dict[str, Sequence[int]] | None = None,
) -> Iterator[StreamChunk]:
    """The chunks of a multi-file scan, in file order. Each chunk is one
    ``read_parquet`` call over its group, with ``cache`` (as there) and the
    group's part of the ``row_groups`` selection, so the concatenated chunks equal
    the monolithic read column for column (a dtype that differs between
    files is promoted there; the consumer aborts on it).

    With ``overlap``, groups decode on an IO pool of ``io_threads()``
    workers, each decoding its group's files one by one: at most width + 2
    groups in flight, each reserving twice its file bytes through the
    global read-ahead ledger before it is submitted (a stream that holds
    nothing is always granted). Without it, or with one group or one
    thread, each group decodes on the caller's thread when asked for; so
    it does when ``cache`` holds every group already (a warm index scan:
    nothing to decode ahead, and no pool to start). Under a serving query
    the read-ahead runs on the shared engine pool, each task charged to
    the query (its ``io`` phase and counters), and a cancelled query
    unwinds at the next group, returning its reservations."""
    groups = plan_chunk_groups(paths, target_bytes)
    cache = _chunk_cache(cache)

    def decode(group: list[str], parallel: bool):
        t0 = time.perf_counter()
        try:
            batch = _read_parquet(group, columns, None, cache, row_groups, parallel)
        except Exception as e:  # noqa: BLE001 - one type for every read failure
            raise ChunkReadError(f"chunk decode failed for {group}: {e}") from e
        dt = time.perf_counter() - t0
        REGISTRY.histogram("io.chunk_decode_ms").observe(dt * 1000)
        _attr.charge_phase("io", dt)
        return batch, dt

    def emit(i: int, batch: ColumnBatch, dt: float) -> StreamChunk:
        nbytes = _batch_nbytes(batch)
        REGISTRY.counter("io.chunks").inc()
        REGISTRY.counter("io.bytes_decoded").inc(nbytes)
        REGISTRY.counter("io.rows_decoded").inc(batch.num_rows)
        return StreamChunk(batch, i, groups[i], dt, nbytes)

    width = min(io_threads(), len(groups))
    if not overlap or width <= 1 or len(groups) < 2 or _all_cached(groups, columns, cache,
                                                                     row_groups):
        for i, g in enumerate(groups):
            check_cancelled()
            batch, dt = decode(g, True)
            yield emit(i, batch, dt)
        return

    ests = [max(1, sum(os.path.getsize(p) for p in g if os.path.exists(p))) * 2
            for g in groups]
    max_inflight = width + 2
    pool, owned = _stream_pool(width, "hs-scan-io")
    bstream = serve_budget.global_budget().stream("scan")
    futures: dict = {}
    nxt = 0

    def pump() -> None:
        nonlocal nxt
        while nxt < len(groups) and len(futures) < max_inflight \
                and bstream.try_reserve(ests[nxt]):
            futures[nxt] = pool.submit(_attr.bound(decode), groups[nxt], False)
            nxt += 1

    try:
        pump()
        for i in range(len(groups)):
            check_cancelled()
            batch, dt = futures.pop(i).result()
            bstream.release(ests[i])
            pump()
            yield emit(i, batch, dt)
    finally:
        try:
            for f in futures.values():
                f.cancel()
            if owned:
                pool.shutdown(wait=False)
        finally:
            bstream.close()


def _stream_pool(width: int, name: str):
    """(pool, owned) for a streamer's read-ahead: under a serving query the
    process-wide shared engine pool, so total decode parallelism stays
    bounded across concurrent queries (owned=False: never shut it down);
    otherwise a private pool of ``width`` workers."""
    from ..utils.workers import shared_io_pool

    if current_query() is not None:
        return shared_io_pool(), False
    return io_pool(width, name), True


def read_parquet_schema(path: str) -> Schema:
    if path.endswith(ARROW_EXT):
        with pa.memory_map(path) as src:
            return arrow_schema_to_schema(pa.ipc.open_file(src).schema)
    return arrow_schema_to_schema(pq.read_schema(path))


# --- the other formats ---------------------------------------------------------


def _pmap_ordered(fn, items):
    """``[fn(x) for x in items]`` on a pool of ``io_threads()`` workers,
    results in item order; a worker's exception propagates."""
    items = list(items)
    width = min(io_threads(), len(items))
    if width <= 1 or len(items) < 2:
        return [fn(x) for x in items]
    REGISTRY.counter("io.parallel_reads").inc(len(items))
    # per-file work (decode, retries, cache counters) runs on pool threads:
    # each task carries the caller's attribution target (a running query's
    # ledger record), so its charges stay the query's
    with io_pool(width, "hs-read") as pool:
        return list(pool.map(_attr.bound(fn), items))


def _retried_file_reader(read_fn):
    """A non-parquet reader's per-file decode unit, with
    ``_read_one_table``'s retry boundary and ``io.read_file`` fault point."""

    def unit(p):
        def once():
            faults.fire("io.read_file", path=os.path.basename(p))
            return read_fn(p)

        return retry.retry_call(once, what="io.read_file")

    return unit


def _read_concat(read_one, paths: Sequence[str], columns) -> ColumnBatch:
    tables = _pmap_ordered(_retried_file_reader(read_one), paths)
    table = pa.concat_tables(tables, promote_options="permissive")
    if columns:
        table = table.select(list(columns))
    return table_to_batch(table)


def read_csv(paths: Sequence[str], columns: Sequence[str] | None = None) -> ColumnBatch:
    """CSV files with a header row, types inferred by pyarrow's defaults
    (an ISO date column reads as date32)."""
    return _read_concat(pacsv.read_csv, paths, columns)


def read_json(paths: Sequence[str], columns: Sequence[str] | None = None) -> ColumnBatch:
    """Newline-delimited JSON records."""
    return _read_concat(pajson.read_json, paths, columns)


def read_orc(paths: Sequence[str], columns: Sequence[str] | None = None) -> ColumnBatch:
    from pyarrow import orc as paorc

    return _read_concat(paorc.read_table, paths, columns)


def write_orc(batch: ColumnBatch, path: str) -> None:
    """ORC has no dictionary type: string columns are written plain."""
    from pyarrow import orc as paorc

    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = batch_to_table(batch)
    for i, f in enumerate(table.schema):
        if pa.types.is_dictionary(f.type):
            plain = table.column(i).cast(f.type.value_type)
            table = table.set_column(i, pa.field(f.name, f.type.value_type), plain)
    paorc.write_table(table, path)


def read_text(paths: Sequence[str], columns: Sequence[str] | None = None) -> ColumnBatch:
    """One string column ``value``, a row per line: the trailing newline
    dropped, rows split on '\\n' only (a CR before it dropped, other
    Unicode line breaks kept inside a row); an empty file has no rows."""
    lines: list[str] = []
    for p in paths:
        with open(p, encoding="utf-8", newline="") as f:
            content = f.read()
        if content:
            body = content[:-1] if content.endswith("\n") else content
            lines.extend(s[:-1] if s.endswith("\r") else s for s in body.split("\n"))
    table = pa.table({"value": pa.array(lines, type=pa.string())})
    if columns:
        table = table.select(list(columns))
    return table_to_batch(table)


def write_text(batch: ColumnBatch, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for v in batch.column("value").decode():
            f.write(f"{v}\n")


def read_avro(paths: Sequence[str], columns: Sequence[str] | None = None) -> ColumnBatch:
    """Avro records through ``fastavro``; raises HyperspaceError when it is
    not installed. The field names are every file's writer schema's, in
    order of first appearance, null where a file lacks one."""
    try:
        import fastavro
    except ImportError as e:
        raise HyperspaceError(
            "avro support requires the 'fastavro' package, which is not "
            "installed in this environment"
        ) from e
    rows: list[dict] = []
    names: list[str] = []
    for p in paths:
        with open(p, "rb") as f:
            r = fastavro.reader(f)
            for fld in (r.writer_schema or {}).get("fields", []):
                if fld["name"] not in names:
                    names.append(fld["name"])
            rows.extend(r)
    table = pa.table({k: [r.get(k) for r in rows] for k in names})
    if columns:
        table = table.select(list(columns))
    return table_to_batch(table)


_READERS = {"csv": read_csv, "json": read_json, "orc": read_orc, "text": read_text,
            "avro": read_avro}


def read_files(fmt: str, paths: Sequence[str],
               columns: Sequence[str] | None = None) -> ColumnBatch:
    """``paths`` of format ``fmt`` read into one batch, in order."""
    if fmt == "parquet":
        return read_parquet(paths, columns)
    reader = _READERS.get(fmt)
    if reader is None:
        raise HyperspaceError(f"Unsupported format: {fmt}")
    return reader(paths, columns)


def read_schema(fmt: str, path: str) -> Schema:
    """A file's schema: a parquet footer's, or another format's from a
    read of the whole file."""
    if fmt == "parquet":
        return read_parquet_schema(path)
    return read_files(fmt, [path]).schema


def file_num_rows(path: str) -> int:
    """Row count from file metadata only (no data pages), cached by the
    file's (mtime_ns, inode, size): the pipelined executor counts a scan's
    rows on every query, and a footer of a few thousand row groups takes
    milliseconds to parse."""
    st = os.stat(path)
    return _num_rows(path, (st.st_mtime_ns, st.st_ino, st.st_size))


@functools.lru_cache(maxsize=16384)
def _num_rows(path: str, _version: tuple) -> int:
    if path.endswith(ARROW_EXT):
        return arrow_file_num_rows(path)
    return pq.ParquetFile(path).metadata.num_rows


def read_rowgroup_stats(path: str, columns: Sequence[str]) -> list[dict] | None:
    """Per-row-group footer statistics of ``columns``, with each group's row
    and byte counts: ``[{"num_rows", "nbytes", "cols": {col: (min, max,
    null_count) or None}}]``. Reads the footer only, and caches it in the
    footer-statistics cache by the file's (mtime_ns, inode, size) and the
    columns, so a rewrite invalidates it: point lookups consult the same
    footers on every query. None when the footer cannot be read (the
    caller keeps the file); that is not cached, nor is an Arrow IPC file's
    (it has no row-group statistics)."""
    if path.endswith(ARROW_EXT):
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    cols = tuple(sorted(columns))
    key = ((path, st.st_mtime_ns, st.st_ino, st.st_size), cols)
    try:
        if _ROWGROUP_STATS_CACHE.max_bytes > 0:
            return _ROWGROUP_STATS_CACHE.get_or_put(key, lambda: _footer_stats(path, cols))
        return _footer_stats(path, cols)[0]
    except _UnreadableFooter:
        return None


class _UnreadableFooter(Exception):
    """The footer did not parse: the caller keeps the file (never cached)."""


def _footer_stats(path: str, columns: tuple[str, ...]) -> tuple[list[dict], int]:
    """(the statistics, their approximate bytes as the JAX package counts
    them)."""
    def open_footer():
        faults.fire("io.footer", path=os.path.basename(path))
        return pq.ParquetFile(path).metadata

    try:
        # transient IO errors retry with backoff; an exhausted or permanent
        # failure keeps the file (never cached)
        md = retry.retry_call(open_footer, what="io.footer")
    except Exception as e:
        raise _UnreadableFooter from e
    want = set(columns)
    out = []
    nbytes = 64
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        entry: dict = {"num_rows": rg.num_rows, "nbytes": rg.total_byte_size, "cols": {}}
        for j in range(rg.num_columns):
            cmeta = rg.column(j)
            name = cmeta.path_in_schema
            if name not in want:
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
            nbytes += 96
        out.append(entry)
        nbytes += 64
    return out, nbytes


# --- Arrow IPC index files ---------------------------------------------------
# ``hyperspace.tpu.index.format = arrow`` writes index data as uncompressed
# Arrow IPC files: a faster encode and memory-mapped reads, at more disk and
# with no row-group statistics. Readers go by the file's extension, so an
# index whose runs were written under both settings stays readable.
ARROW_EXT = ".arrow"


def index_file_ext(fmt: str) -> str:
    return ARROW_EXT if fmt == "arrow" else ".parquet"


def write_arrow(batch: ColumnBatch, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    table = batch_to_table(batch)
    with pa.OSFile(path, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)


def _read_arrow_file(path: str, cols, arrow_filter) -> pa.Table:
    with pa.memory_map(path) as src:
        table = pa.ipc.open_file(src).read_all()
    if cols is not None:
        table = table.select(list(cols))
    if arrow_filter is not None:
        # no row-group statistics: the pushed filter masks the rows read
        table = table.filter(arrow_filter)
    return table


def arrow_file_num_rows(path: str) -> int:
    with pa.memory_map(path) as src:
        reader = pa.ipc.open_file(src)
        return sum(reader.get_batch(i).num_rows for i in range(reader.num_record_batches))


# --- writers -----------------------------------------------------------------


def write_index_file(
    batch: ColumnBatch,
    path: str,
    row_group_size: int | None = None,
    stats_columns: Sequence[str] | None = None,
    compression: str | None = None,
) -> None:
    """One index data file in the format of ``path``'s extension (callers
    pick it with ``index_file_ext``). Parquet keeps dictionary-typed
    strings, limits row-group statistics to ``stats_columns`` (the
    clustered columns, the only ones whose min/max prune) and takes
    ``compression`` from the session conf (None: the index codec,
    ``INDEX_COMPRESSION_DEFAULT``); an Arrow IPC file takes none of these."""
    if path.endswith(ARROW_EXT):
        write_arrow(batch, path)
        return
    write_parquet(
        batch, path, row_group_size=row_group_size,
        compression=compression or INDEX_COMPRESSION_DEFAULT, keep_dictionary=True,
        stats_columns=stats_columns,
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
