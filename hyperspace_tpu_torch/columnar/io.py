"""Parquet <-> ColumnBatch via pyarrow (counterpart of
hyperspace_tpu/columnar/io.py, reduced to what the covering-index query
path needs: whole-file and row-group-selected reads, footer-only row-group
statistics, index-file writes, and the decoded index-chunk cache).

The chunk cache matters to the device tier: it hands repeated index scans
the SAME numpy buffers, and the device-resident column cache
(utils/device_cache.py) keys on buffer identity, so a warm query uploads
nothing. Raw source scans never use it.
"""

from __future__ import annotations

import functools
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from .table import Column, ColumnBatch, DATE32, Field, STRING, Schema
from ..exceptions import HyperspaceError

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


def _read_one_table(path: str, cols, row_group_sel=None) -> pa.Table:
    if row_group_sel is not None:
        return pq.ParquetFile(path).read_row_groups(list(row_group_sel), columns=cols)
    # partitioning=None: index data lives under v__=<n>/ and pyarrow's hive
    # inference would otherwise graft a v__ column onto the schema
    return pq.read_table(path, columns=cols, partitioning=None)


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


def read_parquet(
    paths: Sequence[str],
    columns: Sequence[str] | None = None,
    cache: IndexChunkCache | None = None,
    row_groups: dict[str, Sequence[int]] | None = None,
) -> ColumnBatch:
    """Read ``paths`` in order into one ColumnBatch. ``row_groups`` maps a
    path to the only row groups to read from it (other paths are read
    whole). With ``cache`` (index files only), repeats return the cached
    batch's Column objects; the selection is part of the key, so a pruned
    read and a full read of the same files never share an entry."""
    cols = list(columns) if columns else None
    row_groups = row_groups or {}

    def decode() -> ColumnBatch:
        if not paths:
            return ColumnBatch({})
        with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
            tables = list(pool.map(
                lambda p: _read_one_table(p, cols, row_groups.get(p)), paths))
        if len(tables) > 1:
            tables = _unify_string_encoding(tables)
        table = pa.concat_tables(tables, promote_options="permissive")
        batch = table_to_batch(table)
        if cols is not None and list(batch.columns) != cols:
            batch = batch.select(cols)
        return batch

    if cache is None or cache.max_bytes <= 0:
        return decode()
    stats = tuple(
        (p, s.st_mtime_ns, s.st_ino, s.st_size)
        for p, s in ((p, os.stat(p)) for p in paths)
    )
    selection = tuple((p, tuple(row_groups[p])) for p in paths if p in row_groups)
    stored = cache.get_or_put(
        (stats, tuple(cols) if cols else None, selection or None), decode
    )
    # shallow copy: callers may rebind columns; Column objects are shared
    return ColumnBatch(stored.columns)


def read_parquet_schema(path: str) -> Schema:
    return arrow_schema_to_schema(pq.read_schema(path))


def file_num_rows(path: str) -> int:
    """Row count from file metadata only (no data pages)."""
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
