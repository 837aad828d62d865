"""ZOrderCoveringIndex, kind "ZCI" (counterpart of
hyperspace_tpu/models/zorder/index.py: the build, in memory and out of
core, and maintenance).

A covering index laid out along a z-order curve instead of hash buckets:
rows are sorted by the z-address of the indexed columns (by the column
itself when there is one) and cut into roughly equal parts, one data file
each, the part count being the slice's bytes over
``_TARGET_BYTES_PER_PARTITION``. Row-group
statistics cover every indexed column, so a range on any of them skips
groups. A create whose source exceeds ``hyperspace.tpu.build.maxBytesInMemory``
streams in two passes over file groups of at most that size
(``streaming_zorder_build``): the first takes each indexed column's extremes
and a seeded sample, from which the fields and the z-range cut points come;
the second writes each group's rows as one sorted run per range,
``part-0-z<range>-<group>``. File names, row order and log-entry JSON
equal the JAX package's, in memory and streamed.

Maintenance rewrites z-ordered parts in memory, as the JAX package's
does at any size: incremental refresh writes the
appended rows as parts of their own (Merge), or, with deleted source
files, rewrites the remaining and appended rows together (Overwrite);
full refresh rebuilds, fields included; optimize re-sorts the files it is
given into new parts (OptimizeAction picks files by the bucket id in their
names, which z-order parts lack, so it leaves them alone, as the
reference's does).
"""

from __future__ import annotations

import os
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
    _file_groups,
    _single_file_scan,
    index_write_opts,
    resolve_columns,
)
from ...columnar import io as cio
from ...columnar.table import STRING, Column, ColumnBatch, Schema, sort_key_values
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
            _TARGET_BYTES_PER_PARTITION, ext=cio.index_file_ext(ctx.session.conf.index_format),
            session=ctx.session,
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
    ext: str = ".parquet",
    session=None,
) -> list[str]:
    """Sort rows stably by z-address (one indexed column: by its sort key)
    and split them into ``ceil(bytes / target)`` near-equal parts, one file
    ``part-<version>-z<part><ext>`` each. A string column counts 64
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
        fname = f"part-{version}-z{i:05d}{ext}"
        cio.write_index_file(part, os.path.join(path, fname),
                             row_group_size=INDEX_ROW_GROUP_SIZE, **write_opts)
        return fname

    # bounded so in-flight part copies stay under ~1 GB of extra memory
    per_part = max(1, approx_bytes // num_parts)
    workers = max(1, min(8, num_parts, (1 << 30) // per_part))
    from ...utils.workers import io_pool

    with io_pool(workers, "hs-zorder") as pool:
        return [f for f in pool.map(write_part, range(num_parts)) if f]


def streaming_zorder_build(ctx: IndexerContext, df: "DataFrame", scan, indexed: list[str],
                           included: list[str], lineage: bool, quantile_enabled: bool,
                           target_bytes: int, limit: int, sample_rows: int = 200_000):
    """The out-of-core z-order build, two passes over file groups of at
    most ``limit`` bytes. Pass 1 reads the indexed columns of each group
    and keeps each column's exact extremes and a sample of the same rows of
    every column (``np.random.default_rng(0)``, ``sample_rows`` in all);
    the fields build from the sample with the extremes, and the cut points
    of ``ceil(source bytes / target_bytes)`` ranges are the sample's
    z-address quantiles. Pass 2 reads each group whole, assigns its rows to
    ranges and writes one run per range sorted by z-address,
    ``part-0-z<range>-<group>``. Returns (fields, index schema list), or
    None when an indexed column is a string (the caller builds in
    memory)."""
    from ...plan.dataframe import DataFrame as DF

    groups = _file_groups(scan.files, limit)
    rng = np.random.default_rng(0)
    per_group = max(1, sample_rows // max(1, len(groups)))
    samples: dict[str, list[np.ndarray]] = {c: [] for c in indexed}
    validity_samples: dict[str, list[np.ndarray]] = {c: [] for c in indexed}
    dtype_labels: dict[str, str] = {}

    def group_df(group):
        return DF(ctx.session, df.plan.transform_up(
            lambda nd: nd.copy(files=group) if nd is scan else nd))

    # pass 1: extremes and a sample, indexed columns only
    for group in groups:
        data = CoveringIndex.create_index_data(ctx, group_df(group), indexed, [], lineage=False)
        if not dtype_labels:
            if any(data.column(c).dtype == STRING for c in indexed):
                return None
            dtype_labels = {c: data.schema.field(c).dtype for c in indexed}
        n = data.num_rows
        if n == 0:
            continue
        # the same sampled rows of every column; nulls ride along as validity
        take = rng.choice(n, size=min(per_group, n), replace=False)
        for c in indexed:
            col = data.column(c)
            vals = col.data[take]
            vmask = (np.ones(len(take), dtype=bool) if col.validity is None
                     else col.validity[take])
            valid_all = col.data if col.validity is None else col.data[col.validity]
            if len(valid_all):  # exact extremes, so min-max scaling never clips
                vals = np.concatenate([vals, [valid_all.min(), valid_all.max()]])
                vmask = np.concatenate([vmask, [True, True]])
            samples[c].append(vals)
            validity_samples[c].append(vmask)

    fields = []
    sample_cols = {}
    for c in indexed:
        if samples[c]:
            arr = np.concatenate(samples[c])
            vmask = np.concatenate(validity_samples[c])
        else:
            arr, vmask = np.zeros(1, np.int64), np.ones(1, dtype=bool)
        col = Column(arr, dtype_labels.get(c, str(arr.dtype)), None if vmask.all() else vmask)
        sample_cols[c] = col
        fields.append(build_field(c, col, quantile_enabled))

    # range cut points from the sample's z-address quantiles
    num_parts = max(1, int(np.ceil(sum(f.size for f in scan.files) / max(1, target_bytes))))
    if len(indexed) == 1:
        z_sample = fields[0].codes(sample_cols[indexed[0]]).astype(np.uint64)
    else:
        z_sample = compute_zaddresses(ColumnBatch(sample_cols), indexed, fields)
    cuts = np.unique(np.quantile(
        z_sample.astype(np.float64), [i / num_parts for i in range(1, num_parts)]
    ).astype(np.uint64)) if num_parts > 1 else np.empty(0, np.uint64)

    # pass 2: assign rows to ranges, sort, append one run per range
    os.makedirs(ctx.index_data_path, exist_ok=True)
    zext = cio.index_file_ext(ctx.session.conf.index_format)
    write_opts = index_write_opts(ctx.session, indexed)
    schema_list = None
    for seq, group in enumerate(groups):
        data = CoveringIndex.create_index_data(ctx, group_df(group), indexed, included, lineage)
        if schema_list is None:
            schema_list = data.schema.to_list()
        if data.num_rows == 0:
            continue
        if len(indexed) == 1:
            z = fields[0].codes(data.column(indexed[0])).astype(np.uint64)
        else:
            z = compute_zaddresses(data, indexed, fields)
        part_ids = np.searchsorted(cuts, z, side="right")
        order = np.lexsort((z, part_ids))
        bounds = np.searchsorted(part_ids[order], np.arange(len(cuts) + 2))

        def write_run(p: int, data=data, order=order, bounds=bounds, seq=seq):
            rows = order[bounds[p]: bounds[p + 1]]
            if len(rows):
                cio.write_index_file(
                    data.take(rows),
                    os.path.join(ctx.index_data_path, f"part-0-z{p:05d}-{seq}{zext}"),
                    row_group_size=INDEX_ROW_GROUP_SIZE, **write_opts)

        from ...utils.workers import io_pool

        with io_pool(8, "hs-zorder") as pool:
            list(pool.map(write_run, range(len(cuts) + 1)))
    return fields, schema_list or []


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
        """(the index, its data); a source above the in-memory limit builds
        out of core (``streaming_zorder_build``) and the data is None
        (already written), unless an indexed column is a string."""
        indexed = resolve_columns(df.schema, self._indexed)
        included = resolve_columns(df.schema, self._included)
        scan = _single_file_scan(df)
        lineage = properties.get("lineage", "false") == "true"
        limit = ctx.session.conf.build_max_bytes_in_memory
        if sum(f.size for f in scan.files) > limit and len(scan.files) > 1:
            out = streaming_zorder_build(ctx, df, scan, indexed, included, lineage, _QUANTILE,
                                         _TARGET_BYTES_PER_PARTITION, limit)
            if out is not None:
                fields, schema_list = out
                return ZOrderCoveringIndex(indexed, included, schema_list, fields,
                                           properties), None
        data = CoveringIndex.create_index_data(ctx, df, indexed, included, lineage)
        fields = [build_field(c, data.column(c), _QUANTILE) for c in indexed]
        index = ZOrderCoveringIndex(indexed, included, data.schema.to_list(), fields,
                                    properties)
        return index, data
