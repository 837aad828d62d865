"""Plan execution on the host (counterpart of hyperspace_tpu/plan/executor.py,
reduced to scan, filter, project, join, aggregate, sort, limit and the
hybrid-scan unions), with the streamed scan the pipelined executor
consumes (``scan_streamable``, ``iter_scan_chunks``).

This is the always-correct reference path for every node, and the port's
plain end-to-end reference. When the session's device tier is on, an
Aggregate first goes to plan/gpu_exec.py, where the JAX executor calls
try_execute_tpu; a Join of two co-bucketed index scans goes to
plan/bucket_join.py, whose plain join and fused join+aggregate run on the
device (plan/device_join.py); Limit(Sort) tries the device top-k, then the
host top-k, then the full sort, and a full sort tries the device sort
first, as the reference's chains do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import expr as X
from .expr import AggExpr, Alias, Expr, expr_output_name, split_conjunction
from .nodes import (
    Aggregate,
    BucketUnion,
    FileScan,
    Filter,
    InMemoryScan,
    Join,
    Limit,
    LogicalPlan,
    Project,
    RepartitionByExpr,
    Sort,
    Union,
)
from .. import constants as C
from ..columnar import io as cio
from ..columnar.table import Column, ColumnBatch, STRING, sort_key_values
from ..exceptions import HyperspaceError


def execute_plan(plan: LogicalPlan, session=None) -> ColumnBatch:
    """Execute one plan node (recursing into its children). With tracing on
    every node runs in an ``exec:<op>`` span carrying its output rows and
    the meter deltas of everything beneath it; with a plan-statistics
    collector active (EXPLAIN ANALYZE, ``HYPERSPACE_PLAN_STATS=1``) the
    node's output rows and inclusive wall time are recorded. Both observe
    only. Off, this costs one contextvar read and one bool check. A
    cancelled serving query unwinds here, before the node runs."""
    from ..serve.context import check_cancelled
    from ..telemetry import plan_stats, trace

    check_cancelled()
    col = plan_stats.current()
    if col is None and not trace.enabled():
        return _execute_node(plan, session)
    import time

    t0 = time.perf_counter() if col is not None else 0.0
    if not trace.enabled():
        out = _execute_node(plan, session)
        col.record_node(plan, out.num_rows, time.perf_counter() - t0)
        return out
    with trace.span(f"exec:{plan.kind}", plan_id=plan.plan_id) as sp:
        out = _execute_node(plan, session)
        sp.set_attr("rows_out", out.num_rows)
        if col is not None:
            ns = col.record_node(plan, out.num_rows, time.perf_counter() - t0)
            if ns.route != "host":
                sp.set_attr("route", ns.route)
            if ns.bytes_scanned is not None:
                sp.set_attr("bytes_scanned", ns.bytes_scanned)
        return out


def _execute_node(plan: LogicalPlan, session=None) -> ColumnBatch:
    if (
        session is not None
        and isinstance(plan, Aggregate)
        and session.conf.exec_device_enabled
    ):
        from .gpu_exec import try_execute_gpu

        result = try_execute_gpu(plan, session)
        if result is not None:
            return result
    if isinstance(plan, InMemoryScan):
        return plan.batch
    if isinstance(plan, FileScan):
        return _exec_file_scan(plan, session)
    if isinstance(plan, Filter):
        child = execute_plan(plan.child, session)
        return child.filter(np.asarray(plan.condition.eval(child).data, dtype=bool))
    if isinstance(plan, Project):
        plan.schema  # raises on duplicate output names
        child = execute_plan(plan.child, session)
        return ColumnBatch({expr_output_name(e): e.eval(child) for e in plan.exprs})
    if isinstance(plan, Join):
        return _exec_join(plan, session)
    if isinstance(plan, Aggregate):
        return _exec_aggregate(plan, session)
    if isinstance(plan, Sort):
        return _exec_sort(plan, execute_plan(plan.child, session), session)
    if isinstance(plan, Limit):
        if isinstance(plan.child, Sort):
            # the sort's child runs once; every route below reuses it
            sort_plan = plan.child
            child = execute_plan(sort_plan.child, session)
            if session is not None and session.conf.exec_device_enabled:
                from .gpu_exec import try_device_topk

                topk = try_device_topk(sort_plan, plan.n, child, session)
                if topk is not None:
                    from ..telemetry import plan_stats

                    plan_stats.note_route(plan.plan_id, "device")
                    return topk
            topk = _try_topk_batch(sort_plan, plan.n, child)
            if topk is not None:
                return topk
            full = _exec_sort(sort_plan, child, session)
            return full.take(np.arange(min(plan.n, full.num_rows)))
        child = execute_plan(plan.child, session)
        return child.take(np.arange(min(plan.n, child.num_rows)))
    if isinstance(plan, (Union, BucketUnion)):
        batches = [execute_plan(c, session) for c in plan.children()]
        return ColumnBatch.concat([b.select(batches[0].schema.names) for b in batches])
    if isinstance(plan, RepartitionByExpr):
        # a marker on the host path: the bucketed join re-buckets the rows
        return execute_plan(plan.child, session)
    raise HyperspaceError(f"Cannot execute node {plan.kind}")


def _empty_scan_batch(scan: FileScan, want: list[str]) -> ColumnBatch:
    return ColumnBatch(
        {
            f.name: Column(
                np.empty(0, dtype=np.int32 if f.dtype in (STRING, "date32")
                         else np.dtype(f.dtype)),
                f.dtype, None, [""] if f.dtype == STRING else None,
            )
            for f in scan.full_schema.select(want)
        }
    )


def resolve_scan_pruning(scan: FileScan):
    """(row groups by path, kept files) of the scan's row-group pruning;
    (None, scan.files) when its prune spec has no row-group or sketch
    conjuncts."""
    spec = scan.prune_spec
    if spec is None or not (spec.rowgroup_conjuncts or spec.sketch_conjuncts):
        return None, list(scan.files)
    from .pruning import rowgroup_selection

    return rowgroup_selection(scan)


def scan_streamable(scan: FileScan) -> bool:
    """True when the scan can run as an ordered stream of file-group chunks
    whose concatenation is the monolithic read: parquet, at least two files
    to overlap, no partition column to attach, no pushed filter, no lineage
    filter (it makes new buffers per read), not in pruning's verify mode
    (the comparison with the full read runs in ``_exec_file_scan``), and
    some column to read."""
    if scan.fmt != "parquet" or len(scan.files) < 2:
        return False
    if scan.pushed_filter is not None or scan.lineage_filter_ids is not None:
        return False
    if any(c in scan.full_schema for c in scan.partition_columns):
        return False
    if scan.prune_spec is not None:
        from . import pruning

        if pruning.is_verify(scan):
            return False
    return bool(scan.required_columns or scan.full_schema.names)


def iter_scan_chunks(scan: FileScan, session=None, overlap: bool = True, selection=None):
    """The chunk stream of a ``scan_streamable`` scan (columnar/io.
    iter_chunks): the columns, files and row groups ``_exec_file_scan``
    reads, per file group. An index scan's groups go through the session's
    chunk cache, so a repeat gets the same buffers, which the device column
    cache keys on. ``selection`` is ``resolve_scan_pruning``'s result when
    the caller already has it (one resolution per scan)."""
    want = list(scan.required_columns or scan.full_schema.names)
    if selection is None:
        selection = resolve_scan_pruning(scan)
    row_groups, files = selection
    cache = (
        session.index_chunk_cache
        if session is not None and scan.index_info is not None
        else None
    )
    return cio.iter_chunks([f.name for f in files], want, cache=cache, overlap=overlap,
                           row_groups=row_groups)


def _maybe_verify_pruning(scan: FileScan, out: ColumnBatch, session) -> ColumnBatch:
    """Verify mode: hold the pruned read against the full one (pruned-to-
    empty reads included: a wrong bucket hash shows as a wrongly empty
    scan)."""
    if scan.prune_spec is not None:
        from . import pruning

        if pruning.is_verify(scan):
            pruning.verify_against_full(scan, out, session)
    return out


def _constant_column(dtype: str, value: str, n: int) -> Column:
    """A partition value as a column of ``n`` rows."""
    if dtype == STRING:
        return Column(np.zeros(n, dtype=np.int32), STRING, None, [value])
    return Column(np.full(n, int(value), dtype=np.int64).astype(np.dtype(dtype)), dtype)


def _partition_conjuncts(scan: FileScan, part_names: list[str]) -> list[Expr]:
    """The pushed filter's conjuncts on partition columns alone: each
    decides a file group before any read."""
    if scan.pushed_filter is None:
        return []
    part_set = set(part_names)
    return [c for c in split_conjunction(scan.pushed_filter)
            if c.references() and c.references() <= part_set]


def _exec_file_scan(scan: FileScan, session=None) -> ColumnBatch:
    """Read the scan's columns: only the files and row groups its pruning
    keeps. Index files, and source files a data-skipping index pruned, go
    through the session's chunk cache (stable buffers for the device-
    resident column cache); other source scans never cache. A read of
    source parquet files applies the pushed filter as the parquet reader's
    filter (passes.to_arrow_filter), which skips row groups by their
    statistics; the Filter above the scan still applies the whole
    condition. A covering index's read stays unfiltered, so its cached
    buffers are the same for every predicate (its PruneSpec prunes it). A
    lineage filter drops the rows of deleted source files, which makes new
    buffers on every read, as in the reference.

    A partitioned scan reads its files by partition, skips a partition the
    pushed filter's partition-only conjuncts rule out before any read, and
    attaches each partition's values as constant columns; when only
    partition columns are wanted, parquet footers give the row counts.
    Formats other than parquet read through ``columnar/io.read_files``."""
    from ..utils.partitions import partition_key

    want = list(scan.required_columns or scan.full_schema.names)
    part_names = [c for c in scan.partition_columns if c in scan.full_schema]
    read_cols = [c for c in want if c not in part_names]
    lineage = scan.lineage_filter_ids is not None
    if lineage and C.DATA_FILE_NAME_ID not in read_cols:
        read_cols.append(C.DATA_FILE_NAME_ID)
    if part_names or not read_cols:
        row_groups, files = None, list(scan.files)
    else:
        row_groups, files = resolve_scan_pruning(scan)
    if not files:
        return _maybe_verify_pruning(scan, _empty_scan_batch(scan, want), session)
    cache = (
        session.index_chunk_cache
        if session is not None and scan.index_info is not None
        else None
    )
    arrow_filter = None
    if scan.pushed_filter is not None and scan.fmt == "parquet" and (
            scan.index_info is None or scan.index_info.index_kind_abbr == "DS"):
        from .passes import to_arrow_filter

        physical = scan.full_schema.select(
            [n for n in scan.full_schema.names if n not in part_names])
        arrow_filter = to_arrow_filter(scan.pushed_filter, physical)

    def read(paths: list[str]) -> ColumnBatch:
        if scan.fmt != "parquet":
            return cio.read_files(scan.fmt, paths, read_cols)
        if not read_cols and arrow_filter is None:
            n = sum(cio.file_num_rows(p) for p in paths)
            return ColumnBatch({"__rows__": Column(np.zeros(n, np.int8), "int8")})
        return cio.read_parquet(paths, read_cols, cache, row_groups, arrow_filter)

    if not part_names:
        out = read([f.name for f in files])
    else:
        groups: dict[tuple, list[str]] = {}
        for f in files:
            groups.setdefault(partition_key(f.name, part_names, scan.root_paths),
                              []).append(f.name)
        prunable = _partition_conjuncts(scan, part_names)
        dtypes = {c: scan.full_schema.field(c).dtype for c in part_names}
        parts = []
        for key, paths in groups.items():
            values = ColumnBatch({c: _constant_column(dtypes[c], v, 1)
                                  for c, v in zip(part_names, key)})
            if any(not bool(p.eval(values).data[0]) for p in prunable):
                continue
            b = read(paths)
            for c, v in zip(part_names, key):
                if c in want:
                    b = b.with_column(c, _constant_column(dtypes[c], v, b.num_rows))
            parts.append(b)
        if not parts:
            return _empty_scan_batch(scan, want)
        out = ColumnBatch.concat([p.select(parts[0].schema.names) for p in parts])
    if lineage:
        ids = np.asarray(scan.lineage_filter_ids, dtype=np.int64)
        out = out.filter(~np.isin(out.column(C.DATA_FILE_NAME_ID).data, ids))
    if out.schema.names != want:
        out = out.select(want)
    return _maybe_verify_pruning(scan, out, session)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def extract_equi_keys(
    condition: Expr, left_schema, right_schema
) -> tuple[list[str], list[str], list[Expr]]:
    """Split a join condition into equi column pairs and residual
    predicates (conjuncts of Col = Col across the two sides)."""
    left_keys: list[str] = []
    right_keys: list[str] = []
    residual: list[Expr] = []
    for conj in split_conjunction(condition):
        if isinstance(conj, X.Eq) and isinstance(conj.left, X.Col) and isinstance(
            conj.right, X.Col
        ):
            a, b = conj.left.name, conj.right.name
            if a in left_schema and b in right_schema:
                left_keys.append(a)
                right_keys.append(b)
                continue
            if b in left_schema and a in right_schema:
                left_keys.append(b)
                right_keys.append(a)
                continue
        residual.append(conj)
    return left_keys, right_keys, residual


def _join_comparable_values(c: Column) -> np.ndarray:
    """Order-correct raw values for factorization (strings decoded; NULLs
    get a placeholder, callers mask them through the validity)."""
    if c.dtype == STRING:
        vals = np.asarray(c.decode(), dtype=object)
        if c.validity is not None:
            vals = vals.copy()
            vals[~c.validity] = ""
        return vals.astype(str)
    return c.data


def _factorize_pair(a: Column, b: Column) -> tuple[np.ndarray, np.ndarray]:
    """Joint factorization of two key columns into comparable int codes."""
    if (a.dtype == STRING) != (b.dtype == STRING):
        raise HyperspaceError(
            f"Cannot join string key with non-string key ({a.dtype} vs {b.dtype})"
        )
    av = _join_comparable_values(a)
    bv = _join_comparable_values(b)
    _, codes = np.unique(np.concatenate([av, bv]), return_inverse=True)
    return codes[: len(av)], codes[len(av):]


def _combine_codes(code_list: list[np.ndarray], other_list: list[np.ndarray]):
    combined_a = code_list[0].astype(np.int64)
    combined_b = other_list[0].astype(np.int64)
    for ca, cb in zip(code_list[1:], other_list[1:]):
        n = int(max(ca.max(initial=0), cb.max(initial=0))) + 1
        combined_a = combined_a * n + ca
        combined_b = combined_b * n + cb
    return combined_a, combined_b


def _any_null_mask(batch: ColumnBatch, keys: Sequence[str]) -> np.ndarray | None:
    masks = [batch.column(k).validity for k in keys]
    if all(m is None for m in masks):
        return None
    invalid = np.zeros(batch.num_rows, dtype=bool)
    for m in masks:
        if m is not None:
            invalid |= ~m
    return invalid


def join_indices(
    left: ColumnBatch,
    right: ColumnBatch,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
) -> tuple[np.ndarray, np.ndarray]:
    """Inner-join row indices of factorized keys, left-major with ascending
    right rows within a key. A NULL key never matches anything, another
    NULL included. From 4096 left rows up the native hash join computes
    them (native/hs_native.cpp), below that ``join_codes_plain``; both give
    the same pairs in the same order."""
    from .. import native

    la, lb = [], []
    for lk, rk in zip(left_keys, right_keys):
        ca, cb = _factorize_pair(left.column(lk), right.column(rk))
        la.append(ca)
        lb.append(cb)
    lcodes, rcodes = _combine_codes(la, lb)
    lnull = _any_null_mask(left, left_keys)
    rnull = _any_null_mask(right, right_keys)
    if lnull is not None:
        lcodes = np.where(lnull, np.int64(-1), lcodes)
    if rnull is not None:
        rcodes = np.where(rnull, np.int64(-2), rcodes)
    if len(lcodes) >= _NATIVE_JOIN_MIN_ROWS:
        return native.join_i64(lcodes, rcodes)
    return join_codes_plain(lcodes, rcodes)


_NATIVE_JOIN_MIN_ROWS = 4096


def join_codes_plain(lcodes: np.ndarray, rcodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The numpy form of the code join: sort the right codes, find each left
    code's run of equal right codes, expand the runs."""
    from ..ops.join import expand_runs

    order = np.argsort(rcodes, kind="stable")
    starts, counts = _match_runs(lcodes, rcodes, order)
    li = np.repeat(np.arange(len(lcodes)), counts)
    ri = order[expand_runs(starts, counts)]
    return li, ri


def _match_runs(lcodes: np.ndarray, rcodes: np.ndarray, order: np.ndarray):
    """For each left code: where its run of equal right codes starts in the
    sorted right codes (``rcodes[order]``), and how long it is. Negative
    (NULL) codes never match. Codes from one factorization are dense, so a
    count per code and a prefix sum give the same runs as a binary search
    per row, without its random memory access (tens of times faster at
    tens of millions of rows); combined multi-key codes can be sparse and
    take the binary search."""
    hi = int(max(lcodes.max(initial=-1), rcodes.max(initial=-1))) + 1
    if hi > 4 * (len(lcodes) + len(rcodes)) + 1024:
        sorted_r = rcodes[order]
        starts = np.searchsorted(sorted_r, lcodes, side="left")
        return starts, np.searchsorted(sorted_r, lcodes, side="right") - starts
    valid_r = rcodes >= 0
    per_code = np.bincount(rcodes[valid_r], minlength=hi)
    # the NULL right codes sort before every real code
    first = np.cumsum(per_code) - per_code + (len(rcodes) - int(valid_r.sum()))
    valid_l = lcodes >= 0
    lc = np.where(valid_l, lcodes, 0)
    return first[lc], np.where(valid_l, per_code[lc], 0)


def _exec_join(plan: Join, session) -> ColumnBatch:
    if plan.how != "inner":
        raise HyperspaceError(f"Join type not yet supported: {plan.how}")
    # co-partitioned path: both sides bucketed on the join keys (the shape
    # JoinIndexRule produces) join bucket by bucket with no global hash table
    from .bucket_join import try_bucketed_merge_join

    bucketed = try_bucketed_merge_join(plan, session)
    if bucketed is not None:
        from ..telemetry import plan_stats

        plan_stats.note_route(plan.plan_id, "bucketed")
        return bucketed
    plan.schema  # raises on ambiguous output columns before any work runs
    if plan.condition is None:
        raise HyperspaceError("Cross join not supported")
    left = execute_plan(plan.left, session)
    right = execute_plan(plan.right, session)
    lk, rk, residual = extract_equi_keys(
        plan.condition, plan.left.schema, plan.right.schema
    )
    if not lk:
        raise HyperspaceError(f"No equi keys in join condition: {plan.condition!r}")
    li, ri = join_indices(left, right, lk, rk)
    out_cols = {n: c.take(li) for n, c in left.columns.items()}
    out_cols.update({n: c.take(ri) for n, c in right.columns.items()})
    out = ColumnBatch(out_cols)
    for r in residual:
        out = out.filter(np.asarray(r.eval(out).data, dtype=bool))
    return out


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

def _unwrap_agg(e: Expr) -> tuple[str, AggExpr]:
    if isinstance(e, Alias):
        return e.name, _unwrap_agg(e.child)[1]
    if isinstance(e, AggExpr):
        return expr_output_name(e), e
    raise HyperspaceError(f"Not an aggregate expression: {e!r}")


def _agg_values(agg: AggExpr, batch: ColumnBatch):
    """(values, valid_mask, source_column). String values come back as codes
    over a sorted vocabulary, so code order is string order."""
    if isinstance(agg, X.Count) and isinstance(agg.child, X.Lit):
        return (np.ones(batch.num_rows, dtype=np.int64),
                np.ones(batch.num_rows, dtype=bool), None)
    c = agg.child.eval(batch)
    valid = c.validity if c.validity is not None else np.ones(len(c), dtype=bool)
    if c.dtype == STRING:
        if not isinstance(agg, (X.Min, X.Max, X.Count)):
            raise HyperspaceError(f"{agg.func} not supported on string column")
        vals = np.asarray(c.decode(), dtype=object)
        vals[~valid] = ""
        vocab, codes = np.unique(vals.astype(str), return_inverse=True)
        sorted_col = Column(codes.astype(np.int32), STRING, c.validity, list(vocab))
        return codes.astype(np.int64), valid, sorted_col
    return c.data, valid, c


def _exec_aggregate(plan: Aggregate, session) -> ColumnBatch:
    from ..telemetry import plan_stats

    if isinstance(plan.child, Join):
        from .bucket_join import try_bucketed_join_aggregate

        fused = try_bucketed_join_aggregate(plan, session)
        if fused is not None:
            plan_stats.note_route(plan.plan_id, "bucketed")
            return fused
    elif plan.group_exprs and not isinstance(plan.child, InMemoryScan):
        from .bucket_join import try_bucketed_scan_aggregate

        fused = try_bucketed_scan_aggregate(plan, session)
        if fused is not None:
            plan_stats.note_route(plan.plan_id, "bucketed")
            return fused
    child = execute_plan(plan.child, session)
    if not plan.group_exprs:
        out = {}
        for e in plan.agg_exprs:
            name, agg = _unwrap_agg(e)
            out[name] = _global_agg(agg, child)
        return ColumnBatch(out)
    key_cols = [e.eval(child) for e in plan.group_exprs]
    group_ids, num_groups, first_idx = factorize_group_keys(key_cols)
    out_cols: dict[str, Column] = {}
    for e, kc in zip(plan.group_exprs, key_cols):
        out_cols[expr_output_name(e)] = kc.take(first_idx)
    for e in plan.agg_exprs:
        name, agg = _unwrap_agg(e)
        vals, valid, src = _agg_values(agg, child)
        out_cols[name] = _grouped_agg(agg, vals, valid, src, group_ids, num_groups)
    return ColumnBatch(out_cols)


def _comparable_values(c: Column) -> np.ndarray:
    if c.dtype == STRING:
        return np.asarray(c.dictionary, dtype=object)[c.data].astype(str)
    return c.data


def factorize_group_keys(key_cols: list[Column]) -> tuple[np.ndarray, int, np.ndarray]:
    """(group_ids, num_groups, first_occurrence_idx) for one or more key
    columns. NULL keys form one group of their own."""
    codes_list = []
    for kc in key_cols:
        codes = _dense_int_codes(kc)
        if codes is None:
            _, codes = np.unique(_comparable_values(kc), return_inverse=True)
            codes = codes.astype(np.int64)
        if kc.validity is not None:
            codes = np.where(kc.validity, codes, np.int64(codes.max(initial=-1) + 1))
        codes_list.append(codes)
    domain = 1
    for c in codes_list:
        domain *= int(c.max(initial=0)) + 1
        if domain > 2**62:
            codes_list = [
                np.unique(c, return_inverse=True)[1].astype(np.int64) for c in codes_list
            ]
            break
    combined = codes_list[0]
    for c in codes_list[1:]:
        combined = combined * (int(c.max(initial=0)) + 1) + c
    uniq, group_ids = _compact_group_ids(combined)
    num_groups = len(uniq)
    seen_order = np.argsort(group_ids, kind="stable")
    boundaries = np.searchsorted(group_ids[seen_order], np.arange(num_groups))
    return group_ids, num_groups, seen_order[boundaries]


def _dense_int_codes(kc: Column) -> np.ndarray | None:
    """Group codes without a sort: dictionary codes of a string column with
    a duplicate-free vocabulary, or small non-negative int keys as-is."""
    if kc.dtype == STRING:
        return kc.data.astype(np.int64) if kc.dictionary_is_unique else None
    if kc.data.dtype.kind not in ("i", "u") or len(kc.data) == 0:
        return None
    mn, mx = int(kc.data.min()), int(kc.data.max())
    if mn < 0 or mx > max(1024, 8 * len(kc.data)):
        return None
    return kc.data.astype(np.int64)


def _compact_group_ids(combined: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = len(combined)
    if n and combined.min() >= 0:
        domain = int(combined.max()) + 1
        if domain <= max(1024, 8 * n):
            present = np.zeros(domain, dtype=bool)
            present[combined] = True
            uniq = np.nonzero(present)[0].astype(np.int64)
            remap = np.zeros(domain, dtype=np.int64)
            remap[uniq] = np.arange(len(uniq))
            return uniq, remap[combined]
    return np.unique(combined, return_inverse=True)


def _global_agg(agg: AggExpr, batch: ColumnBatch) -> Column:
    vals, valid, src = _agg_values(agg, batch)
    v = vals[valid]
    if isinstance(agg, X.Count):
        return Column(np.array([len(v)], dtype=np.int64), "int64")
    if len(v) == 0:  # SQL: an aggregate over zero rows is NULL
        return Column(np.array([0.0]), "float64", np.array([False]))
    if isinstance(agg, (X.Min, X.Max)) and src is not None and src.dtype == STRING:
        code = v.min() if isinstance(agg, X.Min) else v.max()
        return Column(np.array([code], dtype=np.int32), STRING, None, src.dictionary)
    if isinstance(agg, X.Sum):
        r = v.sum()
    elif isinstance(agg, X.Min):
        r = v.min()
    elif isinstance(agg, X.Max):
        r = v.max()
    elif isinstance(agg, X.Avg):
        r = v.astype(np.float64).mean()
    else:
        raise HyperspaceError(f"Unknown aggregate {agg!r}")
    arr = np.asarray([r])
    dtype = str(arr.dtype)
    return Column(arr, dtype if dtype in ("int64", "float64", "int32", "float32") else "float64")


def _grouped_agg(agg, vals, valid, src, group_ids, num_groups) -> Column:
    counts = np.bincount(
        group_ids, weights=valid.astype(np.float64), minlength=num_groups
    ).astype(np.int64)
    if isinstance(agg, X.Count):
        return Column(counts, "int64")
    group_validity = None if (counts > 0).all() else counts > 0
    fvals = np.where(valid, vals, 0)
    if isinstance(agg, X.Sum):
        s = np.bincount(group_ids, weights=fvals.astype(np.float64), minlength=num_groups)
        if vals.dtype.kind == "i":
            return Column(s.astype(np.int64), "int64", group_validity)
        return Column(s, "float64", group_validity)
    if isinstance(agg, X.Avg):
        s = np.bincount(group_ids, weights=fvals.astype(np.float64), minlength=num_groups)
        with np.errstate(invalid="ignore", divide="ignore"):
            return Column(np.where(counts > 0, s / np.maximum(counts, 1), 0.0),
                          "float64", group_validity)
    if isinstance(agg, (X.Min, X.Max)):
        is_min = isinstance(agg, X.Min)
        if vals.dtype.kind == "f":
            init = np.inf if is_min else -np.inf
        else:
            info = np.iinfo(vals.dtype)
            init = info.max if is_min else info.min
        out = np.full(num_groups, init, dtype=vals.dtype)
        (np.minimum if is_min else np.maximum).at(out, group_ids[valid], vals[valid])
        out = np.where(counts > 0, out, 0)
        if src is not None and src.dtype == STRING:
            return Column(out.astype(np.int32), STRING, group_validity, src.dictionary)
        return Column(out, str(out.dtype), group_validity)
    raise HyperspaceError(f"Unknown aggregate {agg!r}")


def _try_topk_batch(sort_plan: Sort, k: int, child: ColumnBatch) -> ColumnBatch | None:
    """Limit(Sort) -> argpartition top-k and a small final sort instead of a
    full sort (the ORDER BY ... LIMIT shape of Q3). None: use the full
    sort (small inputs, non-numeric primary keys, heavy boundary ties)."""
    n = child.num_rows
    if n <= max(k * 4, 1024) or not sort_plan.orders:
        return None
    keys = [sort_key_values(e.eval(child), asc) for e, asc in reversed(sort_plan.orders)]
    primary = keys[-1]  # lexsort's last key is the primary
    if primary.dtype.kind not in ("i", "u", "f"):
        return None
    # over-select 4k candidates on the primary key; exact unless more than
    # the buffer's worth of rows tie at the boundary value
    cand_size = min(n, max(4 * k, 64))
    cand = np.argpartition(primary, cand_size - 1)[:cand_size]
    boundary = primary[cand].max()
    if (primary <= boundary).sum() > cand_size:
        return None
    sub = child.take(cand)
    order = np.lexsort([kk[cand] for kk in keys])[:k]
    return sub.take(order)


def _exec_sort(plan: Sort, child: ColumnBatch, session=None) -> ColumnBatch:
    """Multi-key sort; with the device tier on, the device sort serves
    first (the same permutation as the host's stable lexsort)."""
    if session is not None and session.conf.exec_device_enabled:
        from .gpu_exec import try_device_sort

        out = try_device_sort(plan, child, session)
        if out is not None:
            return out
    keys = [sort_key_values(e.eval(child), asc) for e, asc in reversed(plan.orders)]
    order = np.lexsort(keys) if keys else np.arange(child.num_rows)
    return child.take(order)
