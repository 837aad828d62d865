"""Plan execution on the host (counterpart of hyperspace_tpu/plan/executor.py,
reduced to scan, filter, project, aggregate and sort).

This is the always-correct reference path for every node, and the port's
plain end-to-end reference. When the session's device tier is on, an
Aggregate first goes to plan/gpu_exec.py, where the JAX executor calls
try_execute_tpu.
"""

from __future__ import annotations

import numpy as np

from . import expr as X
from .expr import AggExpr, Alias, Expr, expr_output_name
from .nodes import Aggregate, FileScan, Filter, InMemoryScan, LogicalPlan, Project, Sort
from ..columnar import io as cio
from ..columnar.table import Column, ColumnBatch, STRING, sort_key_values
from ..exceptions import HyperspaceError


def execute_plan(plan: LogicalPlan, session=None) -> ColumnBatch:
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
    if isinstance(plan, Aggregate):
        return _exec_aggregate(plan, session)
    if isinstance(plan, Sort):
        return _exec_sort(plan, execute_plan(plan.child, session))
    raise HyperspaceError(f"Cannot execute node {plan.kind}")


def _exec_file_scan(scan: FileScan, session=None) -> ColumnBatch:
    """Read the scan's columns. Index files go through the session's chunk
    cache (stable buffers for the device-resident column cache); raw source
    scans never cache."""
    want = list(scan.required_columns or scan.full_schema.names)
    if scan.fmt != "parquet":
        raise HyperspaceError(f"Unsupported format: {scan.fmt}")
    if not scan.files:
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
    cache = (
        session.index_chunk_cache
        if session is not None and scan.index_info is not None
        else None
    )
    return cio.read_parquet([f.name for f in scan.files], want, cache)


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


def _exec_sort(plan: Sort, child: ColumnBatch) -> ColumnBatch:
    keys = [sort_key_values(e.eval(child), asc) for e, asc in reversed(plan.orders)]
    order = np.lexsort(keys) if keys else np.arange(child.num_rows)
    return child.take(order)
