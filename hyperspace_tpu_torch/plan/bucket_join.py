"""Co-partitioned bucketed merge join execution (counterpart of
hyperspace_tpu/plan/bucket_join.py, single device).

The payoff of JoinIndexRule's rewrite: both sides arrive hash-bucketed on
the join keys with the same bucket count, so bucket b joins only bucket b,
with no shuffle and no global hash table.

Three device paths, each recorded in ``session.device_stats.join_paths``:

- ``batched``: a plain (not aggregated) join loads every bucket pair on a
  thread pool, applies the side filters on the host, and runs the
  band-stacked probe and run expansion on the device with two fetches in
  all (plan/device_join.try_batched_plain_join);
- ``stacked_agg``: an Aggregate grouped by the join key over such a join
  runs the fused join+aggregate on the device for every bucket pair at
  once (plan/device_join.try_stacked_join_agg): buckets load RAW, side
  filters run in the body over the stable index-chunk buffers, and the
  whole query pays one fetch;
- ``per_bucket``: when those decline (by shape or data), each bucket runs
  alone: the numpy twin of the fused body, or a plain join whose probe
  runs on the device (try_device_plain_join) or on the host.

An Aggregate grouped by a bucketed scan's bucket columns aggregates bucket
by bucket (``try_bucketed_scan_aggregate``; AggregateIndexRule's rewrite).

Not ported: the mesh paths, read-ahead pipelining of bucket pairs (pairs
load on a pool, then the device works), hybrid-scan appended rows, the
per-bucket strategy plan (plan/join_memory.py) and adaptive re-planning.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from .expr import Alias, Col, Expr, expr_output_name
from .nodes import BucketSpec, FileScan, Filter, Join, LogicalPlan, Project
from ..columnar.table import Column, ColumnBatch, STRING, numpy_dtype
from ..exceptions import HyperspaceError
from ..models.covering import bucket_id_from_filename
from ..ops.join import host_merge_join_indices

@dataclass
class BucketedSide:
    """One join side decomposed into bucket-addressable pieces. ``ops`` are
    the Filter/Project nodes between the scan and the join, bottom-up
    (nearest the scan first), so per-bucket execution replays them exactly."""

    scan: FileScan  # the bucketed index scan
    spec: BucketSpec
    ops: list[LogicalPlan]  # Filter/Project nodes, bottom-up

    @property
    def filters(self) -> list[Expr]:
        return [op.condition for op in self.ops if isinstance(op, Filter)]

    @property
    def project(self) -> Optional[Project]:
        for op in self.ops:
            if isinstance(op, Project):
                return op
        return None

    def __post_init__(self):
        self._files_by_bucket: dict[int, list] = {}
        for f in self.scan.files:
            self._files_by_bucket.setdefault(bucket_id_from_filename(f.name), []).append(f)

    def files_for_bucket(self, b: int) -> list:
        return self._files_by_bucket.get(b, [])

    def scan_for_bucket(self, b: int) -> FileScan:
        """The side's scan narrowed to bucket ``b``. Verify mode's file list
        from before pruning narrows to the same bucket, so it holds this
        bucket's pruned read against this bucket's full files."""
        spec = self.scan.prune_spec
        if spec is not None and spec.verify_files:
            spec = replace(spec, verify_files=tuple(
                f for f in spec.verify_files if bucket_id_from_filename(f.name) == b))
        return self.scan.copy(files=self.files_for_bucket(b), prune_spec=spec)

    def key_is_identity(self, name: str) -> bool:
        """True iff output column ``name`` is the scan column ``name``
        unchanged (a derived projection would decouple the join values from
        the on-disk hash placement)."""
        if self.project is None:
            return True
        for e in self.project.exprs:
            if expr_output_name(e) == name:
                inner = e.child if isinstance(e, Alias) else e
                return isinstance(inner, Col) and inner.name == name
        return False


def _decompose_side(plan: LogicalPlan) -> Optional[BucketedSide]:
    """Match a stack of Filter/Project (at most one Project) over a
    bucketed FileScan whose every file carries a bucket id."""
    node = plan
    ops_topdown: list[LogicalPlan] = []
    n_projects = 0
    while isinstance(node, (Project, Filter)):
        if isinstance(node, Project):
            n_projects += 1
            if n_projects > 1:
                return None
        ops_topdown.append(node)
        node = node.child
    if not isinstance(node, FileScan) or node.bucket_spec is None:
        return None
    if any(bucket_id_from_filename(f.name) is None for f in node.files):
        return None
    return BucketedSide(node, node.bucket_spec, list(reversed(ops_topdown)))


def try_bucketed_scan_aggregate(agg_plan, session) -> Optional[ColumnBatch]:
    """Aggregate(group by a superset of the bucket columns)(bucketed scan
    stack): every group lives in one bucket, so buckets aggregate on a
    thread pool and the results concatenate (AggregateIndexRule's rewrite)."""
    from .executor import _exec_aggregate
    from .nodes import Aggregate, InMemoryScan

    if not agg_plan.group_exprs:
        return None
    side = _decompose_side(agg_plan.child)
    if side is None:
        return None
    group_cols = set()
    for e in agg_plan.group_exprs:
        if not isinstance(e, Col):
            return None
        group_cols.add(e.name.lower())
    if not {c.lower() for c in side.spec.bucket_columns} <= group_cols:
        return None  # a group could span buckets
    if not all(side.key_is_identity(c) for c in side.spec.bucket_columns):
        return None

    def aggregate(batch: ColumnBatch) -> ColumnBatch:
        sub = Aggregate(agg_plan.group_exprs, agg_plan.agg_exprs, InMemoryScan(batch))
        return _exec_aggregate(sub, session)

    def agg_bucket(b: int) -> Optional[ColumnBatch]:
        batch = _load_side_bucket(side, b, session)
        return None if batch.num_rows == 0 else aggregate(batch)

    n = side.spec.num_buckets
    with ThreadPoolExecutor(max_workers=max(1, min(8, n))) as pool:
        parts = [p for p in pool.map(agg_bucket, range(n)) if p is not None]
    if not parts:
        # every bucket filtered to nothing: the empty grouped shape (read
        # from no file, so verify mode has nothing to hold it against)
        spec = side.scan.prune_spec
        if spec is not None:
            spec = replace(spec, verify_files=())
        empty = BucketedSide(side.scan.copy(files=[], prune_spec=spec), side.spec, side.ops)
        return aggregate(_load_side_bucket(empty, 0, session))
    return ColumnBatch.concat(parts)


def try_bucketed_join_aggregate(agg_plan, session) -> Optional[ColumnBatch]:
    """Aggregate(group_by covering the join key)(Join(co-bucketed sides)):
    groups are disjoint across buckets, so each bucket joins AND aggregates
    locally and the results concatenate; the join output never
    materializes (TPC-H Q3's shape)."""
    from .executor import extract_equi_keys

    child = agg_plan.child
    if not isinstance(child, Join) or not agg_plan.group_exprs:
        return None
    group_cols = []
    for e in agg_plan.group_exprs:
        if not isinstance(e, Col):
            return None
        group_cols.append(e.name)
    lkeys, rkeys, _res = extract_equi_keys(
        child.condition, child.left.schema, child.right.schema
    ) if child.condition is not None else ([], [], [])
    # buckets hash the whole key tuple: a group is bucket-local only when
    # the grouping names every key component (either side of each pair)
    group_set = {c.lower() for c in group_cols}
    if not lkeys or not all(
        lk.lower() in group_set or rk.lower() in group_set for lk, rk in zip(lkeys, rkeys)
    ):
        return None

    def per_bucket(batch: ColumnBatch) -> ColumnBatch:
        from .executor import _exec_aggregate
        from .nodes import Aggregate, InMemoryScan

        sub = Aggregate(agg_plan.group_exprs, agg_plan.agg_exprs, InMemoryScan(batch))
        return _exec_aggregate(sub, session)

    return try_bucketed_merge_join(child, session, per_bucket=per_bucket, agg_plan=agg_plan)


def try_bucketed_merge_join(
    plan: Join, session, per_bucket=None, agg_plan=None
) -> Optional[ColumnBatch]:
    """Execute an equi-join of two co-bucketed sides; None when the plan
    does not have that shape. Without ``per_bucket`` and the device tier on,
    the batched device plain join runs first. ``per_bucket`` post-processes
    each bucket's joined rows (the fused aggregate); with ``agg_plan`` too
    and the device tier on, the fused join+aggregate runs on the device
    over every bucket pair. The per-bucket flow is the fallback of both,
    and reuses the pairs they loaded."""
    from .executor import extract_equi_keys

    if plan.how != "inner" or plan.condition is None:
        return None
    left = _decompose_side(plan.left)
    right = _decompose_side(plan.right)
    if left is None or right is None:
        return None
    if left.spec.num_buckets != right.spec.num_buckets:
        return None
    lkeys, rkeys, residual = extract_equi_keys(
        plan.condition, plan.left.schema, plan.right.schema
    )
    # join keys must be the scan columns unchanged, and exactly the bucket
    # columns, pairwise aligned
    if not all(left.key_is_identity(k) for k in lkeys):
        return None
    if not all(right.key_is_identity(k) for k in rkeys):
        return None
    pairs = list(zip(lkeys, rkeys))
    if list(left.spec.bucket_columns) != lkeys or list(right.spec.bucket_columns) != rkeys:
        if len(left.spec.bucket_columns) != len(lkeys):
            return None
        lmap = {a.lower(): b.lower() for a, b in pairs}
        for a, b in zip(left.spec.bucket_columns, right.spec.bucket_columns):
            if lmap.get(a.lower()) != b.lower():
                return None
    plan.schema  # ambiguity check before doing any work

    n = left.spec.num_buckets

    def done(out: ColumnBatch, path: str) -> ColumnBatch:
        if session is not None:
            paths = session.device_stats.join_paths
            paths[path] = paths.get(path, 0) + 1
        return out

    preloaded = None
    if agg_plan is None and per_bucket is None:
        dev_out, preloaded = _try_device_join_paths(left, right, lkeys, rkeys, residual,
                                                    session)
        if dev_out is not None:
            return done(dev_out, "batched")
    if (agg_plan is not None and per_bucket is not None and session is not None
            and session.conf.exec_device_enabled):
        if _fused_device_possible(left, right, lkeys, rkeys) and _stacked_plan_screen(
            session, agg_plan, left, right, lkeys, rkeys, residual
        ):
            from .device_join import try_stacked_join_agg

            raw_loaded: list = [None] * n
            gen = _iter_bucket_pairs(left, right, session)

            def raw_pairs():
                for b, lb, rb, ls, rs in gen:
                    raw_loaded[b] = (lb, rb, ls, rs)
                    yield b, lb, rb, ls, rs

            dev_out = try_stacked_join_agg(
                raw_pairs(), lkeys, rkeys, residual, session, agg_plan,
                lfilters=tuple(left.filters), rfilters=tuple(right.filters),
                lcols_avail=set(plan.left.schema.names),
                rcols_avail=set(plan.right.schema.names),
            )
            if dev_out is not None:
                return done(dev_out, "stacked_agg")
            for b, lb, rb, ls, rs in gen:  # the fallback reuses every pair
                raw_loaded[b] = (lb, rb, ls, rs)
            preloaded = [
                None if t is None else (
                    None if t[0] is None else _apply_side_ops(left, t[0]),
                    None if t[1] is None else _apply_side_ops(right, t[1]),
                    t[2], t[3],
                )
                for t in raw_loaded
            ]
        else:
            from .gpu_exec import _decline

            _decline(session, "join_plan_screen")

    def join_bucket(b: int) -> Optional[ColumnBatch]:
        # a bucket loaded from ONE index file keeps its on-disk sort by the
        # bucket columns; filters and projections preserve row order
        if preloaded is not None and preloaded[b] is not None:
            lb, rb, l_sorted, r_sorted = preloaded[b]
        else:
            l_sorted = len(left.files_for_bucket(b)) <= 1
            r_sorted = len(right.files_for_bucket(b)) <= 1
            lb = _load_side_bucket(left, b, session)
            rb = _load_side_bucket(right, b, session)
        if lb is None or rb is None or lb.num_rows == 0 or rb.num_rows == 0:
            return None
        if agg_plan is not None:
            from .device_join import try_host_join_agg

            fused = try_host_join_agg(agg_plan, lb, rb, lkeys, rkeys, residual, session,
                                      r_sorted)
            if fused is not None:
                return fused
        # a plain (or fused-declined) join: the probe runs on the device
        # when the tier is on; the rows equal the host merge join's
        from .device_join import try_device_plain_join

        joined = try_device_plain_join(lb, rb, lkeys, rkeys, session, l_sorted, r_sorted)
        if joined is None:
            joined = _merge_join_batches(lb, rb, lkeys, rkeys, l_sorted, r_sorted)
        else:
            probed.append(b)
        for r in residual:
            joined = joined.filter(np.asarray(r.eval(joined).data, dtype=bool))
        if per_bucket is not None:
            joined = per_bucket(joined)
        return joined

    probed: list = []  # buckets whose probe ran on the device
    with ThreadPoolExecutor(max_workers=max(1, min(8, n))) as pool:
        parts = [p for p in pool.map(join_bucket, range(n)) if p is not None]
    if probed:
        session.device_stats.device_plain_probes += len(probed)
    if not parts:
        empty = _empty_like(plan)
        return done(per_bucket(empty) if per_bucket is not None else empty, "per_bucket")
    return done(ColumnBatch.concat(parts), "per_bucket")


class _SchemaCols:
    """Stand-in for a ColumnBatch in plan-level screens: ``.columns``
    membership and ``.column(name).dtype`` from a scan schema, so
    structural checks run without loading a byte."""

    def __init__(self, schema):
        self.columns = {f.name: f for f in schema}

    def column(self, name):
        return self.columns[name]


def _no_derived_rebinding(side: BucketedSide, names) -> bool:
    """True iff no referenced name is a derived projection output on this
    side: the device path reads raw scan columns by name, so a Project that
    derives an expression under an existing raw column name would bind the
    raw column instead of the derivation."""
    project = side.project
    if project is None:
        return True
    for e in project.exprs:
        out = expr_output_name(e)
        if out in names:
            inner = e.child if isinstance(e, Alias) else e
            if not (isinstance(inner, Col) and inner.name == out):
                return False
    return True


def _stacked_plan_screen(session, agg_plan, left, right, lkeys, rkeys, residual) -> bool:
    """Structural (data-independent) eligibility for the fused
    join+aggregate, before any bucket loads."""
    from .device_join import _stacked_eligibility

    try:
        elig = _stacked_eligibility(
            agg_plan, _SchemaCols(left.scan.full_schema), _SchemaCols(right.scan.full_schema),
            lkeys, rkeys, residual, tuple(left.filters), tuple(right.filters),
            set(agg_plan.child.left.schema.names), set(agg_plan.child.right.schema.names),
            exact_f64=session.conf.exec_exact_f64_aggregates,
        )
    except HyperspaceError:
        return False
    if elig is None:
        return False
    # every column the body touches must reach the raw scan unchanged
    refs: set[str] = set(lkeys) | set(rkeys)
    for g in agg_plan.group_exprs:
        if isinstance(g, Col):
            refs.add(g.name)
    for e in list(agg_plan.agg_exprs) + list(residual):
        refs |= e.references()
    for f in list(left.filters) + list(right.filters):
        refs |= f.references()
    return _no_derived_rebinding(left, refs) and _no_derived_rebinding(right, refs)


def _fused_device_possible(left, right, lkeys, rkeys) -> bool:
    """Plan-level key eligibility, knowable from the schema: one key
    column, neither string nor f64 (f64 keys never ship: a lossy downcast
    could fabricate matches)."""
    if len(lkeys) != 1:
        return False
    for side, key in ((left, lkeys[0]), (right, rkeys[0])):
        if key not in side.scan.full_schema:
            return False
        if side.scan.full_schema.field(key).dtype in (STRING, "float64"):
            return False
    return True


def _plain_join_plan_screen(left, right, lkeys, rkeys) -> bool:
    """Plan-level eligibility of the batched device plain join, before any
    bucket loads: one key, not a string (nulls and the int32 range are
    checked per bucket)."""
    if len(lkeys) != 1:
        return False
    for side, key in ((left, lkeys[0]), (right, rkeys[0])):
        schema = side.scan.full_schema
        if key in schema and schema.field(key).dtype == STRING:
            return False
    return True


_INELIGIBLE = object()  # a bucket pair that can never take the device path


def _prep_plain_work(b, lb, rb, lkeys, rkeys, l_sorted, r_sorted, session):
    """One bucket pair as the work tuple the batched device join takes:
    ``(b, lb, rb, lk32_sorted, rk32_sorted, lorder, rorder, lk_src,
    rk_src)``; None for an empty pair; ``_INELIGIBLE`` for string, null or
    inexact keys. The argsorts are cached on the source key buffers."""
    from ..ops.join import exact_key32

    if lb is None or rb is None or lb.num_rows == 0 or rb.num_rows == 0:
        return None
    lk_col, rk_col = lb.column(lkeys[0]), rb.column(rkeys[0])
    if lk_col.dtype == STRING or rk_col.dtype == STRING:
        return _INELIGIBLE
    if lk_col.validity is not None or rk_col.validity is not None:
        return _INELIGIBLE
    lk32, rk32 = exact_key32(lk_col.data), exact_key32(rk_col.data)
    if lk32 is None or rk32 is None or lk32.dtype != rk32.dtype:
        return _INELIGIBLE
    lorder = rorder = None
    if not l_sorted:
        lorder = session.host_derived_cache.get_or_put(
            (lk_col.data,), ("jorder",), lambda a=lk32: np.argsort(a, kind="stable"))
        lk32 = lk32[lorder]
    if not r_sorted:
        rorder = session.host_derived_cache.get_or_put(
            (rk_col.data,), ("jorder",), lambda a=rk32: np.argsort(a, kind="stable"))
        rk32 = rk32[rorder]
    return (b, lb, rb, lk32, rk32, lorder, rorder, lk_col.data, rk_col.data)


def _load_all_bucket_pairs(left, right, session) -> list:
    """Every bucket pair, side ops applied, loaded on a thread pool:
    ``[(lb, rb, l_sorted, r_sorted)]`` by bucket. A bucket loaded from one
    index file keeps its on-disk sort by the bucket columns."""
    n = left.spec.num_buckets

    def load(b):
        return (_load_side_bucket(left, b, session), _load_side_bucket(right, b, session),
                len(left.files_for_bucket(b)) <= 1, len(right.files_for_bucket(b)) <= 1)

    with ThreadPoolExecutor(max_workers=max(1, min(8, n))) as pool:
        return list(pool.map(load, range(n)))


def _collect_plain_join_work(left, right, lkeys, rkeys, session):
    """(work, loaded): every pair loaded, and its work tuple; work is None
    when a pair's keys are ineligible (counted as a decline)."""
    from .gpu_exec import _decline

    loaded = _load_all_bucket_pairs(left, right, session)
    work = []
    for b, (lb, rb, l_sorted, r_sorted) in enumerate(loaded):
        w = _prep_plain_work(b, lb, rb, lkeys, rkeys, l_sorted, r_sorted, session)
        if w is _INELIGIBLE:
            return _decline(session, "plain_join_key"), loaded
        if w is not None:
            work.append(w)
    return work, loaded


def _empty_join_output(lb: ColumnBatch, rb: ColumnBatch) -> ColumnBatch:
    """The zero-row joined batch, from any occupied bucket pair's columns:
    disjoint keys are a result, not a reason to redo the join on the host."""
    empty = np.empty(0, dtype=np.int64)
    out = {nm: c.take(empty) for nm, c in lb.columns.items()}
    out.update({nm: c.take(empty) for nm, c in rb.columns.items()})
    return ColumnBatch(out)


def _try_device_join_paths(left, right, lkeys, rkeys, residual, session):
    """The batched device plain join of a whole co-partitioned join:
    ``(result, loaded)``. A None result hands ``loaded`` (the pairs by
    bucket, or None when the plan screen declined before loading) to the
    per-bucket flow, so nothing is read twice."""
    from .device_join import try_batched_plain_join
    from .gpu_exec import _decline

    if session is None or not session.conf.exec_device_enabled:
        return None, None
    if not _plain_join_plan_screen(left, right, lkeys, rkeys):
        return _decline(session, "plain_join_plan_screen"), None
    work, loaded = _collect_plain_join_work(left, right, lkeys, rkeys, session)
    if not work:
        return None, loaded  # ineligible keys, or no occupied pair
    parts = try_batched_plain_join(work, residual, session)
    if parts is None:
        return None, loaded
    ordered = [parts[b] for b in sorted(parts)]
    if not ordered:
        return _empty_join_output(work[0][1], work[0][2]), loaded
    return ColumnBatch.concat(ordered), loaded


def _iter_bucket_pairs(left, right, session):
    """``(bucket, lb, rb, l_sorted, r_sorted)`` in bucket order, each pair
    loaded RAW when it is asked for (no op replay: the device body runs the
    side filters over the stable index-chunk buffers)."""
    for b in range(left.spec.num_buckets):
        l_sorted = len(left.files_for_bucket(b)) <= 1
        r_sorted = len(right.files_for_bucket(b)) <= 1
        lb = _load_side_bucket(left, b, session, raw=True)
        rb = _load_side_bucket(right, b, session, raw=True)
        yield b, lb, rb, l_sorted, r_sorted


def _apply_side_ops(side: BucketedSide, batch: ColumnBatch) -> ColumnBatch:
    """Replay a side's Filter/Project ops on a raw-loaded bucket, bottom-up."""
    for op in side.ops:
        if isinstance(op, Filter):
            batch = batch.filter(np.asarray(op.condition.eval(batch).data, dtype=bool))
        else:
            batch = ColumnBatch({expr_output_name(e): e.eval(batch) for e in op.exprs})
    return batch


def _load_side_bucket(side: BucketedSide, b: int, session, raw: bool = False
                      ) -> Optional[ColumnBatch]:
    from .executor import execute_plan

    batch = execute_plan(side.scan_for_bucket(b), session)
    return batch if raw else _apply_side_ops(side, batch)


def _merge_join_batches(
    lb: ColumnBatch,
    rb: ColumnBatch,
    lkeys: Sequence[str],
    rkeys: Sequence[str],
    l_sorted: bool = False,
    r_sorted: bool = False,
) -> ColumnBatch:
    from .executor import join_indices

    if len(lkeys) == 1:
        lcol = lb.column(lkeys[0])
        rcol = rb.column(rkeys[0])
        if (lcol.dtype != STRING and rcol.dtype != STRING
                and lcol.validity is None and rcol.validity is None):
            # single numeric key: searchsorted merge on the on-disk sort
            # order; only unsorted sides pay an argsort
            if l_sorted:
                lsorted_keys, lorder = lcol.data, None
            else:
                lorder = np.argsort(lcol.data, kind="stable")
                lsorted_keys = lcol.data[lorder]
            if r_sorted:
                rsorted_keys, rorder = rcol.data, None
            else:
                rorder = np.argsort(rcol.data, kind="stable")
                rsorted_keys = rcol.data[rorder]
            li, ri = host_merge_join_indices(lsorted_keys, rsorted_keys)
            if lorder is not None:
                li = lorder[li]
            if rorder is not None:
                ri = rorder[ri]
            out = {n: c.take(li) for n, c in lb.columns.items()}
            out.update({n: c.take(ri) for n, c in rb.columns.items()})
            return ColumnBatch(out)
    li, ri = join_indices(lb, rb, list(lkeys), list(rkeys))
    out = {n: c.take(li) for n, c in lb.columns.items()}
    out.update({n: c.take(ri) for n, c in rb.columns.items()})
    return ColumnBatch(out)


def _empty_like(plan: Join) -> ColumnBatch:
    cols = {}
    for f in plan.schema:
        if f.dtype == STRING:
            cols[f.name] = Column(np.empty(0, np.int32), STRING, None, [""])
        else:
            cols[f.name] = Column(np.empty(0, numpy_dtype(f.dtype)), f.dtype)
    return ColumnBatch(cols)
