"""Co-partitioned bucketed merge join execution (counterpart of
hyperspace_tpu/plan/bucket_join.py, single device).

The payoff of JoinIndexRule's rewrite: both sides arrive hash-bucketed on
the join keys with the same bucket count, so bucket b joins only bucket b,
with no shuffle and no global hash table.

Three device paths, each recorded in ``session.device_stats.join_paths``:

- ``batched``: a plain (not aggregated) join streams its bucket pairs,
  side filters applied on the host, into the band-stacked probe and run
  expansion on the device, two fetches in all
  (plan/device_join.try_batched_plain_join);
- ``stacked_agg``: an Aggregate grouped by the join key over such a join
  runs the fused join+aggregate on the device for every bucket pair
  (plan/device_join.try_stacked_join_agg): buckets load RAW, side filters
  run in the body over the stable index-chunk buffers, and the whole query
  pays one fetch;
- ``per_bucket``: when those decline (by shape or data), or the join is
  too large for the in-memory path (below), each bucket runs alone: the
  fused join+aggregate on the device (try_device_join_agg; its buckets
  count as ``per_bucket_device``), else its host twin, or a plain join
  whose probe runs on the device (try_device_plain_join) or on the host.

When the device tier is on, ``plan_join_memory`` (plan/join_memory.py)
first classes every bucket pair as broadcast, banded or split from its
files' footer statistics and the device grant; both device paths take
its split row counts. With ``HYPERSPACE_DEVICE_BUDGET_MB=0`` there is no
plan and they split at ``HYPERSPACE_JOIN_SPLIT_ROWS``.

An Aggregate grouped by a bucketed scan's bucket columns aggregates bucket
by bucket (``try_bucketed_scan_aggregate``; AggregateIndexRule's rewrite).

A side may be a hybrid scan's BucketUnion: the index scan (perhaps
lineage-filtered) beside the appended files under a RepartitionByExpr.
The appended rows are read once and split by bucket, and each bucket
appends its part to what it read from the index. A bucket counts as sorted
by its key only when it has no appended part and at most one file (a
refreshed index keeps one run per data version in a bucket): every path
that trusts the on-disk sort reads these flags.

Both device paths take their bucket pairs as a stream
(``_iter_bucket_pairs``): pairs load ahead on an IO pool under the global
read-ahead ledger while the device works on earlier ones, bit for bit the
pairs the load-all barrier gives. ``HYPERSPACE_PIPELINE=0`` keeps the
barrier and one global band wave; ``serial`` loads each pair on the
caller's thread when asked for. A join whose index files exceed
``hyperspace.tpu.build.maxBytesInMemory`` takes the fused path only when
it can run memory-adaptively (streamed pairs and the device ledger on);
else it takes the per-bucket flow.

With ``hyperspace.tpu.exec.meshDevices`` set and that many devices
visible, the plain join probes every bucket pair on the mesh, one bucket
per shard (``_mesh_join_work``, path "mesh"); a hierarchical mesh declines
it. Under ``HYPERSPACE_MESH`` the band waves of both device paths are
placed across the devices instead (plan/device_join.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from .expr import Alias, Col, Expr, expr_output_name
from .nodes import (
    BucketSpec,
    BucketUnion,
    FileScan,
    Filter,
    Join,
    LogicalPlan,
    Project,
    RepartitionByExpr,
)
from ..columnar.table import Column, ColumnBatch, STRING, numpy_dtype
from ..exceptions import HyperspaceError
from ..models.covering import bucket_id_from_filename
from ..ops.bucketize import bucket_ids_for_batch
from ..ops.join import host_merge_join_indices
from ..serve.context import check_cancelled, current_query
from ..telemetry import attribution as _attr
from ..telemetry import trace
from ..telemetry.metrics import REGISTRY
from ..utils.workers import io_pool, io_worker_count, shared_io_pool

@dataclass
class BucketedSide:
    """One join side decomposed into bucket-addressable pieces. ``ops`` are
    the Filter/Project nodes between the scan and the join, bottom-up
    (nearest the scan first), so per-bucket execution replays them exactly."""

    scan: FileScan  # the bucketed index scan
    spec: BucketSpec
    ops: list[LogicalPlan]  # Filter/Project nodes, bottom-up
    appended: Optional[LogicalPlan] = None  # subplan under RepartitionByExpr

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
    bucketed FileScan whose every file carries a bucket id, or over
    BucketUnion(that scan, RepartitionByExpr(appended subplan))."""
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
    appended = None
    if isinstance(node, BucketUnion):
        children = node.children()
        scans = [c for c in children if isinstance(c, FileScan)]
        reparts = [c for c in children if isinstance(c, RepartitionByExpr)]
        if len(scans) != 1 or len(reparts) != 1 or len(children) != 2:
            return None
        appended = reparts[0].child
        node = scans[0]
    if not isinstance(node, FileScan) or node.bucket_spec is None:
        return None
    if any(bucket_id_from_filename(f.name) is None for f in node.files):
        return None
    return BucketedSide(node, node.bucket_spec, list(reversed(ops_topdown)), appended)


def try_bucketed_scan_aggregate(agg_plan, session) -> Optional[ColumnBatch]:
    """Aggregate(group by a superset of the bucket columns)(bucketed scan
    stack): every group lives in one bucket, so buckets aggregate on a
    thread pool and the results concatenate (AggregateIndexRule's rewrite)."""
    from .executor import _exec_aggregate
    from .nodes import Aggregate, InMemoryScan

    if not agg_plan.group_exprs:
        return None
    side = _decompose_side(agg_plan.child)
    if side is None or side.appended is not None:
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
        batch = _load_side_bucket(side, b, None, session)
        return None if batch.num_rows == 0 else aggregate(batch)

    n = side.spec.num_buckets
    with io_pool(io_worker_count(n), "hs-join") as pool:
        parts = [p for p in pool.map(_attr.bound(agg_bucket), range(n)) if p is not None]
    if not parts:
        # every bucket filtered to nothing: the empty grouped shape (read
        # from no file, so verify mode has nothing to hold it against)
        spec = side.scan.prune_spec
        if spec is not None:
            spec = replace(spec, verify_files=())
        empty = BucketedSide(side.scan.copy(files=[], prune_spec=spec), side.spec, side.ops)
        return aggregate(_load_side_bucket(empty, 0, None, session))
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
    appended = (_bucketize_appended(left, n, session), _bucketize_appended(right, n, session))
    t0 = time.perf_counter()

    def done(out: ColumnBatch, path: str) -> ColumnBatch:
        _log_join_exec(session, left, right, path)
        if path != "per_bucket":
            REGISTRY.counter("pipeline.join.queries").inc()
            REGISTRY.histogram("pipeline.join.query_ms").observe(
                (time.perf_counter() - t0) * 1000)
        if session is not None:
            paths = session.device_stats.join_paths
            paths[path] = paths.get(path, 0) + 1
        return out

    device_on = session is not None and session.conf.exec_device_enabled
    # the per-bucket-pair strategy plan from the footer statistics; None
    # when the device ledger is off (the executors keep the fixed split)
    strategy = None
    if device_on:
        from .join_memory import plan_join_memory

        strategy = plan_join_memory(left, right, session)
    preloaded = None
    if agg_plan is None and per_bucket is None:
        dev_out, preloaded, path = _try_device_join_paths(left, right, lkeys, rkeys, residual,
                                                          appended, session, strategy)
        if dev_out is not None:
            return done(dev_out, path)
        if preloaded is not None:
            REGISTRY.counter("pipeline.join.aborted").inc()
    if agg_plan is not None and per_bucket is not None and device_on:
        reason = _fused_device_decline(session, left, right, lkeys, rkeys)
        if reason is None and not _stacked_plan_screen(session, agg_plan, left, right, lkeys,
                                                       rkeys, residual):
            reason = "join_plan_screen"
        if reason is None:
            from .device_join import try_stacked_join_agg
            from .gpu_exec import _pipeline_enabled, _pipeline_overlap

            raw_loaded: list = [None] * n
            pipelined = _pipeline_enabled()
            if pipelined:
                gen = _iter_bucket_pairs(left, right, appended, session, raw=True,
                                         overlap=_pipeline_overlap())
            else:  # the load-all barrier
                gen = (t for t in [(b,) + p for b, p in enumerate(
                    _load_all_bucket_pairs(left, right, appended, session, raw=True))])

            def raw_pairs():
                for b, lb, rb, ls, rs in gen:
                    raw_loaded[b] = (lb, rb, ls, rs)
                    yield b, lb, rb, ls, rs

            try:
                dev_out = try_stacked_join_agg(
                    raw_pairs(), lkeys, rkeys, residual, session, agg_plan,
                    lfilters=tuple(left.filters), rfilters=tuple(right.filters),
                    lcols_avail=set(plan.left.schema.names),
                    rcols_avail=set(plan.right.schema.names),
                    banded=pipelined, strategy=strategy,
                )
                if dev_out is not None:
                    return done(dev_out, "stacked_agg")
                for b, lb, rb, ls, rs in gen:  # the fallback reuses every pair
                    raw_loaded[b] = (lb, rb, ls, rs)
            finally:
                gen.close()  # stops the read-ahead, whatever raised
            REGISTRY.counter("pipeline.join.aborted").inc()
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

            _decline(session, reason)

    def join_bucket(b: int) -> Optional[ColumnBatch]:
        if preloaded is not None and preloaded[b] is not None:
            lb, rb, l_sorted, r_sorted = preloaded[b]
        else:
            l_sorted = _bucket_sorted(left, b, appended[0])
            r_sorted = _bucket_sorted(right, b, appended[1])
            lb = _load_side_bucket(left, b, appended[0], session)
            rb = _load_side_bucket(right, b, appended[1], session)
        if lb is None or rb is None or lb.num_rows == 0 or rb.num_rows == 0:
            return None
        if agg_plan is not None:
            from .device_join import try_device_join_agg, try_host_join_agg

            fused = try_device_join_agg(agg_plan, lb, rb, lkeys, rkeys, residual, session,
                                        r_sorted, l_sorted)
            if fused is not None:
                on_device.append(b)
                return fused
            # the numpy twin of the fused body: the join output does not
            # materialize on the host path either
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
    on_device: list = []  # buckets whose fused join+aggregate ran on the device
    with io_pool(io_worker_count(n), "hs-join") as pool:
        parts = [p for p in pool.map(_attr.bound(join_bucket), range(n)) if p is not None]
    if probed:
        session.device_stats.device_plain_probes += len(probed)
    if on_device:
        paths = session.device_stats.join_paths
        paths["per_bucket_device"] = paths.get("per_bucket_device", 0) + len(on_device)
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


def _fused_device_decline(session, left, right, lkeys, rkeys) -> Optional[str]:
    """Why the all-bucket fused path cannot run, from the plan alone, or
    None when it can (the reference's ``_fused_device_possible``). It needs
    one key column, neither string nor f64 (f64 keys never ship: a lossy
    downcast could fabricate matches): else "join_plan_screen". A join
    whose index files exceed ``maxBytesInMemory`` stays on it only when it
    can run memory-adaptively, pairs streamed and the device ledger on;
    under ``HYPERSPACE_PIPELINE=0`` or with the ledger off it takes the
    per-bucket flow ("join_over_memory"), as in the reference."""
    from ..serve.budget import device_budget
    from .gpu_exec import _pipeline_enabled

    if len(lkeys) != 1:
        return "join_plan_screen"
    for side, key in ((left, lkeys[0]), (right, rkeys[0])):
        if key not in side.scan.full_schema:
            return "join_plan_screen"
        if side.scan.full_schema.field(key).dtype in (STRING, "float64"):
            return "join_plan_screen"
    total_bytes = sum(f.size for side in (left, right) for f in side.scan.files)
    if total_bytes > session.conf.build_max_bytes_in_memory and not (
            _pipeline_enabled() and device_budget().max_bytes > 0):
        return "join_over_memory"
    return None


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


def _bucket_sorted(side: BucketedSide, b: int, appended) -> bool:
    """True iff bucket ``b`` of the side arrives in its on-disk key order:
    read from at most one index file (filters and projections keep row
    order) and with no appended part. A refreshed index's bucket (one run
    per data version) or a hybrid scan's appended rows make an unsorted
    concatenation."""
    return appended is None and len(side.files_for_bucket(b)) <= 1


def _load_pair(left, right, appended, session, b: int, raw: bool) -> tuple:
    """Bucket ``b``'s ``(lb, rb, l_sorted, r_sorted)``; its decode is the
    running query's ``io`` phase (on a pool thread too, through
    ``attribution.bound``)."""
    t0 = time.perf_counter()
    out = (_load_side_bucket(left, b, appended[0], session, raw=raw),
           _load_side_bucket(right, b, appended[1], session, raw=raw),
           _bucket_sorted(left, b, appended[0]), _bucket_sorted(right, b, appended[1]))
    _attr.charge_phase("io", time.perf_counter() - t0)
    return out


def _load_all_bucket_pairs(left, right, appended, session, raw: bool = False) -> list:
    """Every bucket pair (side ops applied unless ``raw``), loaded on a
    thread pool before anything else runs: ``[(lb, rb, l_sorted,
    r_sorted)]`` by bucket."""
    n = left.spec.num_buckets
    with io_pool(io_worker_count(n), "hs-join") as pool:
        return list(pool.map(
            _attr.bound(lambda b: _load_pair(left, right, appended, session, b, raw)),
            range(n)))


def _collect_plain_join_work(left, right, lkeys, rkeys, appended, session):
    """(work, loaded): every pair loaded, and its work tuple; work is None
    when a pair's keys are ineligible (counted as a decline)."""
    from .gpu_exec import _decline

    loaded = _load_all_bucket_pairs(left, right, appended, session)
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


class _PlainJoinIneligible(Exception):
    """A streamed bucket pair's keys cannot take the device (string, null
    or inexact keys): the batched plain join declines, and the per-bucket
    flow reuses the pairs already loaded."""


def _try_device_join_paths(left, right, lkeys, rkeys, residual, appended, session,
                           strategy=None):
    """The device plain join of a whole co-partitioned join: ``(result,
    loaded, path)``. A None result hands ``loaded`` (the pairs by bucket,
    or None when the plan screen declined before loading) to the
    per-bucket flow, so nothing is read twice.

    With a mesh active (``meshDevices``), every pair loads first and the
    mesh probe runs in waves of one bucket per shard (``_mesh_join_work``,
    path "mesh"); a hierarchical mesh declines it (the probe moves bucket
    rows, which stay within one slice), and the one-device paths run.
    Otherwise pairs stream into the band-stacked probe under
    ``HYPERSPACE_PIPELINE`` 1 or serial (its waves dispatch while later
    pairs load); under 0 every pair loads behind the barrier and the probe
    runs one global wave (path "batched")."""
    from .device_join import try_batched_plain_join
    from .gpu_exec import _decline, _pipeline_enabled, _pipeline_overlap
    from ..parallel.mesh import _log, active_mesh, is_hierarchical

    if session is None or not session.conf.exec_device_enabled:
        return None, None, None
    if not _plain_join_plan_screen(left, right, lkeys, rkeys):
        return _decline(session, "plain_join_plan_screen"), None, None
    mesh = active_mesh(session)
    if mesh is not None and is_hierarchical(mesh):
        _log.info("the mesh join probe stays within one slice: a hierarchical mesh "
                  "declines it")
        _decline(session, "mesh_join_hierarchical")
        mesh = None
    if mesh is not None or not _pipeline_enabled():
        work, loaded = _collect_plain_join_work(left, right, lkeys, rkeys, appended, session)
        if not work:
            return None, loaded, None  # ineligible keys, or no occupied pair
        if mesh is not None:
            return _mesh_join_work(mesh, work, residual, session, left, right), loaded, "mesh"
        parts = try_batched_plain_join(work, residual, session, banded=False,
                                       strategy=strategy)
        if parts is None:
            return None, loaded, None
        ordered = [parts[b] for b in sorted(parts)]
        if not ordered:
            return _empty_join_output(work[0][1], work[0][2]), loaded, "batched"
        return ColumnBatch.concat(ordered), loaded, "batched"

    n = left.spec.num_buckets
    loaded: list = [None] * n
    gen = _iter_bucket_pairs(left, right, appended, session, overlap=_pipeline_overlap())

    def work_items():
        for b, lb, rb, ls, rs in gen:
            loaded[b] = (lb, rb, ls, rs)
            w = _prep_plain_work(b, lb, rb, lkeys, rkeys, ls, rs, session)
            if w is _INELIGIBLE:
                raise _PlainJoinIneligible()
            if w is not None:
                yield w

    try:
        try:
            parts = try_batched_plain_join(work_items(), residual, session, banded=True,
                                           strategy=strategy)
        except _PlainJoinIneligible:
            parts = _decline(session, "plain_join_key")
        for b, lb, rb, ls, rs in gen:  # drain: the per-bucket flow reuses every pair
            loaded[b] = (lb, rb, ls, rs)
    finally:
        gen.close()  # stops the read-ahead, whatever raised
    if parts is None:
        return None, loaded, None
    ordered = [parts[b] for b in sorted(parts)]
    if ordered:
        return ColumnBatch.concat(ordered), loaded, "batched"
    occupied = next((t for t in loaded if t is not None and t[0] is not None
                     and t[1] is not None and t[0].num_rows and t[1].num_rows), None)
    if occupied is None:
        return None, loaded, None  # nothing occupied: the per-bucket empty shape
    return _empty_join_output(occupied[0], occupied[1]), loaded, "batched"


def _mesh_join_work(mesh, work, residual, session=None, left=None,
                    right=None) -> ColumnBatch:
    """Join pre-collected bucket work across the device mesh: the probe
    runs in waves of one bucket per shard (parallel/dist_join: shard-local,
    no traffic between devices, since the sides are co-partitioned); run
    expansion and column gathers stay on the host, so the rows equal the
    per-bucket host merge join's, in bucket order. A shard whose probe
    fails to launch raises."""
    from ..ops.join import expand_runs
    from ..parallel.dist_join import mesh_join_probe
    from ..parallel.mesh import num_shards
    from .device_join import _pow2

    S = num_shards(mesh)
    pad_l = _pow2(max(len(w[3]) for w in work))
    pad_r = _pow2(max(len(w[4]) for w in work))
    dt = work[0][3].dtype
    pad_val = np.iinfo(dt).max if dt.kind == "i" else np.float32(np.inf)

    parts: dict[int, ColumnBatch] = {}
    for wave_start in range(0, len(work), S):
        wave = work[wave_start: wave_start + S]
        lk_stack = np.full((S, pad_l), pad_val, dtype=dt)
        rk_stack = np.full((S, pad_r), pad_val, dtype=dt)
        n_r = np.zeros(S, dtype=np.int64)
        for i, (_b, _lb, _rb, lk32, rk32, _lo, _ro, _ls, _rs) in enumerate(wave):
            lk_stack[i, : len(lk32)] = lk32
            rk_stack[i, : len(rk32)] = rk32
            n_r[i] = len(rk32)
        starts_all, counts_all = mesh_join_probe(mesh, lk_stack, rk_stack, n_r)
        for i, (b, lb, rb, lk32, _rk32, lorder, rorder, _ls, _rs) in enumerate(wave):
            n_l = len(lk32)
            counts = counts_all[i, :n_l]
            li = np.repeat(np.arange(n_l, dtype=np.int64), counts)
            ri = expand_runs(starts_all[i, :n_l], counts)
            if lorder is not None:
                li = lorder[li]
            if rorder is not None:
                ri = rorder[ri]
            out = {nm: c.take(li) for nm, c in lb.columns.items()}
            out.update({nm: c.take(ri) for nm, c in rb.columns.items()})
            joined = ColumnBatch(out)
            for r in residual:
                joined = joined.filter(np.asarray(r.eval(joined).data, dtype=bool))
            parts[b] = joined
    if session is not None:
        session.device_stats.mesh_joins += 1
        names = sorted({s.scan.index_info.index_name for s in (left, right)
                        if s is not None and s.scan.index_info is not None})
        if names:
            from ..rules.rule_utils import log_index_usage

            log_index_usage(session, "MeshBucketedExec", names,
                            f"Mesh bucketed join: {len(work)} buckets in waves of "
                            f"{S} shards ({', '.join(names)})")
    ordered = [parts[b] for b in sorted(parts)]
    return ColumnBatch.concat(ordered) if ordered else _empty_join_output(work[0][1],
                                                                         work[0][2])


def _iter_bucket_pairs(left, right, appended, session, raw: bool = False,
                       overlap: bool = True):
    """``(bucket, lb, rb, l_sorted, r_sorted)`` in bucket order, each pair
    made by the calls the barrier loader makes (``raw`` leaves the side ops
    for the device body), so the stream equals ``_load_all_bucket_pairs``
    pair for pair. With ``overlap`` the pairs load ahead on an IO pool: at
    most width + 2 in flight, each reserving twice both sides' file bytes
    through the global read-ahead ledger before it is submitted (a stream
    that holds nothing is always granted). Without it, or with one bucket
    or one thread, each pair loads on the caller's thread when asked for.
    Under a serving query the pairs load on the shared engine pool, each
    task charged to the query, and a cancelled query unwinds at the next
    pair, returning its reservations."""
    from ..serve import budget as serve_budget

    n = left.spec.num_buckets
    width = io_worker_count(n)
    if not overlap or width <= 1 or n < 2:
        for b in range(n):
            check_cancelled()
            with trace.span("join:load", bucket=b) as sp:
                out = _load_pair(left, right, appended, session, b, raw)
                _note_pair_rows(sp, out)
            REGISTRY.counter("pipeline.join.pairs").inc()
            yield (b,) + out
        return
    ests = [max(1, sum(f.size for side in (left, right) for f in side.files_for_bucket(b))) * 2
            for b in range(n)]
    owned = current_query() is None  # served: the shared engine pool
    pool = io_pool(width, "hs-join-io") if owned else shared_io_pool()
    bstream = serve_budget.global_budget().stream("join")
    futures: dict = {}
    nxt = 0

    def pump() -> None:
        nonlocal nxt
        while nxt < n and len(futures) < width + 2 and bstream.try_reserve(ests[nxt]):
            futures[nxt] = pool.submit(_attr.bound(_load_pair), left, right, appended,
                                       session, nxt, raw)
            nxt += 1

    try:
        pump()
        for b in range(n):
            check_cancelled()
            # the span is the consumer's wait for the pair, on its thread
            with trace.span("join:load", bucket=b) as sp:
                out = futures.pop(b).result()
                _note_pair_rows(sp, out)
            bstream.release(ests[b])
            pump()
            REGISTRY.counter("pipeline.join.pairs").inc()
            yield (b,) + out
    finally:
        try:
            for f in futures.values():
                f.cancel()
            if owned:
                pool.shutdown(wait=False)
        finally:
            bstream.close()


def _note_pair_rows(sp, out) -> None:
    sp.set_attr("rows_l", 0 if out[0] is None else out[0].num_rows)
    sp.set_attr("rows_r", 0 if out[1] is None else out[1].num_rows)


def _log_join_exec(session, left: BucketedSide, right: BucketedSide, path: str) -> None:
    """The usage event of the bucketed join's execution tier (which path
    ran: the batched device join, the stacked fused aggregate or the
    per-bucket flow), logged as the rewrite rules log theirs. A bucketed
    scan that is no index's stays silent."""
    if session is None:
        return
    names = sorted({s.scan.index_info.index_name for s in (left, right)
                    if s.scan.index_info is not None})
    if names:
        from ..rules.rule_utils import log_index_usage

        log_index_usage(session, "BucketedJoinExec", names,
                        f"Bucketed join executed ({path}): {', '.join(names)}")


def _apply_side_ops(side: BucketedSide, batch: ColumnBatch) -> ColumnBatch:
    """Replay a side's Filter/Project ops on a raw-loaded bucket, bottom-up."""
    for op in side.ops:
        if isinstance(op, Filter):
            batch = batch.filter(np.asarray(op.condition.eval(batch).data, dtype=bool))
        else:
            batch = ColumnBatch({expr_output_name(e): e.eval(batch) for e in op.exprs})
    return batch


def _bucketize_appended(side: BucketedSide, num_buckets: int, session
                        ) -> Optional[list[ColumnBatch]]:
    """The appended-files subplan, read once and split by bucket: the
    "re-bucket only the appended rows" half of hybrid scan."""
    if side.appended is None:
        return None
    from .executor import execute_plan

    batch = execute_plan(side.appended, session)
    ids = bucket_ids_for_batch(batch, list(side.spec.bucket_columns), num_buckets)
    return [batch.filter(ids == b) for b in range(num_buckets)]


def _load_side_bucket(side: BucketedSide, b: int, appended: Optional[list[ColumnBatch]],
                      session, raw: bool = False) -> Optional[ColumnBatch]:
    """Bucket ``b`` of the side: its index files, then its appended part;
    ``raw`` leaves the side's ops for the device body to run."""
    from .executor import execute_plan

    batch = execute_plan(side.scan_for_bucket(b), session)
    if appended is not None and appended[b].num_rows:
        batch = ColumnBatch.concat([batch, appended[b].select(batch.schema.names)])
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
