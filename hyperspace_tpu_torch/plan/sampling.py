"""The approximate tier's read side: sampled execution with confidence
intervals (counterpart of hyperspace_tpu/plan/sampling.py).

The write side (models/sample_store.py) keeps universe-sampled *twin*
files beside every index data file. Given an optimized exact plan, this
module decides whether the sampled tier may answer it, rewrites it to scan
the twins, executes it through the ordinary executor (the device routes
included), and scales each aggregate by the inverse fraction with a 95%
confidence interval.

Eligibility is all or nothing: a partly sampled plan would be biased, so a
plan the rewrite cannot prove unbiased runs exact and is counted under
``approx.ineligible.<reason>``:

- ``shape``: the root is not an Aggregate (a Sort/Limit chain above it is
  fine), or below it stands a node other than Filter, Project, Join and
  FileScan (a hybrid-scan Union mixes sampled and unsampled rows);
- ``aggfunc``: an aggregate other than Count or Sum;
- ``not-index``: a scan that is not a bucketed covering-index scan;
- ``format``: a scan that is not parquet;
- ``ndv``: the fraction is expected to keep fewer than
  ``HYPERSPACE_APPROX_MIN_KEYS`` distinct keys;
- ``group-on-key`` / ``key-filtered``: a group column or a Filter below the
  aggregate references a sampling-key column (whole keys are kept, so both
  bias the 1/p scaling);
- ``join-key-dtypes``: the scans' key dtypes differ (they hash through
  different words, decorrelating the sides);
- ``join-not-on-key``: a join that is not an inner equi-join on exactly
  both sides' bucket-key tuples, aligned, with no key residual (the twins
  of two sides correlate only through the hash of their keys);
- ``missing-samples``: a kept file has no twin at the fraction;
- ``hot-key``: a key owning ``HYPERSPACE_APPROX_MAX_KEY_SHARE`` of an
  index's rows (the per-file heavy-cluster metas) that the fraction drops;
- ``key-pruned``: no scan's key tuple survives into the aggregate's input.

Estimator. Universe sampling keeps or drops whole key clusters, so the unit
of sampling is the cluster. With ``S_k`` the aggregate's partial over a
surviving cluster ``k`` and fraction ``p``, ``est = raw/p`` and ``Var^ =
(1-p)/p^2 * sum_k S_k^2``. The sampled plan runs as a two-level aggregate:
the inner level groups by (user groups + cluster keys) into partials
``__hs_p<i>``; the outer re-groups by the user groups into the outputs
(Sum of partials) and the squared-partial companions ``__hs_sq<i>``,
dropped before results surface. Half-widths are multiplied by
``HYPERSPACE_APPROX_CI_SAFETY`` (2.0). ``HYPERSPACE_APPROX=verify`` runs
the exact plan beside it and raises :class:`ApproxVerifyError` when a
reported interval misses the exact answer.

A sampled run bypasses the result cache and the adaptive executor
(``execute_plan`` directly). The JAX package also runs its static plan
verifier over the sampled plan under ``HYPERSPACE_VERIFY_PLAN``; the port
has no verifier yet.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo
from ..models import sample_store
from ..staticcheck.concurrency import TrackedLock
from ..utils import env
from .expr import AggExpr, Alias, Col, Count, Mul, Sum, expr_output_name
from .nodes import Aggregate, FileScan, Filter, Join, Limit, Project, Sort

_Z95 = 1.959964


class ApproxVerifyError(HyperspaceError):
    """verify mode: a reported 95% interval missed the exact answer."""


@dataclass(frozen=True)
class SampleSpec:
    """The sampled tier's contract on a FileScan whose ``files`` are sample
    twins."""

    fraction: float
    ppm: int
    key_columns: tuple
    method: str = "universe"

    def describe(self) -> str:
        return f"sampled[{self.method} f={self.fraction:g}]"

    def structure_key(self) -> tuple:
        return (self.method, self.ppm, self.key_columns)


@dataclass(frozen=True)
class _AggOutput:
    name: str       # output column name in the exact plan
    kind: str       # "count" | "sum"
    companion: Optional[str]  # the squared-cluster-partials companion
    dtype: str      # the exact plan's output dtype


@dataclass(frozen=True)
class SampledPlan:
    plan: object                  # the rewritten plan, over sample twins
    fraction: float
    group_names: tuple
    outputs: tuple                # an _AggOutput per exact output
    agg_plan_id: int              # the sampled outer Aggregate
    scan_plan_ids: tuple          # the sampled FileScans


def ci_safety() -> float:
    try:
        v = float(env.env_float("HYPERSPACE_APPROX_CI_SAFETY"))
    except (TypeError, ValueError):
        return 2.0
    return v if v > 0 else 2.0


# --- the requested fraction: an explicit scope, else a degraded query -------

_requested: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_approx_fraction", default=None
)


@contextlib.contextmanager
def approx_scope(fraction: float):
    """Ask for sampled execution at ``fraction`` for the collects in the
    block (the QoS degrade uses the query context instead)."""
    token = _requested.set(float(fraction))
    try:
        yield
    finally:
        _requested.reset(token)


def requested_fraction() -> Optional[float]:
    v = _requested.get()
    if v is not None:
        return v
    from ..serve.context import current_query

    q = current_query()
    if q is not None:
        return q.approx_fraction
    return None


# --- process-wide telemetry (the exporter's "approx" block) -----------------

class ApproxTelemetry:
    """Counts and the mean relative interval width of the sampled tier.
    A leaf lock; metrics are emitted at the call sites, never under it."""

    def __init__(self):
        self._lock = TrackedLock("telemetry.approx")
        self.degrades = 0
        self.sampled_queries = 0
        self.ineligible = 0
        self.verify_checked = 0
        self._ci_rel_sum = 0.0
        self._ci_rel_n = 0

    def note_degrade(self) -> None:
        with self._lock:
            self.degrades += 1

    def note_ineligible(self) -> None:
        with self._lock:
            self.ineligible += 1

    def note_sampled(self, mean_rel_ci: Optional[float]) -> None:
        with self._lock:
            self.sampled_queries += 1
            if mean_rel_ci is not None:
                self._ci_rel_sum += float(mean_rel_ci)
                self._ci_rel_n += 1

    def note_verified(self) -> None:
        with self._lock:
            self.verify_checked += 1

    def snapshot(self) -> dict:
        with self._lock:
            n = self._ci_rel_n
            return {
                "degrades": self.degrades,
                "sampled_queries": self.sampled_queries,
                "ineligible": self.ineligible,
                "verify_checked": self.verify_checked,
                "mean_ci_rel": round(self._ci_rel_sum / n, 6) if n else None,
            }

    def reset_for_testing(self) -> None:
        with self._lock:
            self.degrades = self.sampled_queries = 0
            self.ineligible = self.verify_checked = 0
            self._ci_rel_sum, self._ci_rel_n = 0.0, 0


APPROX = ApproxTelemetry()


# --- eligibility and the rewrite ---------------------------------------------

def _unwrap_agg(e) -> tuple[str, Optional[AggExpr]]:
    name = expr_output_name(e)
    node = e.child if isinstance(e, Alias) else e
    return name, node if isinstance(node, AggExpr) else None


def _expr_cols(e, out: set) -> None:
    if isinstance(e, Col):
        out.add(e.name)
    for c in e.children():
        _expr_cols(c, out)


def _min_viable_fraction(session, scan: FileScan) -> float:
    """The NDV floor of the tier: ``HYPERSPACE_APPROX_MIN_KEYS`` over the
    index's key NDV, from the sketch sidecars when they are there, else
    the largest ``key_ndv`` of the first 8 files' sample metas (a lower
    bound, so it leans toward declining). No evidence: no floor."""
    min_keys = max(1, int(env.env_int("HYPERSPACE_APPROX_MIN_KEYS")))
    info = scan.index_info
    if info is None or session is None:
        return 0.0
    try:
        from ..index_manager import index_manager_for
        from ..models.dataskipping import sketch_store

        entry = index_manager_for(session).get_index(info.index_name, info.log_version)
        if entry is None:
            return 0.0
        stats = sketch_store.index_ndv_stats(entry)
        if stats:
            ndv_map = stats[0]
            key_cols = tuple(scan.bucket_spec.bucket_columns)
            ndvs = [ndv_map[c] for c in key_cols if c in ndv_map]
            if ndvs:
                return min_keys / max(1, min(ndvs))
        ndv = 0
        for i, f in enumerate(scan.files):
            if i >= 8:
                break
            meta = sample_store.load_sample_meta(f.name)
            if meta:
                ndv = max(ndv, int(meta.get("key_ndv", 0)))
        if ndv > 0:
            return min_keys / ndv
        return 0.0
    except Exception:
        return 0.0


def _join_on_keys(joins) -> bool:
    """Every join is an inner equi-join on exactly both sides' bucket-key
    tuples (aligned in bucket-column order), with no residual on a key."""
    from .executor import extract_equi_keys

    for j in joins:
        if j.condition is None or j.how != "inner":
            return False
        lk, rk, residual = extract_equi_keys(j.condition, j.left.schema, j.right.schema)
        if not lk or len(set(lk)) != len(lk) or len(set(rk)) != len(rk):
            return False
        join_keys = set(lk) | set(rk)
        if any(r.references() & join_keys for r in residual):
            return False
        pair = dict(zip(lk, rk))
        for ls in (n for n in j.left.preorder() if isinstance(n, FileScan)):
            lcols = tuple(ls.bucket_spec.bucket_columns)
            if set(lk) != set(lcols):
                return False
            rtuple = tuple(pair[c] for c in lcols)
            for rs in (n for n in j.right.preorder() if isinstance(n, FileScan)):
                if tuple(rs.bucket_spec.bucket_columns) != rtuple:
                    return False
    return True


def build_sampled_plan(session, optimized, fraction: float):
    """``optimized`` rewritten to scan the sample twins at ``fraction``: a
    :class:`SampledPlan`, or the reason string when it is ineligible."""
    wrappers = []
    node = optimized
    while isinstance(node, (Sort, Limit)):
        wrappers.append(node)
        node = node.child
    if not isinstance(node, Aggregate):
        return "shape"
    agg = node

    outputs = []
    schema = optimized.schema
    for e in agg.agg_exprs:
        name, fn = _unwrap_agg(e)
        if isinstance(fn, Count):
            outputs.append(_AggOutput(name, "count", None, "int64"))
        elif isinstance(fn, Sum):
            outputs.append(_AggOutput(name, "sum", None, schema.field(name).dtype))
        else:
            return "aggfunc"
    if not outputs:
        return "aggfunc"

    scans: list[FileScan] = []
    joins: list[Join] = []
    filter_cols: set = set()
    for n in agg.child.preorder():
        if isinstance(n, FileScan):
            scans.append(n)
        elif isinstance(n, Filter):
            _expr_cols(n.condition, filter_cols)
        elif isinstance(n, Join):
            joins.append(n)
        elif not isinstance(n, Project):
            return "shape"
    if not scans:
        return "shape"

    key_dtype_sets = set()
    for scan in scans:
        if scan.index_info is None or scan.bucket_spec is None:
            return "not-index"
        if scan.fmt != "parquet":
            return "format"
        if fraction < _min_viable_fraction(session, scan):
            return "ndv"
        key_cols = tuple(scan.bucket_spec.bucket_columns)
        if any(expr_output_name(g) in key_cols for g in agg.group_exprs):
            return "group-on-key"
        if any(c in filter_cols for c in key_cols):
            return "key-filtered"
        key_dtype_sets.add(tuple(scan.full_schema.field(c).dtype for c in key_cols))
    if len(scans) > 1 and len(key_dtype_sets) > 1:
        return "join-key-dtypes"
    if not _join_on_keys(joins):
        return "join-not-on-key"

    replacements: dict[int, FileScan] = {}
    max_share = env.env_float("HYPERSPACE_APPROX_MAX_KEY_SHARE")
    kept_below = sample_store.keep_threshold(fraction)
    for scan in scans:
        twins = []
        total_rows = 0
        heavy_by_hash: dict[str, int] = {}
        for f in scan.files:
            tp = sample_store.sample_path(f.name, fraction)
            if not os.path.exists(tp):
                return "missing-samples"
            twins.append(FileInfo.from_path(tp, f.id))
            meta = sample_store.load_sample_meta(f.name)
            if meta:
                total_rows += int(meta.get("rows", 0))
                for hstr, r in (meta.get("heavy") or {}).items():
                    heavy_by_hash[hstr] = heavy_by_hash.get(hstr, 0) + int(r)
        # a heavy key the hash drops leaves a dominant cluster the sample
        # cannot see: its estimate is biased low and no interval covers it
        if total_rows > 0 and max_share > 0:
            for hstr, r in heavy_by_hash.items():
                if r >= max_share * total_rows and int(hstr) >= kept_below:
                    return "hot-key"
        spec = SampleSpec(fraction=fraction, ppm=sample_store.fraction_ppm(fraction),
                          key_columns=tuple(scan.bucket_spec.bucket_columns))
        prune = scan.prune_spec
        if prune is not None:
            # the prune decisions carry over (a twin keeps its data file's
            # bucket and sort order); the verify list and the predictions
            # belong to the exact scan, so they go
            prune = replace(prune, verify_files=(), predicted_kept=-1, sketch_fraction=-1.0)
        replacements[scan.plan_id] = scan.copy(files=twins, sample_spec=spec, prune_spec=prune)

    # the unit of sampling is the key cluster: its columns must reach the
    # aggregate to form per-cluster partials
    child_names = set(agg.child.schema.names)
    cluster_cols: Optional[tuple] = None
    for scan in scans:
        kc = tuple(scan.bucket_spec.bucket_columns)
        if all(c in child_names for c in kc):
            cluster_cols = kc
            break
    if cluster_cols is None:
        return "key-pruned"

    # the two-level rewrite; above a bucketed join the inner level still
    # groups by the join key, so the join+aggregate route applies unchanged
    inner_group = list(agg.group_exprs) + [Col(c) for c in cluster_cols]
    inner_aggs = []
    outer_aggs = []
    outs = []
    for i, (e, o) in enumerate(zip(agg.agg_exprs, outputs)):
        fn = e.child if isinstance(e, Alias) else e
        pname = f"__hs_p{i}"
        inner_aggs.append(Alias(fn, pname))
        outer_aggs.append(Alias(Sum(Col(pname)), o.name))
        outs.append(replace(o, companion=f"__hs_sq{i}"))
    for i in range(len(outputs)):
        pname = f"__hs_p{i}"
        outer_aggs.append(Alias(Sum(Mul(Col(pname), Col(pname))), f"__hs_sq{i}"))

    new_child = agg.child.transform_up(lambda n: replacements.get(n.plan_id, n))
    inner = Aggregate(inner_group, inner_aggs, new_child)
    outer_group = [Col(expr_output_name(g)) for g in agg.group_exprs]
    new_node = Aggregate(outer_group, outer_aggs, inner)
    agg_plan_id = new_node.plan_id
    cur = new_node
    for w in reversed(wrappers):
        cur = w.with_new_children([cur])

    return SampledPlan(
        plan=cur,
        fraction=fraction,
        group_names=tuple(expr_output_name(g) for g in agg.group_exprs),
        outputs=tuple(outs),
        agg_plan_id=agg_plan_id,
        scan_plan_ids=tuple(n.plan_id for n in cur.preorder() if isinstance(n, FileScan)),
    )


# --- finalize: scale and intervals -------------------------------------------

@dataclass
class _OutputEstimate:
    name: str
    est: np.ndarray        # the unrounded scaled estimates (float64)
    ci95: np.ndarray       # half-widths, safety factor applied
    valid: Optional[np.ndarray]


def _finalize(batch, sp: SampledPlan):
    """Scale the raw sampled aggregates by 1/p, compute the half-widths,
    drop the companions and restore the exact plan's columns. Returns
    ``(out_batch, estimates, info)``."""
    from ..columnar.table import Column, ColumnBatch

    p = sp.fraction
    safety = ci_safety()
    cols: dict = {}
    for g in sp.group_names:
        cols[g] = batch.column(g)
    estimates: list[_OutputEstimate] = []
    rel_widths: list[float] = []
    for o in sp.outputs:
        raw_col = batch.column(o.name)
        raw = np.asarray(raw_col.data, dtype=np.float64)
        est = raw / p
        ssq = np.asarray(batch.column(o.companion).data, dtype=np.float64)
        var = (1.0 - p) / (p * p) * np.maximum(ssq, 0.0)
        hw = _Z95 * np.sqrt(var) * safety
        if o.dtype in ("int64", "int32", "int16", "int8"):
            data = np.rint(est).astype(np.dtype(o.dtype))
        else:
            data = est.astype(np.dtype(o.dtype))
        cols[o.name] = Column(data, o.dtype, raw_col.validity, None)
        estimates.append(_OutputEstimate(o.name, est, hw, raw_col.validity))
        v = raw_col.validity
        mask = v if v is not None else np.ones(len(est), dtype=bool)
        if mask.any():
            denom = np.maximum(np.abs(est[mask]), 1.0)
            rel_widths.extend((hw[mask] / denom).tolist())
    out = ColumnBatch(cols)
    info = {
        "fraction": p,
        "rows": int(out.num_rows),
        "safety": safety,
        "mean_ci_rel": round(float(np.mean(rel_widths)), 6) if rel_widths else None,
        "outputs": {
            e.name: {
                "ci95_mean": round(float(np.mean(e.ci95)), 6) if len(e.ci95) else 0.0,
                "ci95_max": round(float(np.max(e.ci95)), 6) if len(e.ci95) else 0.0,
            }
            for e in estimates
        },
    }
    return out, estimates, info


def _coverage_violations(sampled_out, estimates: Sequence[_OutputEstimate], exact_batch,
                         sp: SampledPlan) -> tuple[list[str], int]:
    """The reported intervals that miss the exact answer, and the exact
    groups the sample missed (counted, not violations)."""
    gnames = list(sp.group_names)
    exact_d = exact_batch.to_pydict()
    sampled_d = sampled_out.select(gnames).to_pydict() if gnames else {}
    n_exact = exact_batch.num_rows
    if gnames:
        exact_by_key = {tuple(exact_d[g][i] for g in gnames): i for i in range(n_exact)}
        keys = [tuple(sampled_d[g][i] for g in gnames) for i in range(sampled_out.num_rows)]
        rows = [(i, exact_by_key.get(k)) for i, k in enumerate(keys)]
        missed = n_exact - sum(1 for _, j in rows if j is not None)
    else:
        rows = [(0, 0)] if n_exact and sampled_out.num_rows else []
        missed = 0
    violations: list[str] = []
    for e in estimates:
        exact_col = exact_batch.column(e.name)
        exact_vals = np.asarray(exact_col.data, dtype=np.float64)
        exact_valid = exact_col.validity
        for i, j in rows:
            if j is None:
                continue
            if e.valid is not None and not e.valid[i]:
                continue
            if exact_valid is not None and not exact_valid[j]:
                continue
            diff = abs(float(exact_vals[j]) - float(e.est[i]))
            if diff > float(e.ci95[i]) + 1e-9:
                violations.append(
                    f"{e.name}[row {i}]: exact={exact_vals[j]:.6g} "
                    f"est={e.est[i]:.6g} ci95={e.ci95[i]:.6g}"
                )
    return violations, missed


# --- the collect-time hook ---------------------------------------------------

def maybe_execute_sampled(session, optimized):
    """The sampled tier's chokepoint in ``DataFrame.collect``: the scaled
    sampled result, or None to go on down the exact path. Off (the
    default), one knob read."""
    mode = sample_store.approx_mode()
    if mode == "0":
        return None
    fraction = requested_fraction()
    if fraction is None:
        return None
    from ..telemetry import attribution, plan_stats, trace
    from ..telemetry.metrics import REGISTRY

    sp = build_sampled_plan(session, optimized, fraction)
    stats = attribution.current_stats()
    if isinstance(sp, str):
        APPROX.note_ineligible()
        REGISTRY.counter("approx.ineligible").inc()
        REGISTRY.counter(f"approx.ineligible.{sp}").inc()
        if trace.enabled():
            trace.add_event("approx:ineligible", reason=sp, fraction=fraction)
        declined = {"requested_f": fraction, "engaged": False, "reason": sp}
        if stats is not None:
            stats.note_approx(declined)
        col = plan_stats.current()
        if col is not None:
            col.note_approx(declined)
        return None

    from .executor import execute_plan

    # the sampled plan bypasses DataFrame.optimized_plan (it derives from
    # the already-optimized exact plan), so under HYPERSPACE_VERIFY_PLAN=1
    # it gets its own verifier pass here: the SAMPLE_* codes check the twin
    # substitution before it can execute
    from ..staticcheck.plan_verifier import maybe_verify_plan

    maybe_verify_plan(sp.plan, session)

    with trace.span("approx:sample", fraction=fraction, scans=len(sp.scan_plan_ids)) as span:
        raw = execute_plan(sp.plan, session)
        out, estimates, info = _finalize(raw, sp)
        span.set_attr("rows_out", out.num_rows)

    route = f"sampled(f={fraction:g})"
    col = plan_stats.current()
    if col is not None:
        col.note_plan_override(sp.plan)
        col.note_route(sp.agg_plan_id, route)
        for pid in sp.scan_plan_ids:
            col.note_route(pid, route)
        col.note_approx(info)
    REGISTRY.counter("approx.sampled").inc()
    APPROX.note_sampled(info["mean_ci_rel"])
    if stats is not None:
        stats.note_approx({"engaged": True, **info})

    if mode == "verify":
        with trace.span("approx:verify", fraction=fraction):
            exact = execute_plan(optimized, session)
            violations, missed = _coverage_violations(out, estimates, exact, sp)
        APPROX.note_verified()
        REGISTRY.counter("approx.verify.checked").inc()
        if missed:
            REGISTRY.counter("approx.verify.groups_missed").inc(missed)
        if violations:
            REGISTRY.counter("approx.verify.violations").inc(len(violations))
            raise ApproxVerifyError(
                f"approx verify: {len(violations)} CI(s) fail to cover the "
                f"exact answer at f={fraction:g} "
                f"(safety={ci_safety():g}): " + "; ".join(violations[:5])
            )
    return out
