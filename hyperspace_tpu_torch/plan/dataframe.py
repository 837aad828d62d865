"""Lazy DataFrame frontend (counterpart of hyperspace_tpu/plan/dataframe.py).

Every DataFrame op builds logical nodes lazily; collect() runs filter
pushdown through joins and column pruning, the session's extra
optimizations (the Hyperspace rewrite when enabled), predicate pushdown
into scans, column pruning again and index pruning (all in a ``plan``
span), then hands the plan to the executor (in a ``query`` span).
``explain(analyze=True)`` is EXPLAIN ANALYZE. ``session.read`` builds the leaf: a FileScan over the files
of parquet, CSV, JSON, ORC, text or avro roots, with glob roots expanded,
a declared ``globbingPattern`` checked and recorded, and hive-style
``key=value`` directories as partition columns. A dotted column name
binds to a struct's flattened leaf (``__hs_nested.a.b``).
"""

from __future__ import annotations

import fnmatch
import glob as _glob
import os
from typing import Sequence

from .expr import Alias, Col, Expr, Lit, col, map_cols
from .nodes import (
    Aggregate,
    FileScan,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Sort,
    Union,
)
from .executor import execute_plan
from .. import constants as C
from ..columnar import io as cio
from ..columnar.table import ColumnBatch, Schema
from ..exceptions import HyperspaceError


def _glob_segments_match(path: str, pattern: str) -> bool:
    """fnmatch per path component: ``*`` never crosses a separator."""
    p_segs, g_segs = path.split(os.sep), pattern.split(os.sep)
    return len(p_segs) == len(g_segs) and all(
        fnmatch.fnmatch(p, g) for p, g in zip(p_segs, g_segs))


def _first_unmatched(paths: list[str], patterns: list[str]) -> str | None:
    """The first path no pattern covers; None when all are covered."""
    for p in paths:
        if not any(_glob_segments_match(os.path.abspath(p), os.path.abspath(g))
                   for g in patterns):
            return p
    return None


def _to_expr(c) -> Expr:
    if isinstance(c, Expr):
        return c
    if isinstance(c, str):
        return col(c)
    return Lit(c)


def resolve_nested_refs(e: Expr, schema: Schema, alias_bare: bool = False) -> Expr:
    """A dotted ``col("a.b.c")`` bound to the schema's flattened
    ``__hs_nested.a.b.c`` when the schema has it (case-insensitively); with
    ``alias_bare``, a bare column so rewritten keeps the user's name."""
    names = set(schema.names)
    if not any(n.startswith(C.NESTED_FIELD_PREFIX) for n in names):
        return e
    lower = {n.lower(): n for n in names}

    def fix(c: Col) -> Col:
        if c.name in names:
            return c
        cand = lower.get((C.NESTED_FIELD_PREFIX + c.name).lower())
        return Col(cand) if cand is not None else c

    out = map_cols(e, fix)
    if alias_bare and isinstance(e, Col) and isinstance(out, Col) and out.name != e.name:
        return Alias(out, e.name)
    return out


class DataFrame:
    def __init__(self, session, plan: LogicalPlan):
        self.session = session
        self.plan = plan

    def _r(self, e: Expr, alias_bare: bool = False) -> Expr:
        return resolve_nested_refs(e, self.plan.schema, alias_bare)

    def filter(self, condition: Expr) -> "DataFrame":
        return DataFrame(self.session, Filter(self._r(condition), self.plan))

    where = filter

    def select(self, *cols) -> "DataFrame":
        exprs = [self._r(_to_expr(c), alias_bare=True) for c in cols]
        return DataFrame(self.session, Project(exprs, self.plan))

    def with_column(self, name: str, e: Expr) -> "DataFrame":
        """Every other column, then ``e`` as ``name`` (last)."""
        exprs: list[Expr] = [col(n) for n in self.schema.names if n != name]
        exprs.append(_to_expr(e).alias(name))
        return DataFrame(self.session, Project(exprs, self.plan))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        exprs = [col(n).alias(new) if n == old else col(n) for n in self.schema.names]
        return DataFrame(self.session, Project(exprs, self.plan))

    def join(self, other: "DataFrame", condition: Expr, how: str = "inner") -> "DataFrame":
        both = Schema(list(self.plan.schema) + list(other.plan.schema))
        return DataFrame(self.session, Join(self.plan, other.plan,
                                            resolve_nested_refs(condition, both), how))

    def group_by(self, *cols) -> "GroupedData":
        # keys stay bare Cols (the device paths match on Col); a nested key
        # comes out under its full __hs_nested. name
        return GroupedData(self, [self._r(_to_expr(c)) for c in cols])

    groupBy = group_by

    def agg(self, *aggs: Expr) -> "DataFrame":
        return DataFrame(self.session, Aggregate([], [self._r(a) for a in aggs], self.plan))

    def sort(self, *cols, ascending: bool | Sequence[bool] = True) -> "DataFrame":
        exprs = [self._r(_to_expr(c)) for c in cols]
        if isinstance(ascending, bool):
            orders = [(e, ascending) for e in exprs]
        else:
            orders = list(zip(exprs, ascending))
        return DataFrame(self.session, Sort(orders, self.plan))

    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, Limit(n, self.plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session, Union([self.plan, other.plan]))

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    @property
    def columns(self) -> list[str]:
        return self.schema.names

    def __getitem__(self, name: str) -> Col:
        self.schema.field(name)  # raises on an unknown column
        return col(name)

    def optimized_plan(self) -> LogicalPlan:
        from .passes import pre_rewrite_plan, prune_columns, push_predicates
        from .pruning import apply_pruning
        from ..telemetry import attribution, trace

        with trace.span("plan"), attribution.phase("plan"):
            plan = pre_rewrite_plan(self.plan)
            for rule in self.session.extra_optimizations:
                plan = rule(plan)
            # scan-level passes after the rewrite, so index scans get them
            # too; index pruning last: it reads the filters pushed just
            # before
            plan = apply_pruning(prune_columns(push_predicates(plan)), self.session)
            # HYPERSPACE_VERIFY_PLAN=1: enforce the structural invariants
            # of the final plan (read-only walk; raises PlanInvariantError)
            from ..staticcheck.plan_verifier import maybe_verify_plan

            maybe_verify_plan(plan, self.session)
            return plan

    def explain_plan(self, optimized: bool = True) -> str:
        return (self.optimized_plan() if optimized else self.plan).pretty()

    def explain(self, analyze: bool = False, redirect=None):
        """The optimized plan tree; ``analyze=True`` executes the query once
        with the plan-statistics collector installed and returns the tree
        annotated with per-node actual rows, wall time, route and bytes and
        the estimator q-errors (the same route and bits as ``collect``)."""
        if not analyze:
            s = self.explain_plan()
        else:
            from ..analysis.explain import explain_analyze_string

            s = explain_analyze_string(self.session, self)
        if redirect is not None:
            redirect(s)
            return None
        return s

    def collect(self) -> ColumnBatch:
        """Plan and execute. A direct collect opens its own
        ``collect:<RootKind>`` record in the per-query ledger
        (telemetry/attribution.py), so the query log and the slow-query
        log cover ad-hoc queries too; a served query (an attribution scope
        already installed by the scheduler) keeps the scheduler's record."""
        from ..telemetry import attribution

        if attribution.current_stats() is not None:
            return self._collect_inner()
        from ..serve.context import QueryCancelledError, QueryContext
        from ..telemetry.attribution import LEDGER

        stats = LEDGER.begin(QueryContext(label=f"collect:{self.plan.kind}"))
        outcome, error = "done", None
        try:
            with attribution.scope(stats):
                return self._collect_inner()
        except QueryCancelledError as e:
            outcome, error = "cancelled", e
            raise
        except BaseException as e:
            outcome, error = "failed", e
            raise
        finally:
            # after the scope exited: the rollups are not charged back
            LEDGER.finish(stats, outcome, error)

    def _collect_inner(self) -> ColumnBatch:
        """Plan and execute, in the JAX package's order: a pin scope keeps
        every index snapshot the rewrite resolves on disk until the query
        drains (released on success, failure and cancellation alike), and
        ``serve_collect`` is the result-cache chokepoint: with
        ``HYPERSPACE_RESULT_CACHE`` on, a plan whose (fingerprint, pinned
        snapshots) key repeats is served from the cache with no scan,
        upload or dispatch, and otherwise it executes exactly as before.
        ``plan_stats.maybe_scope`` installs a per-node statistics collector
        only under ``HYPERSPACE_PLAN_STATS=1`` (EXPLAIN ANALYZE installs its
        own outside); with tracing on, the run is one ``query`` span.
        Before the exact path, the sampled tier may answer the query
        (plan/sampling.py: ``HYPERSPACE_APPROX`` and a requested fraction);
        the exact path is ``adaptive.execute_collect``, which is
        ``serve_collect`` with ``HYPERSPACE_ADAPTIVE=0`` and otherwise
        re-plans a scan that aborted mid-stream against the same pinned
        snapshot."""
        from ..ingest.snapshots import pin_scope
        from ..telemetry import plan_stats, trace, workload
        from . import adaptive, sampling

        def run() -> ColumnBatch:
            optimized = self.optimized_plan()
            plan_stats.note_plan(optimized)
            # the workload plane's shapes, join keys and columns (a no-op
            # with HYPERSPACE_WORKLOAD_DIR unset)
            workload.note_plan(optimized)
            approx = sampling.maybe_execute_sampled(self.session, optimized)
            if approx is not None:
                return approx
            return adaptive.execute_collect(self.session, self.plan, optimized,
                                            self.optimized_plan)

        if not trace.enabled():
            with plan_stats.maybe_scope(), pin_scope():
                return run()
        with plan_stats.maybe_scope(), trace.span("query") as sp, pin_scope():
            out = run()
            sp.set_attr("rows_out", out.num_rows)
            return out

    def to_pydict(self) -> dict[str, list]:
        return self.collect().to_pydict()

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    def count(self) -> int:
        return self.collect().num_rows

    def write_parquet(self, path: str, filename: str = "part-0.parquet") -> None:
        cio.write_parquet(self.collect(), os.path.join(path, filename))


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs: list[Expr]):
        self._df = df
        self._group_exprs = group_exprs

    def agg(self, *aggs: Expr) -> DataFrame:
        return DataFrame(self._df.session, Aggregate(
            self._group_exprs, [self._df._r(a) for a in aggs], self._df.plan))


class DataFrameReader:
    """``session.read``: options, then ``parquet``, ``csv``, ``json``,
    ``orc``, ``text`` or ``format(f).load`` of a path or paths; each builds
    a FileScan over the resolved files."""

    def __init__(self, session):
        self.session = session
        self._options: dict[str, str] = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = str(value)
        return self

    def _load(self, fmt: str, path: str | Sequence[str]) -> DataFrame:
        from ..sources.interfaces import encode_glob_paths, expand_glob_roots, relist_files
        from ..utils.partitions import infer_partition_fields

        roots = [path] if isinstance(path, str) else list(path)
        had_glob = any(_glob.has_magic(r) for r in roots)
        expanded = expand_glob_roots(roots)
        declared = (self._options.get(C.GLOBBING_PATTERN_KEY)
                    or self._options.get("globbingPattern"))
        if declared:
            # the whole string first (a path may hold a comma), then the
            # comma-separated patterns
            whole = [str(declared)]
            parts = [p.strip() for p in str(declared).split(",") if p.strip()]
            patterns = whole if _first_unmatched(expanded, whole) is None else parts
            bad = _first_unmatched(expanded, patterns)
            if bad is not None:
                raise HyperspaceError(
                    f"Path {bad!r} does not match the declared globbing pattern {declared!r}")
            # the declared pattern is the relation's scope: refresh expands it
            self._options[C.OPT_GLOB_PATHS] = encode_glob_paths(patterns)
        elif had_glob:
            self._options[C.OPT_GLOB_PATHS] = encode_glob_paths(roots)
        else:
            # a reused reader never inherits an earlier load's scope
            self._options.pop(C.OPT_GLOB_PATHS, None)
        roots = [os.path.abspath(r) for r in expanded]
        for root in roots:
            if not (os.path.isfile(root) or os.path.isdir(root)):
                raise HyperspaceError(f"Path not found: {root}")
        files = relist_files(roots)
        if not files:
            raise HyperspaceError(f"No data files under {roots}")
        schema = cio.read_schema(fmt, files[0].name)
        part_fields = [f for f in infer_partition_fields([fi.name for fi in files], roots)
                       if f.name not in schema]
        if part_fields:
            schema = Schema(list(schema.fields) + part_fields)
        scan = FileScan(roots, fmt, schema, files, options=self._options,
                        partition_columns=[f.name for f in part_fields])
        return DataFrame(self.session, scan)

    def parquet(self, path) -> DataFrame:
        return self._load("parquet", path)

    def csv(self, path) -> DataFrame:
        return self._load("csv", path)

    def json(self, path) -> DataFrame:
        return self._load("json", path)

    def orc(self, path) -> DataFrame:
        return self._load("orc", path)

    def text(self, path) -> DataFrame:
        return self._load("text", path)

    def format(self, fmt: str) -> "_FormatReader":
        return _FormatReader(self, fmt)


class _FormatReader:
    """``session.read.format(fmt)``; ``load(path)`` reads it."""

    def __init__(self, reader: DataFrameReader, fmt: str):
        self._reader = reader
        self._fmt = fmt

    def load(self, path) -> DataFrame:
        return self._reader._load(self._fmt, path)
