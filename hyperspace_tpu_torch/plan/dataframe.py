"""Lazy DataFrame frontend (counterpart of hyperspace_tpu/plan/dataframe.py).

Every DataFrame op builds logical nodes lazily; collect() runs filter
pushdown through joins and column pruning, the session's extra
optimizations (the Hyperspace rewrite when enabled), predicate pushdown
into scans, column pruning again and index pruning, then hands the plan to
the executor.
"""

from __future__ import annotations

import os
from typing import Sequence

from .expr import Expr, Lit, col
from .nodes import Aggregate, FileScan, Filter, Join, Limit, LogicalPlan, Project, Sort
from .executor import execute_plan
from ..columnar import io as cio
from ..columnar.table import ColumnBatch, Schema
from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo


def _to_expr(c) -> Expr:
    if isinstance(c, Expr):
        return c
    if isinstance(c, str):
        return col(c)
    return Lit(c)


class DataFrame:
    def __init__(self, session, plan: LogicalPlan):
        self.session = session
        self.plan = plan

    def filter(self, condition: Expr) -> "DataFrame":
        return DataFrame(self.session, Filter(condition, self.plan))

    where = filter

    def select(self, *cols) -> "DataFrame":
        return DataFrame(self.session, Project([_to_expr(c) for c in cols], self.plan))

    def join(self, other: "DataFrame", condition: Expr, how: str = "inner") -> "DataFrame":
        return DataFrame(self.session, Join(self.plan, other.plan, condition, how))

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [_to_expr(c) for c in cols])

    def agg(self, *aggs: Expr) -> "DataFrame":
        return DataFrame(self.session, Aggregate([], list(aggs), self.plan))

    def sort(self, *cols, ascending: bool | Sequence[bool] = True) -> "DataFrame":
        exprs = [_to_expr(c) for c in cols]
        if isinstance(ascending, bool):
            orders = [(e, ascending) for e in exprs]
        else:
            orders = list(zip(exprs, ascending))
        return DataFrame(self.session, Sort(orders, self.plan))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, Limit(n, self.plan))

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    def optimized_plan(self) -> LogicalPlan:
        from .passes import pre_rewrite_plan, prune_columns, push_predicates
        from .pruning import apply_pruning

        plan = pre_rewrite_plan(self.plan)
        for rule in self.session.extra_optimizations:
            plan = rule(plan)
        # scan-level passes after the rewrite, so index scans get them too;
        # index pruning last: it reads the filters pushed just before
        return apply_pruning(prune_columns(push_predicates(plan)))

    def collect(self) -> ColumnBatch:
        return execute_plan(self.optimized_plan(), self.session)

    def to_pydict(self) -> dict[str, list]:
        return self.collect().to_pydict()


class GroupedData:
    def __init__(self, df: DataFrame, group_exprs: list[Expr]):
        self._df = df
        self._group_exprs = group_exprs

    def agg(self, *aggs: Expr) -> DataFrame:
        return DataFrame(
            self._df.session, Aggregate(self._group_exprs, list(aggs), self._df.plan)
        )


def _data_files(root: str) -> list[FileInfo]:
    """The data files under a directory, hidden and metadata dirs and files
    (``_*``, ``.*``, e.g. _hyperspace_log) skipped."""
    files: list[FileInfo] = []
    for dirpath, _dirs, names in os.walk(root):
        parts = os.path.relpath(dirpath, root).split(os.sep)
        if any(p.startswith(("_", ".")) for p in parts if p != "."):
            continue
        for fn in sorted(names):
            if not fn.startswith(("_", ".")):
                files.append(FileInfo.from_path(os.path.join(dirpath, fn)))
    return files


def relist_files(root_paths: Sequence[str]) -> list[FileInfo]:
    """A fresh listing of a recorded relation's roots (refresh and the
    hybrid-scan delta read the source as it is now)."""
    files: list[FileInfo] = []
    for root in root_paths:
        if os.path.isfile(root):
            files.append(FileInfo.from_path(root))
        elif os.path.isdir(root):
            files.extend(_data_files(root))
        else:
            raise HyperspaceError(f"Source path disappeared: {root}")
    return files


class DataFrameReader:
    """session.read.parquet(path) -> a FileScan over the resolved files."""

    def __init__(self, session):
        self.session = session

    def parquet(self, path: str | Sequence[str]) -> DataFrame:
        roots = [path] if isinstance(path, str) else list(path)
        files: list[FileInfo] = []
        for root in roots:
            root = os.path.abspath(root)
            if os.path.isfile(root):
                files.append(FileInfo.from_path(root))
            elif os.path.isdir(root):
                files.extend(_data_files(root))
            else:
                raise HyperspaceError(f"Path not found: {root}")
        if not files:
            raise HyperspaceError(f"No data files under {roots}")
        schema = cio.read_parquet_schema(files[0].name)
        scan = FileScan([os.path.abspath(r) for r in roots], "parquet", schema, files)
        return DataFrame(self.session, scan)
