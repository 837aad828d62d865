"""Logical plan IR (counterpart of hyperspace_tpu/plan/nodes.py, reduced to
the nodes of the covering-index filter-aggregate and join paths and of
hybrid scan: scans, Filter, Project, Join, Aggregate, Sort, Limit, Union,
BucketUnion, RepartitionByExpr).

DataFrame ops build these nodes lazily; at collect the session's extra
optimizations (the Hyperspace rewrite when enabled) run, then the executor
lowers the final plan.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from . import expr as X
from .expr import Alias, Col, Expr, expr_output_name
from ..columnar.table import ColumnBatch, Field, Schema, STRING
from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo

_plan_ids = itertools.count()


@dataclass(frozen=True)
class BucketSpec:
    """Hash-bucket layout of a file set: what the join rule's rewrite
    carries so the executor can join bucket b with bucket b."""

    num_buckets: int
    bucket_columns: tuple[str, ...]
    sort_columns: tuple[str, ...] = ()


@dataclass
class IndexScanInfo:
    """Marks a scan as reading index data."""

    index_name: str
    index_kind_abbr: str
    log_version: int


class LogicalPlan:
    def __init__(self, children: Sequence["LogicalPlan"]):
        self.children_nodes = list(children)
        self.plan_id = next(_plan_ids)

    @property
    def kind(self) -> str:
        return type(self).__name__

    def children(self) -> list["LogicalPlan"]:
        return self.children_nodes

    def with_new_children(self, children: Sequence["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def transform_up(
        self, fn: Callable[["LogicalPlan"], "LogicalPlan"]
    ) -> "LogicalPlan":
        new_children = [c.transform_up(fn) for c in self.children()]
        node = self
        if any(nc is not oc for nc, oc in zip(new_children, self.children())):
            node = self.with_new_children(new_children)
        return fn(node)

    def preorder(self) -> list["LogicalPlan"]:
        out = [self]
        for c in self.children():
            out.extend(c.preorder())
        return out

    # --- signature protocol (meta.signatures.SignablePlan) ---
    def preorder_kinds(self) -> list[str]:
        return [n.kind for n in self.preorder()]

    def leaf_file_infos(self) -> list[list[FileInfo]]:
        return [list(n.files) for n in self.preorder() if isinstance(n, FileScan)]

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def pretty(self, indent: int = 0) -> str:
        line = "  " * indent + self.describe()
        return "\n".join([line] + [c.pretty(indent + 1) for c in self.children()])

    def describe(self) -> str:
        return self.kind

    def __repr__(self):
        return self.pretty()


class _Unary(LogicalPlan):
    def __init__(self, child: LogicalPlan):
        super().__init__([child])

    @property
    def child(self) -> LogicalPlan:
        return self.children_nodes[0]


class FileScan(LogicalPlan):
    """Leaf scan over a file-based relation: the resolved file list,
    ``bucket_spec`` when it reads bucketed index data for a join,
    ``index_info`` when it reads index data, and the pruned column set.
    ``pushed_filter`` mirrors the condition of a Filter right above the
    scan (that Filter still applies it); ``prune_spec`` is the layout
    contract of a bucketed index scan (plan/pruning.PruneSpec), from which
    the pushed filter derives the buckets and row groups to read.
    ``lineage_filter_ids`` are the ids of deleted source files whose rows
    the scan drops by the index's lineage column (hybrid scan).
    ``sample_spec`` (plan/sampling.SampleSpec) marks a scan whose ``files``
    are the index data's sample twins; None for an exact scan.
    ``partition_columns`` are hive-style columns derived from ``key=value``
    directories; ``full_schema`` holds them after the files' own columns,
    and no file stores them."""

    def __init__(
        self,
        root_paths: Sequence[str],
        fmt: str,
        schema: Schema,
        files: Sequence[FileInfo],
        options: dict[str, str] | None = None,
        bucket_spec: Optional[BucketSpec] = None,
        index_info: Optional[IndexScanInfo] = None,
        lineage_filter_ids: Optional[Sequence[int]] = None,
        required_columns: Optional[Sequence[str]] = None,
        pushed_filter: Optional[Expr] = None,
        partition_columns: Optional[Sequence[str]] = None,
        prune_spec=None,
        sample_spec=None,
    ):
        super().__init__([])
        self.root_paths = list(root_paths)
        self.fmt = fmt
        self._schema = schema
        self.files = list(files)
        self.options = dict(options or {})
        self.bucket_spec = bucket_spec
        self.index_info = index_info
        self.lineage_filter_ids = (
            list(lineage_filter_ids) if lineage_filter_ids is not None else None
        )
        self.required_columns = list(required_columns) if required_columns else None
        self.pushed_filter = pushed_filter
        self.partition_columns = list(partition_columns or [])
        self.prune_spec = prune_spec
        self.sample_spec = sample_spec

    def with_new_children(self, children):
        if children:
            raise HyperspaceError("FileScan has no children")
        return self

    def copy(self, **kw) -> "FileScan":
        args = dict(
            root_paths=self.root_paths,
            fmt=self.fmt,
            schema=self._schema,
            files=self.files,
            options=self.options,
            bucket_spec=self.bucket_spec,
            index_info=self.index_info,
            lineage_filter_ids=self.lineage_filter_ids,
            required_columns=self.required_columns,
            pushed_filter=self.pushed_filter,
            partition_columns=self.partition_columns,
            prune_spec=self.prune_spec,
            sample_spec=self.sample_spec,
        )
        args.update(kw)
        return FileScan(**args)

    @property
    def schema(self) -> Schema:
        if self.required_columns:
            return self._schema.select(self.required_columns)
        return self._schema

    @property
    def full_schema(self) -> Schema:
        return self._schema

    def describe(self) -> str:
        extra = ""
        if self.index_info:
            extra = (
                f" Hyperspace(Type: {self.index_info.index_kind_abbr}, "
                f"Name: {self.index_info.index_name}, "
                f"LogVersion: {self.index_info.log_version})"
            )
        if self.bucket_spec:
            extra += f" buckets={self.bucket_spec.num_buckets}"
        if self.prune_spec is not None and self.prune_spec.active:
            extra += f" pruned[{self.prune_spec.describe()}]"
        if self.sample_spec is not None:
            extra += f" {self.sample_spec.describe()}"
        return (
            f"FileScan {self.fmt} [{', '.join(self.schema.names)}] "
            f"({len(self.files)} files){extra}"
        )


class InMemoryScan(LogicalPlan):
    def __init__(self, batch: ColumnBatch):
        super().__init__([])
        self.batch = batch

    def with_new_children(self, children):
        if children:
            raise HyperspaceError("InMemoryScan has no children")
        return self

    @property
    def schema(self) -> Schema:
        return self.batch.schema

    def describe(self) -> str:
        return f"InMemoryScan [{', '.join(self.schema.names)}] ({self.batch.num_rows} rows)"


class Filter(_Unary):
    def __init__(self, condition: Expr, child: LogicalPlan):
        super().__init__(child)
        self.condition = condition

    def with_new_children(self, children):
        return Filter(self.condition, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self) -> str:
        return f"Filter ({self.condition!r})"


class Project(_Unary):
    def __init__(self, exprs: Sequence[Expr], child: LogicalPlan):
        super().__init__(child)
        self.exprs = list(exprs)

    def with_new_children(self, children):
        return Project(self.exprs, children[0])

    @property
    def schema(self) -> Schema:
        in_schema = self.child.schema
        return Schema(
            [Field(expr_output_name(e), infer_dtype(e, in_schema)) for e in self.exprs]
        )

    def describe(self) -> str:
        return f"Project [{', '.join(expr_output_name(e) for e in self.exprs)}]"


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 condition: Optional[Expr], how: str = "inner"):
        super().__init__([left, right])
        self.condition = condition
        self.how = how

    @property
    def left(self) -> LogicalPlan:
        return self.children_nodes[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children_nodes[1]

    def with_new_children(self, children):
        return Join(children[0], children[1], self.condition, self.how)

    @property
    def schema(self) -> Schema:
        fields = list(self.left.schema.fields)
        seen = {f.name for f in fields}
        for f in self.right.schema.fields:
            if f.name in seen:
                raise HyperspaceError(
                    f"Ambiguous column {f.name!r} in join output; alias before joining"
                )
            fields.append(f)
        return Schema(fields)

    def describe(self) -> str:
        return f"Join {self.how} ({self.condition!r})"


class Aggregate(_Unary):
    def __init__(
        self,
        group_exprs: Sequence[Expr],
        agg_exprs: Sequence[Expr],
        child: LogicalPlan,
    ):
        super().__init__(child)
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)  # AggExpr or Alias(AggExpr)

    def with_new_children(self, children):
        return Aggregate(self.group_exprs, self.agg_exprs, children[0])

    @property
    def schema(self) -> Schema:
        in_schema = self.child.schema
        return Schema(
            [
                Field(expr_output_name(e), infer_dtype(e, in_schema))
                for e in self.group_exprs + self.agg_exprs
            ]
        )

    def describe(self) -> str:
        return (
            f"Aggregate group=[{', '.join(map(repr, self.group_exprs))}] "
            f"aggs=[{', '.join(map(repr, self.agg_exprs))}]"
        )


class Sort(_Unary):
    def __init__(self, orders: Sequence[tuple[Expr, bool]], child: LogicalPlan):
        super().__init__(child)
        self.orders = list(orders)  # [(expr, ascending)]

    def with_new_children(self, children):
        return Sort(self.orders, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self) -> str:
        return "Sort [" + ", ".join(
            f"{e!r} {'ASC' if asc else 'DESC'}" for e, asc in self.orders
        ) + "]"


class Limit(_Unary):
    def __init__(self, n: int, child: LogicalPlan):
        super().__init__(child)
        self.n = n

    def with_new_children(self, children):
        return Limit(self.n, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self) -> str:
        return f"Limit {self.n}"


class Union(LogicalPlan):
    def __init__(self, children: Sequence[LogicalPlan]):
        super().__init__(children)

    def with_new_children(self, children):
        return Union(children)

    @property
    def schema(self) -> Schema:
        return self.children_nodes[0].schema

    def describe(self) -> str:
        return "Union"


class BucketUnion(LogicalPlan):
    """A union of children that share one bucket layout: bucket i of the
    output is bucket i of each child, with no re-shuffle."""

    def __init__(self, children: Sequence[LogicalPlan], bucket_spec: BucketSpec):
        super().__init__(children)
        self.bucket_spec = bucket_spec

    def with_new_children(self, children):
        return BucketUnion(children, self.bucket_spec)

    @property
    def schema(self) -> Schema:
        return self.children_nodes[0].schema

    def describe(self) -> str:
        return (f"BucketUnion buckets={self.bucket_spec.num_buckets} on "
                f"{list(self.bucket_spec.bucket_columns)}")


class RepartitionByExpr(_Unary):
    """Co-partition rows by hash(exprs) % n. Hybrid scan puts one over the
    appended-files subplan only; the index side keeps its layout."""

    def __init__(self, exprs: Sequence[Expr], num_partitions: int, child: LogicalPlan):
        super().__init__(child)
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def with_new_children(self, children):
        return RepartitionByExpr(self.exprs, self.num_partitions, children[0])

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def describe(self) -> str:
        return f"RepartitionByExpr [{', '.join(map(repr, self.exprs))}] n={self.num_partitions}"


# ---------------------------------------------------------------------------
# type inference
# ---------------------------------------------------------------------------

_NUMERIC_ORDER = ["int8", "int16", "int32", "int64", "float32", "float64"]


def infer_dtype(e: Expr, schema: Schema) -> str:
    if isinstance(e, Alias):
        return infer_dtype(e.child, schema)
    if isinstance(e, Col):
        return schema.field(e.name).dtype
    if isinstance(e, X.Lit):
        v = e.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int64"
        if isinstance(v, float):
            return "float64"
        if isinstance(v, str):
            return STRING
        return "int32"
    if isinstance(e, (X.Eq, X.Ne, X.Lt, X.Le, X.Gt, X.Ge, X.And, X.Or, X.Not,
                      X.IsNull, X.IsNotNull, X.In)):
        return "bool"
    if isinstance(e, X.Div):
        return "float64"
    if isinstance(e, (X.Add, X.Sub, X.Mul)):
        lt = infer_dtype(e.left, schema)
        rt = infer_dtype(e.right, schema)
        widened = max(
            _NUMERIC_ORDER.index(lt) if lt in _NUMERIC_ORDER else 3,
            _NUMERIC_ORDER.index(rt) if rt in _NUMERIC_ORDER else 3,
        )
        return _NUMERIC_ORDER[widened]
    if isinstance(e, X.Count):
        return "int64"
    if isinstance(e, X.Avg):
        return "float64"
    if isinstance(e, (X.Min, X.Max, X.Sum)):
        inner = infer_dtype(e.child, schema)
        if isinstance(e, X.Sum) and inner in ("int8", "int16", "int32"):
            return "int64"
        return inner
    raise HyperspaceError(f"Cannot infer dtype of {e!r}")
