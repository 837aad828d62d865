"""Column pruning, filter pushdown through joins and predicate pushdown
into scans (counterpart of hyperspace_tpu/plan/passes.py). The pushed
filter drives index pruning, and ``to_arrow_filter`` turns it into the
parquet reader's filter for the host's reads of source files.

Pruning runs before the Hyperspace rewrite, so the rules see each scan's
real column needs (a Filter -> Scan with no projection otherwise "requires"
every relation column and covering indexes are wrongly rejected), and again
after it, so index scans read only the columns the query uses. Filter
pushdown runs before it: a single-side conjunct above a join (Q3's
o_orderdate bound) must sit on its side, or the aggregate's child is a
Filter, not a Join, and no join path fires.
"""

from __future__ import annotations

import datetime

from . import expr as X
from .expr import And, Expr, split_conjunction
from .nodes import Aggregate, FileScan, Filter, Join, LogicalPlan, Project, RepartitionByExpr, Sort
from ..columnar.table import DATE32, Schema


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    return _prune(plan, set(plan.schema.names))


def pre_rewrite_plan(plan: LogicalPlan) -> LogicalPlan:
    """The passes that run before the Hyperspace rewrite: filter pushdown
    through joins, then column pruning."""
    return prune_columns(push_filters_through_joins(plan))


def _prune(plan: LogicalPlan, required: set[str]) -> LogicalPlan:
    if isinstance(plan, FileScan):
        cols = [n for n in plan.full_schema.names if n in required]
        if set(cols) == set(plan.full_schema.names):
            return plan
        existing = plan.required_columns
        if existing is not None and set(existing) <= set(cols):
            return plan
        return plan.copy(required_columns=cols)
    if isinstance(plan, Filter):
        return Filter(plan.condition, _prune(plan.child, required | plan.condition.references()))
    if isinstance(plan, Project):
        child_req: set[str] = set()
        for e in plan.exprs:
            child_req |= e.references()
        return Project(plan.exprs, _prune(plan.child, child_req))
    if isinstance(plan, Aggregate):
        child_req = set()
        for e in plan.group_exprs + plan.agg_exprs:
            child_req |= e.references()
        return Aggregate(plan.group_exprs, plan.agg_exprs, _prune(plan.child, child_req))
    if isinstance(plan, Join):
        cond_refs = plan.condition.references() if plan.condition else set()
        need = required | cond_refs
        left = _prune(plan.left, {c for c in need if c in plan.left.schema})
        right = _prune(plan.right, {c for c in need if c in plan.right.schema})
        return Join(left, right, plan.condition, plan.how)
    if isinstance(plan, Sort):
        child_req = set(required)
        for e, _asc in plan.orders:
            child_req |= e.references()
        return Sort(plan.orders, _prune(plan.child, child_req))
    if isinstance(plan, RepartitionByExpr):
        child_req = set(required)
        for e in plan.exprs:
            child_req |= e.references()
        return RepartitionByExpr(plan.exprs, plan.num_partitions, _prune(plan.child, child_req))
    if plan.children():  # Limit, Union, BucketUnion
        return plan.with_new_children([_prune(c, set(required)) for c in plan.children()])
    return plan


def push_predicates(plan: LogicalPlan) -> LogicalPlan:
    """Attach the condition of a Filter directly above a FileScan to the
    scan as its pushed filter (the Filter stays and applies it)."""

    def visit(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Filter) and isinstance(node.child, FileScan):
            scan = node.child
            if scan.fmt == "parquet" and scan.pushed_filter is None:
                return Filter(node.condition, scan.copy(pushed_filter=node.condition))
        return node

    return plan.transform_up(visit)


def push_filters_through_joins(plan: LogicalPlan) -> LogicalPlan:
    """Move conjuncts that reference only one side of an inner join below
    it (Spark's PushPredicateThroughJoin)."""

    def conjoin(exprs: list[Expr]) -> Expr:
        out = exprs[0]
        for e in exprs[1:]:
            out = And(out, e)
        return out

    def visit(node: LogicalPlan) -> LogicalPlan:
        if not (isinstance(node, Filter) and isinstance(node.child, Join)):
            return node
        join = node.child
        if join.how != "inner":
            return node
        left_cols = set(join.left.schema.names)
        right_cols = set(join.right.schema.names)
        to_left: list[Expr] = []
        to_right: list[Expr] = []
        keep: list[Expr] = []
        for conj in split_conjunction(node.condition):
            refs = conj.references()
            if refs and refs <= left_cols:
                to_left.append(conj)
            elif refs and refs <= right_cols:
                to_right.append(conj)
            else:
                keep.append(conj)
        if not to_left and not to_right:
            return node
        new_left = Filter(conjoin(to_left), join.left) if to_left else join.left
        new_right = Filter(conjoin(to_right), join.right) if to_right else join.right
        new_join = Join(new_left, new_right, join.condition, join.how)
        return Filter(conjoin(keep), new_join) if keep else new_join

    return plan.transform_up(visit)


_ARROW_CMP = {
    X.Eq: lambda f, v: f == v,
    X.Ne: lambda f, v: f != v,
    X.Lt: lambda f, v: f < v,
    X.Le: lambda f, v: f <= v,
    X.Gt: lambda f, v: f > v,
    X.Ge: lambda f, v: f >= v,
}
_ARROW_FLIP = {X.Lt: X.Gt, X.Le: X.Ge, X.Gt: X.Lt, X.Ge: X.Le, X.Eq: X.Eq, X.Ne: X.Ne}


def to_arrow_filter(cond: Expr, schema: Schema):
    """The conjuncts of ``cond`` that translate, as one pyarrow.compute
    expression (the rest are dropped: the plan's Filter applies the whole
    condition again); None when none translates."""
    parts = [p for c in split_conjunction(cond) if (p := _leaf_to_arrow(c, schema)) is not None]
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = out & p
    return out


def _literal_for(col_name: str, value, schema: Schema):
    """A date column's int literal (days since the epoch) as a date32
    scalar; any other literal as it is."""
    import pyarrow as pa

    if schema.field(col_name).dtype == DATE32 and isinstance(value, int):
        return pa.scalar(datetime.date(1970, 1, 1) + datetime.timedelta(days=value),
                         pa.date32())
    return value


def _leaf_to_arrow(e: Expr, schema: Schema):
    import pyarrow.compute as pc

    from ..constants import NESTED_FIELD_PREFIX

    # a flattened nested column lives inside a struct in source files: its
    # dotted name is no arrow field there, so it is never pushed
    if any(r.startswith(NESTED_FIELD_PREFIX) for r in e.references()):
        return None
    if type(e) in _ARROW_CMP:
        for a, b, kind in ((e.left, e.right, type(e)), (e.right, e.left, _ARROW_FLIP[type(e)])):
            if isinstance(a, X.Col) and isinstance(b, X.Lit):
                if a.name not in schema:
                    return None
                return _ARROW_CMP[kind](pc.field(a.name), _literal_for(a.name, b.value, schema))
        return None
    if isinstance(e, X.In) and isinstance(e.child, X.Col) and e.child.name in schema:
        return pc.field(e.child.name).isin(
            [_literal_for(e.child.name, v, schema) for v in e.values])
    if isinstance(e, X.Or):
        # an Or is sound only when both sides translate
        left, right = _leaf_to_arrow(e.left, schema), _leaf_to_arrow(e.right, schema)
        return left | right if left is not None and right is not None else None
    if isinstance(e, X.IsNotNull) and isinstance(e.child, X.Col) and e.child.name in schema:
        return ~pc.field(e.child.name).is_null()
    return None
