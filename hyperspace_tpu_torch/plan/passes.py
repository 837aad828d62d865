"""Column pruning, filter pushdown through joins and predicate pushdown
into scans (counterpart of hyperspace_tpu/plan/passes.py; the pushed
filter feeds index pruning only, it is not turned into a parquet reader
filter).

Pruning runs before the Hyperspace rewrite, so the rules see each scan's
real column needs (a Filter -> Scan with no projection otherwise "requires"
every relation column and covering indexes are wrongly rejected), and again
after it, so index scans read only the columns the query uses. Filter
pushdown runs before it: a single-side conjunct above a join (Q3's
o_orderdate bound) must sit on its side, or the aggregate's child is a
Filter, not a Join, and no join path fires.
"""

from __future__ import annotations

from .expr import And, Expr, split_conjunction
from .nodes import Aggregate, FileScan, Filter, Join, LogicalPlan, Project, RepartitionByExpr, Sort


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
