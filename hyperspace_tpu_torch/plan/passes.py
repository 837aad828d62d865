"""Column pruning (counterpart of hyperspace_tpu/plan/passes.py, projection
pushdown only).

It runs before the Hyperspace rewrite, so the rules see each scan's real
column needs (a Filter -> Scan with no projection otherwise "requires" every
relation column and covering indexes are wrongly rejected), and again after
it, so index scans read only the columns the query uses.
"""

from __future__ import annotations

from .nodes import Aggregate, FileScan, Filter, LogicalPlan, Project, Sort


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    return _prune(plan, set(plan.schema.names))


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
    if isinstance(plan, Sort):
        child_req = set(required)
        for e, _asc in plan.orders:
            child_req |= e.references()
        return Sort(plan.orders, _prune(plan.child, child_req))
    return plan
