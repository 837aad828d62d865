"""AggregateIndexRule: rewrite a grouped aggregation over a bare scan to a
bucketed covering-index scan (counterpart of
hyperspace_tpu/rules/agg_rule.py).

When the GROUP BY keys contain an index's bucket columns, every group lives
in one bucket, so the aggregation is parallel per bucket
(plan/bucket_join.try_bucketed_scan_aggregate); swapping in the bucketed
index scan buys both the column slice and that per-bucket aggregation. The
score (40 per scan) sits below the Filter rule's 50 and the Join rule's 70,
so those win where both apply.
"""

from __future__ import annotations

from typing import Optional

from .base import (
    HyperspaceRule,
    IndexRankFilter,
    MISSING_INDEXED_COL,
    MISSING_REQUIRED_COL,
    QueryPlanIndexFilter,
    TAG_HYBRIDSCAN_REQUIRED,
    index_type_filter,
    reason,
)
from .rule_utils import (
    common_bytes_ratio,
    find_scan_by_id,
    is_plan_linear,
    log_index_usage,
    subtree_required_columns,
    transform_plan_to_use_index,
)
from ..plan.expr import Col
from ..plan.nodes import Aggregate, FileScan, LogicalPlan


def match_aggregate_pattern(plan: LogicalPlan) -> Optional[tuple[Aggregate, FileScan]]:
    """An Aggregate grouped by plain columns over Project/Filter over one scan."""
    if not isinstance(plan, Aggregate) or not plan.group_exprs:
        return None
    if not all(isinstance(e, Col) for e in plan.group_exprs):
        return None
    if not is_plan_linear(plan.child):
        return None
    scans = [n for n in plan.child.preorder() if isinstance(n, FileScan)]
    if len(scans) != 1:
        return None
    return plan, scans[0]


class AggPlanNodeFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates):
        m = match_aggregate_pattern(plan)
        if m is None:
            return {}
        _, scan = m
        ci = index_type_filter("CI")(candidates.get(scan.plan_id, []))
        return {scan.plan_id: ci} if ci else {}


class AggColumnFilter(QueryPlanIndexFilter):
    """Usable indexes: indexed columns within the group keys (so groups are
    disjoint across buckets), every column the subtree needs covered."""

    def apply(self, plan, candidates):
        m = match_aggregate_pattern(plan)
        if m is None:
            return {}
        agg, scan = m
        group_cols = {e.name.lower() for e in agg.group_exprs}
        required = {c.lower() for c in subtree_required_columns(agg.child)}
        for e in agg.group_exprs + agg.agg_exprs:
            required |= {c.lower() for c in e.references()}
        out = []
        for e in candidates.get(scan.plan_id, []):
            indexed = {c.lower() for c in e.derived_dataset.indexed_columns()}
            covered = {c.lower() for c in e.derived_dataset.referenced_columns()}
            if not self.tag_reason_if(
                indexed <= group_cols, plan, e,
                reason(MISSING_INDEXED_COL,
                       "GROUP BY keys must contain all indexed columns.",
                       indexed=sorted(indexed), groupBy=sorted(group_cols)),
            ):
                continue
            if not self.tag_reason_if(
                required <= covered, plan, e,
                reason(MISSING_REQUIRED_COL,
                       "The index does not cover all required columns.",
                       missing=sorted(required - covered)),
            ):
                continue
            self.tag_applicable_rule(plan, e, "AggregateIndexRule")
            out.append(e)
        return {scan.plan_id: out} if out else {}


class AggIndexRanker(IndexRankFilter):
    """An entry that needs no hybrid scan first (appended rows cost the
    per-bucket path a re-bucketing), then the smallest, then the name."""

    def apply(self, plan, candidates):
        return {
            leaf_id: min(entries, key=lambda e: (
                bool(e.get_tag(leaf_id, TAG_HYBRIDSCAN_REQUIRED)),
                e.index_data_size_in_bytes(), e.name))
            for leaf_id, entries in candidates.items()
            if entries
        }


class AggregateIndexRule(HyperspaceRule):
    @property
    def filters(self):
        return [AggPlanNodeFilter(self.session), AggColumnFilter(self.session)]

    @property
    def rank_filter(self):
        return AggIndexRanker(self.session)

    def apply_index(self, plan, chosen):
        out = plan
        for leaf_id, entry in chosen.items():
            out = transform_plan_to_use_index(self.session, entry, out, leaf_id, True, True)
            log_index_usage(self.session, "AggregateIndexRule", [entry.name],
                            f"Aggregate index applied: {entry.name}")
        return out

    def score(self, plan, chosen):
        total = 0.0
        for leaf_id, entry in chosen.items():
            total += 40 * common_bytes_ratio(entry, find_scan_by_id(plan, leaf_id))
        return int(total)
