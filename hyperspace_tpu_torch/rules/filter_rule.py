"""FilterIndexRule: rewrite [Project ->] Filter -> Scan to a covering-index
scan (counterpart of hyperspace_tpu/rules/filter_rule.py).

An index qualifies when its first indexed column appears in the filter
condition and it covers every column the subtree needs. Among those the
ranker takes the least expected read: index bytes times the fraction
bucket pruning keeps for the condition (plan/pruning.estimate_scan_
fraction), name breaking ties. Score = 50 * covered-bytes ratio (1 without
hybrid scan) plus up to 10 for that pruning, which keeps the rule above
AggregateIndexRule's 40 and lets a bucket-prunable rewrite win a tie
against a z-order one.
"""

from __future__ import annotations

from typing import Optional

from .base import HyperspaceRule, IndexRankFilter, QueryPlanIndexFilter
from .rule_utils import (
    common_bytes_ratio,
    find_scan_by_id,
    subtree_required_columns,
    transform_plan_to_use_index,
)
from ..plan.nodes import FileScan, Filter, LogicalPlan, Project
from ..plan.pruning import estimate_scan_fraction


def match_filter_pattern(plan: LogicalPlan) -> Optional[tuple[Filter, FileScan]]:
    node = plan
    if isinstance(node, Project):
        node = node.child
    if isinstance(node, Filter) and isinstance(node.child, FileScan):
        return node, node.child
    return None


class FilterPlanNodeFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        if m is None:
            return {}
        _, scan = m
        return {scan.plan_id: candidates.get(scan.plan_id, [])}


class FilterColumnFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        if m is None:
            return {}
        filter_node, scan = m
        filter_refs = {c.lower() for c in filter_node.condition.references()}
        required = {c.lower() for c in subtree_required_columns(plan)} | filter_refs
        out = []
        for e in candidates.get(scan.plan_id, []):
            if e.derived_dataset.kind != "CI":
                continue
            indexed = [c.lower() for c in e.derived_dataset.indexed_columns()]
            covered = {c.lower() for c in e.derived_dataset.referenced_columns()}
            if indexed[0] in filter_refs and required <= covered:
                out.append(e)
        return {scan.plan_id: out} if out else {}


def _filter_condition(plan):
    m = match_filter_pattern(plan)
    return m[0].condition if m is not None else None


class FilterIndexRanker(IndexRankFilter):
    def apply(self, plan, candidates):
        cond = _filter_condition(plan)
        return {
            leaf_id: min(entries, key=lambda e: (
                e.index_data_size_in_bytes() * estimate_scan_fraction(cond, e), e.name))
            for leaf_id, entries in candidates.items()
            if entries
        }


class FilterIndexRule(HyperspaceRule):
    @property
    def filters(self):
        return [FilterPlanNodeFilter(self.session), FilterColumnFilter(self.session)]

    @property
    def rank_filter(self):
        return FilterIndexRanker(self.session)

    def apply_index(self, plan, chosen):
        out = plan
        for leaf_id, entry in chosen.items():
            out = transform_plan_to_use_index(entry, out, leaf_id)
        return out

    def score(self, plan, chosen):
        cond = _filter_condition(plan)
        total = 0.0
        for leaf_id, entry in chosen.items():
            total += 50 * common_bytes_ratio(entry, find_scan_by_id(plan, leaf_id))
            total += 10 * (1.0 - estimate_scan_fraction(cond, entry))
        return int(total)
