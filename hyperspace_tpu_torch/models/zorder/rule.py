"""ZOrderFilterIndexRule (counterpart of
hyperspace_tpu/models/zorder/rule.py).

Like FilterIndexRule, but any indexed column in the filter condition
qualifies a z-order index, since the z-curve clusters every indexed
column. The ranker prefers the index with the fewest indexed columns the
filter leaves untouched, then the smallest, then the name. A z-order scan
has no bucket layout, so it carries no prune spec.
"""

from __future__ import annotations

from ...plan.nodes import LogicalPlan
from ...rules.base import (
    HyperspaceRule,
    IndexRankFilter,
    MISSING_INDEXED_COL,
    MISSING_REQUIRED_COL,
    QueryPlanIndexFilter,
    index_type_filter,
    reason,
)
from ...rules.filter_rule import match_filter_pattern
from ...rules.rule_utils import (
    log_index_usage,
    common_bytes_ratio,
    find_scan_by_id,
    subtree_required_columns,
    transform_plan_to_use_index,
)
from ...rules.score_optimizer import register_rule


class ZOrderFilterColumnFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        if m is None:
            return {}
        filter_node, scan = m
        filter_refs = {c.lower() for c in filter_node.condition.references()}
        required = {c.lower() for c in subtree_required_columns(plan)} | filter_refs
        out = []
        for e in index_type_filter("ZCI")(candidates.get(scan.plan_id, [])):
            indexed = {c.lower() for c in e.derived_dataset.indexed_columns()}
            covered = {c.lower() for c in e.derived_dataset.referenced_columns()}
            if not self.tag_reason_if(
                bool(indexed & filter_refs), plan, e,
                reason(MISSING_INDEXED_COL,
                       "No indexed column appears in the filter condition.",
                       indexed=sorted(indexed)),
            ):
                continue
            if not self.tag_reason_if(
                required <= covered, plan, e,
                reason(MISSING_REQUIRED_COL,
                       "The index does not cover all required columns.",
                       missing=sorted(required - covered)),
            ):
                continue
            self.tag_applicable_rule(plan, e, "ZOrderFilterIndexRule")
            out.append(e)
        return {scan.plan_id: out} if out else {}


class ZOrderFilterRankFilter(IndexRankFilter):
    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        filter_refs = {c.lower() for c in m[0].condition.references()} if m else set()

        def key(e):
            indexed = {c.lower() for c in e.derived_dataset.indexed_columns()}
            return (len(indexed - filter_refs), e.index_data_size_in_bytes(), e.name)

        return {leaf_id: min(entries, key=key)
                for leaf_id, entries in candidates.items() if entries}


class ZOrderFilterIndexRule(HyperspaceRule):
    @property
    def filters(self):
        return [ZOrderFilterColumnFilter(self.session)]

    @property
    def rank_filter(self):
        return ZOrderFilterRankFilter(self.session)

    def apply_index(self, plan: LogicalPlan, chosen) -> LogicalPlan:
        out = plan
        for leaf_id, entry in chosen.items():
            # z-order data has no bucket spec
            out = transform_plan_to_use_index(self.session, entry, out, leaf_id, False, False)
            log_index_usage(self.session, "ZOrderFilterIndexRule", [entry.name],
                            f"Z-order index applied: {entry.name}")
        return out

    def score(self, plan, chosen) -> int:
        return int(sum(50 * common_bytes_ratio(e, find_scan_by_id(plan, leaf_id))
                       for leaf_id, e in chosen.items()))


register_rule(ZOrderFilterIndexRule)
