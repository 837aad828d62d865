"""FilterIndexRule: rewrite [Project ->] Filter -> Scan to a covering-index
scan (counterpart of hyperspace_tpu/rules/filter_rule.py).

An index qualifies when its first indexed column appears in the filter
condition (or, with sidecar sketches on, a declared sketch can bound a
conjunct of it) and it covers every column the subtree needs. Among those the
ranker takes the least expected read: index bytes times the fraction
bucket pruning keeps for the condition (plan/pruning.estimate_scan_
fraction), name breaking ties. Score = 50 * covered-bytes ratio (1 without
hybrid scan; with it on, the ranker takes the candidate with the largest
such ratio) plus up to 10 for that pruning, which keeps the rule above
AggregateIndexRule's 40 and lets a bucket-prunable rewrite win a tie
against a z-order one.
"""

from __future__ import annotations

from typing import Optional

from .base import (
    HyperspaceRule,
    IndexRankFilter,
    MISSING_REQUIRED_COL,
    NO_FIRST_INDEXED_COL_COND,
    QueryPlanIndexFilter,
    index_type_filter,
    reason,
)
from .rule_utils import (
    common_bytes_ratio,
    find_scan_by_id,
    log_index_usage,
    subtree_required_columns,
    transform_plan_to_use_index,
)
from ..plan.nodes import FileScan, Filter, LogicalPlan, Project
from ..plan.pruning import corrected_scan_fraction, estimate_scan_fraction


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
        for e in index_type_filter("CI")(candidates.get(scan.plan_id, [])):
            indexed = [c.lower() for c in e.derived_dataset.indexed_columns()]
            covered = {c.lower() for c in e.derived_dataset.referenced_columns()}
            leading_ok = indexed[0] in filter_refs or _sketchable_condition(e, filter_node)
            if not self.tag_reason_if(
                leading_ok, plan, e,
                reason(NO_FIRST_INDEXED_COL_COND,
                       "The first indexed column is not in the filter condition.",
                       firstIndexedCol=indexed[0]),
            ):
                continue
            if not self.tag_reason_if(
                required <= covered, plan, e,
                reason(MISSING_REQUIRED_COL,
                       "The index does not cover all required columns.",
                       missing=sorted(required - covered)),
            ):
                continue
            self.tag_applicable_rule(plan, e, "FilterIndexRule")
            out.append(e)
        return {scan.plan_id: out} if out else {}


def _sketchable_condition(entry, filter_node: Filter) -> bool:
    """With sketches on, a condition a declared sidecar sketch can bound
    admits the index too: its scan then skips row groups on a column
    other than the first indexed one."""
    from ..models.dataskipping import sketch_store

    dd = entry.derived_dataset
    return sketch_store.condition_sketchable(
        filter_node.condition, dd.schema(), tuple(dd.indexed_columns()))


def _filter_condition(plan):
    m = match_filter_pattern(plan)
    return m[0].condition if m is not None else None


class FilterIndexRanker(IndexRankFilter):
    """With hybrid scan on, the candidate covering most of the scan's
    bytes; otherwise the least expected read. Under
    ``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` the expected fraction is multiplied
    by the accuracy ledger's observed correction for (index, predicate
    shape) (plan/pruning.corrected_scan_fraction); off, it is the raw
    estimate."""

    def apply(self, plan, candidates):
        cond = _filter_condition(plan)
        out = {}
        for leaf_id, entries in candidates.items():
            if not entries:
                continue
            if self.session.conf.hybrid_scan_enabled:
                scan = find_scan_by_id(plan, leaf_id)
                out[leaf_id] = max(entries, key=lambda e: (common_bytes_ratio(e, scan), e.name))
            else:
                out[leaf_id] = min(entries, key=lambda e: (
                    e.index_data_size_in_bytes() * corrected_scan_fraction(cond, e), e.name))
        return out


class FilterIndexRule(HyperspaceRule):
    @property
    def filters(self):
        return [FilterPlanNodeFilter(self.session), FilterColumnFilter(self.session)]

    @property
    def rank_filter(self):
        return FilterIndexRanker(self.session)

    def apply_index(self, plan, chosen):
        out = plan
        use_bucket_spec = self.session.conf.filter_rule_use_bucket_spec
        for leaf_id, entry in chosen.items():
            out = transform_plan_to_use_index(self.session, entry, out, leaf_id,
                                              use_bucket_spec, False)
            log_index_usage(self.session, "FilterIndexRule", [entry.name],
                            f"Filter index applied: {entry.name}")
        return out

    def score(self, plan, chosen):
        cond = _filter_condition(plan)
        total = 0.0
        for leaf_id, entry in chosen.items():
            total += 50 * common_bytes_ratio(entry, find_scan_by_id(plan, leaf_id))
            total += 10 * (1.0 - estimate_scan_fraction(cond, entry))
        return int(total)
