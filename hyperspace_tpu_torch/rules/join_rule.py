"""JoinIndexRule: rewrite an equi-join with linear children to read two
compatible bucketed covering indexes (counterpart of
hyperspace_tpu/rules/join_rule.py).

Shape: an inner join whose condition is a conjunction of column equalities
and whose children are each Project/Filter over one scan. Usable indexes per
side: indexed columns equal to the side's join keys as a set, and every
column the side needs covered. Among compatible pairs (the same indexed
column order with respect to the join pairs) the ranker prefers equal bucket
counts, then more buckets, then covered bytes. Score = 70 per side.

The rewrite leaves both sides as bucket-carrying index scans; the executor
(plan/bucket_join.py) joins bucket b of one side with bucket b of the other,
with no shuffle.
"""

from __future__ import annotations

from typing import Optional

from .base import (
    HyperspaceRule,
    IndexRankFilter,
    MISSING_REQUIRED_COL,
    NOT_ALL_JOIN_COL_INDEXED,
    NOT_ELIGIBLE_JOIN,
    NO_AVAIL_JOIN_INDEX_PAIR,
    QueryPlanIndexFilter,
    index_type_filter,
    reason,
)
from .rule_utils import (
    common_bytes_ratio,
    find_scan_by_id,
    is_plan_linear,
    subtree_required_columns,
    transform_plan_to_use_index,
)
from ..meta.entry import IndexLogEntry
from ..plan.executor import extract_equi_keys
from ..plan.nodes import FileScan, Join, LogicalPlan


def _leaf(plan: LogicalPlan) -> Optional[FileScan]:
    scans = [n for n in plan.preorder() if isinstance(n, FileScan)]
    return scans[0] if len(scans) == 1 else None


class JoinPlanNodeFilter(QueryPlanIndexFilter):
    """Shape eligibility: an inner pure equi-join over linear children."""

    def apply(self, plan, candidates):
        if not isinstance(plan, Join) or plan.condition is None or plan.how != "inner":
            return {}
        left_leaf, right_leaf = _leaf(plan.left), _leaf(plan.right)
        if left_leaf is None or right_leaf is None:
            return {}
        linear = is_plan_linear(plan.left) and is_plan_linear(plan.right)
        lkeys, _rkeys, residual = extract_equi_keys(
            plan.condition, plan.left.schema, plan.right.schema
        )
        all_entries = candidates.get(left_leaf.plan_id, []) + candidates.get(
            right_leaf.plan_id, []
        )
        if not self.tag_reason_if(
            linear and bool(lkeys) and not residual, plan, all_entries,
            reason(NOT_ELIGIBLE_JOIN,
                   "Join is not eligible: requires a pure equi-join over linear children."),
        ):
            return {}
        return {
            left_leaf.plan_id: candidates.get(left_leaf.plan_id, []),
            right_leaf.plan_id: candidates.get(right_leaf.plan_id, []),
        }


class JoinColumnFilter(QueryPlanIndexFilter):
    """Usable indexes per side: join keys indexed, required columns covered."""

    def apply(self, plan, candidates):
        left_leaf, right_leaf = _leaf(plan.left), _leaf(plan.right)
        lkeys, rkeys, _ = extract_equi_keys(
            plan.condition, plan.left.schema, plan.right.schema
        )
        out = {}
        for leaf, keys, side in ((left_leaf, lkeys, plan.left), (right_leaf, rkeys, plan.right)):
            required = {c.lower() for c in subtree_required_columns(side)}
            keyset = {c.lower() for c in keys}
            usable = []
            for e in index_type_filter("CI")(candidates.get(leaf.plan_id, [])):
                indexed = {c.lower() for c in e.derived_dataset.indexed_columns()}
                covered = {c.lower() for c in e.derived_dataset.referenced_columns()}
                if not self.tag_reason_if(
                    indexed == keyset, plan, e,
                    reason(NOT_ALL_JOIN_COL_INDEXED,
                           "Indexed columns must exactly match the join keys.",
                           indexed=sorted(indexed), joinKeys=sorted(keyset)),
                ):
                    continue
                if not self.tag_reason_if(
                    required <= covered, plan, e,
                    reason(MISSING_REQUIRED_COL,
                           "The index does not cover all required columns.",
                           missing=sorted(required - covered)),
                ):
                    continue
                usable.append(e)
            if not usable:
                return {}
            out[leaf.plan_id] = usable
        return out


def _compatible(l: IndexLogEntry, r: IndexLogEntry, lkeys: list[str], rkeys: list[str]) -> bool:
    """Same indexed-column order with respect to the join pairs."""
    li = [c.lower() for c in l.derived_dataset.indexed_columns()]
    ri = [c.lower() for c in r.derived_dataset.indexed_columns()]
    if len(li) != len(ri):
        return False
    pairs = {(a.lower(), b.lower()) for a, b in zip(lkeys, rkeys)}
    return all((a, b) in pairs for a, b in zip(li, ri))


class JoinRankFilter(IndexRankFilter):
    """Pick the best compatible pair."""

    def apply(self, plan, candidates):
        left_leaf, right_leaf = _leaf(plan.left), _leaf(plan.right)
        lkeys, rkeys, _ = extract_equi_keys(
            plan.condition, plan.left.schema, plan.right.schema
        )
        lefts = candidates.get(left_leaf.plan_id, [])
        rights = candidates.get(right_leaf.plan_id, [])
        pairs = [(le, re) for le in lefts for re in rights
                 if _compatible(le, re, lkeys, rkeys)]
        if not self.tag_reason_if(
            bool(pairs), plan, lefts + rights,
            reason(NO_AVAIL_JOIN_INDEX_PAIR, "No compatible index pair for the join."),
        ):
            return {}

        def pair_key(p):
            le, re = p
            lb = getattr(le.derived_dataset, "num_buckets", 0)
            rb = getattr(re.derived_dataset, "num_buckets", 0)
            common = common_bytes_ratio(le, left_leaf) + common_bytes_ratio(re, right_leaf)
            # equal buckets avoid re-bucketing; then parallelism; then
            # covered bytes; names for determinism
            return (lb == rb, min(lb, rb), common, -ord(le.name[0]) if le.name else 0)

        le, re = max(pairs, key=pair_key)
        return {left_leaf.plan_id: le, right_leaf.plan_id: re}


class JoinIndexRule(HyperspaceRule):
    @property
    def filters(self):
        return [JoinPlanNodeFilter(self.session), JoinColumnFilter(self.session)]

    @property
    def rank_filter(self):
        return JoinRankFilter(self.session)

    def apply_index(self, plan, chosen):
        out = plan
        for leaf_id, entry in chosen.items():
            out = transform_plan_to_use_index(entry, out, leaf_id, use_bucket_spec=True)
        return out

    def score(self, plan, chosen):
        total = 0.0
        for leaf_id, entry in chosen.items():
            total += 70 * common_bytes_ratio(entry, find_scan_by_id(plan, leaf_id))
        return int(total)
