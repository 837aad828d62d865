"""Score-based plan optimizer (counterpart of
hyperspace_tpu/rules/score_optimizer.py): FilterIndexRule, JoinIndexRule
and AggregateIndexRule, then the rules index kinds register at import
(ZOrderFilterIndexRule), then NoOpRule. Ties go to the later rule.

A memoized recursive search keeps, per plan node, the transformation with
the highest total score: a rule's rewrite of the whole subtree, or the
children's best rewrites.
"""

from __future__ import annotations

from .agg_rule import AggregateIndexRule
from .base import NoOpRule
from .filter_rule import FilterIndexRule
from .join_rule import JoinIndexRule
from ..meta.entry import IndexLogEntry
from ..plan.nodes import LogicalPlan


# rule classes that index kinds register when their package is imported
_EXTRA_RULES: list = []


def register_rule(rule_cls) -> None:
    if rule_cls not in _EXTRA_RULES:
        _EXTRA_RULES.append(rule_cls)


class ScoreBasedIndexPlanOptimizer:
    def __init__(self, session):
        self.session = session
        self.rules = [
            FilterIndexRule(session),
            JoinIndexRule(session),
            AggregateIndexRule(session),
            *(extra(session) for extra in _EXTRA_RULES),
            NoOpRule(session),
        ]

    def apply(self, plan: LogicalPlan, candidates: dict[int, list[IndexLogEntry]]) -> LogicalPlan:
        memo: dict[int, tuple[LogicalPlan, int]] = {}

        def rec(node: LogicalPlan) -> tuple[LogicalPlan, int]:
            hit = memo.get(node.plan_id)
            if hit is not None:
                return hit
            best_plan, best_score = node, 0
            if node.children():
                new_children, child_score = [], 0
                for c in node.children():
                    cp, cs = rec(c)
                    new_children.append(cp)
                    child_score += cs
                if child_score > 0:
                    best_plan, best_score = node.with_new_children(new_children), child_score
            # ties go to the higher node: it sees the real column needs
            for rule in self.rules:
                t_plan, score = rule.apply(node, candidates)
                if score > 0 and score >= best_score:
                    best_plan, best_score = t_plan, score
            memo[node.plan_id] = (best_plan, best_score)
            return best_plan, best_score

        return rec(plan)[0]
