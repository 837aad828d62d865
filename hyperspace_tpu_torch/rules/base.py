"""Rule framework: filter chain, ranker, rule base (counterpart of
hyperspace_tpu/rules/base.py, without the whyNot reason tagging: a filter
states why it drops a candidate with a typed reason, which the port does
not record).

Candidates flow through a rule's filters as {scan plan_id: [entries]}; each
filter narrows them, the ranker picks one entry per scan, and the rule
returns the rewritten plan with a score.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

from ..meta.entry import IndexLogEntry
from ..plan.nodes import LogicalPlan

if TYPE_CHECKING:
    from ..session import HyperspaceSession


@dataclass(frozen=True)
class FilterReason:
    code: str
    args: tuple[tuple[str, str], ...] = ()
    verbose: str = ""


def reason(code: str, verbose: str = "", **args) -> FilterReason:
    return FilterReason(code, tuple((k, str(v)) for k, v in args.items()), verbose)


# reason codes of the join and aggregate rules' filters (the reference's
# FilterReason names)
MISSING_REQUIRED_COL = "MISSING_REQUIRED_COL"
MISSING_INDEXED_COL = "MISSING_INDEXED_COL"
NOT_ELIGIBLE_JOIN = "NOT_ELIGIBLE_JOIN"
NO_AVAIL_JOIN_INDEX_PAIR = "NO_AVAIL_JOIN_INDEX_PAIR"
NOT_ALL_JOIN_COL_INDEXED = "NOT_ALL_JOIN_COL_INDEXED"


class IndexFilter:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session

    def tag_reason_if(self, condition: bool, plan: LogicalPlan, entries,
                      r: FilterReason) -> bool:
        """Returns ``condition``; the reference also records ``r`` for whyNot
        when it is false."""
        return condition


class QueryPlanIndexFilter(IndexFilter):
    def apply(
        self, plan: LogicalPlan, candidates: dict[int, list[IndexLogEntry]]
    ) -> dict[int, list[IndexLogEntry]]:
        raise NotImplementedError


class IndexRankFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates) -> dict[int, IndexLogEntry]:
        raise NotImplementedError


def index_type_filter(kind: str) -> Callable[[list[IndexLogEntry]], list[IndexLogEntry]]:
    def f(entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
        return [e for e in entries if e.derived_dataset.kind == kind]

    return f


class HyperspaceRule:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session

    @property
    def filters(self) -> list[QueryPlanIndexFilter]:
        return []

    @property
    def rank_filter(self) -> Optional[IndexRankFilter]:
        return None

    def apply(
        self, plan: LogicalPlan, candidates: dict[int, list[IndexLogEntry]]
    ) -> tuple[LogicalPlan, int]:
        applicable = candidates
        for f in self.filters:
            applicable = f.apply(plan, applicable)
            if not any(applicable.values()):
                return plan, 0
        if self.rank_filter is None:
            return plan, 0
        chosen = self.rank_filter.apply(plan, applicable)
        if not chosen:
            return plan, 0
        return self.apply_index(plan, chosen), self.score(plan, chosen)

    def apply_index(self, plan: LogicalPlan, chosen: dict[int, IndexLogEntry]) -> LogicalPlan:
        raise NotImplementedError

    def score(self, plan: LogicalPlan, chosen: dict[int, IndexLogEntry]) -> int:
        raise NotImplementedError


class NoOpRule(HyperspaceRule):
    def apply(self, plan, candidates):
        return plan, 0
