"""Rule framework: filter chain, ranker, rule base (counterpart of
hyperspace_tpu/rules/base.py). A filter states why it drops a candidate
with a typed reason; in analysis mode (``set_analysis_enabled``) the reason
is recorded on the entry's tags for the (plan, entry) pair, as whyNot reads
it in the reference (the port has no whyNot view yet).

Candidates flow through a rule's filters as {scan plan_id: [entries]}; each
filter narrows them, the ranker picks one entry per scan, and the rule
returns the rewritten plan with a score.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

from ..meta.entry import IndexLogEntry
from ..plan.nodes import LogicalPlan

if TYPE_CHECKING:
    from ..session import HyperspaceSession


# runtime tag names (the reference's IndexLogEntryTags)
TAG_FILTER_REASONS = "FILTER_REASONS"
TAG_HYBRIDSCAN_REQUIRED = "HYBRIDSCAN_REQUIRED"
TAG_COMMON_SOURCE_SIZE_IN_BYTES = "COMMON_SOURCE_SIZE_IN_BYTES"
TAG_HYBRIDSCAN_APPENDED = "HYBRIDSCAN_APPENDED_FILES"
TAG_HYBRIDSCAN_DELETED = "HYBRIDSCAN_DELETED_FILES"

_analysis_lock = threading.Lock()
_ANALYSIS_SESSIONS: set = set()


def set_analysis_enabled(session, enabled: bool) -> None:
    with _analysis_lock:
        if enabled:
            _ANALYSIS_SESSIONS.add(id(session))
        else:
            _ANALYSIS_SESSIONS.discard(id(session))


def analysis_enabled(session) -> bool:
    return id(session) in _ANALYSIS_SESSIONS


@dataclass(frozen=True)
class FilterReason:
    code: str
    args: tuple[tuple[str, str], ...] = ()
    verbose: str = ""


def reason(code: str, verbose: str = "", **args) -> FilterReason:
    return FilterReason(code, tuple((k, str(v)) for k, v in args.items()), verbose)


# reason codes (the reference's FilterReason names)
COL_SCHEMA_MISMATCH = "COL_SCHEMA_MISMATCH"
SOURCE_DATA_CHANGED = "SOURCE_DATA_CHANGED"
NO_DELETE_SUPPORT = "NO_DELETE_SUPPORT"
NO_COMMON_FILES = "NO_COMMON_FILES"
TOO_MUCH_APPENDED = "TOO_MUCH_APPENDED"
TOO_MUCH_DELETED = "TOO_MUCH_DELETED"
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
        """Returns ``condition``; when it is false in analysis mode, records
        ``r`` on each entry's reasons for this plan."""
        if not condition and analysis_enabled(self.session):
            for e in ([entries] if isinstance(entries, IndexLogEntry) else entries):
                reasons = e.get_tag(plan.plan_id, TAG_FILTER_REASONS) or []
                reasons.append(r)
                e.set_tag(plan.plan_id, TAG_FILTER_REASONS, reasons)
        return condition


class SourcePlanIndexFilter(IndexFilter):
    """Filters candidates against one source scan."""

    def apply(self, plan: LogicalPlan, entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
        raise NotImplementedError


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
