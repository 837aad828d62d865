"""Rule framework: filter chain, ranker, rule base (counterpart of
hyperspace_tpu/rules/base.py). A filter states why it drops a candidate
with a typed reason: the ``rules.reject.<code>`` counter always counts it,
the enclosing ``rule:<Name>`` span gets a ``reject`` event when tracing is
on, and in analysis mode (``set_analysis_enabled``) the reason and the
rules an index was applicable to are recorded on the entry's tags for the
(plan, entry) pair, which whyNot reads (analysis/whynot.py).

Candidates flow through a rule's filters as {scan plan_id: [entries]}; each
filter narrows them, the ranker picks one entry per scan, and the rule
returns the rewritten plan with a score. An applied rule counts
``rules.<Name>.applied`` and observes its score in
``rules.candidate_score``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

from ..meta.entry import IndexLogEntry
from ..plan.nodes import LogicalPlan
from ..staticcheck.concurrency import TrackedLock, guarded_by

if TYPE_CHECKING:
    from ..session import HyperspaceSession


# runtime tag names (the reference's IndexLogEntryTags)
TAG_FILTER_REASONS = "FILTER_REASONS"
TAG_APPLICABLE_INDEX_RULES = "APPLICABLE_INDEX_RULES"
TAG_HYBRIDSCAN_REQUIRED = "HYBRIDSCAN_REQUIRED"
TAG_COMMON_SOURCE_SIZE_IN_BYTES = "COMMON_SOURCE_SIZE_IN_BYTES"
TAG_HYBRIDSCAN_APPENDED = "HYBRIDSCAN_APPENDED_FILES"
TAG_HYBRIDSCAN_DELETED = "HYBRIDSCAN_DELETED_FILES"

_analysis_lock = TrackedLock("rules.analysis_sessions")
_ANALYSIS_SESSIONS: set = guarded_by(
    set(), _analysis_lock, name="rules.base._ANALYSIS_SESSIONS"
)


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

    def arg_string(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.args)


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
NO_FIRST_INDEXED_COL_COND = "NO_FIRST_INDEXED_COL_COND"
NOT_ELIGIBLE_JOIN = "NOT_ELIGIBLE_JOIN"
NO_AVAIL_JOIN_INDEX_PAIR = "NO_AVAIL_JOIN_INDEX_PAIR"
NOT_ALL_JOIN_COL_INDEXED = "NOT_ALL_JOIN_COL_INDEXED"
NO_CONVERTIBLE_PREDICATE = "NO_CONVERTIBLE_PREDICATE"


class IndexFilter:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session

    def tag_reason_if(self, condition: bool, plan: LogicalPlan, entries,
                      r: FilterReason) -> bool:
        """Returns ``condition``; when it is false, records why: on the
        metrics registry (always), the enclosing rule span (when tracing)
        and each entry's tags (in analysis mode)."""
        if not condition:
            if isinstance(entries, IndexLogEntry):
                entries = [entries]
            from ..telemetry import trace, workload
            from ..telemetry.metrics import REGISTRY

            REGISTRY.counter(f"rules.reject.{r.code}").inc(max(1, len(entries)))
            # the workload plane's candidate rejects (a no-op when it is off)
            workload.note_candidate_reject([e.name for e in entries], r.code)
            if trace.enabled():
                trace.add_event("reject", code=r.code,
                                indexes=[e.name for e in entries], **dict(r.args))
            if analysis_enabled(self.session):
                for e in entries:
                    reasons = e.get_tag(plan.plan_id, TAG_FILTER_REASONS) or []
                    reasons.append(r)
                    e.set_tag(plan.plan_id, TAG_FILTER_REASONS, reasons)
        return condition

    def tag_applicable_rule(self, plan: LogicalPlan, entry: IndexLogEntry, rule: str) -> None:
        if analysis_enabled(self.session):
            rules = entry.get_tag(plan.plan_id, TAG_APPLICABLE_INDEX_RULES) or []
            rules.append(rule)
            entry.set_tag(plan.plan_id, TAG_APPLICABLE_INDEX_RULES, rules)


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
        from ..telemetry import trace
        from ..telemetry.metrics import REGISTRY

        name = type(self).__name__
        with trace.span(f"rule:{name}", node=plan.kind, plan_id=plan.plan_id) as sp:
            out, score = self._apply(plan, candidates)
            if score > 0:
                REGISTRY.counter(f"rules.{name}.applied").inc()
                REGISTRY.histogram("rules.candidate_score").observe(score)
            if trace.enabled():
                sp.set_attr("score", score)
                sp.set_attr("applied", score > 0)
                if score <= 0 and not any(ev.get("event") == "reject"
                                          for ev in sp.attrs.get("events", ())):
                    # no filter named a reason: the node does not match the
                    # rule's pattern
                    sp.add_event("reject", code="NO_APPLICABLE_PATTERN",
                                 detail="plan node does not match the rule pattern")
            return out, score

    def _apply(
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
