"""hs.why_not — explain why candidate indexes were not applied
(counterpart of hyperspace_tpu/analysis/whynot.py).

Reference parity: plananalysis/CandidateIndexAnalyzer.scala:29-340 — enable
the analysis tag, re-run candidate collection and the score-based optimizer,
then render:

- the rewritten plan plus an applied / applicable-but-not-applied summary
  (generateWhyNotString:147-200),
- the original plan with per-node position labels (numberedTreeString /
  getSubPlanLoc:107-124 — here the pretty() line order IS the preorder
  position, so labels are exact instead of first-line heuristics),
- the applicable-rule breakdown per (sub-plan, index) (APPLICABLE_INDEX_RULES),
- the typed FilterReason table, sorted and de-duplicated; non-extended
  output drops the verbose column AND the COL_SCHEMA_MISMATCH noise rows
  exactly like the reference (:230-235 `filter(!Reason.like(...))`).

`applicable_index_info_string` is the standalone applicable-index report the
reference exposes at CandidateIndexAnalyzer.applicableIndexInfoString:58-61
(used by verbose explain, PlanAnalyzer.scala:131).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..actions.states import ACTIVE
from ..index_manager import index_manager_for
from ..plan.nodes import FileScan
from ..rules.base import (
    COL_SCHEMA_MISMATCH,
    TAG_APPLICABLE_INDEX_RULES,
    TAG_FILTER_REASONS,
    set_analysis_enabled,
)
from ..rules.collector import CandidateIndexCollector
from ..rules.score_optimizer import ScoreBasedIndexPlanOptimizer

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession

_BAR = "=" * 65


class AnalysisResult:
    """Everything one analysis pass produces (ref: collectAnalysisResult
    returns (planWithHyperspace, filterReasons, applicableIndexes))."""

    def __init__(self, plan, rewritten, indexes):
        self.plan = plan
        self.rewritten = rewritten
        self.indexes = indexes
        self.labels = {
            n.plan_id: f"{n.kind} #{i}" for i, n in enumerate(plan.preorder())
        }
        self.applied = {}
        for n in rewritten.preorder():
            if isinstance(n, FileScan) and n.index_info is not None:
                self.applied[n.index_info.index_name] = n.index_info
        self._applicable_rows: list[tuple] | None = None

    def applicable_rows(self) -> list[tuple]:
        """(subPlan, indexName, indexType, ruleName), sorted + distinct
        (ref: applicableIndexes flattening, :112-124). Memoized: callers
        (why_not summary + table, verbose explain) share one tag scan.
        Returns a fresh list so no caller can corrupt the memo."""
        if self._applicable_rows is None:
            rows = set()
            for e in self.indexes:
                for node in self.plan.preorder():
                    for rule in (
                        e.get_tag(node.plan_id, TAG_APPLICABLE_INDEX_RULES) or []
                    ):
                        rows.add(
                            (self.labels.get(node.plan_id, "?"), e.name, e.kind, rule)
                        )
            self._applicable_rows = sorted(rows)
        return list(self._applicable_rows)

    def applicable_not_applied(self) -> list[str]:
        """Index names a rule could use that lost on priority/score
        (ref: applicableButNotAppliedIndexNames, :195-198)."""
        applicable = {r[1] for r in self.applicable_rows()}
        return sorted(applicable - set(self.applied))

    def reason_rows(self, extended: bool) -> tuple[list[tuple], set[str], int]:
        """Reason table rows, sorted + distinct, plus the names of ALL
        indexes that had any reason (pre-filter — an index whose only
        reasons are hidden must not read as having none) and how many rows
        the filter dropped. Non-extended mode keeps (subPlan, name, kind,
        reason+args) and drops COL_SCHEMA_MISMATCH rows — schema mismatches
        are the expected common case on multi-table plans and would drown
        the signal (ref: :230-235)."""
        rows = set()
        with_reasons: set[str] = set()
        # hidden rows dedupe through the SAME tuple shape extended mode
        # displays, so the "(N rows hidden)" footer counts exactly what
        # extended=True would reveal (duplicate tags collapse identically)
        hidden_rows: set[tuple] = set()
        for e in self.indexes:
            if e.name in self.applied:
                continue
            for node in self.plan.preorder():
                label = self.labels.get(node.plan_id, "?")
                for r in e.get_tag(node.plan_id, TAG_FILTER_REASONS) or []:
                    with_reasons.add(e.name)
                    if not extended and r.code == COL_SCHEMA_MISMATCH:
                        msg = f"{r.verbose} {r.arg_string()}".rstrip()
                        hidden_rows.add((label, e.name, e.kind, r.code, msg))
                        continue
                    if extended:
                        msg = f"{r.verbose} {r.arg_string()}".rstrip()
                        rows.add((label, e.name, e.kind, r.code, msg))
                    else:
                        rows.add(
                            (
                                label,
                                e.name,
                                e.kind,
                                f"{r.code} {r.arg_string()}".rstrip(),
                            )
                        )
        return sorted(rows), with_reasons, len(hidden_rows)


def collect_analysis(
    session: "HyperspaceSession",
    df: "DataFrame",
    index_name: Optional[str] = None,
) -> AnalysisResult:
    """Re-run candidate collection + the score-based optimizer with reason
    tagging enabled (ref: prepareTagsForAnalysis + applyHyperspaceForAnalysis,
    CandidateIndexAnalyzer.scala:110-131, 324+). Tag state is scoped to the
    pass: analysis mode is always reset, and entries are re-read per call so
    stale tags from a previous pass cannot leak in."""
    from ..plan.passes import pre_rewrite_plan

    manager = index_manager_for(session)
    indexes = [e for e in manager.get_indexes([ACTIVE]) if e.enabled]
    if index_name is not None:
        indexes = [e for e in indexes if e.name == index_name]
    plan = pre_rewrite_plan(df.plan)  # what the rules actually see
    set_analysis_enabled(session, True)
    try:
        candidates = CandidateIndexCollector(session).apply(plan, indexes)
        rewritten = ScoreBasedIndexPlanOptimizer(session).apply(plan, candidates)
    finally:
        set_analysis_enabled(session, False)
    return AnalysisResult(plan, rewritten, indexes)


def _annotated_plan(plan) -> str:
    """pretty() with per-line preorder positions — the label space the
    subPlan column refers to (ref analogue: numberedTreeString)."""
    lines = plan.pretty().splitlines()
    nodes = plan.preorder()
    if len(lines) != len(nodes):  # defensive: never mis-label
        return plan.pretty()
    return "\n".join(f"{line}  (#{i})" for i, line in enumerate(lines))


def _table(rows: list[tuple], headers: tuple) -> list[str]:
    widths = [
        max([len(str(h))] + [len(str(r[i])) for r in rows]) + 2
        for i, h in enumerate(headers)
    ]
    out = ["".join(f"{h:<{w}}" for h, w in zip(headers, widths)).rstrip()]
    for r in rows:
        out.append("".join(f"{str(v):<{w}}" for v, w in zip(r, widths)).rstrip())
    return out


def _index_name_list(names: list[str]) -> list[str]:
    """Bulleted name list; the empty case matches the reference's wording
    (generateWhyNotString printIndexNames, :177-186)."""
    return [f"- {n}" for n in names] or ["- No such index found."]


def why_not_string(
    session: "HyperspaceSession",
    df: "DataFrame",
    index_name: Optional[str] = None,
    extended: bool = False,
) -> str:
    res = collect_analysis(session, df, index_name)
    lines: list[str] = []

    # --- rewritten plan + summary (ref: generateWhyNotString:158-200) -----
    lines += [_BAR, "Plan with Hyperspace & Summary:", _BAR]
    lines += [res.rewritten.pretty(), ""]
    lines.append("Applied indexes:")
    lines += _index_name_list(
        sorted(
            f"{n} (Type: {i.index_kind_abbr}, LogVersion: {i.log_version})"
            for n, i in res.applied.items()
        )
    )
    lines.append("")
    lines.append("Applicable indexes, but not applied due to priority:")
    lines += _index_name_list(res.applicable_not_applied())
    lines.append("")

    # --- original plan with position labels -------------------------------
    lines += [_BAR, "Plan without Hyperspace:", _BAR, _annotated_plan(res.plan), ""]

    # --- applicable-rule breakdown per sub-plan ---------------------------
    applicable = res.applicable_rows()
    lines += [_BAR, "Applicable indexes:", _BAR]
    if applicable:
        lines += _table(applicable, ("subPlan", "indexName", "indexType", "ruleName"))
    else:
        lines.append("(none)")
    lines.append("")

    # --- per-(sub-plan, index) reasons ------------------------------------
    headers = ("subPlan", "indexName", "indexKind", "reason")
    if extended:
        headers += ("message",)
    reason_rows, with_reasons, hidden = res.reason_rows(extended)
    # indexes with no reasons at all still get a line each, so the table
    # always answers "what about MY index" (applied indexes say so; an
    # index whose only rows were filtered out keeps its filtered status
    # implicit rather than a false NO_CANDIDATE_LEAF)
    for e in res.indexes:
        if e.name in res.applied:
            info = res.applied[e.name]
            row = ("-", e.name, e.kind, f"(applied) LogVersion={info.log_version}")
            reason_rows.append(row + (("",) if extended else ()))
        elif e.name not in with_reasons:
            row = ("-", e.name, e.kind, "NO_CANDIDATE_LEAF")
            reason_rows.append(row + (("",) if extended else ()))
    reason_rows.sort(key=lambda r: (r[1], r[0], r[3]))
    lines += [_BAR, "Index reasons:", _BAR]
    if reason_rows:
        lines += _table(reason_rows, headers)
    else:
        lines.append("(no indexes)")
    if hidden:
        lines.append(
            f"({hidden} COL_SCHEMA_MISMATCH rows hidden; use extended=True to see them)"
        )
    lines.append("")
    return "\n".join(lines)


def applicable_index_info_string(
    session: "HyperspaceSession",
    df: "DataFrame",
    res: Optional[AnalysisResult] = None,
) -> str:
    """Standalone applicable-index report (ref:
    CandidateIndexAnalyzer.applicableIndexInfoString:58-61 +
    generateApplicableIndexInfoString:126-146, including its empty-case
    message verbatim). Pass a precomputed ``res`` to reuse an analysis pass
    (verbose explain does)."""
    if res is None:
        res = collect_analysis(session, df)
    rows = list(res.applicable_rows())  # copy: never mutate the memo
    # applied indexes are applicable by definition; the reference's tags
    # include them because analysis re-runs the full rule chain
    for name, info in sorted(res.applied.items()):
        rows.append(("-", name, info.index_kind_abbr, "(applied)"))
    if not rows:
        return "No applicable indexes. Try hyperspace.whyNot()"
    lines = ["Plan without Hyperspace:", "", _annotated_plan(res.plan), ""]
    lines += _table(sorted(rows), ("subPlan", "indexName", "indexType", "ruleName"))
    return "\n".join(lines)
