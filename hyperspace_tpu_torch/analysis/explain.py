"""hs.explain — plan diff with and without Hyperspace, EXPLAIN ANALYZE and
the per-query profile (counterpart of hyperspace_tpu/analysis/explain.py).

Reference parity: plananalysis/PlanAnalyzer.explainString:48-143 — render the
plan with the rewrite on and off (differing lines highlighted per display
mode), list the indexes used (collected from the index-marked relations),
compare physical-operator counts (PhysicalOperatorAnalyzer.scala:29-60), and
in verbose mode append the applicable-index table
(CandidateIndexAnalyzer.applicableIndexInfoString, PlanAnalyzer.scala:131).
Rendering goes through BufferStream/DisplayMode (BufferStream.scala:23-83).

The JAX package's profile also renders its serving, tenant, result-cache
and query-log state and its device tier's circuit breaker; the port has no
serving plane, result cache or per-query attribution yet, and by design no
breaker (a kernel that fails raises), so its profile holds the span tree
with the metrics and the accuracy block.
"""

from __future__ import annotations

from collections import Counter
from typing import TYPE_CHECKING

from ..plan.nodes import FileScan, LogicalPlan
from .display import BufferStream, display_mode_for

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession

_BAR = "=" * 65


def used_indexes(plan: LogicalPlan) -> list[str]:
    out = []
    for n in plan.preorder():
        if isinstance(n, FileScan) and n.index_info is not None:
            i = n.index_info
            out.append(
                f"{i.index_name} (Type: {i.index_kind_abbr}, LogVersion: {i.log_version})"
            )
    return sorted(set(out))


def operator_counts(plan: LogicalPlan) -> Counter:
    return Counter(n.kind for n in plan.preorder())


def index_scan_details(plan: LogicalPlan) -> list[tuple]:
    """(name, kind, log_version, n_files, total_bytes) per index scan in the
    rewritten plan (the verbose half of the reference's used-indexes list)."""
    out = {}
    for n in plan.preorder():
        if isinstance(n, FileScan) and n.index_info is not None:
            i = n.index_info
            key = (i.index_name, i.index_kind_abbr, i.log_version)
            files, size = out.get(key, (0, 0))
            out[key] = (
                files + len(n.files),
                size + sum(f.size for f in n.files),
            )
    return sorted(
        (name, kind, ver, files, size)
        for (name, kind, ver), (files, size) in out.items()
    )


def _write_plan_diff(
    buf: BufferStream, plan_lines: list[str], other_lines: list[str]
) -> None:
    """Write plan lines, highlighting every line that does not appear in the
    other plan — multiset-aware so duplicated subtrees (self-joins)
    highlight correctly (ref: PlanAnalyzer highlights all differing nodes,
    :67-99, via buildHighlightedOutput)."""
    budget = Counter(l.strip() for l in other_lines)
    for line in plan_lines:
        key = line.strip()
        if budget[key] > 0:
            budget[key] -= 1
            buf.write_line(line)
        else:
            buf.highlight_line(line)


def _write_header(buf: BufferStream, title: str) -> None:
    buf.write_line(_BAR).write_line(title).write_line(_BAR)


def explain_string(
    session: "HyperspaceSession", df: "DataFrame", verbose: bool = False
) -> str:
    from ..plan.passes import pre_rewrite_plan

    analysis = None
    if verbose and session.conf.apply_enabled:
        # one analysis pass serves both the plan diff and the applicable
        # table (re-running the collector + optimizer would double the
        # rewrite cost on many-index sessions). Same contract as the
        # rewrite rule itself: gated on apply_enabled above, and fail-open
        # below — a diagnostics call must never crash where the query
        # would have survived (ref: ApplyHyperspace.scala:60-64)
        from .whynot import collect_analysis

        try:
            analysis = collect_analysis(session, df)
        except Exception:
            analysis = None
    if analysis is not None:
        original, rewritten = analysis.plan, analysis.rewritten
    else:
        from ..rules.apply import ApplyHyperspace

        original = pre_rewrite_plan(df.plan)  # what the rules actually see
        rewritten = ApplyHyperspace(session)(original)
    buf = BufferStream(display_mode_for(session))

    with_lines = rewritten.pretty().splitlines()
    without_lines = original.pretty().splitlines()

    _write_header(buf, "Plan with indexes:")
    _write_plan_diff(buf, with_lines, without_lines)
    buf.write_line()
    _write_header(buf, "Plan without indexes:")
    _write_plan_diff(buf, without_lines, with_lines)
    buf.write_line()
    _write_header(buf, "Indexes used:")
    for line in used_indexes(rewritten) or ["(none)"]:
        buf.write_line(line)
    buf.write_line()
    if verbose:
        detail = index_scan_details(rewritten)
        if detail:
            _write_header(buf, "Indexes used (detail):")
            buf.write_line(
                f"{'name':<24}{'kind':>6}{'logVersion':>12}{'files':>7}{'bytes':>14}"
            )
            for name, kind, ver, nfiles, nbytes in detail:
                buf.write_line(
                    f"{name:<24}{kind:>6}{ver:>12}{nfiles:>7}{nbytes:>14,}"
                )
            buf.write_line()
        _write_header(buf, "Physical operator stats:")
        with_c = operator_counts(rewritten)
        without_c = operator_counts(original)
        all_ops = sorted(set(with_c) | set(without_c))
        name_w = max([len(o) for o in all_ops] + [20])
        buf.write_line(
            f"{'Physical Operator':<{name_w}} {'Hyperspace Disabled':>20} "
            f"{'Hyperspace Enabled':>20} {'Difference':>11}"
        )
        for op in all_ops:
            a, b = without_c.get(op, 0), with_c.get(op, 0)
            buf.write_line(f"{op:<{name_w}} {a:>20} {b:>20} {b - a:>11}")
        buf.write_line()
        # ref: PlanAnalyzer.scala:131 appends the applicable-index info in
        # verbose mode so users see near-miss indexes next to the diff
        _write_header(buf, "Applicable indexes:")
        if analysis is not None:
            from .whynot import applicable_index_info_string

            buf.write_block(applicable_index_info_string(session, df, analysis))
        else:
            buf.write_line(
                "(unavailable: hyperspace is disabled or analysis failed)"
            )
        buf.write_line()
    return buf.render()


def explain_analyze_string(session: "HyperspaceSession", df: "DataFrame") -> str:
    """EXPLAIN ANALYZE: execute the query ONCE with the plan-statistics
    collector installed (telemetry/plan_stats.py) and render the optimized
    plan tree annotated with per-node actual rows / inclusive wall time /
    route / bytes plus the estimator q-errors recorded during the run.
    Observe-only — the analyzed execution is bit-identical to a plain
    ``collect()`` (tools/plan_stats_smoke.py gates it)."""
    import time

    from ..telemetry import plan_stats

    t0 = time.perf_counter()
    with plan_stats.collect_scope() as col:
        batch = df.collect()
    wall_ms = (time.perf_counter() - t0) * 1000
    buf = BufferStream(display_mode_for(session))
    _write_header(buf, "Plan statistics (EXPLAIN ANALYZE):")
    buf.write_block(plan_stats.render_annotated(col.plan, col))
    buf.write_line()
    buf.write_block(plan_stats.summary_string(col))
    buf.write_line(
        f"result: {batch.num_rows} row(s) in {wall_ms:.2f} ms"
    )
    buf.write_line()
    buf.write_block(plan_stats.accuracy_string())
    return buf.render()


def profile_string(session: "HyperspaceSession", df: "DataFrame") -> str:
    """Execute the query once under tracing and render the per-query profile:
    the span tree (rule decisions → plan → executor → kernel dispatches, each
    with wall time and RpcMeter deltas) plus the metrics-registry snapshot,
    the result cache's block and the process-wide estimator-accuracy
    block. The run-it-and-attribute companion to `explain_string`'s static
    plan diff."""
    from ..cache.result_cache import result_cache_state_string
    from ..telemetry import trace
    from ..telemetry.plan_stats import accuracy_string

    with trace.capture() as cap:
        df.collect()
    buf = BufferStream(display_mode_for(session))
    _write_header(buf, "Query profile (spans + metrics):")
    buf.write_block(cap.profile_string())
    buf.write_line()
    buf.write_block(result_cache_state_string())
    buf.write_line()
    buf.write_block(accuracy_string())
    return buf.render()
