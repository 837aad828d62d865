"""hs.explain — plan diff with and without Hyperspace, EXPLAIN ANALYZE and
the per-query profile (counterpart of hyperspace_tpu/analysis/explain.py).

Reference parity: plananalysis/PlanAnalyzer.explainString:48-143 — render the
plan with the rewrite on and off (differing lines highlighted per display
mode), list the indexes used (collected from the index-marked relations),
compare physical-operator counts (PhysicalOperatorAnalyzer.scala:29-60), and
in verbose mode append the applicable-index table
(CandidateIndexAnalyzer.applicableIndexInfoString, PlanAnalyzer.scala:131).
Rendering goes through BufferStream/DisplayMode (BufferStream.scala:23-83).

The profile renders, after the span tree with the metrics, the serving,
tenant, result-cache, estimator-accuracy and query-log blocks, as the JAX
package's does. The JAX package's profile also names its device tier's
circuit breaker; the port has none by design (a kernel that fails raises
inside its query), so that line is left out. ``workload_report_string``
and ``index_report_string`` are the workload plane's views.
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
    then the serving, tenant, result-cache, estimator-accuracy and query-log
    blocks. The run-it-and-attribute companion to `explain_string`'s static
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
    buf.write_block(serving_state_string())
    buf.write_line()
    buf.write_block(tenant_state_string())
    buf.write_line()
    buf.write_block(result_cache_state_string())
    buf.write_line()
    buf.write_block(accuracy_string())
    buf.write_line()
    buf.write_block(query_log_string())
    return buf.render()


def serving_state_string() -> str:
    """Aggregate serving-layer snapshot: active/queued queries with their
    queue waits, admission totals, and global-budget occupancy — so a
    loaded server is debuggable from the REPL (``hs.profile``)."""
    from ..serve import serve_state

    st = serve_state()
    budget = st["budget"]
    lines = ["Serving (scheduler + global budget):"]
    if st["max_concurrent"] is None:
        lines.append("  scheduler: idle (no queries submitted)")
    else:
        t = st["totals"]
        lines.append(
            f"  scheduler: {len(st['active'])} active / "
            f"{len(st['queued'])} queued "
            f"(max_concurrent={st['max_concurrent']}, "
            f"queue_depth={st['queue_depth_limit']})"
        )
        lines.append(
            f"  totals: admitted={t.get('admitted', 0)} "
            f"done={t.get('done', 0)} failed={t.get('failed', 0)} "
            f"cancelled={t.get('cancelled', 0)} "
            f"rejected={t.get('rejected', 0)}"
        )
        for q in st["active"]:
            lines.append(
                f"  active q{q['query_id']} [{q['label']}] "
                f"prio={q['priority']} "
                f"queue_wait={q['queue_wait_ms']:.1f}ms "
                f"running={q['running_ms']:.1f}ms"
            )
        for q in st["queued"]:
            lines.append(
                f"  queued q{q['query_id']} [{q['label']}] "
                f"prio={q['priority']} waited={q['waited_ms']:.1f}ms"
            )
    pct = (
        100.0 * budget["held_bytes"] / budget["limit_bytes"]
        if budget["limit_bytes"]
        else 0.0
    )
    lines.append(
        f"  budget: {budget['held_bytes']}/{budget['limit_bytes']} bytes "
        f"held ({pct:.1f}%), {len(budget['streams'])} open stream(s)"
    )
    dev = st.get("device_budget")
    if dev is not None:
        if dev["limit_bytes"]:
            dpct = 100.0 * dev["held_bytes"] / dev["limit_bytes"]
            lines.append(
                f"  device budget: {dev['held_bytes']}/{dev['limit_bytes']} "
                f"bytes held ({dpct:.1f}%), {len(dev['streams'])} open "
                f"stream(s) | parks={dev.get('parks', 0)} "
                f"spills={dev.get('spills', 0)} "
                f"resumes={dev.get('resumes', 0)}"
            )
        else:
            lines.append("  device budget: disabled "
                         "(HYPERSPACE_DEVICE_BUDGET_MB=0)")
    return "\n".join(lines)


def tenant_state_string() -> str:
    """Per-tenant QoS snapshot: weights, virtual clocks, delivered cost
    share, queue occupancy, quota rejections (scheduler side) merged with
    the attribution ledger's per-tenant rollups — the ``hs.profile`` face
    of the multi-tenant serving plane."""
    from ..serve import serve_state
    from ..telemetry.attribution import LEDGER

    sched = serve_state().get("tenants") or {}
    rollups = LEDGER.tenant_rollups()
    lines = ["Tenants (weighted-fair QoS):"]
    names = sorted(set(sched) | set(rollups))
    if not names:
        lines.append("  (no tenant activity recorded)")
        return "\n".join(lines)
    hdr = (
        f"  {'tenant':<12} {'weight':>6} {'share':>6} {'vclock':>9} "
        f"{'q/a':>5} {'done':>5} {'rej':>4} {'wall_ms':>9} {'MB':>8}"
    )
    lines.append(hdr)
    for name in names:
        s = sched.get(name) or {}
        r = rollups.get(name) or {}
        rejected = (
            s.get("rejected_rate", 0) + s.get("rejected_quota", 0)
            + s.get("rejected_deadline", 0)
        )
        lines.append(
            f"  {name[:12]:<12} {s.get('weight', 1.0):>6.2f} "
            f"{s.get('delivered_share', 0.0):>6.2f} "
            f"{s.get('vclock', 0.0):>9.3f} "
            f"{s.get('queued', 0)}/{s.get('active', 0):>3} "
            f"{s.get('done', 0):>5} {rejected:>4} "
            f"{r.get('total_ms', 0.0):>9.1f} "
            f"{r.get('bytes_read', 0) / 1e6:>8.2f}"
        )
    return "\n".join(lines)


def _phase_cell(record: dict) -> str:
    """Compact ``plan/io/up/disp/fetch/fold/park`` ms breakdown for one
    query record (phases the query never entered are omitted)."""
    short = {"plan": "plan", "io": "io", "upload": "up",
             "dispatch": "disp", "fetch": "fetch", "fold": "fold",
             "park": "park"}
    parts = [
        f"{short.get(p, p)}={ms:.0f}"
        for p, ms in record.get("phases_ms", {}).items()
        if ms >= 0.05
    ]
    return " ".join(parts) if parts else "-"


def query_log_string(limit: int = 12) -> str:
    """Per-query breakdown from the serving attribution ledger
    (telemetry/attribution.py): active queries plus the tail of the
    rolling query log, each with its phase times, bytes, and cache hit
    ratio — the ``hs.profile`` face of the per-query telemetry plane."""
    from ..telemetry.attribution import LEDGER

    snap = LEDGER.snapshot(limit=limit)
    lines = ["Query log (per-query attribution):"]
    if not snap["active"] and not snap["recent"]:
        lines.append("  (no serving queries recorded)")
        return "\n".join(lines)
    totals = snap["totals"]
    lines.append(
        f"  recorded={totals.get('recorded', 0)} "
        f"slow={totals.get('slow', 0)} window={snap['window']}"
    )
    hdr = (
        f"  {'qid':>5} {'label':<18} {'tenant':<10} {'outcome':<9} "
        f"{'total_ms':>9} {'queue_ms':>9} {'MB':>7} {'hit%':>5}  phases_ms"
    )
    lines.append(hdr)
    for r in snap["active"] + snap["recent"][-limit:]:
        ratio = r.get("cache_hit_ratio")
        lines.append(
            f"  {r['query_id']:>5} {r['label'][:18]:<18} "
            f"{str(r.get('tenant', '-'))[:10]:<10} "
            f"{r['outcome'][:9]:<9} {r['total_ms']:>9.1f} "
            f"{r['queue_wait_ms']:>9.1f} "
            f"{r['bytes_read'] / 1e6:>7.2f} "
            f"{100 * ratio if ratio is not None else 0:>5.1f}  "
            f"{_phase_cell(r)}"
        )
    return "\n".join(lines)


def workload_report_string() -> str:
    """``hs.workload_report()``: the durable-journal state, the journaled
    workload's label/shape mix, and the drift detector's regressions."""
    from ..telemetry import workload

    return workload.workload_report_string()


def index_report_string() -> str:
    """``hs.index_report()``: the per-index utility ledger — counterfactual
    benefit vs maintenance cost, heat, and cold-index candidates."""
    from ..telemetry import workload
    from ..telemetry.index_ledger import INDEX_LEDGER

    lines = ["== Index utility ledger =="]
    if not workload.enabled():
        lines.append("disabled (set HYPERSPACE_WORKLOAD_DIR to enable)")
        return "\n".join(lines)
    INDEX_LEDGER.maybe_recover(workload.journal_dir())
    rows = INDEX_LEDGER.report()
    if not rows:
        lines.append("  (no index activity recorded)")
        return "\n".join(lines)
    lines.append(
        f"  {'index':<20} {'queries':>7} {'benefit_MB':>10} "
        f"{'skip_MB':>8} {'rg_skip':>7} {'maint_s':>8} {'actions':>7} "
        f"{'net_s':>9}  last_used"
    )
    import time as _time

    for r in rows:
        last = (
            _time.strftime("%H:%M:%S", _time.localtime(r["last_used_s"]))
            if r["last_used_s"] else "-"
        )
        actions = sum(r["maintenance_actions"].values())
        lines.append(
            f"  {r['name'][:20]:<20} {r['queries']:>7} "
            f"{r['benefit_bytes'] / 1e6:>10.2f} "
            f"{r['bytes_skipped'] / 1e6:>8.2f} "
            f"{r['rowgroups_skipped']:>7} "
            f"{r['maintenance_s']:>8.3f} {actions:>7} "
            f"{r['net_utility_s']:>9.3f}  {last}"
        )
    cold = INDEX_LEDGER.cold_candidates()
    if cold:
        lines.append(f"  cold candidates: {', '.join(cold)}")
    return "\n".join(lines)
