"""Operator-level runtime statistics: per-node actuals, estimator accuracy,
and the EXPLAIN ANALYZE surface (counterpart of
hyperspace_tpu/telemetry/plan_stats.py).

The optimizer makes three kinds of estimates nothing used to check:
``plan/pruning.estimate_scan_fraction`` (how much of a covering index a
predicate keeps), ``FilterIndexRanker``'s size-x-selectivity cost, and
``plan/join_memory.plan_join_memory``'s per-bucket row/byte sizes from
parquet footer stats.  This module closes the loop in three layers:

1. **EstimatorAccuracy** (process-wide, always on): every estimator
   chokepoint that later learns the truth calls ``ACCURACY.observe(name,
   predicted, actual, index=..., shape=...)``.  The observation feeds a
   ``estimator.qerror.<name>`` histogram in the metrics registry and a
   bounded per-(estimator, index, predicate-shape) log-ratio window from
   which ``correction()`` derives the observed geometric-mean
   actual/predicted factor.

2. **PlanStatsCollector** (per-query, contextvar): installed by
   ``hs.explain_analyze`` / ``df.explain(analyze=True)`` or force-enabled
   with ``HYPERSPACE_PLAN_STATS=1``.  The executor records every plan
   node's rows out / inclusive wall time, the device tier notes the route
   taken (host / device / pipelined / bucketed), scans
   note files/bytes, and the pruning/estimator chokepoints attach their
   q-errors to the node they describe.  ``render_annotated`` prints the
   optimized plan tree with the actuals next to each node.  When no
   collector is installed every hook is ONE contextvar read returning
   None — the disabled path allocates nothing.

3. **Feedback** (``HYPERSPACE_ESTIMATOR_FEEDBACK=1``, off by default):
   ``FilterIndexRanker`` and ``plan_join_memory`` multiply their estimates
   by ``ACCURACY.correction(...)`` so a layout whose selectivity the
   uniform-bucket model consistently mis-prices gets re-ranked from
   observed truth.  Off, the observe-only path changes nothing.

Collection is observe-only by construction: the collector never feeds back
into an execution decision, so an analyze-mode run is bit-identical to a
plain ``collect()``, and no hook synchronizes the device: a node's wall
time on the card is what the host waited for.

The JAX package's collector also records mid-query adaptation events and
the sampled tier's confidence intervals, and feeds the workload journal;
the port has no adaptive, sampling or workload plane yet, so those wait
with them.
"""

from __future__ import annotations

import collections
import contextvars
import math
import threading
from typing import Optional

from ..utils import env

# q-error histogram bounds: 1.0 = perfect estimate; the tail buckets catch
# order-of-magnitude misses worth re-ranking on
QERROR_BOUNDS = (1.05, 1.1, 1.25, 1.5, 2.0, 4.0, 8.0, 16.0, 64.0, 256.0)

# per-(estimator, index, shape) observation window for correction factors
_RATIO_WINDOW = 128

# floor for predicted/actual values so zero never blows up the ratio: a
# predicted-empty scan that kept bytes is exactly the kind of miss the
# q-error tail should record, not an exception
_EPS = 1e-9


def feedback_enabled() -> bool:
    """``HYPERSPACE_ESTIMATOR_FEEDBACK=1``: estimator consumers consult the
    accuracy ledger's correction factors.  Off (default) the ledger is
    observe-only and planning behavior is bit-identical to pre-ledger."""
    return env.env_bool("HYPERSPACE_ESTIMATOR_FEEDBACK")


def stats_forced() -> bool:
    """``HYPERSPACE_PLAN_STATS=1``: collect per-node plan statistics on
    every ``collect()`` (annotations ride exec spans when tracing)."""
    return env.env_bool("HYPERSPACE_PLAN_STATS")


# ---------------------------------------------------------------------------
# estimator-accuracy ledger (process-wide, always on)
# ---------------------------------------------------------------------------

class EstimatorAccuracy:
    """Estimate-vs-actual ledger for the engine's cardinality/size
    estimators.  ``observe`` is the single entry point; the q-error
    histograms live in the metrics registry, the correction windows live
    here under one leaf lock (metric emission happens outside it)."""

    def __init__(self):
        self._lock = threading.Lock()
        # (estimator, index, shape) -> deque of log(actual/predicted)
        self._ratios: dict[tuple, collections.deque] = {}
        self._counts: dict[str, int] = {}

    def observe(self, estimator: str, predicted: float, actual: float,
                index: str = "", shape: str = "") -> float:
        """Record one (predicted, actual) pair; returns the q-error
        ``max(p/a, a/p)`` (1.0 = perfect).  Also appends the log-ratio to
        the exact (estimator, index, shape) window AND the shape-agnostic
        (estimator, index, "") window so corrections degrade gracefully
        when a later query's shape key differs."""
        p = max(float(predicted), _EPS)
        a = max(float(actual), _EPS)
        q = max(p / a, a / p)
        ratio = math.log(a / p)
        keys = [(estimator, index, shape)]
        if shape:
            keys.append((estimator, index, ""))
        with self._lock:
            for key in keys:
                dq = self._ratios.get(key)
                if dq is None:
                    dq = self._ratios[key] = collections.deque(
                        maxlen=_RATIO_WINDOW
                    )
                dq.append(ratio)
            self._counts[estimator] = self._counts.get(estimator, 0) + 1
        from .metrics import REGISTRY

        REGISTRY.counter("estimator.observations").inc()
        REGISTRY.histogram(
            f"estimator.qerror.{estimator}", QERROR_BOUNDS
        ).observe(q)
        from . import workload

        workload.observe_qerror(estimator, q)
        from . import trace

        if trace.enabled():
            trace.add_event(
                "qerror", estimator=estimator, index=index, shape=shape,
                predicted=round(p, 6), actual=round(a, 6),
                qerror=round(q, 3),
            )
        return q

    def correction(self, estimator: str, index: str = "",
                   shape: str = "") -> float:
        """Observed geometric-mean actual/predicted factor for the key
        (exact shape first, then the shape-agnostic window); 1.0 when
        nothing has been observed — an unknown estimator is trusted."""
        with self._lock:
            vals = list(
                self._ratios.get((estimator, index, shape))
                or self._ratios.get((estimator, index, ""))
                or ()
            )
        if not vals:
            return 1.0
        return math.exp(sum(vals) / len(vals))

    def snapshot(self) -> dict:
        """Per-estimator q-error summaries (read from the registry histograms
        — one consistent cut each) plus the correction-factor table."""
        from .metrics import REGISTRY

        with self._lock:
            counts = dict(self._counts)
            keys = sorted(self._ratios)
            corrections = {
                "|".join(k): round(math.exp(sum(dq) / len(dq)), 4)
                for k, dq in sorted(self._ratios.items())
                if dq
            }
        qerror = {}
        for est in sorted(counts):
            h = REGISTRY.get(f"estimator.qerror.{est}")
            qerror[est] = h.summary() if h is not None else {"count": 0}
        return {
            "observations": sum(counts.values()),
            "by_estimator": counts,
            "qerror": qerror,
            "correction_keys": len(keys),
            "corrections": dict(list(corrections.items())[:64]),
        }

    def reset_for_testing(self) -> None:
        with self._lock:
            self._ratios.clear()
            self._counts.clear()


ACCURACY = EstimatorAccuracy()


# ---------------------------------------------------------------------------
# per-query collector
# ---------------------------------------------------------------------------

class NodeStats:
    """Actuals of one executed plan node. ``wall_s`` is inclusive of the
    node's children (span semantics)."""

    __slots__ = ("plan_id", "kind", "rows_out", "wall_s", "route",
                 "bytes_scanned", "files_scanned", "qerrors", "executed")

    def __init__(self, plan_id: int, kind: str = "?"):
        self.plan_id = plan_id
        self.kind = kind
        self.rows_out: Optional[int] = None
        self.wall_s = 0.0
        self.route = "host"
        self.bytes_scanned: Optional[int] = None
        self.files_scanned: Optional[int] = None
        self.qerrors: list[tuple] = []  # (estimator, predicted, actual, q)
        self.executed = False


class PlanStatsCollector:
    """One query's node-level actuals + the plan they describe.  Mutated
    from the query's worker thread (executor, tpu_exec, pruning) under one
    plain leaf lock — nothing else is ever acquired while holding it."""

    __slots__ = ("_lock", "nodes", "plan", "flags", "joins")

    def __init__(self):
        self._lock = threading.Lock()
        self.nodes: dict[int, NodeStats] = {}
        self.plan = None  # optimized root, captured at collect time
        self.flags: dict[str, int] = {}  # query-level events (e.g. spilled)
        self.joins: list[dict] = []  # join memory-plan decision mixes

    def _node(self, plan_id: int, kind: str = "?") -> NodeStats:
        ns = self.nodes.get(plan_id)
        if ns is None:
            ns = self.nodes[plan_id] = NodeStats(plan_id, kind)
        return ns

    # --- write paths (each guarded; all leaf-locked) ----------------------

    def record_node(self, plan, rows_out: int, wall_s: float) -> NodeStats:
        with self._lock:
            ns = self._node(plan.plan_id, plan.kind)
            ns.kind = plan.kind
            ns.rows_out = rows_out
            ns.wall_s += wall_s
            ns.executed = True
            if ns.bytes_scanned is None and plan.kind == "FileScan":
                ns.files_scanned = len(plan.files)
                ns.bytes_scanned = sum(f.size for f in plan.files)
            return ns

    def note_route(self, plan_id: int, route: str) -> None:
        with self._lock:
            self._node(plan_id).route = route

    def note_scan(self, plan_id: int, files: int, nbytes: int,
                  rows: Optional[int] = None) -> None:
        with self._lock:
            ns = self._node(plan_id, "FileScan")
            ns.files_scanned = files
            ns.bytes_scanned = nbytes
            if rows is not None and ns.rows_out is None:
                ns.rows_out = rows

    def note_qerror(self, plan_id: int, estimator: str,
                    predicted: float, actual: float, q: float) -> None:
        with self._lock:
            self._node(plan_id).qerrors.append(
                (estimator, predicted, actual, q)
            )

    def note_flag(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.flags[name] = self.flags.get(name, 0) + n

    def note_join_plan(self, info: dict) -> None:
        with self._lock:
            self.joins.append(info)


    # --- reads ------------------------------------------------------------

    def annotation(self, plan_id: int) -> str:
        """The per-node EXPLAIN ANALYZE suffix, '' when nothing recorded."""
        with self._lock:
            ns = self.nodes.get(plan_id)
            if ns is None:
                return ""
            parts = []
            if ns.rows_out is not None:
                parts.append(f"rows={ns.rows_out}")
            if ns.executed:
                parts.append(f"wall={ns.wall_s * 1000:.2f}ms")
            if ns.route != "host":
                parts.append(f"route={ns.route}")
            if ns.bytes_scanned is not None:
                parts.append(f"bytes={ns.bytes_scanned}")
            if ns.files_scanned is not None:
                parts.append(f"files={ns.files_scanned}")
            ann = f"[{' '.join(parts)}]" if parts else ""
            for est, p, a, q in ns.qerrors:
                ann += (
                    f" [{est}: pred={p:.4g} actual={a:.4g} q={q:.2f}]"
                )
            return ann

    def summary(self) -> dict:
        with self._lock:
            qerrors = [
                (ns.kind, est, p, a, q)
                for ns in self.nodes.values()
                for est, p, a, q in ns.qerrors
            ]
            return {
                "nodes_executed": sum(
                    1 for ns in self.nodes.values() if ns.executed
                ),
                "routes": collections.Counter(
                    ns.route for ns in self.nodes.values() if ns.executed
                ),
                "flags": dict(self.flags),
                "joins": list(self.joins),
                "qerrors": qerrors,
            }


_collector: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_plan_stats", default=None
)


def current() -> Optional[PlanStatsCollector]:
    """The active collector, or None (the one-read disabled check)."""
    return _collector.get()


class collect_scope:
    """Install a fresh collector for the block (what EXPLAIN ANALYZE runs under).
    Nested scopes keep the OUTER collector so an analyze call composes
    with a force-enabled environment."""

    __slots__ = ("_token", "collector")

    def __enter__(self) -> PlanStatsCollector:
        outer = _collector.get()
        if outer is not None:
            self.collector = outer
            self._token = None
            return outer
        from .metrics import REGISTRY

        self.collector = PlanStatsCollector()
        REGISTRY.counter("plan_stats.collectors").inc()
        self._token = _collector.set(self.collector)
        return self.collector

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _collector.reset(self._token)
        return False


class maybe_scope:
    """``collect_scope`` iff ``HYPERSPACE_PLAN_STATS=1`` and no collector
    is active; otherwise a no-op.  The ``DataFrame.collect`` hook."""

    __slots__ = ("_inner",)

    def __enter__(self):
        self._inner = None
        if _collector.get() is None and stats_forced():
            self._inner = collect_scope()
            return self._inner.__enter__()
        return _collector.get()

    def __exit__(self, *exc) -> bool:
        if self._inner is not None:
            return self._inner.__exit__(*exc)
        return False


def note_plan(plan) -> None:
    """Capture the optimized plan the collector's node stats describe."""
    col = _collector.get()
    if col is not None and col.plan is None:
        col.plan = plan


def note_route(plan_id: int, route: str) -> None:
    """Route chokepoint hook (gpu_exec / executor): one
    contextvar read when no collector is installed."""
    col = _collector.get()
    if col is not None:
        col.note_route(plan_id, route)


def note_scan(plan_id: int, files: int, nbytes: int,
              rows: Optional[int] = None) -> None:
    col = _collector.get()
    if col is not None:
        col.note_scan(plan_id, files, nbytes, rows)


def note_flag(name: str, n: int = 1) -> None:
    col = _collector.get()
    if col is not None:
        col.note_flag(name, n)



def observe(estimator: str, predicted: float, actual: float,
            index: str = "", shape: str = "",
            plan_id: Optional[int] = None) -> float:
    """``ACCURACY.observe`` + attach the q-error to the collector's node
    when one is active.  The single call estimator chokepoints make."""
    q = ACCURACY.observe(estimator, predicted, actual, index, shape)
    if plan_id is not None:
        col = _collector.get()
        if col is not None:
            col.note_qerror(plan_id, estimator, predicted, actual, q)
    return q


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render_annotated(plan, col: PlanStatsCollector) -> str:
    """The optimized plan tree with each node's actuals appended — the
    EXPLAIN ANALYZE body.  Un-executed nodes (fused into a device fragment,
    or short-circuited by a cache hit) render without an [..] block."""
    lines: list[str] = []

    def walk(node, indent: int) -> None:
        ann = col.annotation(node.plan_id)
        lines.append("  " * indent + node.describe() + ("  " + ann if ann else ""))
        for c in node.children():
            walk(c, indent + 1)

    if plan is not None:
        walk(plan, 0)
    return "\n".join(lines)


def summary_string(col: PlanStatsCollector) -> str:
    """Footer of the EXPLAIN ANALYZE report: route mix, query-level flags,
    join memory-plan decisions, and this query's estimator q-errors."""
    s = col.summary()
    lines = []
    routes = " ".join(
        f"{r}={n}" for r, n in sorted(s["routes"].items())
    ) or "(none)"
    lines.append(f"routes: {routes} ; nodes executed: {s['nodes_executed']}")
    if s["flags"]:
        lines.append(
            "flags: " + " ".join(
                f"{k}={v}" for k, v in sorted(s["flags"].items())
            )
        )
    for j in s["joins"]:
        lines.append(
            "join plan: " + " ".join(f"{k}={v}" for k, v in sorted(j.items()))
        )
    if s["qerrors"]:
        lines.append("estimator q-errors (this query):")
        for kind, est, p, a, q in s["qerrors"]:
            lines.append(
                f"  {est} @ {kind}: pred={p:.4g} actual={a:.4g} q={q:.2f}"
            )
    else:
        lines.append("estimator q-errors (this query): (none recorded)")
    return "\n".join(lines)


def accuracy_string() -> str:
    """Process-wide estimator-accuracy block (``hs.profile``)."""
    snap = ACCURACY.snapshot()
    lines = ["Estimator accuracy (process-wide):"]
    if not snap["observations"]:
        lines.append("  (no observations yet)")
        return "\n".join(lines)
    for est, h in sorted(snap["qerror"].items()):
        if not h.get("count"):
            continue
        lines.append(
            f"  qerror.{est}: n={h['count']} mean={h.get('mean', 0):.3f} "
            f"max={h.get('max', 0):.3f}"
        )
    lines.append(
        f"  corrections tracked: {snap['correction_keys']} "
        f"(feedback={'on' if feedback_enabled() else 'off'})"
    )
    return "\n".join(lines)
