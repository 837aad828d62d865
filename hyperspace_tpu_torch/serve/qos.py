"""Weighted-fair scheduling and SLO-aware admission for the serving plane
(counterpart of hyperspace_tpu/serve/qos.py).

One priority+FIFO run queue lets a tenant flooding heavy scans monopolize
the worker slots while every other tenant queues behind it. The scheduler
therefore drains per-tenant queues by **weighted-fair queueing over
delivered cost**:

- Each tenant owns a (-priority, seq) heap — within a tenant, dispatch
  order is exactly the old FIFO+priority order, so a single-tenant process
  dispatches in plain priority+FIFO order.
- Each tenant carries a *virtual-cost clock*: ``vclock += cost / weight``
  charged at query completion from the attribution ledger's ACTUAL
  per-query cost (run wall + io bytes + device transfer bytes, bytes
  normalized at ``HYPERSPACE_QOS_COST_MBPS``). Dispatch always picks the
  backlogged tenant with the smallest vclock, so the clocks — and
  therefore delivered cost *per unit weight* — equalize across backlogged
  tenants regardless of how lopsided their query sizes are.
- An idle tenant's clock does not accumulate credit: on wake (first entry
  into an empty queue) the clock jumps forward to the smallest clock among
  busy tenants (or the high-water mark when all are idle), so returning
  from idle buys fair treatment *from now on*, never a monopoly replaying
  the idle period.
- Queue-wait aging (``HYPERSPACE_SERVE_AGING_MS`` > 0): a queued entry's
  effective priority grows by one level per aging interval waited, capped
  at ``HYPERSPACE_SERVE_AGING_CAP`` — bounded escape hatch for the
  priority-0-starves-forever failure mode under a sustained high-priority
  flood. 0 (default) disables aging and preserves exact static-priority
  order.

``TenantQueues`` is NOT internally locked: every method is called under
the owning scheduler's lock (the ``_locked`` contract scheduler.py already
uses), which is what keeps vclock reads and heap mutation atomic with the
admission bookkeeping.

SLO-aware admission: ``CostModel`` keeps a per-label EWMA of observed run
wall seconds, corrected by the estimator-accuracy ledger's observed
``serve.wall`` factor (telemetry/plan_stats.ACCURACY). A query submitted
with a deadline gets a fast feasibility check at the door — predicted run
cost plus expected queue wait against the deadline — and an unmeetable
deadline rejects *at submit time* (typed ``DeadlineUnmeetable``) instead
of queueing a query that is already dead. Completions with a prediction
observe (predicted, actual) back into ``ACCURACY`` so the correction
factor converges exactly like the scan/join estimators.

Graceful degradation: when the approximate tier is enabled
(``HYPERSPACE_APPROX``) and the submitter allowed it, an unmeetable
deadline degrades instead of rejecting — ``choose_degrade_tier`` picks
the largest sample fraction whose per-tier cost prediction fits the
deadline. Degraded walls feed the cost model under ``tier_label(label,
f)`` only when the sampled tier engaged (plan/sampling.py), never the
exact label; a degrade the tier declined ran exact and feeds the exact
label.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Optional

from ..utils import env
from .tenant import TENANTS

_QUEUED = "queued"  # scheduler's QueryHandle.status value for live entries


class _TenantQueue:
    """One tenant's run queue + virtual clock + delivered totals."""

    __slots__ = ("name", "heap", "queued", "active", "vclock", "totals")

    def __init__(self, name: str):
        self.name = name
        self.heap: list = []  # (-priority, seq, handle); lazily removed
        self.queued = 0  # live (status == queued) entries
        self.active = 0  # dispatched, not yet finished
        self.vclock = 0.0
        self.totals = {
            "admitted": 0, "done": 0, "failed": 0, "cancelled": 0,
            "rejected_rate": 0, "rejected_quota": 0, "rejected_deadline": 0,
            "aging_boosts": 0, "degraded": 0, "cost_s": 0.0,
        }


class TenantQueues:
    """Per-tenant queues + WFQ clocks. Every method runs under the owning
    scheduler's lock (the ``_locked`` contract) — no internal lock."""

    def __init__(self, registry=None):
        self._registry = registry if registry is not None else TENANTS
        self._q: dict[str, _TenantQueue] = {}
        self._vmax = 0.0  # high-water vclock (idle-wake floor)

    def _tq(self, name: str) -> _TenantQueue:
        tq = self._q.get(name)
        if tq is None:
            tq = self._q[name] = _TenantQueue(name)
        return tq

    # --- admission bookkeeping -------------------------------------------

    def counts(self, name: str) -> tuple[int, int]:
        tq = self._q.get(name)
        return (tq.queued, tq.active) if tq is not None else (0, 0)

    def push(self, name: str, entry: tuple) -> None:
        tq = self._tq(name)
        if tq.queued == 0 and tq.active == 0:
            # idle wake: jump the clock forward so the idle period never
            # converts into a backlog-monopolizing credit
            busy = [
                t.vclock for t in self._q.values()
                if t is not tq and (t.queued or t.active)
            ]
            tq.vclock = max(tq.vclock, min(busy) if busy else self._vmax)
        heapq.heappush(tq.heap, entry)
        tq.queued += 1
        tq.totals["admitted"] += 1

    def on_dequeue(self, name: str) -> None:
        self._tq(name).queued -= 1

    def on_activate(self, name: str) -> None:
        self._tq(name).active += 1

    def on_deactivate(self, name: str) -> None:
        self._tq(name).active -= 1

    def note_outcome(self, name: str, status: str) -> None:
        tq = self._tq(name)
        if status in tq.totals:
            tq.totals[status] += 1

    def note_rejection(self, name: str, kind: str) -> None:
        self._tq(name).totals[f"rejected_{kind}"] += 1

    def note_degrade(self, name: str) -> None:
        """An admitted query the deadline door degraded to the sampled
        tier instead of rejecting (counted on top of ``admitted``)."""
        self._tq(name).totals["degraded"] += 1

    # --- WFQ dispatch -----------------------------------------------------

    def pop_locked(self, aging_ms: float = 0.0, aging_cap: int = 0,
                   now: Optional[float] = None):
        """Next dispatchable ``(tenant, handle)``: the smallest-vclock
        tenant with a live queued entry and worker-slot headroom (its
        ``max_active`` quota), or None. Stale (already-cancelled) heap
        entries are skipped without touching counts — their counts were
        released when the scheduler resolved them."""
        while True:
            cands = []
            for tq in self._q.values():
                if tq.queued <= 0:
                    continue
                cap = self._registry.get(tq.name).max_active
                if cap is not None and tq.active >= cap:
                    continue
                cands.append(tq)
            if not cands:
                return None
            tq = min(cands, key=lambda t: (t.vclock, t.name))
            h = self._pop_live(tq, aging_ms, aging_cap, now)
            if h is None:
                tq.queued = 0  # count drifted past an all-stale heap
                continue
            return tq.name, h

    def _pop_live(self, tq: _TenantQueue, aging_ms: float, aging_cap: int,
                  now: Optional[float]):
        if not (aging_ms and aging_ms > 0):
            while tq.heap:
                _, _, h = heapq.heappop(tq.heap)
                if h.status == _QUEUED:
                    return h
            return None
        # aging: effective priority = priority + min(cap, waited/aging_ms);
        # bounded queues make the linear scan cheap, and order genuinely
        # changes with wait time so a static heap order cannot serve
        if now is None:
            now = time.perf_counter()
        best = static = None
        best_key = static_key = None
        for entry in tq.heap:
            pri_neg, seq, h = entry
            if h.status != _QUEUED:
                continue
            waited_ms = max(0.0, (now - h._submit_t) * 1000.0)
            boost = min(int(aging_cap), int(waited_ms / aging_ms))
            key = (pri_neg - boost, seq)
            if best_key is None or key < best_key:
                best, best_key = entry, key
            skey = (pri_neg, seq)
            if static_key is None or skey < static_key:
                static, static_key = entry, skey
        if best is None:
            return None
        if best is not static:
            tq.totals["aging_boosts"] += 1
        tq.heap.remove(best)
        heapq.heapify(tq.heap)
        return best[2]

    # --- virtual-cost charging -------------------------------------------

    def charge(self, name: str, cost_s: float) -> None:
        """Charge a finished query's delivered cost to its tenant's clock.
        Weight is read NOW (not at admission), so reweighting mid-stream
        takes effect on the very next charge."""
        tq = self._tq(name)
        weight = max(1e-6, float(self._registry.get(name).weight))
        tq.vclock += cost_s / weight
        tq.totals["cost_s"] += cost_s
        if tq.vclock > self._vmax:
            self._vmax = tq.vclock

    # --- introspection (still under the scheduler lock) -------------------

    def queued_entries(self) -> list[tuple]:
        """Live ``(tenant, -priority, seq, handle)`` across every queue."""
        out = []
        for tq in self._q.values():
            for pri_neg, seq, h in tq.heap:
                if h.status == _QUEUED:
                    out.append((tq.name, pri_neg, seq, h))
        return out

    def state(self) -> dict:
        """Per-tenant QoS snapshot (weights/quotas from the registry,
        clocks/totals/delivered share from this scheduler)."""
        total_cost = sum(tq.totals["cost_s"] for tq in self._q.values())
        out = {}
        for name, tq in sorted(self._q.items()):
            cfg = self._registry.get(name).config()
            out[name] = {
                **cfg,
                "queued": tq.queued,
                "active": tq.active,
                "vclock": round(tq.vclock, 6),
                "delivered_share": (
                    round(tq.totals["cost_s"] / total_cost, 4)
                    if total_cost > 0 else 0.0
                ),
                **{k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in tq.totals.items()},
            }
        return out


# ---------------------------------------------------------------------------
# cost normalization + the SLO cost model
# ---------------------------------------------------------------------------

def query_cost(record: dict) -> float:
    """A finished query's delivered cost in seconds, from its attribution
    record: run wall + attributed bytes (scan io + device transfers)
    normalized at ``HYPERSPACE_QOS_COST_MBPS`` — so a byte-heavy query that
    overlapped its io under a cheap wall still pays for the ledger share it
    consumed."""
    mbps = env.env_float("HYPERSPACE_QOS_COST_MBPS")
    nbytes = (
        record.get("bytes_read", 0)
        + record.get("upload_bytes", 0)
        + record.get("fetch_bytes", 0)
    )
    return record.get("total_ms", 0.0) / 1000.0 + nbytes / max(1.0, mbps * 1e6)


class CostModel:
    """Per-label EWMA of observed run wall seconds — the deadline-admission
    predictor. Its lock is a plain leaf (read under the scheduler's lock;
    never acquires anything itself). Predictions multiply by the accuracy
    ledger's observed ``serve.wall`` correction factor,
    so a label the EWMA consistently mis-prices converges from truth."""

    _ALPHA = 0.3

    def __init__(self):
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}
        self._global: Optional[float] = None

    def update(self, label: str, run_s: float) -> None:
        with self._lock:
            prev = self._ewma.get(label)
            self._ewma[label] = (
                run_s if prev is None
                else (1 - self._ALPHA) * prev + self._ALPHA * run_s
            )
            self._global = (
                run_s if self._global is None
                else (1 - self._ALPHA) * self._global + self._ALPHA * run_s
            )

    def predict(self, label: str) -> Optional[float]:
        """Corrected run-cost prediction for a label; None = no history
        (an unknown workload is admitted, never guessed at)."""
        with self._lock:
            base = self._ewma.get(label)
        if base is None:
            return None
        from ..telemetry.plan_stats import ACCURACY

        return base * ACCURACY.correction("serve.wall", index=label)

    def mean_run_s(self) -> Optional[float]:
        with self._lock:
            return self._global

    def reset_for_testing(self) -> None:
        with self._lock:
            self._ewma.clear()
            self._global = None


COST_MODEL = CostModel()


def observe_wall(label: str, predicted_s: float, actual_s: float) -> None:
    """Feed a (predicted, actual) run-wall pair into the accuracy
    ledger. MUST be called inside the query's attribution scope so the
    ``estimator.qerror.serve.wall`` histogram stays conserved (per-query
    attributed counts == global deltas)."""
    from ..telemetry.plan_stats import observe

    observe("serve.wall", predicted_s, actual_s, index=label)


def tier_label(label: str, fraction: float) -> str:
    """Cost-model label for a query label running at a sampled fraction.
    Kept separate from the exact label on purpose: sampled walls feeding
    the exact EWMA would teach the door that exact queries are cheap and
    stop it degrading (or rejecting) exactly when it should."""
    return f"{label}|f={fraction:g}"


def choose_degrade_tier(label: str, deadline_s: float, queued: int,
                        max_concurrent: int) -> Optional[dict]:
    """Pick the sampled tier for a query whose exact-tier deadline verdict
    came back unmeetable: the LARGEST configured fraction (most accurate
    answer) whose predicted completion fits the deadline, falling back to
    the smallest fraction when none fits (serve a coarse answer inside a
    best-effort wall rather than reject). Per-tier predictions come from
    the tier's own EWMA once observed; before any observation the exact
    prediction scaled by the fraction is the prior — sampled scan cost is
    ~linear in kept rows. None when approximation is off (no fractions
    configured / ``HYPERSPACE_APPROX`` disabled) — the caller then rejects
    exactly as before."""
    from ..models import sample_store

    if not sample_store.approx_enabled():
        return None
    fractions = sample_store.sample_fractions()
    if not fractions:
        return None
    exact = COST_MODEL.predict(label)
    mean = COST_MODEL.mean_run_s()
    base = exact if exact is not None else mean
    if base is None:
        return None  # no evidence at all: verdict admits, never degrades
    chosen = None
    for f in sorted(fractions, reverse=True):
        pred = COST_MODEL.predict(tier_label(label, f))
        if pred is None:
            pred = base * f
        wait = (queued / max(1, max_concurrent)) * (
            mean if mean is not None else pred
        )
        tier = {"fraction": f, "predicted_s": pred,
                "expected_s": wait + pred}
        if tier["expected_s"] <= deadline_s:
            return tier
        chosen = tier  # loop is descending: ends at the smallest fraction
    return chosen


def deadline_verdict(label: str, deadline_s: float, queued: int,
                     max_concurrent: int) -> dict:
    """Fast feasibility check at the admission door. Expected completion =
    predicted run cost (per-label, corrected) + expected queue wait
    (queue depth / worker slots × global mean run cost). With zero history
    the query is admitted — rejection requires evidence, not a guess."""
    predicted = COST_MODEL.predict(label)
    mean = COST_MODEL.mean_run_s()
    if predicted is None and mean is None:
        return {"admit": True, "predicted_s": None, "expected_s": None}
    run = predicted if predicted is not None else mean
    wait = (queued / max(1, max_concurrent)) * (mean if mean is not None else run)
    expected = wait + run
    return {
        "admit": expected <= deadline_s,
        "predicted_s": predicted,
        "expected_s": expected,
    }
