"""The multi-tenant QoS gate: weighted tenants through one scheduler get
cost in proportion to their weights, over-quota tenants are refused with
the typed errors, per-tenant attribution is conserved and every result is
the serial one bit for bit, under the lock-order audit (counterpart of the
reference repo's ``tools/qos_smoke.py``).

Three tenants at weights 1:2:3 (bronze, silver, gold) each run a
closed-loop feeder that keeps ``backlog`` queries in flight against ONE
``QueryScheduler`` until ``target`` results have come back; as every
tenant stays backlogged, the weighted-fair virtual clocks equalize the
cost delivered per unit of weight. A quota exercise then drives the typed
rejections (``max_in_flight``, the token bucket, an unmeetable deadline).

The served set is the reference's ``TPCH_QUERIES`` plus the port's
kernel-shaped forms ``q6_count``, ``q6_sum`` and ``q1_sums`` (a port-only
addition, as in ``serve_smoke``): on the card the tenants' queries launch
kernels 1-3 from the scheduler's workers. After the fairness window a
kernel wave submits each kernel-shaped query once per worker, meeting at
a barrier, under the default tenant (outside the three tenants' shares).

Required (exit 0 iff all hold):

- every served result equals the serial one bit for bit;
- each kernel-shaped run counted its one kernel on the worker thread that
  served it, and each kernel from at least two workers;
- ``fairness_ratio`` (max over min of delivered cost per unit weight
  across the three tenants) <= ``fair_tol`` (1.8; a weight-blind FIFO
  scores about 3.0 on this workload);
- the quota-capped and rate-limited tenants raise ``TenantQuotaExceeded``
  (not ``AdmissionRejected``), an unmeetable deadline raises
  ``DeadlineUnmeetable``, and ``serve.tenant.rejected.{quota,rate,
  deadline}`` each move;
- per tenant, the ledger's sums of every ``io. cache. rpc. pipeline.
  pruning. serve.budget.`` counter over the window, summed over tenants,
  equal the global deltas;
- ``staticcheck.lock.violations`` does not move; the global budget
  drains; every bounded cache is consistent; the scheduler is idle; at
  least ``target`` results came back and the read-ahead reserved through
  the global budget.

Departures from the reference, by decision: ``HYPERSPACE_DEVICE_STRICT``
(a breaker knob the port does not register) is not set; the caches
checked are the session's (``_common.cache_consistency``); the ledger
window is the one the package was imported with (``_common.
Conservation``).

    python -m hyperspace_tpu_torch.tools.qos_smoke [--device cpu] [--rows N]

Env: SMOKE_CONCURRENT (4), SMOKE_TARGET served queries in the fairness
window (60), SMOKE_BACKLOG per-tenant in-flight depth (4), SMOKE_ROWS
(40000), FAIR_TOL (1.8), SMOKE_LOCK_AUDIT=0 turns the audit off. Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading
import time

from . import _common
from .serve_smoke import KERNEL_QUERIES, served_queries

CONCURRENT = 4
TARGET = 60
BACKLOG = 4
ROWS = 40_000
FAIR_TOL = 1.8
SEED = 29
BUCKETS = 8
ENV = {"HYPERSPACE_STREAM_CHUNK_MB": "0.5", "HYPERSPACE_IO_THREADS": "4"}
WEIGHTS = {"bronze": 1.0, "silver": 2.0, "gold": 3.0}


def rejections(sched) -> dict:
    """The typed refusals: a second query of a tenant capped at one in
    flight, a second of a tenant whose bucket holds one token, and a
    deadline the cost model says cannot be met."""
    from .. import serve
    from ..serve import qos
    from ..serve.tenant import TENANTS, TenantQuotaExceeded

    out = {"quota": False, "rate": False, "deadline": False, "quota_not_admission": False}
    TENANTS.configure("capped", max_in_flight=1)
    gate = threading.Event()
    running = sched.submit(lambda: gate.wait(30), tenant="capped", label="capped-runner")
    try:
        sched.submit(lambda: 1, tenant="capped", label="capped-over")
    except TenantQuotaExceeded as e:
        out["quota"] = True
        out["quota_not_admission"] = not isinstance(e, serve.AdmissionRejected)
    gate.set()
    running.result(30)

    TENANTS.configure("ratey", rate_qps=0.001, burst=1)
    sched.submit(lambda: 1, tenant="ratey", label="ratey-1").result(30)
    try:
        sched.submit(lambda: 2, tenant="ratey", label="ratey-2")
    except TenantQuotaExceeded:
        out["rate"] = True

    qos.COST_MODEL.update("deadline-probe", 0.5)
    try:
        sched.submit(lambda: 3, label="deadline-probe", deadline_s=0.001)
    except serve.DeadlineUnmeetable:
        out["deadline"] = True
    return out


def run(device, root: "str | None" = None, concurrent: int = CONCURRENT, target: int = TARGET,
        backlog: int = BACKLOG, rows: int = ROWS, fair_tol: float = FAIR_TOL,
        lock_audit: bool = True) -> dict:
    """The gate over a TPC-H lake of ``rows`` lineitem rows in a temporary
    directory (under ``root`` when given), removed at the end; ``results``
    holds the serial results."""
    from .. import serve
    from ..serve.tenant import TENANTS
    from ..staticcheck import concurrency as cc
    from ..utils.workers import spawn_thread

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    ws = tempfile.mkdtemp(prefix="hs_qos_smoke_", dir=root)
    sched = None
    try:
        with _common.gate_scope(ENV, lock_audit=lock_audit):
            idle = _common.settle_background()
            session = _common.tpch_world(ws, rows, device, seed=SEED, buckets=BUCKETS)
            fns = served_queries()
            names = list(fns)
            results = {n: fns[n](session, ws).to_pydict() for n in names}
            serial = {n: _common.bits(r) for n, r in results.items()}
            for name, w in WEIGHTS.items():
                TENANTS.configure(name, weight=w)

            violations0 = _common.counter("staticcheck.lock.violations")
            acquisitions0 = _common.counter("staticcheck.lock.acquisitions")
            reservations0 = _common.counter("serve.budget.reservations")
            conservation = _common.Conservation(by="tenant")
            sched = serve.QueryScheduler(max_concurrent=concurrent,
                                         queue_depth=max(64, 4 * backlog * 3))
            mismatches: list = []
            errors: list = []
            runs: list = []
            served = {"n": 0}
            served_lock = threading.Lock()
            stop = threading.Event()

            def check(tenant: str, name: str, h) -> None:
                out, launched, thread = h.result(timeout=300)
                runs.append((name, launched, thread))
                if _common.bits(out.to_pydict()) != serial[name]:
                    mismatches.append((tenant, name))

            def feeder(tenant: str, tid: int) -> None:
                """Closed loop with a constant in-flight backlog: the
                tenant stays backlogged, the regime weighted-fair shares
                are defined over."""
                try:
                    inflight: list = []
                    i = 0
                    while not stop.is_set():
                        while len(inflight) < backlog and not stop.is_set():
                            name = names[(tid + i) % len(names)]
                            i += 1
                            inflight.append((name, sched.submit(
                                (lambda n=name: _common.counted(
                                    device, lambda: fns[n](session, ws).collect())),
                                label=name, tenant=tenant)))
                        if not inflight:
                            break
                        name, h = inflight.pop(0)
                        check(tenant, name, h)
                        with served_lock:
                            served["n"] += 1
                            if served["n"] >= target:
                                stop.set()
                    for name, h in inflight:  # the tail
                        check(tenant, name, h)
                except Exception as e:  # noqa: BLE001 - reported through the gate
                    errors.append((tenant, repr(e)))

            feeders = [spawn_thread(feeder, name=f"hs-qos-{t}", daemon=False, args=(t, i))
                       for i, t in enumerate(WEIGHTS)]
            for t in feeders:
                t.join()
            sched.drain(timeout=120)

            # fairness: delivered cost per unit weight, equal across tenants
            tenants_state = sched.state()["tenants"]
            per_weight = {n: tenants_state[n]["cost_s"] / WEIGHTS[n]
                          for n in WEIGHTS if n in tenants_state}
            fairness_ratio = (max(per_weight.values()) / max(1e-9, min(per_weight.values()))
                              if len(per_weight) == len(WEIGHTS) else float("inf"))

            wave = _common.kernel_wave(sched, {q: fns[q] for q in KERNEL_QUERIES}, session, ws,
                                       device, concurrent)
            errors += wave["errors"]
            mismatches += _common.wave_mismatches(wave, serial)
            kernels = _common.kernel_leg(device, runs + wave["runs"], KERNEL_QUERIES)

            rejected0 = {k: _common.counter(f"serve.tenant.rejected.{k}")
                         for k in ("rate", "quota", "deadline")}
            typed = {"quota": False, "rate": False, "deadline": False,
                     "quota_not_admission": False}
            try:
                typed = rejections(sched)
            except Exception as e:  # noqa: BLE001 - reported through the gate
                errors.append(("rejection-exercise", repr(e)))
            sched.drain(timeout=60)
            rejected = {k: _common.counter(f"serve.tenant.rejected.{k}") - v
                        for k, v in rejected0.items()}

            unconserved = conservation.settle()
            quiet = _common.quiescence(sched, session)
            sched.shutdown(wait=True)
            sched = None
            lock_report = cc.report()
            violations = _common.counter("staticcheck.lock.violations") - violations0
            acquisitions = _common.counter("staticcheck.lock.acquisitions") - acquisitions0
            reservations = _common.counter("serve.budget.reservations") - reservations0
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
        TENANTS.reset_for_testing()
        shutil.rmtree(ws, ignore_errors=True)
    fairness_ok = fairness_ratio <= fair_tol
    ok = (not mismatches and not errors and kernels["ok"] and fairness_ok
          and all(typed.values()) and all(v >= 1 for v in rejected.values())
          and violations == 0 and all(quiet["cache_consistency"].values())
          and quiet["budget_drained"] and quiet["scheduler_quiescent"] and not unconserved
          and served["n"] >= target and reservations > 0 and idle)
    out = {
        "device": str(device),
        "rows": rows,
        "max_concurrent": concurrent,
        "target": target,
        "backlog": backlog,
        "queries": names,
        "tenants": {n: {"weight": WEIGHTS[n],
                        **{k: tenants_state.get(n, {}).get(k)
                           for k in ("done", "cost_s", "delivered_share", "vclock")}}
                    for n in WEIGHTS},
        "served": served["n"],
        "wave_runs": len(wave["runs"]),
        "bit_identical": not mismatches and not errors,
        "mismatches": mismatches[:10],
        "errors": errors[:10],
        "kernels": kernels,
        "cost_per_weight": per_weight,
        "fairness_ratio": fairness_ratio,
        "fairness_tolerance": fair_tol,
        "fairness_ok": fairness_ok,
        "typed_rejections": typed,
        "tenant_rejection_counters": rejected,
        "attribution_conserved_per_tenant": not unconserved,
        "conservation_mismatches": dict(list(unconserved.items())[:10]),
        "scheduler_quiescent": quiet["scheduler_quiescent"],
        "budget_drained": quiet["budget_drained"],
        "budget_reservations": reservations,
        "lock_audit": lock_report["audit_enabled"],
        "lock_acquisitions": acquisitions,
        "lock_violations": violations,
        "cache_consistency": quiet["cache_consistency"],
        "background_idle": idle,
        "ok": ok,
        "seconds": time.perf_counter() - t0,
        "results": results,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    _common.add_rows_flag(p, ROWS)
    args = p.parse_args(argv)
    device = _common.resolve_device(args.device)
    out = run(device,
              concurrent=_common.smoke_int("SMOKE_CONCURRENT", CONCURRENT),
              target=_common.smoke_int("SMOKE_TARGET", TARGET),
              backlog=_common.smoke_int("SMOKE_BACKLOG", BACKLOG),
              rows=args.rows,
              # hslint: HS301 — the gate's own tolerance knob, not an engine knob
              fair_tol=float(os.environ.get("FAIR_TOL", FAIR_TOL)),
              lock_audit=_common.smoke_flag("SMOKE_LOCK_AUDIT"))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
