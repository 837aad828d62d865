"""The plan-statistics gate: EXPLAIN ANALYZE and the estimators' accuracy
(counterpart of the reference repo's ``tools/plan_stats_smoke.py``).

Four legs, one JSON line, exit 0 iff every check holds:

1. **Analyze bit-identity.** Every TPC-H query (``TPCH_QUERIES``) and the
   pruned point, range and IN queries over a bucketed covering index
   (``ev_k_idx`` over an events table) run once plain and once with the
   plan-statistics collector installed (``plan_stats.collect_scope``,
   what ``explain_analyze`` drives); the results are equal at
   ``float.hex()`` precision and the collector saw every query's nodes.
2. **Feedback off against on.** With ``HYPERSPACE_ESTIMATOR_FEEDBACK=1``
   the ranker may re-rank candidates, but every result stays bit for bit
   the plain run's.
3. **The annotated output.** ``explain_analyze`` of the pruned point
   query shows per-node actual rows and bytes and a scan-fraction q-error.
4. **Concurrent conservation.** Four point queries served at once through
   one scheduler: the ``estimator.qerror.*`` histogram counts summed over
   their four ledger records equal the global deltas, observations > 0,
   and ``staticcheck.lock.violations`` does not move (the lock-order audit
   is on throughout).

Departures from the reference, by decision: ``HYPERSPACE_DEVICE_STRICT``
(a breaker knob the port does not register) is not set; the lock
violations are the gate's delta, not the process's total, so the gate
can run inside a longer process.

    python -m hyperspace_tpu_torch.tools.plan_stats_smoke [--device cpu] [--rows N]

Env: SMOKE_ROWS (lineitem rows, 120000). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

from . import _common

ROWS = 120_000
SEED = 7
BUCKETS = 8
EVENT_FILES = 8
EVENT_SEED = 3
SERVED = 4
ENV = {"HYPERSPACE_STREAM_CHUNK_MB": "0.5", "HYPERSPACE_IO_THREADS": "4",
       "HYPERSPACE_ESTIMATOR_FEEDBACK": None, "HYPERSPACE_PLAN_STATS": None}
FEEDBACK_ON = {"HYPERSPACE_ESTIMATOR_FEEDBACK": "1"}


def event_rows(rows: int) -> int:
    return max(rows, 80_000)


def write_events(ws: str, rows: int) -> None:
    """The events table: ``event_rows(rows)`` rows in EVENT_FILES files,
    ``ev_k`` ascending across them (the reference's generator)."""
    import numpy as np

    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch

    rng = np.random.default_rng(EVENT_SEED)
    per = event_rows(rows) // EVENT_FILES
    for i in range(EVENT_FILES):
        data = {"ev_k": (np.arange(per, dtype=np.int64) + i * per).tolist(),
                "ev_q": rng.integers(1, 50, per).tolist(),
                "ev_v": rng.uniform(0, 100, per).tolist()}
        cio.write_parquet(ColumnBatch.from_pydict(data),
                          os.path.join(ws, "events", f"part-{i:02d}.parquet"))


def keys(rows: int) -> dict:
    """The point key and the range the sections read."""
    n_ev = event_rows(rows)
    return {"point": int(n_ev * 5 // 8 + 17), "lo": int(n_ev // 8 + 100),
            "hi": int(n_ev // 8 + 2100), "last": int(n_ev - 5)}


def run(device, root: "str | None" = None, rows: int = ROWS) -> dict:
    """The gate over a TPC-H lake of ``rows`` lineitem rows and the events
    table in a temporary directory (under ``root`` when given), removed at
    the end; ``results`` holds the plain results, ``report`` the annotated
    EXPLAIN ANALYZE."""
    from .. import CoveringIndexConfig, Hyperspace, serve
    from ..benchmark.tpch import TPCH_QUERIES
    from ..plan import col
    from ..telemetry import plan_stats
    from ..telemetry.attribution import LEDGER

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    ws = tempfile.mkdtemp(prefix="hs_plan_stats_smoke_", dir=root)
    try:
        with _common.gate_scope(ENV, lock_audit=True):
            idle = _common.settle_background()
            violations0 = _common.counter("staticcheck.lock.violations")
            observations0 = _common.counter("estimator.observations")
            write_events(ws, rows)
            session = _common.tpch_world(ws, rows, device, seed=SEED, buckets=BUCKETS)
            session.disable_hyperspace()
            hs = Hyperspace(session)
            hs.create_index(session.read.parquet(os.path.join(ws, "events")),
                            CoveringIndexConfig("ev_k_idx", ["ev_k"], ["ev_q", "ev_v"]))
            session.enable_hyperspace()

            def ev():
                return session.read.parquet(os.path.join(ws, "events"))

            k = keys(rows)

            def point(key=k["point"]):
                return ev().filter(col("ev_k") == key).select("ev_k", "ev_q", "ev_v")

            sections = {
                "point": lambda: point().to_pydict(),
                "range": lambda: ev().filter((col("ev_k") >= k["lo"]) & (col("ev_k") < k["hi"]))
                .select("ev_k", "ev_v").to_pydict(),
                "in": lambda: ev().filter(col("ev_k").isin([3, k["point"], k["last"]]))
                .select("ev_k", "ev_q").to_pydict(),
            }
            for name in TPCH_QUERIES:
                sections[name] = (lambda n=name: TPCH_QUERIES[n](session, ws).to_pydict())

            # legs 1 and 2: plain, analyzed and feedback-on runs, bit for bit
            mismatches = []
            plain = {}
            results = {}
            for name, q in sections.items():
                results[name] = q()
                plain[name] = _common.bits(results[name])
                with plan_stats.collect_scope() as colr:
                    analyzed = _common.bits(q())
                if analyzed != plain[name]:
                    mismatches.append(("analyze", name))
                if not colr.nodes:
                    mismatches.append(("no-node-stats", name))
            with _common.gate_scope(FEEDBACK_ON):
                for name, q in sections.items():
                    if _common.bits(q()) != plain[name]:
                        mismatches.append(("feedback", name))

            # leg 3: the annotated EXPLAIN ANALYZE
            report = hs.explain_analyze(point())
            annotated_ok = all(s in report for s in ("rows=", "bytes=", "scan_fraction", "q="))

            # leg 4: SERVED concurrent point queries, the q-error ledger conserved
            g0 = _common.histogram_counts("estimator.qerror.")
            seq0 = LEDGER.last_seq()
            sched = serve.QueryScheduler(max_concurrent=SERVED, queue_depth=16)
            try:
                handles = [sched.submit((lambda key=k["point"] + i: ev()
                                         .filter(col("ev_k") == key).select("ev_k", "ev_q")
                                         .collect()), label=f"est:{i}")
                           for i in range(SERVED)]
                for h in handles:
                    h.result(timeout=300)
            finally:
                sched.shutdown(wait=True)
            g1 = _common.histogram_counts("estimator.qerror.")
            global_delta = {h: g1.get(h, 0) - g0.get(h, 0) for h in set(g0) | set(g1)}
            served = [r for r in LEDGER.recent_records(since_seq=seq0)
                      if r["label"].startswith("est:")]
            ledger_sum: dict = {}
            for r in served:
                for name, h in r["histograms"].items():
                    if name.startswith("estimator.qerror."):
                        ledger_sum[name] = ledger_sum.get(name, 0) + h["count"]
            conserved = (len(served) == SERVED and sum(global_delta.values()) > 0
                         and all(global_delta.get(h, 0) == ledger_sum.get(h, 0)
                                 for h in set(global_delta) | set(ledger_sum)))
            consistency = _common.cache_consistency(session)
            violations = _common.counter("staticcheck.lock.violations") - violations0
            observations = _common.counter("estimator.observations") - observations0
            accuracy = plan_stats.ACCURACY.snapshot()["qerror"]
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    ok = (not mismatches and annotated_ok and conserved and observations > 0
          and violations == 0 and all(consistency.values()) and idle)
    out = {
        "device": str(device),
        "rows": rows,
        "sections": len(sections),
        "bit_identical": not mismatches,
        "mismatches": mismatches[:10],
        "annotated_ok": annotated_ok,
        "estimator_observations": observations,
        "qerror_conserved": conserved,
        "qerror_global_delta": global_delta,
        "qerror_ledger_sum": ledger_sum,
        "served_records": len(served),
        "accuracy": accuracy,
        "lock_violations": violations,
        "cache_consistency": consistency,
        "background_idle": idle,
        "ok": ok,
        "seconds": time.perf_counter() - t0,
        "results": results,
        "report": report,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    _common.add_rows_flag(p, ROWS)
    args = p.parse_args(argv)
    out = run(_common.resolve_device(args.device), rows=args.rows)
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
