"""The workload-intelligence gate: the journal, per-index attribution and
drift detection end to end with the plane on (counterpart of the
reference repo's ``tools/workload_smoke.py``).

A mixed run (direct collects, queries served through the scheduler, and
one cancelled while queued) runs against an events table with TWO
covering indexes, one the queries use and one no query can apply, with
``HYPERSPACE_WORKLOAD_DIR`` set and the lock-order audit on.

Required (exit 0 iff all hold):

- every journal line parses and carries the full record schema, one shape
  across the done and cancelled outcomes, ``phases_ms`` over the whole
  phase vocabulary;
- per-index attribution conserves: the utility ledger's sums equal the
  ``workload.index.*`` and ``workload.maintenance.*`` counter deltas
  (benefit bytes within per-increment rounding);
- ``index_report`` ranks the used index above the never-applied one, which
  is a cold candidate;
- the drift detector flags a label slowed from 2 ms to 50 ms and stays
  silent on a stable 2 ms control run beside it;
- results equal the no-index reference (rows sorted, ``float.hex()``);
- ``staticcheck.lock.violations`` does not move; no journal write errs.

The workload plane is process-wide; the gate resets it (journal, drift
series, index ledger) when it starts and when it ends, and compares the
counters and the query log as deltas over its own run, so it can run
inside a longer process. ``HYPERSPACE_DEVICE_STRICT`` (a breaker knob the
port does not register) is not set.

    python -m hyperspace_tpu_torch.tools.workload_smoke [--device cpu] [--rows N]

Env: SMOKE_ROWS (40000), SMOKE_DRIFT_N (samples per drift side, 6),
SMOKE_LOCK_AUDIT=0 turns the audit off. Prints one JSON line.
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

ROWS = 40_000
DRIFT_N = 6
SEED = 11
FILES = 4
BUCKETS = 4
FAST_S, SLOW_S = 0.002, 0.05
REQUIRED_KEYS = (
    "v", "seq", "query_id", "label", "tenant", "outcome", "started_s",
    "queue_wait_ms", "total_ms", "phases_ms", "bytes_read", "counters",
    "histograms", "workload",
)
WORKLOAD_KEYS = (
    "shapes", "join_keys", "columns", "candidates", "chosen", "pruned",
    "qerror_counts",
)
WORKLOAD_COUNTERS = ("workload.index.applied", "workload.index.bytes_skipped",
                     "workload.index.rowgroups_skipped", "workload.index.benefit_bytes",
                     "workload.maintenance.actions", "workload.drift.latency",
                     "workload.journal.errors", "staticcheck.lock.violations")


def canonical_bits(d: dict) -> str:
    """Rows sorted, floats as ``float.hex()``: an index scan may order the
    rows otherwise."""
    cols = sorted(d)
    rows = sorted(zip(*(d[c] for c in cols))) if cols else []
    return repr((cols, [[x.hex() if isinstance(x, float) else x for x in r] for r in rows]))


def write_events(src: str, rows: int) -> None:
    import numpy as np

    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch

    rng = np.random.default_rng(SEED)
    per = rows // FILES
    for i in range(FILES):
        k = np.arange(per, dtype=np.int64) + i * per
        cio.write_parquet(ColumnBatch.from_pydict({
            "ev_k": k.tolist(),
            "ev_q": rng.integers(1, 50, per).tolist(),
            "ev_v": rng.uniform(0, 100, per).tolist(),
            "ev_s": rng.choice(["a", "b", "c"], per).tolist(),
        }), os.path.join(src, f"part-{i:02d}.parquet"))


def _metric_values() -> dict:
    from ..telemetry.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    return {k: snap.get(k, 0) for k in WORKLOAD_COUNTERS}


def run(device, root: "str | None" = None, rows: int = ROWS, drift_n: int = DRIFT_N,
        lock_audit: bool = True) -> dict:
    """The gate over an events table of ``rows`` rows in a temporary
    directory (under ``root`` when given), the journal in another, both
    removed at the end."""
    from .. import CoveringIndexConfig, Hyperspace, HyperspaceSession, serve
    from .. import constants as C
    from ..plan import col
    from ..telemetry import attribution, workload
    from ..telemetry.attribution import PHASES
    from ..telemetry.index_ledger import INDEX_LEDGER
    from ..telemetry.workload import DRIFT, JOURNAL

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    ws = tempfile.mkdtemp(prefix="hs_workload_smoke_", dir=root)
    wdir = tempfile.mkdtemp(prefix="hs_workload_journal_", dir=root)
    env = {"HYPERSPACE_WORKLOAD_DIR": wdir,
           "HYPERSPACE_WORKLOAD_BASELINE": str(drift_n),
           "HYPERSPACE_WORKLOAD_WINDOW": str(drift_n),
           "HYPERSPACE_WORKLOAD_DRIFT_MIN": str(max(4, drift_n - 2)),
           "HYPERSPACE_WORKLOAD_DRIFT_FACTOR": "2.0",
           "HYPERSPACE_SKETCHES": "1",
           # a slow cost model: the journaled benefit outweighs the one-off
           # index creation
           "HYPERSPACE_QOS_COST_MBPS": "4"}
    failures: list = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            failures.append(msg)

    try:
        with _common.gate_scope(env, lock_audit=lock_audit):
            idle = _common.settle_background()
            workload.reset_for_testing()
            m0 = _metric_values()
            recorded0 = attribution.LEDGER.snapshot(limit=0)["totals"]["recorded"]
            src = os.path.join(ws, "events")
            write_events(src, rows)
            session = HyperspaceSession(warehouse_dir=ws, device=device)
            session.set_conf(C.INDEX_NUM_BUCKETS, BUCKETS)
            session.set_conf(C.EXEC_TPU_ENABLED, True)
            hs = Hyperspace(session)

            def ev():
                return session.read.parquet(src)

            # the index the workload uses, and one no query can apply
            hs.create_index(ev(), CoveringIndexConfig("ev_used_idx", ["ev_k"], ["ev_q", "ev_v"]))
            hs.create_index(ev(), CoveringIndexConfig("ev_unused_idx", ["ev_s"], ["ev_q"]))
            k_point = rows // 2 + 7
            lo, hi = rows // 4, rows // 4 + 1500

            def q_point():
                return ev().filter(col("ev_k") == k_point).select(
                    "ev_k", "ev_q", "ev_v").to_pydict()

            def q_range():
                return ev().filter((col("ev_k") >= lo) & (col("ev_k") < hi)).select(
                    "ev_k", "ev_v").to_pydict()

            reference = {"point": canonical_bits(q_point()), "range": canonical_bits(q_range())}
            session.enable_hyperspace()

            # the mixed run: direct collects
            for _ in range(4):
                direct = {"point": canonical_bits(q_point()), "range": canonical_bits(q_range())}
                check(direct == reference, "direct results diverged from the reference")

            # served, and one cancelled while queued
            sched = serve.QueryScheduler(max_concurrent=1, queue_depth=64)
            gate = threading.Event()
            try:
                blocker = sched.submit(lambda: gate.wait(30), label="blocker")
                victim = sched.submit(q_point, label="victim")
                sched.cancel(victim)
                gate.set()
                blocker.result(60)
                served = [sched.submit(q_point if i % 2 == 0 else q_range,
                                       label="served").result(60) for i in range(4)]
                check(all(canonical_bits(s) == reference["point" if i % 2 == 0 else "range"]
                          for i, s in enumerate(served)),
                      "served results diverged from the reference")

                # drift: a fast baseline then a slow window, beside a stable control
                def fast():
                    time.sleep(FAST_S)  # hslint: HS401 — the drift leg's planted latency
                    return 1

                def slow():
                    time.sleep(SLOW_S)  # hslint: HS401 — the drift leg's planted latency
                    return 1

                for _ in range(drift_n):
                    sched.submit(fast, label="drifting").result(30)
                    sched.submit(fast, label="stable").result(30)
                for _ in range(drift_n):
                    sched.submit(slow, label="drifting").result(30)
                    sched.submit(fast, label="stable").result(30)
                sched.drain(60)
            finally:
                sched.shutdown()
            JOURNAL.flush()

            # the journal: every line parses, one record shape
            records = JOURNAL.load()
            recorded = attribution.LEDGER.snapshot(limit=0)["totals"]["recorded"] - recorded0
            check(len(records) == recorded,
                  f"journal holds {len(records)} records, the ledger recorded {recorded}")
            outcomes = set()
            for r in records:
                missing = [k for k in REQUIRED_KEYS if k not in r]
                check(not missing, f"record seq={r.get('seq')} missing keys {missing}")
                check(tuple(r.get("phases_ms", {})) == PHASES,
                      f"record seq={r.get('seq')} phases_ms keys != PHASES")
                wl_missing = [k for k in WORKLOAD_KEYS if k not in (r.get("workload") or {})]
                check(not wl_missing,
                      f"record seq={r.get('seq')} workload block missing {wl_missing}")
                outcomes.add(r.get("outcome"))
            check("done" in outcomes and "cancelled" in outcomes,
                  f"expected done and cancelled outcomes in the journal, got {outcomes}")

            # conservation: the ledger's sums against the counter deltas
            m1 = _metric_values()
            d = {k: m1[k] - m0[k] for k in m0}
            totals = INDEX_LEDGER.totals()
            check(d["workload.index.applied"] == totals["queries"],
                  f"applied counter {d['workload.index.applied']} != ledger queries "
                  f"{totals['queries']}")
            check(d["workload.index.bytes_skipped"] == totals["bytes_skipped"],
                  "bytes_skipped counter != ledger sum")
            check(d["workload.index.rowgroups_skipped"] == totals["rowgroups_skipped"],
                  "rowgroups_skipped counter != ledger sum")
            check(abs(d["workload.index.benefit_bytes"] - totals["benefit_bytes"])
                  <= 0.001 * max(1, totals["queries"]),
                  f"benefit_bytes counter {d['workload.index.benefit_bytes']} != ledger sum "
                  f"{totals['benefit_bytes']}")
            check(d["workload.maintenance.actions"] == totals["maintenance_actions"],
                  f"maintenance counter {d['workload.maintenance.actions']} != ledger sum "
                  f"{totals['maintenance_actions']}")
            check(totals["queries"] > 0, "no index application was ever charged")
            check(totals["maintenance_actions"] >= 2,
                  "index creation was not charged as maintenance")

            # the ranking: the used index above the never-applied one
            report = INDEX_LEDGER.report()
            order = [r["name"] for r in report]
            cold = INDEX_LEDGER.cold_candidates()
            check("ev_used_idx" in order and "ev_unused_idx" in order
                  and order.index("ev_used_idx") < order.index("ev_unused_idx"),
                  f"index_report ranking wrong: {order}")
            check("ev_unused_idx" in cold, "the never-applied index is not a cold candidate")
            used_row = next((r for r in report if r["name"] == "ev_used_idx"), {})
            check(used_row.get("queries", 0) > 0, "the used index shows no query")

            # drift: the planted regression fires, the stable label stays silent
            regs = DRIFT.regressions()
            reg_keys = {(r["kind"], r["key"]) for r in regs}
            check(("latency", "drifting") in reg_keys,
                  f"planted regression not flagged; regressions={regs}")
            check(("latency", "stable") not in reg_keys,
                  "stable label wrongly flagged as drifting")
            check(d["workload.drift.latency"] >= 1, "workload.drift.latency never fired")

            check(d["staticcheck.lock.violations"] == 0, "lock-order violations under audit")
            check(d["workload.journal.errors"] == 0, "journal writes errored")
            check(idle, "background maintenance did not settle before the gate")
            record_keys = sorted({k for r in records for k in r})
            workload_keys = sorted({k for r in records for k in (r.get("workload") or {})})
            phases = sorted({tuple(r.get("phases_ms", {})) for r in records})
            workload.reset_for_testing()
    finally:
        shutil.rmtree(ws, ignore_errors=True)
        shutil.rmtree(wdir, ignore_errors=True)
    out = {
        "device": str(device),
        "rows": rows,
        "journal_records": len(records),
        "outcomes": sorted(outcomes),
        "ledger_totals": totals,
        "index_order": order,
        "cold": cold,
        "regressions": regs,
        "lock_violations": d["staticcheck.lock.violations"],
        "failures": failures,
        "ok": not failures,
        "seconds": time.perf_counter() - t0,
        "record_keys": record_keys,
        "workload_keys": workload_keys,
        "phases": phases,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    _common.add_rows_flag(p, ROWS)
    args = p.parse_args(argv)
    out = run(_common.resolve_device(args.device), rows=args.rows,
              drift_n=_common.smoke_int("SMOKE_DRIFT_N", DRIFT_N),
              lock_audit=_common.smoke_flag("SMOKE_LOCK_AUDIT"))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
