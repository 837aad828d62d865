"""The result-cache gate: a repeat-heavy TPC-H mix through the query
scheduler with a concurrent ``append_batch`` stream into a live index,
with ``HYPERSPACE_RESULT_CACHE=1`` (counterpart of the reference repo's
``tools/result_cache_smoke.py``).

Required (exit 0 iff all hold):

- hits > 0 over the serving window, and every served TPC-H result, hit
  or computed, equals the cold reference (cache off) bit for bit;
- every served answer over the live ingested table equals a cold replay
  of the exact snapshot it pinned (the executed plan's leaf files, read
  again with the cache off and Hyperspace off): hits, folds and
  recomputes across every version the stream published;
- a warm hit executes nothing: its trace has the ``cache:probe`` span and
  no ``exec:``, ``kernel:``, ``compile:`` or ``pipeline:`` span;
- the incremental views engaged: ``cache.result.folds`` advanced, and a
  deterministic append, refresh and query after the window folds and
  matches its cold replay;
- for every ``io. cache. rpc. pipeline. pruning. serve.budget.`` counter,
  the per-query ledger sums over the window equal the global deltas (the
  appends and the background refreshes carry ledger records of their
  own);
- ``staticcheck.lock.violations`` does not move; every bounded cache (the
  result cache included) is consistent; the scheduler and the refresh
  plane reach quiescence.

Background compaction is held off (``HYPERSPACE_COMPACT_RUNS``) so that
its unattributed IO stays out of the conservation window, as in the
reference. Departures, by decision: ``HYPERSPACE_DEVICE_STRICT`` (a
breaker knob the port does not register) is not set; the caches checked
are the session's (``_common.cache_consistency``); the ledger window is
the one the package was imported with (``_common.Conservation``).

    python -m hyperspace_tpu_torch.tools.result_cache_smoke [--device cpu] [--rows N]

Env: SMOKE_CLIENTS (4), SMOKE_CONCURRENT (4), SMOKE_REPEATS (3),
SMOKE_ROWS (60000), SMOKE_INGEST_BATCHES (6), SMOKE_INGEST_ROWS (4000),
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

CLIENTS = 4
CONCURRENT = 4
REPEATS = 3
ROWS = 60_000
BATCHES = 6
BATCH_ROWS = 4_000
SEED = 31
BUCKETS = 8
BATCH_SEED = 700
ENV = {"HYPERSPACE_RESULT_CACHE": "1", "HYPERSPACE_STREAM_CHUNK_MB": "0.5",
       "HYPERSPACE_IO_THREADS": "4", "HYPERSPACE_COMPACT_RUNS": "100000"}
CACHE_OFF = {"HYPERSPACE_RESULT_CACHE": "0"}
EXEC_SPANS = ("exec:", "kernel:", "compile:", "pipeline:")


def batch(seed: int, rows: int) -> dict:
    import numpy as np

    r = np.random.default_rng(BATCH_SEED + seed)
    return {"k": r.integers(0, 64, rows).tolist(), "v": r.integers(0, 10_000, rows).tolist(),
            "w": r.integers(0, 100, rows).tolist()}


def live_agg(df):
    """The live-table query: a global integer aggregate, so the answer is
    a function of the visible rows alone."""
    from ..plan import Count, Max, Min, Sum, col, lit

    return df.filter(df["k"] < 40).agg(Count(lit(1)).alias("n"), Sum(col("v")).alias("sv"),
                                       Min(col("v")).alias("mn"), Max(col("w")).alias("mx"))


def run(device, root: "str | None" = None, clients: int = CLIENTS,
        concurrent: int = CONCURRENT, repeats: int = REPEATS, rows: int = ROWS,
        batches: int = BATCHES, batch_rows: int = BATCH_ROWS, lock_audit: bool = True) -> dict:
    """The gate over a TPC-H lake of ``rows`` lineitem rows and the live
    table in a temporary directory (under ``root`` when given), removed at
    the end; ``results`` holds the cold references."""
    from .. import CoveringIndexConfig, Hyperspace, ingest, serve
    from ..benchmark.tpch import TPCH_QUERIES
    from ..cache.result_cache import RESULT_CACHE, serve_collect
    from ..cache.view_maintenance import refresh_idle
    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch
    from ..ingest.snapshots import pin_scope
    from ..plan.nodes import FileScan
    from ..staticcheck import concurrency as cc
    from ..telemetry import trace
    from ..utils.workers import spawn_thread

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    ws = tempfile.mkdtemp(prefix="hs_rc_smoke_", dir=root)
    sched = None
    try:
        with _common.gate_scope(ENV, lock_audit=lock_audit):
            idle = _common.settle_background()
            violations0 = _common.counter("staticcheck.lock.violations")
            session = _common.tpch_world(ws, rows, device, seed=SEED, buckets=BUCKETS)
            session.disable_hyperspace()
            hs = Hyperspace(session)
            ev = os.path.join(ws, "events")
            cio.write_parquet(ColumnBatch.from_pydict(batch(0, batch_rows)),
                              os.path.join(ev, "part0.parquet"))
            hs.create_index(session.read.parquet(ev),
                            CoveringIndexConfig("ev_rc", ["k"], ["v", "w"]))
            session.enable_hyperspace()
            names = list(TPCH_QUERIES)

            # the cold references of the TPC-H mix (cache off)
            with _common.gate_scope(CACHE_OFF):
                results = {n: TPCH_QUERIES[n](session, ws).to_pydict() for n in names}
            reference = {n: _common.bits(r) for n, r in results.items()}

            # a warm hit executes nothing
            TPCH_QUERIES["q6"](session, ws).collect()
            with trace.capture() as cap:
                TPCH_QUERIES["q6"](session, ws).collect()
            hit_spans = [s.name for s in cap.sink.spans]
            zero_exec_on_hit = ("cache:probe" in hit_spans
                                and not [n for n in hit_spans if n.startswith(EXEC_SPANS)])

            conservation = _common.Conservation()
            hits0 = _common.counter("cache.result.hits")
            misses0 = _common.counter("cache.result.misses")
            folds0 = _common.counter("cache.result.folds")
            fold_rows0 = _common.counter("cache.result.fold_rows")
            refreshes0 = _common.counter("cache.result.refreshes")
            sched = serve.QueryScheduler(
                max_concurrent=concurrent,
                queue_depth=max(64, clients * (len(names) + 1) * repeats + batches))
            ev_runs: list = []  # (bits of the answer, the executed plan's leaf files)
            ev_lock = threading.Lock()

            def run_ev():
                """The live-table query collected in DataFrame.collect's two
                steps, so the EXECUTED plan's leaf files (the pinned index
                version, or it and appended source parts under a hybrid
                scan) are recorded beside the answer: the snapshot the cold
                replay reads again."""
                df = live_agg(session.read.parquet(ev))
                with pin_scope():
                    plan = df.optimized_plan()
                    files = tuple(sorted(f.name for n in plan.preorder()
                                         if isinstance(n, FileScan) for f in n.files))
                    out = serve_collect(session, df.plan, plan)
                return out, files

            def live_pass(tid: int) -> None:
                out, files = sched.submit(run_ev, label=f"c{tid}:ev").result(timeout=300)
                with ev_lock:
                    ev_runs.append((_common.bits(out.to_pydict()), files))

            errors: list = []
            start = threading.Barrier(2)

            def ingester() -> None:
                """The appends ride the scheduler too: their IO charges a
                ledger record of their own."""
                try:
                    start.wait()
                    for k in range(1, batches + 1):
                        sched.submit((lambda kk=k: ingest.append_batch(
                            session, "ev_rc", batch(kk, batch_rows))),
                            label=f"ingest:{k}").result(timeout=300)
                        time.sleep(0.05)  # hslint: HS401 — gate tool pacing
                except Exception as e:  # noqa: BLE001 - reported through the gate
                    errors.append(("ingester", repr(e)))

            ing = spawn_thread(ingester, name="hs-rcsmoke-ingester", daemon=False)
            start.wait()
            mix = _common.serve_clients(sched, {n: TPCH_QUERIES[n] for n in names}, session, ws,
                                        reference, clients, repeats, device, label="rc",
                                        extra=live_pass)
            ing.join()
            sched.drain(timeout=120)
            errors += mix["errors"]
            mismatches = mix["mismatches"]

            # the refresh plane quiesces before conservation is read
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not (refresh_idle()
                                                       and ingest.maintenance_idle()):
                time.sleep(0.05)  # hslint: HS401 — gate tool, background settle
            unconserved = conservation.settle()
            hits = _common.counter("cache.result.hits") - hits0
            misses = _common.counter("cache.result.misses") - misses0
            folds_in_window = _common.counter("cache.result.folds") - folds0
            hit_ratio = hits / (hits + misses) if (hits + misses) else 0.0
            state = sched.state()
            quiescent = not state["active"] and not state["queued"]
            sched.shutdown(wait=True)
            sched = None

            # a deterministic fold after the window: append, refresh, replay
            fold_ok = True
            try:
                live_agg(session.read.parquet(ev)).collect()  # anchor at this version
                f0 = _common.counter("cache.result.folds")
                ingest.append_batch(session, "ev_rc", batch(batches + 1, batch_rows))
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and not refresh_idle():
                    time.sleep(0.02)  # hslint: HS401 — gate tool, refresh settle
                fold_ok = _common.counter("cache.result.folds") > f0
                out, files = run_ev()
                ev_runs.append((_common.bits(out.to_pydict()), files))
            except Exception as e:  # noqa: BLE001 - reported through the gate
                fold_ok = False
                errors.append(("fold-exercise", repr(e)))

            # cold replays: every served or folded answer against its pinned
            # snapshot (cache off, Hyperspace off: a direct scan of the
            # executed plan's leaf files; the aggregate is order-free)
            replay_mismatches = 0
            replays: dict = {}
            session.disable_hyperspace()
            with _common.gate_scope(CACHE_OFF):
                for got, files in ev_runs:
                    if not files:
                        replay_mismatches += 1
                        continue
                    if files not in replays:
                        replays[files] = _common.bits(
                            live_agg(session.read.parquet(list(files))).collect().to_pydict())
                    replay_mismatches += got != replays[files]
            refresh_quiet = refresh_idle()
            consistency = _common.cache_consistency(session)
            lock_report = cc.report()
            violations = _common.counter("staticcheck.lock.violations") - violations0
            folds = _common.counter("cache.result.folds") - folds0
            fold_rows = _common.counter("cache.result.fold_rows") - fold_rows0
            refreshes = _common.counter("cache.result.refreshes") - refreshes0
            cache_state = RESULT_CACHE.state()
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
        shutil.rmtree(ws, ignore_errors=True)
    ok = (not mismatches and not errors and replay_mismatches == 0 and hit_ratio > 0
          and folds_in_window + (1 if fold_ok else 0) > 0 and fold_ok and zero_exec_on_hit
          and not unconserved and violations == 0 and all(consistency.values())
          and quiescent and refresh_quiet and idle)
    out = {
        "device": str(device),
        "rows": rows,
        "clients": clients,
        "repeats": repeats,
        "ingest_batches": batches,
        "served_tpch_runs": clients * repeats * len(names),
        "served_live_runs": len(ev_runs),
        "bit_identical_tpch": not mismatches,
        "mismatches": mismatches[:10],
        "replay_mismatches": replay_mismatches,
        "snapshots_replayed": len(replays),
        "errors": errors[:10],
        "hits": hits,
        "misses": misses,
        "hit_ratio": hit_ratio,
        "folds": folds,
        "folds_in_window": folds_in_window,
        "fold_rows": fold_rows,
        "refreshes": refreshes,
        "zero_exec_on_hit": zero_exec_on_hit,
        "hit_spans": sorted(set(hit_spans)),
        "fold_exercise_ok": fold_ok,
        "attribution_conserved": not unconserved,
        "conservation_mismatches": dict(list(unconserved.items())[:10]),
        "scheduler_quiescent": quiescent,
        "refresh_idle": refresh_quiet,
        "lock_audit": lock_report["audit_enabled"],
        "lock_violations": violations,
        "cache_consistency": consistency,
        "result_cache": cache_state,
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
    out = run(_common.resolve_device(args.device),
              clients=_common.smoke_int("SMOKE_CLIENTS", CLIENTS),
              concurrent=_common.smoke_int("SMOKE_CONCURRENT", CONCURRENT),
              repeats=_common.smoke_int("SMOKE_REPEATS", REPEATS),
              rows=args.rows,
              batches=_common.smoke_int("SMOKE_INGEST_BATCHES", BATCHES),
              batch_rows=_common.smoke_int("SMOKE_INGEST_ROWS", BATCH_ROWS),
              lock_audit=_common.smoke_flag("SMOKE_LOCK_AUDIT"))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
