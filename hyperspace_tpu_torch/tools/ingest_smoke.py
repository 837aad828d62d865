"""The continuous-ingestion gate: ingest batches racing concurrent query
clients through the scheduler, with background compaction and a vacuum
mid-run; every query equals a serial replay of the snapshot it pinned
(counterpart of the reference repo's ``tools/ingest_smoke.py``).

Phase A (the serial reference): a twin warehouse appends the same seeded
batches one at a time and records the query set's bits after each:
``bits[k]`` is the answer over exactly the first k+1 batches. The queries
are grouped and global integer aggregates, sorted, so the answer depends
only on the visible rows, which compaction and vacuum must keep.

Phase B (the race): an ingester thread appends the batches (each append
schedules background compaction past ``HYPERSPACE_COMPACT_RUNS`` runs;
an explicit pin-aware vacuum runs two thirds of the way in) while
``clients`` client threads send the query set through ONE
``QueryScheduler``. Each query plans against the file listing of the
latest stable entry it fetched (a serving tier's metadata cache), so the
rewrite matches and pins that snapshot; the entry's recorded source
parts give the k whose ``bits[k]`` the result must equal.

Required (exit 0 iff all hold):

- every served query's bits equal ``bits[k]`` of the snapshot it pinned
  (or, for one that lost the fetch-to-plan race to a commit and read its
  listing raw, of the entry it fetched);
- at least half the served queries pinned a snapshot;
- at least one compaction and one vacuumed version during the run;
- the crash cells: ``ingest.append`` and ``ingest.compact``,
  ``crash_before`` and ``crash_after``, each crash, then ``recover()``
  to a stable index with no orphan, which converges bit for bit to a
  never-crashed twin;
- ``staticcheck.lock.violations`` does not move; every bounded cache is
  consistent; no resource handle is live (the lifecycle audit is on);
- after the final drain, compaction and vacuum: a stable log tail, no
  staging dir, no ``.tmp`` spool file, every ``v__=N`` dir referenced by
  the latest entry, and no active pin; the final warehouse answers as
  ``bits[n]``.

Every warehouse runs the device tier on ``device``. Departures, by
decision: ``HYPERSPACE_DEVICE_STRICT`` (a breaker knob the port does not
register) is not set; the caches checked are the race session's
(``_common.cache_consistency``); the counters are the gate's deltas.

    python -m hyperspace_tpu_torch.tools.ingest_smoke [--device cpu] [--rows N]

Env: SMOKE_CLIENTS (4), SMOKE_CONCURRENT (4), SMOKE_BATCHES (10),
SMOKE_BATCH_ROWS (3000; ``--rows`` sets it too), SMOKE_QUERIES_PER_CLIENT
(30), SMOKE_LOCK_AUDIT=0 and SMOKE_LIFECYCLE_AUDIT=0 turn the audits off.
Prints one JSON line.
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
BATCHES = 10
BATCH_ROWS = 3_000
QUERIES_PER_CLIENT = 30
BUCKETS = 8
BATCH_SEED = 1000
CRASH_SEED = 99
# a real IO pool width, so background maintenance interleaves with the
# served queries; compaction after a few delta runs, so one lands mid-run
ENV = {"HYPERSPACE_IO_THREADS": "4", "HYPERSPACE_COMPACT_RUNS": "3"}
CRASH_CELLS = (
    ("append", "ingest.append:crash_before:n=1"),
    ("append", "ingest.append:crash_after:n=1"),
    ("compact", "ingest.compact:crash_before:n=1"),
    ("compact", "ingest.compact:crash_after:n=1"),
)


def batch(seed: int, rows: int) -> dict:
    import numpy as np

    r = np.random.default_rng(BATCH_SEED + seed)
    return {"k": r.integers(0, 64, rows).tolist(), "v": r.integers(0, 10_000, rows).tolist(),
            "w": r.integers(0, 100, rows).tolist()}


def q_group(df):
    from ..plan import Count, Max, Min, Sum, col, lit

    return (df.filter(df["k"] < 48).group_by("k")
            .agg(Sum(col("v")).alias("sv"), Count(lit(1)).alias("n"),
                 Min(col("w")).alias("mn"), Max(col("w")).alias("mx"))
            .sort("k").collect())


def q_point(df):
    from ..plan import Count, Sum, col, lit

    return df.filter(df["k"] == 7).agg(Sum(col("v")).alias("sv"),
                                       Count(lit(1)).alias("n")).collect()


QUERIES = {"group": q_group, "point": q_point}


def bits(out) -> str:
    return _common.bits(out.to_pydict())


class World:
    """A warehouse with the events table's first batch and the covering
    index ``ev`` (k; v, w) over it, Hyperspace on."""

    def __init__(self, root: "str | None", prefix: str, device, batch_rows: int):
        from .. import CoveringIndexConfig, Hyperspace
        from ..columnar import io as cio
        from ..columnar.table import ColumnBatch

        self.ws = tempfile.mkdtemp(prefix=prefix, dir=root)
        self.src = os.path.join(self.ws, "events")
        self.device = device
        os.makedirs(self.src)
        cio.write_parquet(ColumnBatch.from_pydict(batch(0, batch_rows)),
                          os.path.join(self.src, "part0.parquet"))
        self.session = self.new_session()
        self.hs = Hyperspace(self.session)
        self.hs.create_index(self.session.read.parquet(self.src),
                             CoveringIndexConfig("ev", ["k"], ["v", "w"]))
        self.session.enable_hyperspace()

    def new_session(self):
        from .. import HyperspaceSession
        from .. import constants as C

        s = HyperspaceSession(warehouse_dir=self.ws, device=self.device)
        s.set_conf(C.INDEX_NUM_BUCKETS, BUCKETS)
        s.set_conf(C.EXEC_TPU_ENABLED, True)
        return s


def debris_of(ws: str, live_dirs: "set | None" = None) -> list:
    """What a drained index ``ev`` must not hold: an unstable log tail,
    staging dirs, ``.tmp`` spool files, data versions nothing references
    (the latest entry's dirs when ``live_dirs`` is given, else any entry's)."""
    from .. import constants as C
    from ..index_manager import IndexCollectionManager
    from ..meta.data_manager import IndexDataManager
    from ..meta.log_manager import STABLE_STATES, IndexLogManager

    ip = os.path.join(ws, C.INDEXES_DIR, "ev")
    lm, dm = IndexLogManager(ip), IndexDataManager(ip)
    out = []
    tail = lm.get_latest_log()
    if tail is None or tail.state not in STABLE_STATES:
        out.append(f"unstable log tail: {getattr(tail, 'state', None)}")
    if dm.staged_versions():
        out.append(f"staging dirs: {dm.staged_versions()}")
    if lm.stale_temp_files():
        out.append("stale .tmp spool files")
    refs = live_dirs if live_dirs is not None else IndexCollectionManager._referenced_versions(lm)
    orphans = [v for v in dm.get_all_versions() if v not in refs]
    if orphans:
        out.append(f"version dirs not referenced: {orphans}")
    return out


def crash_cell(root, device, batch_rows: int, action: str, spec: str) -> dict:
    """``action`` (one append, or a compaction after one) with ``spec``
    armed; recover() in a new session, then the action again: stable,
    orphan-free and equal to a never-crashed twin."""
    from .. import Hyperspace
    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch
    from ..utils import faults

    twin = World(root, "hs_ingest_twin_", device, batch_rows)
    p = os.path.join(twin.src, "p1.parquet")
    cio.write_parquet(ColumnBatch.from_pydict(batch(CRASH_SEED, batch_rows)), p)
    twin.hs.append("ev", twin.session.read.parquet(p))
    if action == "compact":
        twin.hs.compact_index("ev", min_runs=2)
    twin_bits = bits(q_group(twin.session.read.parquet(twin.src)))

    cell = World(root, "hs_ingest_cell_", device, batch_rows)
    p = os.path.join(cell.src, "p1.parquet")
    cio.write_parquet(ColumnBatch.from_pydict(batch(CRASH_SEED, batch_rows)), p)
    if action == "compact":
        cell.hs.append("ev", cell.session.read.parquet(p))
    faults.arm(spec)
    crashed = False
    try:
        if action == "compact":
            cell.hs.compact_index("ev", min_runs=2)
        else:
            cell.hs.append("ev", cell.session.read.parquet(p))
    except faults.InjectedCrash:
        crashed = True
    finally:
        faults.disarm()
    s2 = cell.new_session()
    h2 = Hyperspace(s2)
    h2.recover(force=True)
    debris = debris_of(cell.ws)
    if action == "compact":
        h2.compact_index("ev", min_runs=2)
    else:
        h2.append("ev", s2.read.parquet(p))
    s2.enable_hyperspace()
    identical = bits(q_group(s2.read.parquet(cell.src))) == twin_bits
    _common.settle_background()  # no maintenance task may outlive its warehouse
    for w in (twin, cell):
        shutil.rmtree(w.ws, ignore_errors=True)
    return {"action": action, "spec": spec, "crashed": crashed, "recovered_clean": not debris,
            "identical": identical, "debris": debris}


def serial_bits(root, device, batches: int, batch_rows: int) -> dict:
    """Phase A: {k: {query: bits}} over a twin fed one batch at a time."""
    from .. import ingest

    ref = World(root, "hs_ingest_ref_", device, batch_rows)
    try:
        def now() -> dict:
            df = ref.session.read.parquet(ref.src)
            return {qn: bits(fn(df)) for qn, fn in QUERIES.items()}

        out = {0: now()}
        for k in range(1, batches + 1):
            ingest.append_batch(ref.session, "ev", batch(k, batch_rows))
            out[k] = now()
        return out
    finally:
        _common.settle_background()  # the twin's own compactions and vacuums
        shutil.rmtree(ref.ws, ignore_errors=True)


def run(device, root: "str | None" = None, clients: int = CLIENTS,
        concurrent: int = CONCURRENT, batches: int = BATCHES, batch_rows: int = BATCH_ROWS,
        queries_per_client: int = QUERIES_PER_CLIENT, lock_audit: bool = True,
        lifecycle_audit: bool = True) -> dict:
    """The gate in temporary warehouses (under ``root`` when given), each
    removed at the end; ``bits`` holds ``bits[k]``."""
    from .. import ingest, serve
    from ..index_manager import index_manager_for
    from ..staticcheck import concurrency as cc
    from ..staticcheck import lifecycle as lc
    from ..utils.workers import spawn_thread

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    race = None
    sched = None
    try:
        with _common.gate_scope(ENV, lock_audit=lock_audit, lifecycle_audit=lifecycle_audit):
            idle = _common.settle_background()
            c0 = {n: _common.counter(n) for n in (
                "staticcheck.lock.violations", "ingest.compact.runs",
                "ingest.vacuum.versions_removed", "ingest.vacuum.deferred", "ingest.appends",
                "ingest.rows_appended", "ingest.snapshot.pins", "staticcheck.lock.acquisitions")}
            bits_at = serial_bits(root, device, batches, batch_rows)

            # phase B: the race
            race = World(root, "hs_ingest_race_", device, batch_rows)
            session = race.session
            sched = serve.QueryScheduler(max_concurrent=concurrent,
                                         queue_depth=max(64, clients * queries_per_client))
            ingest_errors: list = []
            client_errors: list = []
            served_results: list = []
            results_lock = threading.Lock()
            barrier = threading.Barrier(clients + 1)

            def ingester() -> None:
                try:
                    for k in range(1, batches + 1):
                        ingest.append_batch(session, "ev", batch(k, batch_rows))
                        if k == (batches * 2) // 3:
                            # one explicit pin-aware vacuum mid-stream (background
                            # maintenance also vacuums after each compaction)
                            race.hs.vacuum_outdated_index("ev")
                except Exception as e:  # noqa: BLE001 - reported through the gate
                    ingest_errors.append(repr(e))

            def client(tid: int) -> None:
                try:
                    barrier.wait()
                    qnames = list(QUERIES)
                    for i in range(queries_per_client):
                        qn = qnames[(tid + i) % len(qnames)]
                        obs = ingest.observe_pins()

                        def one(qn=qn, obs=obs):
                            with obs:
                                entry = ingest.latest_stable_entry(session, "ev")
                                files = [f.name for f in entry.relation.content.file_infos()]
                                return entry.id, QUERIES[qn](session.read.parquet(files))

                        fetched, out = sched.submit(one, label=f"c{tid}:{qn}").result(
                            timeout=300)
                        pins = [p for p in obs.pins if p.index_name == "ev"]
                        eid = pins[0].entry_id if pins else fetched
                        with results_lock:
                            served_results.append((tid, qn, eid, bool(pins), bits(out)))
                except Exception as e:  # noqa: BLE001 - reported through the gate
                    client_errors.append((tid, repr(e)))

            threads = [spawn_thread(client, name=f"hs-ingest-client-{i}", daemon=False,
                                    args=(i,)) for i in range(clients)]
            ing = spawn_thread(ingester, name="hs-ingester", daemon=False)
            barrier.wait()  # the clients and the main thread start together
            ing.join()
            for t in threads:
                t.join()
            sched.drain(timeout=120)

            # each pinned entry to its batch count k, from the entry itself:
            # its source parts are part0 and k ingested batches
            manager = index_manager_for(session)
            k_of_entry: dict = {}
            mismatches: list = []
            pinned = 0
            for tid, qn, eid, was_pinned, got in served_results:
                pinned += was_pinned
                k = k_of_entry.get(eid)
                if k is None:
                    e = manager.get_index("ev", log_version=eid)
                    if e is None:
                        mismatches.append((tid, qn, eid, "entry-vanished"))
                        continue
                    k = k_of_entry[eid] = len(e.relation.content.file_infos()) - 1
                if got != bits_at[k][qn]:
                    mismatches.append((tid, qn, eid, f"diverges-from-snapshot-k={k}"))

            # drain background maintenance, then one compaction and vacuum so
            # the end state is canonical
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not ingest.maintenance_idle():
                time.sleep(0.05)  # hslint: HS401 — gate tool, maintenance drain
            maintenance_drained = ingest.maintenance_idle()
            race.hs.compact_index("ev", min_runs=2)
            race.hs.vacuum_outdated_index("ev")
            final_df = session.read.parquet(race.src)
            final_ok = all(bits(fn(final_df)) == bits_at[batches][qn]
                           for qn, fn in QUERIES.items())
            live_dirs = {int(d.split("=")[1])
                         for d in race.hs.get_index("ev").index_version_dirs()}
            debris = debris_of(race.ws, live_dirs)

            cells = [crash_cell(root, device, batch_rows, a, s) for a, s in CRASH_CELLS]
            crash_ok = all(c["crashed"] and c["recovered_clean"] and c["identical"]
                           for c in cells)

            consistency = _common.cache_consistency(session)
            sched.shutdown(wait=True)
            sched = None
            lock_report = cc.report()
            leaks = [h.describe() for h in lc.check_quiescent(raise_on_leak=False)]
            lifecycle = lc.report()
            d = {n: _common.counter(n) - v for n, v in c0.items()}
            pins_drained = ingest.REGISTRY.active_pins() == 0
            registry = ingest.REGISTRY.state()
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
        if race is not None:
            shutil.rmtree(race.ws, ignore_errors=True)
    served = clients * queries_per_client
    ok = (not mismatches and not client_errors and not ingest_errors
          and len(served_results) == served and pinned * 2 >= served and final_ok
          and maintenance_drained and not debris and crash_ok
          and d["staticcheck.lock.violations"] == 0 and all(consistency.values())
          and pins_drained and d["ingest.compact.runs"] >= 1
          and d["ingest.vacuum.versions_removed"] >= 1
          and d["ingest.appends"] >= 2 * batches and not leaks and idle)
    out = {
        "device": str(device),
        "clients": clients,
        "max_concurrent": concurrent,
        "batches": batches,
        "batch_rows": batch_rows,
        "served_queries": served,
        "bit_identical": not mismatches and not client_errors,
        "mismatches": mismatches[:10],
        "client_errors": client_errors[:10],
        "ingest_errors": ingest_errors[:5],
        "pinned_queries": pinned,
        "unpinned_queries": served - pinned,
        "snapshots_seen": sorted(set(k_of_entry.values())),
        "final_state_identical": final_ok,
        "maintenance_drained": maintenance_drained,
        "debris": debris,
        "crash_cells": cells,
        "compactions": d["ingest.compact.runs"],
        "vacuumed_versions": d["ingest.vacuum.versions_removed"],
        "vacuum_deferred": d["ingest.vacuum.deferred"],
        "appends": d["ingest.appends"],
        "rows_appended": d["ingest.rows_appended"],
        "snapshot_pins": d["ingest.snapshot.pins"],
        "snapshot_registry": registry,
        "pins_drained": pins_drained,
        "lock_audit": lock_report["audit_enabled"],
        "lock_acquisitions": d["staticcheck.lock.acquisitions"],
        "lock_violations": d["staticcheck.lock.violations"],
        "cache_consistency": consistency,
        "lifecycle_audit": lifecycle["audit_enabled"],
        "lifecycle_acquires": lifecycle["acquires"],
        "lifecycle_releases": lifecycle["releases"],
        "lifecycle_leaks": leaks[:10],
        "background_idle": idle,
        "ok": ok,
        "seconds": time.perf_counter() - t0,
        "bits": bits_at,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    p.add_argument("--rows", type=int,
                   default=_common.smoke_int("SMOKE_BATCH_ROWS", BATCH_ROWS),
                   help=f"rows per ingested batch (default {BATCH_ROWS})")
    args = p.parse_args(argv)
    out = run(_common.resolve_device(args.device),
              clients=_common.smoke_int("SMOKE_CLIENTS", CLIENTS),
              concurrent=_common.smoke_int("SMOKE_CONCURRENT", CONCURRENT),
              batches=_common.smoke_int("SMOKE_BATCHES", BATCHES),
              batch_rows=args.rows,
              queries_per_client=_common.smoke_int("SMOKE_QUERIES_PER_CLIENT",
                                                   QUERIES_PER_CLIENT),
              lock_audit=_common.smoke_flag("SMOKE_LOCK_AUDIT"),
              lifecycle_audit=_common.smoke_flag("SMOKE_LIFECYCLE_AUDIT"))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
