"""The chaos gate: injected faults across queries and maintenance actions
never give a wrong answer or an unrecoverable warehouse (counterpart of
the reference repo's ``tools/chaos_stress.py``).

1. **Query sweep.** Each armed ``HYPERSPACE_FAULTS`` spec of
   ``QUERY_SPECS`` runs the TPC-H query set (``benchmark/tpch.
   TPCH_QUERIES``) over a cold indexed warehouse with the device tier on.
   Every run must match the clean run at ``float.hex()`` precision or
   raise a typed ``HyperspaceError``; a builtin or a wrong result fails
   the gate. Each ``device.*`` and ``kernel.compile`` spec must fire.
   The reference degrades a device fault to the host through its breaker;
   the port has none, so the same fault ends its query with the typed
   error it raised: each such spec must also end at least one query with
   a typed error (a fault answered from the host fails the gate).
2. **Crash matrix.** Maintenance actions (create, refresh, optimize,
   delete, append, compact) run with ``InjectedCrash`` armed before and
   after every ``log.write`` and ``data.publish`` (and the ingest points)
   they perform, in a fresh warehouse per cell. ``recover(force=True)``
   must leave no debris (a stable log tail, no staging dirs, no ``.tmp``
   files, no unreferenced data version), and the re-run action must
   answer a query bit for bit as a never-crashed twin does.

After both sweeps every bounded cache passes ``check_consistency()`` and
no resource handle is live (the lifecycle audit is on).

    python -m hyperspace_tpu_torch.tools.chaos_stress [--device cpu]

Prints one JSON line; exit 0 iff every gate holds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from . import _common

# transient kinds only (crash kinds simulate process death and belong to
# the crash matrix)
QUERY_SPECS = [
    "io.read_file:ioerror:n=1",
    "io.read_file:ioerror:n=3",
    "io.read_file:ioerror:p=0.02,seed=7",
    "io.read_file:oom:n=2",
    "io.footer:ioerror:n=1",
    "device.upload:ioerror:n=1",
    "device.dispatch:ioerror:n=1",
    "device.dispatch:oom:n=1",
    "device.fetch:ioerror:n=1",
    "device.*:ioerror:p=0.05,seed=3",
    "kernel.compile:ioerror:n=1",
]
# the specs that must fire at least once over the query set
MUST_FIRE = tuple(s for s in QUERY_SPECS if s.startswith(("device.", "kernel.")))

_LOG_CRASHES = [
    "log.write:crash_before:n=1",   # begin() transient entry never lands
    "log.write:crash_after:n=1",    # transient entry lands, op never runs
    "log.write:crash_before:n=2",   # end() final entry never lands
    "log.write:crash_after:n=2",    # final entry lands, pointer rewrite lost
]
_PUBLISH_CRASHES = [
    "data.publish:crash_before:n=1",  # staged build never promoted
    "data.publish:crash_after:n=1",   # version live, final log.write lost
]
_APPEND_CRASHES = [
    "ingest.append:crash_before:n=1",  # staging created, delta never built
    "ingest.append:crash_after:n=1",   # delta published, final log.write lost
]
_COMPACT_CRASHES = [
    "ingest.compact:crash_before:n=1",  # staging created, merge never ran
    "ingest.compact:crash_after:n=1",   # compacted version live, log lost
]
CRASH_MATRIX = [
    ("create", _LOG_CRASHES + _PUBLISH_CRASHES),
    ("refresh", _LOG_CRASHES + _PUBLISH_CRASHES),
    ("optimize", _LOG_CRASHES + _PUBLISH_CRASHES),
    ("delete", _LOG_CRASHES),  # delete moves no data, only log entries
    ("append", _LOG_CRASHES + _PUBLISH_CRASHES + _APPEND_CRASHES),
    ("compact", _LOG_CRASHES + _PUBLISH_CRASHES + _COMPACT_CRASHES),
]
ROWS = 30_000
CELL_ROWS = 4_000


def query_sweep(device, workdir: str, rows: int = ROWS, specs=QUERY_SPECS) -> dict:
    """Sweep 1 over a TPC-H lake of ``rows`` lineitem rows under
    ``workdir``; returns the per-spec outcomes, the points that fired and
    the failures."""
    from ..benchmark.tpch import TPCH_QUERIES
    from ..exceptions import HyperspaceError
    from ..utils import faults

    ws = os.path.join(workdir, "queries")
    session = _common.tpch_world(ws, rows, device)
    names = list(TPCH_QUERIES)
    clean = {n: _common.bits(TPCH_QUERIES[n](session, ws).to_pydict()) for n in names}

    failures: list = []
    sweep = []
    point_fired = dict.fromkeys(faults.POINTS, 0)
    for spec in specs:
        _common.clear_engine_caches(session)
        faults.arm(spec)
        outcomes = {"identical": 0, "typed_error": 0}
        try:
            for n in names:
                try:
                    got = _common.bits(TPCH_QUERIES[n](session, ws).to_pydict())
                except faults.InjectedCrash:
                    raise  # crash kinds never belong in this sweep
                except HyperspaceError:
                    outcomes["typed_error"] += 1
                    continue
                except Exception as e:  # noqa: BLE001 - an untyped error fails the gate
                    failures.append(f"query {n} under {spec!r}: untyped {e!r}")
                    continue
                if got == clean[n]:
                    outcomes["identical"] += 1
                else:
                    failures.append(f"query {n} under {spec!r}: WRONG RESULT")
        finally:
            snap = faults.snapshot()
            faults.disarm()
        fired = sum(r["fired"] for r in snap)
        for r in snap:
            base = r["point"][:-2] if r["point"].endswith(".*") else r["point"]
            for p in point_fired:
                if p == r["point"] or (r["point"].endswith(".*") and p.startswith(base)):
                    point_fired[p] += r["fired"]
        if spec in MUST_FIRE and not fired:
            failures.append(f"{spec!r} never fired")
        elif spec in MUST_FIRE and not outcomes["typed_error"]:
            failures.append(f"{spec!r} fired and no query raised: answered off the device")
        sweep.append({"spec": spec, "fired": fired, **outcomes})
    # every query answers again, clean, after the sweep
    for n in names:
        if _common.bits(TPCH_QUERIES[n](session, ws).to_pydict()) != clean[n]:
            failures.append(f"query {n} differs from its clean run after the sweep")
    return {"rows": rows, "query_specs": len(specs), "query_runs": len(specs) * len(names),
            "query_sweep": sweep, "point_fired": point_fired, "failures": failures,
            "cache_consistency": _common.cache_consistency(session)}


def crash_matrix(device, workdir: str, cell_rows: int = CELL_ROWS, matrix=CRASH_MATRIX) -> dict:
    """Sweep 2: each (action, spec) cell in a fresh warehouse under
    ``workdir``; returns the cells and the failures."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from .. import Hyperspace, HyperspaceSession
    from .. import constants as C
    from ..exceptions import HyperspaceError
    from ..index_manager import IndexCollectionManager
    from ..meta.data_manager import IndexDataManager
    from ..meta.log_manager import STABLE_STATES, IndexLogManager
    from ..models.covering import CoveringIndexConfig
    from ..utils import faults

    def write_part(src: str, part: int, n: int) -> None:
        rng = np.random.default_rng(100 + part)
        pq.write_table(pa.table({"k": rng.integers(0, 50, n), "v": rng.random(n),
                                 "w": rng.integers(0, 1000, n)}),
                       os.path.join(src, f"part{part}.parquet"))

    def fresh_session(root: str):
        s = HyperspaceSession(warehouse_dir=root, device=device)
        s.set_conf(C.INDEX_NUM_BUCKETS, 4)
        return s, Hyperspace(s)

    def run_action(h, s, root: str, action: str, phase: str) -> None:
        """'setup' brings the warehouse to the action's precondition; 'act'
        performs the action under test."""
        src = os.path.join(root, "src")
        if phase == "setup":
            os.makedirs(src)
            write_part(src, 0, cell_rows)
            write_part(src, 1, cell_rows)
            if action != "create":
                h.create_index(s.read.parquet(src), CoveringIndexConfig("cidx", ["k"], ["v", "w"]))
            if action == "optimize":
                # an incremental refresh adds a second small file per bucket
                write_part(src, 2, cell_rows)
                h.refresh_index("cidx", C.REFRESH_MODE_INCREMENTAL)
            if action == "compact":
                # an ingest append gives every bucket a second (delta) run
                write_part(src, 2, cell_rows)
                h.append("cidx", s.read.parquet(os.path.join(src, "part2.parquet")))
            return
        if action == "create":
            h.create_index(s.read.parquet(src), CoveringIndexConfig("cidx", ["k"], ["v", "w"]))
        elif action == "refresh":
            write_part(src, 2, cell_rows)
            h.refresh_index("cidx", C.REFRESH_MODE_FULL)
        elif action == "optimize":
            h.optimize_index("cidx")
        elif action == "append":
            # the part is written once: a re-run after a crash must find an
            # already-appended file unchanged, and no-op
            p2 = os.path.join(src, "part2.parquet")
            if not os.path.exists(p2):
                write_part(src, 2, cell_rows)
            h.append("cidx", s.read.parquet(p2))
        elif action == "compact":
            h.compact_index("cidx", min_runs=2)
        elif action == "delete":
            h.delete_index("cidx")

    def query_bits(s, root: str) -> str:
        df = s.read.parquet(os.path.join(root, "src"))
        return _common.bits(df.filter(df["k"] == 7).select("v", "w").collect().to_pydict())

    def index_debris(root: str) -> list:
        bad = []
        sys_dir = os.path.join(root, C.INDEXES_DIR)
        if not os.path.isdir(sys_dir):
            return bad
        for name in os.listdir(sys_dir):
            ip = os.path.join(sys_dir, name)
            if not os.path.isdir(ip):
                continue
            lm, dm = IndexLogManager(ip), IndexDataManager(ip)
            latest = lm.get_latest_log()
            if latest is not None and latest.state not in STABLE_STATES:
                bad.append(f"{name}: unstable log tail {latest.state}")
            if dm.staged_versions():
                bad.append(f"{name}: staging dirs {dm.staged_versions()}")
            if lm.stale_temp_files():
                bad.append(f"{name}: stale .tmp files")
            refs = IndexCollectionManager._referenced_versions(lm)
            if latest is not None and latest.state == "DOESNOTEXIST":
                refs = set()
            orphans = [v for v in dm.get_all_versions() if v not in refs]
            if orphans:
                bad.append(f"{name}: orphan data versions {orphans}")
        return bad

    failures: list = []
    cells = []
    for action, specs in matrix:
        twin = os.path.join(workdir, f"twin_{action}")
        ts, th = fresh_session(twin)
        run_action(th, ts, twin, action, "setup")
        run_action(th, ts, twin, action, "act")
        ts.enable_hyperspace()
        twin_bits = query_bits(ts, twin)
        for i, spec in enumerate(specs):
            cell = os.path.join(workdir, f"cell_{action}_{i}")
            s, h = fresh_session(cell)
            run_action(h, s, cell, action, "setup")
            crashed = False
            faults.arm(spec)
            try:
                run_action(h, s, cell, action, "act")
            except faults.InjectedCrash:
                crashed = True
            finally:
                snap = faults.snapshot()
                faults.disarm()
            fired = sum(r["fired"] for r in snap)
            # a fresh manager (the restarted process) repairs the debris
            s2, h2 = fresh_session(cell)
            h2.recover(force=True)
            debris = index_debris(cell)
            if debris:
                failures.append(f"{action} under {spec!r}: {debris}")
            try:
                run_action(h2, s2, cell, action, "act")
            except HyperspaceError:
                # it completed before the crash (the final entry landed);
                # the debris check above is the gate
                pass
            s2.enable_hyperspace()
            identical = query_bits(s2, cell) == twin_bits
            if not identical:
                failures.append(f"{action} under {spec!r}: post-recovery result diverges")
            cells.append({"action": action, "spec": spec, "fired": fired, "crashed": crashed,
                          "recovered_clean": not debris, "identical": identical})
    if not any(c["fired"] for c in cells):
        failures.append("no crash fired in the matrix")
    for c in cells:
        if c["fired"] and not c["crashed"]:
            failures.append(f"{c['action']} under {c['spec']!r}: fired but did not crash")
    return {"cell_rows": cell_rows, "crash_cells": len(cells), "crash_matrix": cells,
            "failures": failures}


def run(device, rows: int = ROWS, cell_rows: int = CELL_ROWS, crash: bool = True,
        workdir: "str | None" = None) -> dict:
    """Both sweeps (the crash matrix unless ``crash`` is False) under the
    lifecycle audit, then the global invariants; ``ok`` says whether every
    gate held. ``workdir`` (default: a temporary directory) is removed."""
    from ..staticcheck import lifecycle as lc
    from ..utils import faults

    base = tempfile.mkdtemp(prefix="hs_chaos_", dir=workdir)
    injected0 = _common.counter("faults.injected")
    try:
        with _common.gate_scope(_common.GATE_ENV, lifecycle_audit=True):
            out = query_sweep(device, base, rows)
            if crash:
                matrix = crash_matrix(device, base, cell_rows)
                out["failures"] += matrix.pop("failures")
                out.update(matrix)
            leaks = [h.describe() for h in lc.check_quiescent(raise_on_leak=False)]
            lifecycle = lc.report()
    finally:
        faults.disarm()
        shutil.rmtree(base, ignore_errors=True)
    injected = _common.counter("faults.injected") - injected0
    out.update({
        "device": str(device),
        "injected_total": injected,
        "io_retry_attempts": _common.counter("io.retry.attempts"),
        "io_retry_gave_up": _common.counter("io.retry.gave_up"),
        "recovery_rolled_back": _common.counter("recovery.rolled_back"),
        "recovery_orphan_versions": _common.counter("recovery.orphan_versions"),
        "recovery_staging_removed": _common.counter("recovery.staging_removed"),
        "recovery_pointer_fixed": _common.counter("recovery.pointer_fixed"),
        "lifecycle_audit": lifecycle["audit_enabled"],
        "lifecycle_leaks": leaks[:10],
    })
    out["failures"] = out["failures"][:20]
    out["ok"] = (not out["failures"] and all(out["cache_consistency"].values())
                 and injected > 0 and not leaks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    out = run(_common.resolve_device(args.device))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
