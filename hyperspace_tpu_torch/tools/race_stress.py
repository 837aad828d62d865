"""The race gate: threads of mixed TPC-H queries over one session's shared
caches and pools give the serial answers bit for bit, with no lock-order
violation and consistent cache accounting (counterpart of the reference
repo's ``tools/race_stress.py``).

A serial pass runs every query of ``benchmark/tpch.TPCH_QUERIES`` once
(warming every cache); then ``threads`` threads each run the whole set
``repeats`` times in a thread-rotated order, all started together, with
the lock-order audit (``HYPERSPACE_LOCK_AUDIT``) and the lifecycle audit
on. Required: every threaded result equals the serial one at
``float.hex()`` precision; ``staticcheck.lock.violations`` does not move;
every bounded cache is consistent at quiescence and no handle is live.

    python -m hyperspace_tpu_torch.tools.race_stress [--device cpu]

Prints one JSON line; exit 0 iff all gates hold.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import threading

from . import _common

THREADS = 8
REPEATS = 2
ROWS = 60_000


def run(device, threads: int = THREADS, repeats: int = REPEATS, rows: int = ROWS,
        workdir: "str | None" = None) -> dict:
    """The gate over a TPC-H lake of ``rows`` lineitem rows in a temporary
    directory (under ``workdir`` when given), removed at the end."""
    from ..benchmark.tpch import TPCH_QUERIES
    from ..staticcheck import concurrency as cc
    from ..staticcheck import lifecycle as lc
    from ..utils.workers import spawn_thread

    ws = tempfile.mkdtemp(prefix="hs_race_stress_", dir=workdir)
    try:
        with _common.gate_scope(_common.GATE_ENV, lock_audit=True, lifecycle_audit=True):
            session = _common.tpch_world(ws, rows, device)
            names = list(TPCH_QUERIES)
            violations0 = _common.counter("staticcheck.lock.violations")
            acquisitions0 = _common.counter("staticcheck.lock.acquisitions")
            # the serial reference (also warms every shared cache)
            serial = {n: _common.bits(TPCH_QUERIES[n](session, ws).to_pydict()) for n in names}

            mismatches: list = []
            errors: list = []
            barrier = threading.Barrier(threads)

            def worker(tid: int) -> None:
                try:
                    barrier.wait()  # maximal overlap: all threads start together
                    for r in range(repeats):
                        # rotated per thread, so different queries collide
                        # on the shared caches in every wave
                        i = (tid + r) % len(names)
                        for name in names[i:] + names[:i]:
                            got = _common.bits(TPCH_QUERIES[name](session, ws).to_pydict())
                            if got != serial[name]:
                                mismatches.append((tid, name))
                except Exception as e:  # noqa: BLE001 - reported through the gate
                    errors.append((tid, repr(e)))

            workers = [spawn_thread(worker, name=f"hs-stress-{i}", daemon=False, args=(i,))
                       for i in range(threads)]
            for t in workers:
                t.join()
            consistency = _common.cache_consistency(session)
            lock_report = cc.report()
            leaks = [h.describe() for h in lc.check_quiescent(raise_on_leak=False)]
            lifecycle = lc.report()
            violations = _common.counter("staticcheck.lock.violations") - violations0
            acquisitions = _common.counter("staticcheck.lock.acquisitions") - acquisitions0
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    ok = (not mismatches and not errors and violations == 0 and all(consistency.values())
          and not leaks)
    return {
        "device": str(device),
        "rows": rows,
        "threads": threads,
        "repeats": repeats,
        "queries": names,
        "runs": threads * repeats * len(names),
        "bit_identical": not mismatches and not errors,
        "mismatches": mismatches[:10],
        "errors": errors[:10],
        "lock_audit": lock_report["audit_enabled"],
        "lock_acquisitions": acquisitions,
        "lock_edges": len(lock_report["edges"]),
        "lock_violations": violations,
        "registered_locks": len(lock_report["locks"]),
        "cache_consistency": consistency,
        "lifecycle_audit": lifecycle["audit_enabled"],
        "lifecycle_leaks": leaks[:10],
        "ok": ok,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    out = run(_common.resolve_device(args.device))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
