"""The serving gate: concurrent clients through one query scheduler give
the serial answers bit for bit, with no lock-order violation, consistent
caches, a drained global budget and a conserved per-query attribution
ledger under a live metrics exporter (counterpart of the reference repo's
``tools/serve_smoke.py``).

A serial pass runs every served query once (the reference bits; it also
warms the session's caches). Then ``clients`` client threads (default 8),
started together, each submit the whole set ``repeats`` times (default 2,
client-rotated order, closed loop) to ONE ``QueryScheduler`` of
``concurrent`` workers (default 4) and compare every result with the
serial one at ``float.hex()`` precision. A cancellation exercise then
submits every query and cancels it at once. The exporter runs on an
ephemeral port for the whole window and a scraper thread fetches
/metrics, /snapshot and /healthz throughout.

The served set is the reference's ``TPCH_QUERIES`` (q1, q3, q6, q10, q17,
q18), none of which reaches a kernel, plus the port's kernel-shaped forms
``q6_count``, ``q6_sum`` and ``q1_sums`` (``benchmark/tpch.QUERIES``; a
port-only addition): on the card they launch kernels 1-3 from the
scheduler's workers. Before the serial pass a kernel wave submits each
kernel-shaped query once per worker, the runs meeting at a barrier, so
each kernel launches from every worker at once (and in a fresh process
the kernels' first build is started from the workers; the build lock
serializes it); its results are held to the serial ones too.

Required (exit 0 iff all hold):

- every served result equals the serial one bit for bit;
- each kernel-shaped run counted its one kernel (a CUDA launch on the
  card, the plain version on the host) on the worker thread that served
  it, and each kernel from at least two workers;
- for every ``io. cache. rpc. pipeline. pruning. serve.budget.`` counter,
  the per-query ledger sum over the window equals the global delta;
- every /metrics scrape parses as Prometheus text with consistent
  histograms, every /snapshot parses as JSON with its keys, every
  /healthz parses (a 503 is a valid answer);
- ``staticcheck.lock.violations`` does not move with the lock-order audit
  on; every bounded cache is consistent at quiescence; the global budget
  is consistent and drained; the scheduler is idle; no resource handle is
  live (the lifecycle audit is on); the read-ahead reserved through the
  global budget, and the ledger recorded every served query.

Departures from the reference, by decision: the port's /snapshot has no
``breaker`` key (it has no breaker), so the scraper checks ``ts``,
``metrics``, ``serving`` and ``queries``; ``HYPERSPACE_DEVICE_STRICT`` is
a breaker knob the port does not register, so it is not set; the port's
caches are per session, so the reference's six named caches are the
session's (``_common.cache_consistency``); the ledger window is the one
the package was imported with (``_common.Conservation``).

    python -m hyperspace_tpu_torch.tools.serve_smoke [--device cpu] [--rows N]

Env: SMOKE_CLIENTS (8), SMOKE_CONCURRENT (4), SMOKE_REPEATS (2),
SMOKE_ROWS (60000), SMOKE_EXPORTER=0 skips the exporter and scraper,
SMOKE_LOCK_AUDIT=0 and SMOKE_LIFECYCLE_AUDIT=0 turn the audits off.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from . import _common

CLIENTS = 8
CONCURRENT = 4
REPEATS = 2
ROWS = 60_000
SEED = 23
BUCKETS = 8
# small chunks so the streamed executor engages at these row counts; a
# real IO pool width; a small global budget so backpressure fires
ENV = {"HYPERSPACE_STREAM_CHUNK_MB": "0.5", "HYPERSPACE_IO_THREADS": "4",
       "HYPERSPACE_GLOBAL_BUDGET_MB": "8"}
# the port's kernel-shaped forms and the kernel each launches
KERNEL_QUERIES = {"q6_count": "filter_weighted_sum", "q6_sum": "filter_sum",
                  "q1_sums": "filter_grouped_multi_sum"}
SNAPSHOT_KEYS = ("ts", "metrics", "serving", "queries")


def served_queries() -> dict:
    """The reference's TPC-H set and the port's kernel-shaped forms."""
    from ..benchmark import tpch

    return {**tpch.TPCH_QUERIES, **{q: tpch.QUERIES[q] for q in KERNEL_QUERIES}}


class Scraper:
    """A thread fetching /metrics, /snapshot and /healthz from ``url``
    until stopped, collecting every violation."""

    def __init__(self, url: str):
        from ..utils.workers import spawn_thread

        self.url = url
        self.errors: list = []
        self.scrapes = {"metrics": 0, "snapshot": 0, "healthz": 0}
        self._stop = threading.Event()
        self._thread = spawn_thread(self._loop, name="hs-smoke-scraper")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(self.url + "/metrics", timeout=10) as r:
                    self.errors.extend(_common.parse_prometheus(r.read().decode("utf-8")))
                self.scrapes["metrics"] += 1
                with urllib.request.urlopen(self.url + "/snapshot", timeout=10) as r:
                    snap = json.loads(r.read().decode("utf-8"))
                self.errors.extend(f"/snapshot missing {k!r}" for k in SNAPSHOT_KEYS
                                   if k not in snap)
                self.scrapes["snapshot"] += 1
                try:
                    with urllib.request.urlopen(self.url + "/healthz", timeout=10) as r:
                        json.loads(r.read().decode("utf-8"))
                except urllib.error.HTTPError as he:
                    json.loads(he.read().decode("utf-8"))  # 503 (degraded) is valid
                self.scrapes["healthz"] += 1
            except Exception as e:  # noqa: BLE001 - reported through the gate
                self.errors.append(repr(e))
            self._stop.wait(0.05)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    @property
    def ok(self) -> bool:
        return not self.errors and all(v > 0 for v in self.scrapes.values())


def run(device, root: "str | None" = None, clients: int = CLIENTS,
        concurrent: int = CONCURRENT, repeats: int = REPEATS, rows: int = ROWS,
        exporter: bool = True, lock_audit: bool = True,
        lifecycle_audit: bool = True) -> dict:
    """The gate over a TPC-H lake of ``rows`` lineitem rows in a temporary
    directory (under ``root`` when given), removed at the end; ``results``
    holds the serial results (``to_pydict`` form)."""
    from .. import serve
    from ..staticcheck import concurrency as cc
    from ..staticcheck import lifecycle as lc
    from ..telemetry import exporter as texp
    from ..telemetry.metrics import REGISTRY

    device = _common.resolve_device(device)
    t0 = time.perf_counter()
    env = {**ENV, **({"HYPERSPACE_METRICS_PORT": "0"} if exporter else {})}
    ws = tempfile.mkdtemp(prefix="hs_serve_smoke_", dir=root)
    sched = None
    try:
        with _common.gate_scope(env, lock_audit=lock_audit, lifecycle_audit=lifecycle_audit):
            idle = _common.settle_background()
            session = _common.tpch_world(ws, rows, device, seed=SEED, buckets=BUCKETS)
            fns = served_queries()
            names = list(fns)
            # the kernel wave first: in a fresh process the kernels' first
            # build starts from the workers at once
            sched = serve.QueryScheduler(max_concurrent=concurrent,
                                         queue_depth=max(64, clients * len(names)))
            wave = _common.kernel_wave(sched, {q: fns[q] for q in KERNEL_QUERIES}, session, ws,
                                       device, concurrent)
            sched.shutdown(wait=True)
            sched = None
            results = {n: fns[n](session, ws).to_pydict() for n in names}
            serial = {n: _common.bits(r) for n, r in results.items()}

            violations0 = _common.counter("staticcheck.lock.violations")
            acquisitions0 = _common.counter("staticcheck.lock.acquisitions")
            records0 = _common.counter("serve.query.records")
            budget0 = {n: _common.counter(f"serve.budget.{n}")
                       for n in ("reservations", "stalls", "force_grants")}
            conservation = _common.Conservation()
            sched = serve.QueryScheduler(max_concurrent=concurrent,
                                         queue_depth=max(64, clients * len(names)))
            exp = texp.get_exporter() if exporter else None
            scraper = None if exp is None else Scraper(exp.url)

            mix = _common.serve_clients(sched, fns, session, ws, serial, clients, repeats,
                                        device, label="c", priority=lambda tid: tid % 3)
            sched.drain(timeout=60)
            errors = mix["errors"] + wave["errors"]
            mismatches = mix["mismatches"] + _common.wave_mismatches(wave, serial)
            kernels = _common.kernel_leg(device, mix["runs"] + wave["runs"], KERNEL_QUERIES)

            # the cancellation exercise: every query submitted, cancelled at once
            cancelled = 0
            cancel_ok = True
            try:
                handles = [sched.submit((lambda n=n: fns[n](session, ws).collect()),
                                        label=f"cancel:{n}") for n in names]
                for h in handles:
                    h.cancel()
                for h in handles:
                    try:
                        h.result(timeout=300)
                    except serve.QueryCancelledError:
                        cancelled += 1
                    except Exception as e:  # noqa: BLE001 - reported through the gate
                        errors.append(("cancel", repr(e)))
                sched.drain(timeout=60)
            except Exception as e:  # noqa: BLE001 - reported through the gate
                cancel_ok = False
                errors.append(("cancel-exercise", repr(e)))

            unconserved = conservation.settle()
            if scraper is not None:
                scraper.stop()
            quiet = _common.quiescence(sched, session)
            waits = REGISTRY.get("serve.queue_wait_ms")
            queue_wait = {} if waits is None else waits.value
            sched.shutdown(wait=True)
            sched = None
            texp.stop_exporter()
            texp.stop_snapshot_sink()
            lock_report = cc.report()
            leaks = [h.describe() for h in lc.check_quiescent(raise_on_leak=False)]
            lifecycle = lc.report()
            violations = _common.counter("staticcheck.lock.violations") - violations0
            records = _common.counter("serve.query.records") - records0
            budget = {n: _common.counter(f"serve.budget.{n}") - v for n, v in budget0.items()}
            acquisitions = _common.counter("staticcheck.lock.acquisitions") - acquisitions0
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
            texp.stop_exporter()
        shutil.rmtree(ws, ignore_errors=True)
    served = clients * repeats * len(names)
    scrape_ok = scraper is None or scraper.ok
    ok = (not mismatches and not errors and cancel_ok and kernels["ok"] and violations == 0
          and all(quiet["cache_consistency"].values()) and quiet["budget_drained"]
          and quiet["scheduler_quiescent"] and not unconserved and scrape_ok
          and budget["reservations"] > 0 and records >= served and not leaks and idle)
    out = {
        "device": str(device),
        "rows": rows,
        "clients": clients,
        "max_concurrent": concurrent,
        "repeats": repeats,
        "queries": names,
        "served_runs": served,
        "wave_runs": len(wave["runs"]),
        "bit_identical": not mismatches and not errors,
        "mismatches": mismatches[:10],
        "errors": errors[:10],
        "kernels": kernels,
        "cancelled_resolved": cancelled,
        "scheduler_quiescent": quiet["scheduler_quiescent"],
        "budget_drained": quiet["budget_drained"],
        "attribution_conserved": not unconserved,
        "conservation_mismatches": dict(list(unconserved.items())[:10]),
        "ledger_records": records,
        "exporter": None if scraper is None else {
            "url": scraper.url, "scrapes": scraper.scrapes,
            "scrape_errors": scraper.errors[:10], "ok": scrape_ok},
        "queue_wait_ms": queue_wait,
        "budget_counters": budget,
        "lock_audit": lock_report["audit_enabled"],
        "lock_acquisitions": acquisitions,
        "lock_violations": violations,
        "cache_consistency": quiet["cache_consistency"],
        "background_idle": idle,
        "lifecycle_audit": lifecycle["audit_enabled"],
        "lifecycle_acquires": lifecycle["acquires"],
        "lifecycle_releases": lifecycle["releases"],
        "lifecycle_leaks": leaks[:10],
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
              clients=_common.smoke_int("SMOKE_CLIENTS", CLIENTS),
              concurrent=_common.smoke_int("SMOKE_CONCURRENT", CONCURRENT),
              repeats=_common.smoke_int("SMOKE_REPEATS", REPEATS),
              rows=args.rows,
              exporter=_common.smoke_flag("SMOKE_EXPORTER"),
              lock_audit=_common.smoke_flag("SMOKE_LOCK_AUDIT"),
              lifecycle_audit=_common.smoke_flag("SMOKE_LIFECYCLE_AUDIT"))
    _common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
