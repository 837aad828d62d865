"""What the gates share: the ``float.hex()`` form of a result, the one
JSON line a gate prints, and the ``--device`` flag."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import torch

from ..exceptions import DeviceUnavailableError


def bits(d: dict) -> str:
    """A result dict at bit precision: every float as ``float.hex()``
    (the reference's ``tools/chaos_stress._bits``)."""
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


# what a gate's run() returns for its callers but its JSON line leaves out
DETAILS = ("results", "bits", "report")


def emit(obj: dict) -> None:
    """Print the gate's one JSON line (less DETAILS)."""
    print(json.dumps({k: v for k, v in obj.items() if k not in DETAILS}, default=str),
          flush=True)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device of the device tier (default: the card)")


def add_rows_flag(parser: argparse.ArgumentParser, default: int) -> None:
    """``--rows``: the lake's size (default ``SMOKE_ROWS``, else the
    reference's)."""
    parser.add_argument("--rows", type=int, default=smoke_int("SMOKE_ROWS", default),
                        help=f"lineitem rows of the gate's lake (default {default})")


def smoke_int(name: str, default: int) -> int:
    """A reference gate's ``SMOKE_*`` size knob."""
    return int(os.environ.get(name, default))  # hslint: HS301 — a gate's size, not a knob


def smoke_flag(name: str) -> bool:
    """A reference gate's ``SMOKE_*`` opt-out: on unless set to 0."""
    return os.environ.get(name, "1") == "1"  # hslint: HS301 — a gate's opt-out


def resolve_device(name: "str | None") -> torch.device:
    """The device a gate runs on: the card unless ``name`` says otherwise.
    Asking for CUDA where there is none raises, as the session does; there
    is no fallback to the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "the gate runs on CUDA by default and torch.cuda.is_available() is "
                "false; pass --device cpu to run it on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def engine_caches(session) -> dict:
    """Every bounded cache a query of ``session`` goes through: the
    session's own (the port keeps them per session) and the process-wide
    ones, by the reference's names where it has them."""
    from ..cache.result_cache import RESULT_CACHE
    from ..columnar import io as cio
    from ..models.dataskipping import sketch_store
    from ..plan import kernel_cache as kc

    return {
        "io.index_chunk": session.index_chunk_cache,
        "io.source_col": cio._SOURCE_COL_CACHE,
        "io.rowgroup_stats": cio._ROWGROUP_STATS_CACHE,
        "io.sidecar": sketch_store._SIDECAR_CACHE,
        "device": session.device_cache,
        "host_derived": session.host_derived_cache,
        "kernel": session.kernel_cache,
        "kernel_mesh": kc.MESH_CACHE,
        "result": RESULT_CACHE,
    }


def clear_engine_caches(session) -> None:
    """Start cold: a cached chunk never re-reads and a cached kernel never
    re-builds, so warm caches would absorb the fault points."""
    for cache in engine_caches(session).values():
        cache.clear()


def cache_consistency(session) -> dict:
    """Each bounded cache's ``check_consistency()`` (call at quiescence)."""
    return {name: cache.check_consistency() for name, cache in engine_caches(session).items()}


# the TPC-H world of the chaos and race gates: seed 11, 8 buckets, small
# chunks so the streamed executor engages at their row counts
TPCH_SEED = 11
TPCH_BUCKETS = 8
GATE_ENV = {"HYPERSPACE_STREAM_CHUNK_MB": "0.5"}


def tpch_world(ws: str, rows: int, device, seed: int = TPCH_SEED, buckets: int = TPCH_BUCKETS):
    """A TPC-H lake of ``rows`` lineitem rows under ``ws``, indexed
    (``benchmark/tpch.tpch_indexes``), with the device tier and Hyperspace
    on; returns the session."""
    from .. import Hyperspace, HyperspaceSession
    from .. import constants as C
    from ..benchmark.tpch import generate_tpch, tpch_indexes

    generate_tpch(ws, rows_lineitem=rows, seed=seed)
    session = HyperspaceSession(warehouse_dir=ws, device=device)
    session.set_conf(C.INDEX_NUM_BUCKETS, buckets)
    session.set_conf(C.EXEC_TPU_ENABLED, True)
    tpch_indexes(session, Hyperspace(session), ws)
    session.enable_hyperspace()
    return session


def counter(name: str) -> int:
    from ..telemetry.metrics import REGISTRY

    m = REGISTRY.get(name)
    return 0 if m is None else int(m.value)


@contextlib.contextmanager
def gate_scope(env: dict, lock_audit: bool = False, lifecycle_audit: bool = False):
    """Set ``env`` (the knobs are read at every call; a None value unsets
    its knob) and the audits for the block, and put all back after it, so
    a gate called in-process leaves the caller's settings as they were."""
    from ..staticcheck import concurrency as cc
    from ..staticcheck import lifecycle as lc
    from ..utils import env as knobs

    saved = {k: knobs.read_raw(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    prev_lock = cc.set_audit(lock_audit or cc.audit_enabled())
    prev_life = lc.set_audit(lifecycle_audit or lc.audit_enabled())
    try:
        yield
    finally:
        cc.set_audit(prev_lock)
        lc.set_audit(prev_life)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# what the serving-plane gates share
# ---------------------------------------------------------------------------

# counters charged only inside a query's execution: the conservation set
# (serve.*, exporter.* and staticcheck.* also move on scheduler, scrape and
# audit threads that serve no one query)
CONSERVED_PREFIXES = ("io.", "cache.", "rpc.", "pipeline.", "pruning.", "serve.budget.")


def parse_prometheus(text: str) -> list:
    """A /metrics body checked: the text format's grammar, and for every
    histogram cumulative buckets and a ``+Inf`` bucket equal to its
    ``_count``. Returns the violations (the reference's
    ``tools/serve_smoke._parse_prometheus``, the same messages)."""
    errors = []
    buckets: dict = {}
    counts: dict = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        parts = ln.rsplit(" ", 1)
        if len(parts) != 2:
            errors.append(f"unparseable line: {ln!r}")
            continue
        series, raw = parts
        try:
            val = float(raw)
        except ValueError:
            errors.append(f"non-numeric value: {ln!r}")
            continue
        if '{le="' in series:
            name = series.split("{", 1)[0]
            le = series.split('le="', 1)[1].split('"', 1)[0]
            buckets.setdefault(name, []).append((le, val))
        elif series.endswith("_count"):
            counts[series[: -len("_count")]] = val
    for name, bs in buckets.items():
        cum = [v for _le, v in bs]
        if any(later < earlier for earlier, later in zip(cum, cum[1:])):
            errors.append(f"{name}: buckets not cumulative: {bs}")
        base = name[: -len("_bucket")] if name.endswith("_bucket") else name
        if not bs or bs[-1][0] != "+Inf":
            errors.append(f"{name}: missing +Inf bucket")
        elif counts.get(base) != bs[-1][1]:
            errors.append(f"{name}: +Inf ({bs[-1][1]}) != _count ({counts.get(base)})")
    return errors


def conserved_counters() -> dict:
    from ..telemetry.metrics import REGISTRY

    return {name: value for name, kind, value in REGISTRY.export()
            if kind == "counter" and name.startswith(CONSERVED_PREFIXES)}


def histogram_counts(prefix: str) -> dict:
    """Each registered histogram under ``prefix``: its observation count."""
    from ..telemetry.metrics import REGISTRY

    return {name: value["count"] for name, kind, value in REGISTRY.export()
            if kind == "histogram" and name.startswith(prefix)}


class Conservation:
    """Attribution conservation over a window that opens at construction:
    the query ledger's records since then, summed per query (``by=
    "query"``) or per tenant (``by="tenant"``; each query belongs to one
    tenant, so the sums are the same numbers grouped), against the global
    deltas of every ``CONSERVED_PREFIXES`` counter.

    The reference's gates size the ledger's window (``HYPERSPACE_QUERY_
    LOG_WINDOW``) before the package is imported; the port's ledger is
    sized when the package is imported, so a gate sums only the records
    its window added, and the check fails when the window could not hold
    them all."""

    def __init__(self, by: str = "query"):
        from ..telemetry.attribution import LEDGER

        self.by = by
        self.ledger = LEDGER
        self.seq0 = LEDGER.last_seq()
        self.g0 = conserved_counters()

    def records(self) -> list:
        return self.ledger.recent_records(since_seq=self.seq0)

    def mismatches(self) -> dict:
        g1 = conserved_counters()
        deltas = {k: g1.get(k, 0) - self.g0.get(k, 0) for k in set(self.g0) | set(g1)}
        recs = self.records()
        window = self.ledger.snapshot(limit=0)["window"]
        if len(recs) >= window:
            return {"ledger window": {"window": window, "records": len(recs)}}
        sums: dict = {}
        for r in recs:
            for k, v in r["counters"].items():
                if k.startswith(CONSERVED_PREFIXES):
                    sums[k] = sums.get(k, 0) + v
        side = "tenant_sum" if self.by == "tenant" else "ledger_sum"
        return {k: {"global_delta": deltas.get(k, 0), side: sums.get(k, 0)}
                for k in set(deltas) | set(sums) if deltas.get(k, 0) != sums.get(k, 0)}

    def settle(self, tries: int = 40, wait_s: float = 0.25) -> dict:
        """``mismatches()``, retried while straggler pool tasks (read-ahead
        of a cancelled query) may still be landing charges."""
        m = self.mismatches()
        for _ in range(tries):
            if not m:
                break
            time.sleep(wait_s)  # hslint: HS401 — gate tool, straggler-charge settle
            m = self.mismatches()
        return m


def settle_background(timeout_s: float = 120.0) -> bool:
    """Wait until no background compaction, vacuum or result-cache refresh
    is scheduled or running (their IO would charge counters inside a
    gate's conservation window); True when idle."""
    from ..cache.view_maintenance import refresh_idle
    from ..ingest import maintenance_idle

    deadline = time.monotonic() + timeout_s
    while not (refresh_idle() and maintenance_idle()):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)  # hslint: HS401 — gate tool, background settle
    return True


def quiescence(sched, session) -> dict:
    """At the end of a gate: the scheduler idle (nothing active or
    queued), the global read-ahead budget drained and consistent, and
    every bounded cache consistent."""
    from .. import serve

    state = sched.state()
    budget = serve.global_budget()
    return {"scheduler_quiescent": not state["active"] and not state["queued"],
            "budget_drained": budget.held_bytes() == 0 and budget.check_consistency(),
            "cache_consistency": cache_consistency(session)}


def kernel_counts(device) -> dict:
    """The kernel counts a query on ``device`` moves: the CUDA launches on
    the card, the plain versions' calls on the host."""
    from ..ops import cuda_kernels as K

    return K.LAUNCHES if torch.device(device).type == "cuda" else K.PLAIN_CALLS


def counted(device, fn):
    """Run ``fn()`` and return (its result, the kernels this thread counted
    during it, the thread's name): the kernels a scheduler worker launched
    for one served query."""
    from ..ops import cuda_kernels as K

    counts = kernel_counts(device)
    before = K.thread_counts(counts)
    out = fn()
    after = K.thread_counts(counts)
    return out, {k: after[k] - before[k] for k in after}, threading.current_thread().name


def serve_clients(sched, fns: dict, session, root: str, serial: dict, clients: int,
                  repeats: int, device, label: str = "c", priority=None,
                  extra=None) -> dict:
    """The served mix: ``clients`` client threads, started together, each
    submit every query of ``fns`` ``repeats`` times in a client-rotated
    order to ``sched`` (closed loop: the next submit waits for this
    result) and compare each result with ``serial`` at ``float.hex()``
    precision. The whole query, plan included, runs in the submitted
    closure, so every charge lands in its attribution scope. ``extra(tid)``,
    when given, runs after each pass. Returns the mismatches, the errors
    and the kernels each worker launched."""
    from ..utils.workers import spawn_thread

    names = list(fns)
    mismatches: list = []
    errors: list = []
    runs: list = []
    barrier = threading.Barrier(clients)

    def client(tid: int) -> None:
        try:
            barrier.wait()
            for r in range(repeats):
                off = (tid + r) % len(names)
                for name in names[off:] + names[:off]:
                    h = sched.submit(
                        (lambda n=name: counted(device, lambda: fns[n](session, root).collect())),
                        label=f"{label}{tid}:{name}",
                        priority=None if priority is None else priority(tid),
                    )
                    out, launched, thread = h.result(timeout=300)
                    runs.append((name, launched, thread))
                    if bits(out.to_pydict()) != serial[name]:
                        mismatches.append((tid, name))
                if extra is not None:
                    extra(tid)
        except Exception as e:  # noqa: BLE001 - reported through the gate
            errors.append((tid, repr(e)))

    threads = [spawn_thread(client, name=f"hs-{label}-client-{i}", daemon=False, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.join()
    return {"mismatches": mismatches, "errors": errors, "runs": runs}


def kernel_leg(device, runs, kernel_of: dict) -> dict:
    """The kernel leg of a served window: per kernel-shaped query, its runs
    and the workers that launched its kernel, and whether every run
    launched its kernel (and no other) on the worker that served it."""
    per_query: dict = {}
    for name, launched, thread in runs:
        if name not in kernel_of:
            if any(launched.values()):
                per_query.setdefault("unexpected", []).append((name, launched))
            continue
        q = per_query.setdefault(name, {"runs": 0, "launched_runs": 0, "threads": {}})
        q["runs"] += 1
        want = kernel_of[name]
        if launched[want] > 0 and not any(n for k, n in launched.items() if k != want):
            q["launched_runs"] += 1
        q["threads"][thread] = q["threads"].get(thread, 0) + launched[want]
    ok = all(per_query.get(n, {}).get("runs", 0) > 0
             and per_query[n]["launched_runs"] == per_query[n]["runs"]
             and len([t for t, c in per_query[n]["threads"].items() if c]) >= 2
             for n in kernel_of) and "unexpected" not in per_query
    threads: dict = {}
    for _name, launched, thread in runs:
        for k, n in launched.items():
            if n:
                threads.setdefault(k, {})
                threads[k][thread] = threads[k].get(thread, 0) + n
    return {"queries": per_query, "threads_by_kernel": threads, "ok": ok}


def kernel_wave(sched, fns: dict, session, root: str, device, workers: int,
                tenant: "str | None" = None) -> dict:
    """Each query of ``fns`` submitted ``workers`` times at once; the
    closures meet at a barrier before they run, so ``workers`` scheduler
    workers run the query at the same time, each on its own thread.
    Returns the errors, the runs and each run's bits."""
    errors: list = []
    runs: list = []
    got: list = []
    for name, fn in fns.items():
        meet = threading.Barrier(workers)

        def job(fn=fn):
            meet.wait(timeout=120)
            return counted(device, lambda: fn(session, root).collect())

        handles = [sched.submit(job, label=f"wave:{name}", tenant=tenant)
                   for _ in range(workers)]
        for h in handles:
            try:
                out, launched, thread = h.result(timeout=300)
            except Exception as e:  # noqa: BLE001 - reported through the gate
                errors.append((name, repr(e)))
                continue
            runs.append((name, launched, thread))
            got.append((name, bits(out.to_pydict())))
    return {"errors": errors, "runs": runs, "bits": got}


def wave_mismatches(wave: dict, serial: dict) -> list:
    return [("wave", name) for name, b in wave["bits"] if b != serial[name]]
