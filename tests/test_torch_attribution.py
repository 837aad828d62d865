"""Per-query attribution, the query log and the exporter, the port against
the JAX package on the same inputs (the counterpart of
tests/test_attribution.py, less its tools cases).

- Attributed writes: a counter or histogram write inside a scope charges
  the query and the global value, nothing outside one; scopes nest;
  ``bound`` carries the target onto pool threads; phases charge their
  time.
- The ledger: a record has the JAX package's keys (also for the served
  TPC-H fixture queries: 2,000 lineitem rows, seed 7, ``tpch_indexes``
  built by the JAX package, both device tiers on); begin/finish, the
  rollups that are not charged back, unrun records, the window, the
  aggregates, the health window, the slow-query log and the phase
  percentiles equal the JAX package's.
- Conservation: over a window of concurrent served queries (the multi-file
  fixture and the TPC-H fixture), the per-query sums of every ``io.``,
  ``cache.``, ``rpc.``, ``pipeline.``, ``pruning.`` and ``serve.budget.``
  counter equal the global deltas, per query and per tenant.
- The exporter on an ephemeral port of 127.0.0.1: bind, serve, stop and
  release, the singleton, /snapshot's shape (no breaker block), /healthz
  ok, 404; the Prometheus text equals the JAX package's for the same
  registry contents and carries no breaker series; the snapshot sink.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.telemetry import attribution as jattr
from hyperspace_tpu.telemetry import exporter as jexp
from hyperspace_tpu.telemetry import metrics as jmetrics
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch import serve as tserve
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.telemetry import attribution as tattr
from hyperspace_tpu_torch.telemetry import exporter as texp
from hyperspace_tpu_torch.telemetry import metrics as tmetrics
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG

ATTR = {"jax": jattr, "torch": tattr}
CONSERVED = ("io.", "cache.", "rpc.", "pipeline.", "pruning.", "serve.budget.")
SERVED_TPCH = ("q1", "q6", "q3", "q10")


def _reset_planes() -> None:
    for mod in (J, T):
        mod.serve.TENANTS.reset_for_testing()
        mod.serve.COST_MODEL.reset_for_testing()
        mod.telemetry.attribution.LEDGER.reset_for_testing()
        mod.telemetry.workload.reset_for_testing()
        mod.serve.reset_global_budget()


@pytest.fixture(scope="module", autouse=True)
def _empty_both_planes():
    _reset_planes()
    yield
    _reset_planes()


@pytest.fixture(autouse=True)
def _pristine_exporter():
    yield
    texp.stop_exporter()
    texp.stop_snapshot_sink()
    tserve.reset_global_budget()


def _stats(pkg="torch", qid=1, label="t", **kw):
    return ATTR[pkg].QueryStats(qid, label=label, **kw)


# ---------------------------------------------------------------------------
# the attributed write path
# ---------------------------------------------------------------------------


class TestAttributedWrites:
    def test_counter_inc_charges_scope_and_global(self):
        s = _stats()
        c = TREG.counter("test.attr.counter")
        before = c.value
        with tattr.scope(s):
            c.inc(3)
            c.inc()
        c.inc(10)  # outside the scope: global only
        assert c.value == before + 14
        assert s.counters() == {"test.attr.counter": 4}

    def test_histogram_observe_charges_count_and_sum(self):
        s = _stats()
        h = TREG.histogram("test.attr.hist")
        with tattr.scope(s):
            h.observe(2.0)
            h.observe(3.0)
        h.observe(100.0)
        assert s.record()["histograms"]["test.attr.hist"] == {"count": 2, "sum": 5.0}

    def test_no_scope_no_charge(self):
        assert tattr.current_stats() is None
        TREG.counter("test.attr.untracked").inc()

    def test_nested_scope_restores_outer(self):
        outer, inner = _stats(qid=1), _stats(qid=2)
        c = TREG.counter("test.attr.nested")
        with tattr.scope(outer):
            with tattr.scope(inner):
                assert tattr.current_stats() is inner
                c.inc()
            assert tattr.current_stats() is outer
            c.inc()
        assert tattr.current_stats() is None
        assert inner.counters() == outer.counters() == {"test.attr.nested": 1}

    def test_bound_propagates_target_to_pool_thread(self):
        from hyperspace_tpu_torch.utils.workers import io_pool

        s = _stats()
        c = TREG.counter("test.attr.pool")

        def task(n):
            c.inc(n)
            return tattr.current_stats()

        with tattr.scope(s):
            with io_pool(2, "hs-test-attr") as pool:
                seen = list(pool.map(tattr.bound(task), [1, 2, 3]))
        assert all(x is s for x in seen)
        assert s.counters()["test.attr.pool"] == 6

    def test_bound_is_identity_without_target(self):
        def fn():
            pass

        assert tattr.bound(fn) is fn

    def test_phase_context_and_charge_phase(self):
        s = _stats()
        with tattr.scope(s):
            with tattr.phase("io"):
                pass
            tattr.charge_phase("dispatch", 0.25)
        tattr.charge_phase("fetch", 9.0)  # no scope: dropped
        phases = s.phases_s()
        assert phases["io"] >= 0.0 and phases["dispatch"] == pytest.approx(0.25)
        assert "fetch" not in phases
        assert tattr.PHASES == jattr.PHASES
        assert set(phases) <= set(tattr.PHASES)


# ---------------------------------------------------------------------------
# records and the ledger, against the JAX package
# ---------------------------------------------------------------------------


def _charged(pkg: str) -> dict:
    s = _stats(pkg, qid=7, label="q7")
    s.charge_counter("io.bytes_decoded", 1024)
    s.charge_counter("io.rows_decoded", 10)
    s.charge_counter("cache.index_chunk.hits", 3)
    s.charge_counter("cache.kernel.misses", 1)
    s.charge_observation("kernel.dispatch_ms", 2.5)
    s.charge_phase("io", 0.01)
    rec = s.record()
    rec.pop("started_s")
    rec.pop("total_ms")
    return rec


def test_record_equals_the_jax_packages():
    t, j = _charged("torch"), _charged("jax")
    assert t == j
    assert t["cache_hit_ratio"] == pytest.approx(0.75)
    assert t["phases_ms"]["io"] == pytest.approx(10.0)
    assert _stats().record()["cache_hit_ratio"] is None


def _ledger_story(pkg: str, tmp_path) -> dict:
    """The reference's ledger cases, run on one package's classes."""
    attr = ATTR[pkg]
    ctx_cls = (J if pkg == "jax" else T).serve.QueryContext
    reg = (jmetrics if pkg == "jax" else tmetrics).REGISTRY
    out = {}
    names = ("serve.query.records", "serve.query.outcome.done", "serve.query.slow")
    before = {n: reg.counter(n).value for n in names}
    led = attr.QueryStatsLedger(window=8)
    s = led.begin(ctx_cls(label="unit"), queue_wait_s=0.5)
    out["active"] = [r["label"] for r in led.active_records()]
    rec = led.finish(s, "done")
    out["finished"] = (rec["outcome"], rec["queue_wait_ms"], led.active_records(),
                       [r["label"] for r in led.recent_records()])
    out["charged_back"] = [k for k in s.counters() if k.startswith("serve.query.")]
    unrun = led.record_unrun(ctx_cls(label="never-ran"))
    out["unrun"] = (unrun["outcome"], unrun["bytes_read"], unrun["counters"])
    small = attr.QueryStatsLedger(window=2)
    for i in range(5):
        small.finish(small.begin(ctx_cls(label=f"q{i}")), "done")
    out["window"] = ([r["label"] for r in small.recent_records()],
                     small.snapshot()["totals"], small.snapshot()["window"])
    agg = attr.QueryStatsLedger(window=8)
    a, b = agg.begin(ctx_cls()), agg.begin(ctx_cls())
    a.charge_counter("io.chunks", 2)
    b.charge_counter("io.chunks", 3)
    b.charge_counter("cache.kernel.hits", 1)
    agg.finish(a, "done")
    out["aggregate"] = agg.aggregate_counters()
    health = attr.QueryStatsLedger(window=16)
    for outcome in ("done", "done", "failed", "cancelled"):
        health.finish(health.begin(ctx_cls()), outcome)
    d = health.begin(ctx_cls())
    d.charge_counter("device.degrades", 1)
    health.finish(d, "done")
    out["health"] = health.health_window()
    path = str(tmp_path / f"slow-{pkg}.jsonl")
    os.environ["HYPERSPACE_SLOW_QUERY_FILE"] = path
    os.environ["HYPERSPACE_SLOW_QUERY_MS"] = "50"
    try:
        slow_led = attr.QueryStatsLedger(window=8)
        slow_led.finish(slow_led.begin(ctx_cls(label="fast")), "done")
        slow = slow_led.begin(ctx_cls(label="slow"))
        slow.started_s -= 1.0  # as if it ran for a second
        slow_led.finish(slow, "done")
    finally:
        del os.environ["HYPERSPACE_SLOW_QUERY_FILE"], os.environ["HYPERSPACE_SLOW_QUERY_MS"]
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8").read().splitlines()]
    out["slow"] = ([r["label"] for r in lines], lines[0]["total_ms"] >= 50,
                   sorted(lines[0]), slow_led.snapshot()["totals"])
    recs = [{"total_ms": 10.0, "queue_wait_ms": 1.0, "phases_ms": {"io": 4.0, "dispatch": 2.0}},
            {"total_ms": 20.0, "queue_wait_ms": 3.0, "phases_ms": {"io": 8.0}}]
    out["percentiles"] = (attr.phase_percentiles(recs), attr.phase_percentiles([]))
    out["counters"] = {n: reg.counter(n).value - before[n] for n in names}
    return out


def test_ledger_lifecycle_equals_the_jax_packages(tmp_path):
    t, j = _ledger_story("torch", tmp_path), _ledger_story("jax", tmp_path)
    assert t == j
    assert t["finished"] == ("done", 500.0, [], ["unit"])
    assert t["charged_back"] == []
    assert t["unrun"] == ("cancelled", 0, {})
    assert t["window"][0] == ["q3", "q4"] and t["window"][1]["recorded"] == 5
    assert t["aggregate"] == {"io.chunks": 5, "cache.kernel.hits": 1}
    assert t["health"]["window_records"] == 5 and t["health"]["error_rate"] == 0.2
    assert t["slow"][0] == ["slow"] and t["slow"][1]
    assert t["percentiles"][0]["total"] == {"count": 2, "mean_ms": 15.0, "p99_ms": 20.0}


# ---------------------------------------------------------------------------
# served queries: records and conservation
# ---------------------------------------------------------------------------


def _conserved_globals() -> dict:
    return {name: value for name, kind, value in TREG.export()
            if kind == "counter" and name.startswith(CONSERVED)}


def _conserved_ledger(by_tenant: bool = False) -> dict:
    led = tattr.LEDGER
    if not by_tenant:
        return {k: v for k, v in led.aggregate_counters().items() if k.startswith(CONSERVED)}
    out: dict = {}
    for counters in led.aggregate_counters_by_tenant().values():
        for k, v in counters.items():
            if k.startswith(CONSERVED):
                out[k] = out.get(k, 0) + v
    return out


def _assert_conserved(run) -> None:
    """Per-query (and per-tenant) sums of the conserved counters over the
    window ``run()`` serves equal the global deltas."""
    tattr.LEDGER.reset_for_testing()
    g0 = _conserved_globals()
    run()

    def mismatches(by_tenant):
        g1 = _conserved_globals()
        deltas = {k: g1.get(k, 0) - g0.get(k, 0) for k in set(g0) | set(g1)}
        lsum = _conserved_ledger(by_tenant)
        return {k: (deltas.get(k, 0), lsum.get(k, 0)) for k in set(deltas) | set(lsum)
                if deltas.get(k, 0) != lsum.get(k, 0)}

    for by_tenant in (False, True):
        m = mismatches(by_tenant)
        deadline = time.time() + 10
        while m and time.time() < deadline:
            time.sleep(0.1)  # straggler bound tasks may still be landing
            m = mismatches(by_tenant)
        assert m == {}


def _write_multifile(root, n_files=6, rows=2500, seed=3) -> None:
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        n = rows + i * 97
        p = os.path.join(str(root), "t", f"part-{i}.parquet")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        pq.write_table(pa.table({"k": rng.integers(0, 40, n), "x": rng.uniform(0, 100, n),
                                 "q": rng.integers(1, 50, n)}), p)


def test_conservation_over_the_multifile_fixture(tmp_path, monkeypatch):
    _write_multifile(tmp_path)
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.01")
    session = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")

    def q():
        return session.read.parquet(os.path.join(str(tmp_path), "t")).filter(
            TX.col("q") > 10).agg(TX.Sum(TX.col("x")).alias("sx"),
                                  TX.Count(TX.lit(1)).alias("n"))

    q().collect()  # warm the caches outside the window

    def run():
        sched = tserve.QueryScheduler(max_concurrent=4, queue_depth=64)
        try:
            hs = [sched.submit(q().collect, label=f"c{i}", tenant=f"t{i % 2}")
                  for i in range(8)]
            for h in hs:
                h.result(60)
        finally:
            sched.shutdown()

    _assert_conserved(run)
    mine = [r for r in tattr.LEDGER.recent_records() if r["label"].startswith("c")]
    assert len(mine) == 8 and all(r["outcome"] == "done" for r in mine)
    assert any(r["bytes_read"] > 0 for r in mine)
    assert any(r["phases_ms"]["io"] > 0 for r in mine)
    assert all(r["phases_ms"]["plan"] > 0 for r in mine)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_attribution"))
    jtpch.generate_tpch(root, rows_lineitem=2000, seed=7)
    js = J.HyperspaceSession(warehouse_dir=root)
    jtpch.tpch_indexes(js, J.Hyperspace(js), root)
    js.enable_hyperspace()
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    return root, js, ts


def _serve_tpch(pkg: str, golden) -> list:
    root, js, ts = golden
    mod, session, tpch = (J, js, jtpch) if pkg == "jax" else (T, ts, ttpch)
    sched = mod.serve.QueryScheduler(max_concurrent=2, queue_depth=16)
    try:
        hs = [sched.submit_query(tpch.TPCH_QUERIES[q](session, root), label=q, tenant="tpch")
              for q in SERVED_TPCH]
        for h in hs:
            h.result(120)
    finally:
        sched.shutdown()
    recs = {r["label"]: r for r in mod.telemetry.attribution.LEDGER.recent_records()
            if r["label"] in SERVED_TPCH}
    return [recs[q] for q in SERVED_TPCH]


def test_served_tpch_records_have_the_jax_packages_keys(golden):
    j = _serve_tpch("jax", golden)
    t = _serve_tpch("torch", golden)
    for rj, rt in zip(j, t):
        assert sorted(rt) == sorted(rj), rt["label"]
        assert sorted(rt["phases_ms"]) == sorted(rj["phases_ms"])
        assert (rt["outcome"], rt["tenant"]) == (rj["outcome"], rj["tenant"]) == ("done",
                                                                                  "tpch")
        assert rt["approx"] is None and rt["error"] is None
        # the same counters move for the scan-side families
        scan = ("pruning.", "rules.", "io.rows_decoded")
        assert {k for k in rt["counters"] if k.startswith(scan)} == {
            k for k in rj["counters"] if k.startswith(scan)}, rt["label"]


def test_conservation_over_served_tpch(golden):
    root, _js, ts = golden
    for q in SERVED_TPCH:  # warm
        ttpch.TPCH_QUERIES[q](ts, root).collect()

    def run():
        sched = tserve.QueryScheduler(max_concurrent=4, queue_depth=32)
        try:
            hs = [sched.submit_query(ttpch.TPCH_QUERIES[q](ts, root), label=q,
                                     tenant="a" if i % 2 else "b")
                  for i, q in enumerate(SERVED_TPCH * 2)]
            for h in hs:
                h.result(120)
        finally:
            sched.shutdown()

    _assert_conserved(run)


def test_queued_cancel_lands_in_the_query_log():
    gate = threading.Event()
    sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=8)
    try:
        blocker = sched.submit(lambda: gate.wait(30), label="blocker")
        victim = sched.submit(lambda: None, label="queued-victim")
        victim.cancel()
        with pytest.raises(tserve.QueryCancelledError):
            victim.result(10)
        gate.set()
        blocker.result(30)
        sched.drain(timeout=30)
    finally:
        gate.set()
        sched.shutdown()
    rec = next(r for r in reversed(tattr.LEDGER.recent_records())
               if r["label"] == "queued-victim")
    assert rec["outcome"] == "cancelled" and rec["counters"] == {}


def test_direct_collect_opens_its_own_record(golden):
    root, _js, ts = golden
    tattr.LEDGER.reset_for_testing()
    ttpch.TPCH_QUERIES["q6"](ts, root).collect()
    (rec,) = tattr.LEDGER.recent_records()
    assert rec["label"] == "collect:Aggregate" and rec["outcome"] == "done"
    assert rec["phases_ms"]["plan"] > 0


def test_query_log_string_renders():
    from hyperspace_tpu_torch.analysis.explain import query_log_string

    tattr.LEDGER.reset_for_testing()
    assert query_log_string().splitlines()[1] == "  (no serving queries recorded)"
    sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=8)
    try:
        sched.submit(lambda: 1, label="render-me").result(30)
    finally:
        sched.shutdown()
    out = query_log_string()
    assert out.startswith("Query log (per-query attribution):")
    assert "render-me" in out


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _prom_violations(text: str) -> list:
    """Cumulative buckets and +Inf == _count for every histogram family."""
    buckets, counts, out = {}, {}, []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        series, raw = ln.rsplit(" ", 1)
        float(raw)
        if '{le="' in series:
            name = series.split("{", 1)[0]
            buckets.setdefault(name, []).append(
                (series.split('le="', 1)[1].split('"', 1)[0], float(raw)))
        elif series.endswith("_count"):
            counts[series[: -len("_count")]] = float(raw)
    for name, bs in buckets.items():
        cum = [v for _le, v in bs]
        if any(b < a for a, b in zip(cum, cum[1:])):
            out.append(f"{name}: not cumulative")
        if not bs or bs[-1][0] != "+Inf" or counts.get(name[: -len("_bucket")]) != bs[-1][1]:
            out.append(f"{name}: +Inf != _count")
    return out


class TestExporter:
    def test_disabled_by_default_no_thread_no_socket(self, monkeypatch):
        monkeypatch.delenv("HYPERSPACE_METRICS_PORT", raising=False)
        monkeypatch.delenv("HYPERSPACE_SNAPSHOT_FILE", raising=False)
        texp.maybe_start_from_env()
        assert texp.get_exporter() is None
        assert texp.start_exporter() is None
        assert not [t for t in threading.enumerate() if t.name.startswith("hs-metrics")]

    def test_bind_serve_stop_release(self):
        exp = texp.start_exporter(port=0)
        assert exp is not None and exp.port > 0 and exp.host == "127.0.0.1"
        assert TREG.gauge("exporter.up").value == 1
        code, body = _get(exp.url + "/metrics")
        assert code == 200 and "hyperspace_" in body
        assert _prom_violations(body) == []
        port = exp.port
        texp.stop_exporter()
        assert TREG.gauge("exporter.up").value == 0
        s = socket.socket()
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))  # the port is released
        finally:
            s.close()
        texp.stop_exporter()  # idempotent

    def test_start_is_singleton(self):
        assert texp.start_exporter(port=0) is texp.start_exporter(port=0)

    def test_scheduler_starts_the_exporter_from_the_knob(self, monkeypatch):
        monkeypatch.setenv("HYPERSPACE_METRICS_PORT", "0")
        sched = tserve.QueryScheduler(max_concurrent=1)
        try:
            exp = texp.get_exporter()
            assert exp is not None
            code, body = _get(exp.url + "/healthz")
            assert code == 200 and json.loads(body)["status"] == "ok"
        finally:
            sched.shutdown()

    def test_snapshot_and_health_endpoints(self):
        exp = texp.start_exporter(port=0)
        code, body = _get(exp.url + "/snapshot")
        assert code == 200
        snap = json.loads(body)
        want = set(jexp.snapshot_dict()) - {"breaker", "approx"}
        assert set(snap) == want
        assert set(snap["queries"]) >= {"window", "totals", "active", "recent"}
        code, body = _get(exp.url + "/healthz")
        payload = json.loads(body)
        assert code == 200 and payload["status"] == "ok" and payload["reasons"] == []
        assert "breaker" not in payload
        jpay, _code = jexp.health_dict()
        assert sorted(payload) == sorted(set(jpay) - {"breaker"})
        assert _get(exp.url + "/nope")[0] == 404
        assert TREG.counter("exporter.scrapes").value > 0

    def test_concurrent_scrapes_stay_consistent(self):
        exp = texp.start_exporter(port=0)
        stop = threading.Event()

        def writer():
            h = TREG.histogram("scrape.hammer_ms")
            i = 0
            while not stop.is_set():
                h.observe(i % 750)
                TREG.counter("scrape.hammer").inc()
                i += 1

        t = threading.Thread(target=writer)
        t.start()
        try:
            for _ in range(25):
                code, body = _get(exp.url + "/metrics")
                assert code == 200 and _prom_violations(body) == []
        finally:
            stop.set()
            t.join()

    def test_prometheus_text_equals_the_jax_packages(self, monkeypatch):
        """The same registry contents render the same exposition in both
        packages, and the port's carries no breaker series."""
        regs = {"jax": jmetrics.MetricsRegistry(), "torch": tmetrics.MetricsRegistry()}
        for reg in regs.values():
            reg.counter("io.chunks").inc(7)
            reg.counter("serve.budget.stalls").inc(2)
            reg.gauge("serve.budget_bytes").set(4096)
            reg.gauge("cache.device.bytes").set(12.5)
            h = reg.histogram("serve.query.total_ms")
            for v in (0.05, 3.0, 42.0, 9000.0):
                h.observe(v)
            reg.histogram("kernel.dispatch_ms", (1, 10)).observe(5.0)
        monkeypatch.setattr(jmetrics, "REGISTRY", regs["jax"])
        monkeypatch.setattr(tmetrics, "REGISTRY", regs["torch"])
        _reset_planes()
        t, j = texp.prometheus_text(), jexp.prometheus_text()
        assert t == j
        assert "breaker" not in t
        assert _prom_violations(t) == []

    def test_snapshot_sink_writes_and_final_flush(self, tmp_path):
        path = str(tmp_path / "snaps.jsonl")
        assert texp.start_snapshot_sink(path, interval_s=0.05) is not None
        time.sleep(0.2)
        texp.stop_snapshot_sink()  # also writes one final snapshot
        lines = [json.loads(ln) for ln in open(path, encoding="utf-8").read().splitlines()]
        assert len(lines) >= 2
        assert all(set(s) >= {"ts", "metrics", "serving", "queries"} for s in lines)
        assert not any("breaker" in s for s in lines)

    def test_sink_disabled_without_knob(self, monkeypatch):
        monkeypatch.delenv("HYPERSPACE_SNAPSHOT_FILE", raising=False)
        assert texp.start_snapshot_sink() is None
