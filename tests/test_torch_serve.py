"""Concurrent serving, the port against the JAX package on the same inputs
(the counterpart of tests/test_serve.py ``TestQueryContext``,
``TestScheduler``, ``TestServingIntegration`` and ``TestServeState``).

- The query context: ``QueryCancelledError`` is a BaseException,
  ``check_cancelled`` is a no-op outside serving and raises inside a
  cancelled scope, scopes nest.
- The scheduler: a submit's result round trip, the ``max_concurrent``
  bound, the dispatch order under priorities (the same sequence as the
  JAX scheduler's for the same submissions), the bounded run queue, a
  queued cancel, a submit after shutdown, a failed query's re-raise, the
  queue-wait histogram.
- Serving over the reference's multi-file fixture (six parquet files,
  numpy seed 3, ``HYPERSPACE_STREAM_CHUNK_MB=0.01``, four IO threads): the
  served results equal the direct collect bit for bit and the JAX
  package's served results within the f32 tolerance of the device tiers;
  a running query cancelled mid-stream releases every budget byte; a
  stalled low-priority stream never blocks a new query's first chunk; an
  injected dispatch fault fails its own query (the port has no breaker)
  and leaves the neighbours' results exact.
- The serving state: its idle shape, the profile's serving block, active
  and queued entries, the default scheduler.
- The device column cache's lost build race: two threads build one key at
  once; both get the resident object and the bytes count once.
- The smoke's serve phase, rehearsed on the CPU over a 200k-row TPC-H
  lake with the reference's index set.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu import serve as jserve
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import serve as tserve
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils import faults as TF

REL = 1e-4  # f32 device-tier sums, as tests/test_torch_pipeline.py holds them
PKGS = {"jax": {"mod": J, "C": JC, "X": JX, "serve": jserve},
        "torch": {"mod": T, "C": TC, "X": TX, "serve": tserve}}


def _reset_planes() -> None:
    for p in PKGS.values():
        mod = p["mod"]
        mod.serve.TENANTS.reset_for_testing()
        mod.serve.COST_MODEL.reset_for_testing()
        mod.telemetry.attribution.LEDGER.reset_for_testing()
        mod.telemetry.workload.reset_for_testing()
        p["serve"].reset_global_budget()


@pytest.fixture(scope="module", autouse=True)
def _empty_both_planes():
    yield
    _reset_planes()


@pytest.fixture(autouse=True)
def _pristine_serving_state():
    """The default budget ledger and the fault plan restored around every
    test (several tests shrink the budget or arm a fault)."""
    yield
    TF.disarm()
    tserve.reset_global_budget()
    jserve.reset_global_budget()


def _bits(d: dict) -> str:
    def one(x):
        x = x.item() if hasattr(x, "item") else x
        return x.hex() if isinstance(x, float) else x

    return repr({k: [one(x) for x in v] for k, v in d.items()})


def _write_multifile(root, n_files=6, rows=2500, seed=3) -> list:
    """The reference's fixture: six parquet files of integer keys and
    float values."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        n = rows + i * 97
        data = {"k": rng.integers(0, 40, n), "x": rng.uniform(0, 100, n),
                "q": rng.integers(1, 50, n)}
        p = os.path.join(str(root), "t", f"part-{i}.parquet")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        pq.write_table(pa.table(data), p)
        paths.append(p)
    return paths


def _session(pkg: str, root):
    mod, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
    if pkg == "torch":
        return mod.HyperspaceSession(str(root / "wh-torch"), device="cpu")
    s = mod.HyperspaceSession(warehouse_dir=str(root / "wh-jax"))
    s.set_conf(C.EXEC_TPU_ENABLED, True)
    return s


def _query(pkg: str, session, root, int_only: bool = False):
    X = PKGS[pkg]["X"]
    df = session.read.parquet(os.path.join(str(root), "t")).filter(X.col("q") > 10)
    if int_only:
        return df.agg(X.Sum(X.col("q")).alias("sq"), X.Count(X.lit(1)).alias("n"))
    return df.agg(X.Sum(X.col("x")).alias("sx"), X.Count(X.lit(1)).alias("n"))


@pytest.fixture()
def multifile(tmp_path, monkeypatch):
    _write_multifile(tmp_path)
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.01")
    return tmp_path


# ---------------------------------------------------------------------------
# the query context
# ---------------------------------------------------------------------------


class TestQueryContext:
    def test_cancelled_error_is_base_exception(self):
        assert issubclass(tserve.QueryCancelledError, BaseException)
        assert not issubclass(tserve.QueryCancelledError, Exception)

    def test_check_cancelled_outside_serving_is_noop(self):
        tserve.check_cancelled()
        assert tserve.current_query() is None

    def test_check_cancelled_raises_inside_cancelled_scope(self):
        ctx = tserve.QueryContext(label="x")
        with tserve.query_scope(ctx):
            tserve.check_cancelled()
            ctx.cancel()
            with pytest.raises(tserve.QueryCancelledError):
                tserve.check_cancelled()

    def test_current_query_scoping(self):
        outer, inner = tserve.QueryContext(label="o"), tserve.QueryContext(label="i")
        with tserve.query_scope(outer):
            assert tserve.current_query() is outer
            with tserve.query_scope(inner):
                assert tserve.current_query() is inner
            assert tserve.current_query() is outer
        assert tserve.current_query() is None
        assert inner.query_id > outer.query_id


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


class TestScheduler:
    def test_submit_result_roundtrip(self):
        sched = tserve.QueryScheduler(max_concurrent=2, queue_depth=4)
        try:
            h = sched.submit(lambda: 41 + 1, label="answer")
            assert h.result(30) == 42
            assert h.status == "done" and h.done()
        finally:
            sched.shutdown()

    def test_max_concurrent_enforced(self):
        sched = tserve.QueryScheduler(max_concurrent=2, queue_depth=16)
        lock, gate = threading.Lock(), threading.Event()
        state = {"now": 0, "peak": 0}

        def work():
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            gate.wait(5)
            with lock:
                state["now"] -= 1

        try:
            hs = [sched.submit(work, label=f"w{i}") for i in range(6)]
            time.sleep(0.2)
            assert len(sched.state()["active"]) == 2
            gate.set()
            for h in hs:
                h.result(30)
            assert state["peak"] == 2
        finally:
            gate.set()
            sched.shutdown()

    def test_priority_order_equals_the_jax_scheduler(self):
        """The same submissions behind a blocker run in the same order in
        both packages: highest priority first, FIFO within a priority."""
        subs = [("a", 0), ("b", 3), ("c", 1), ("d", 3), ("e", 0), ("f", 7), ("g", 1)]
        orders = {}
        for pkg in PKGS:
            serve = PKGS[pkg]["serve"]
            sched = serve.QueryScheduler(max_concurrent=1, queue_depth=16)
            order, gate = [], threading.Event()
            try:
                blocker = sched.submit(lambda: gate.wait(30), label="blocker")
                hs = [sched.submit(lambda t=t: order.append(t), priority=p, label=t)
                      for t, p in subs]
                gate.set()
                blocker.result(30)
                for h in hs:
                    h.result(30)
            finally:
                sched.shutdown()
            orders[pkg] = order
        assert orders["torch"] == orders["jax"] == ["f", "b", "d", "c", "g", "a", "e"]

    def test_queue_depth_rejection(self):
        sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=2)
        gate = threading.Event()
        before = TREG.counter("serve.rejected").value
        try:
            sched.submit(lambda: gate.wait(30), label="running")
            time.sleep(0.05)
            sched.submit(lambda: 1, label="q1")
            sched.submit(lambda: 2, label="q2")
            with pytest.raises(tserve.AdmissionRejected):
                sched.submit(lambda: 3, label="q3")
            assert TREG.counter("serve.rejected").value == before + 1
            assert sched.state()["totals"]["rejected"] == 1
        finally:
            gate.set()
            sched.shutdown()

    def test_cancel_queued_resolves_immediately(self):
        sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=4)
        gate = threading.Event()
        try:
            sched.submit(lambda: gate.wait(30), label="running")
            h = sched.submit(lambda: 1, label="victim")
            h.cancel()
            with pytest.raises(tserve.QueryCancelledError):
                h.result(1)
            assert h.status == "cancelled"
        finally:
            gate.set()
            sched.shutdown()

    def test_submit_after_shutdown_raises(self):
        sched = tserve.QueryScheduler(max_concurrent=1)
        sched.shutdown()
        with pytest.raises(tserve.SchedulerShutdown):
            sched.submit(lambda: 1)

    def test_failed_query_reraises_on_result(self):
        sched = tserve.QueryScheduler(max_concurrent=1)

        def boom():
            raise ValueError("kaput")

        try:
            h = sched.submit(boom, label="boom")
            with pytest.raises(ValueError, match="kaput"):
                h.result(30)
            assert h.status == "failed"
            assert sched.state()["totals"]["failed"] == 1
        finally:
            sched.shutdown()

    def test_queue_wait_histogram_recorded(self):
        before = TREG.histogram("serve.queue_wait_ms").value.get("count", 0)
        sched = tserve.QueryScheduler(max_concurrent=1)
        try:
            for i in range(3):
                sched.submit(lambda: None, label=f"h{i}").result(30)
        finally:
            sched.shutdown()
        assert TREG.histogram("serve.queue_wait_ms").value["count"] == before + 3


# ---------------------------------------------------------------------------
# serving over the multi-file fixture
# ---------------------------------------------------------------------------


class TestServingIntegration:
    def test_served_results_equal_direct_and_the_jax_package(self, multifile):
        served = {}
        for pkg in PKGS:
            session = _session(pkg, multifile)
            PKGS[pkg]["serve"].reset_global_budget()
            direct = _bits(_query(pkg, session, multifile).collect().to_pydict())
            sched = PKGS[pkg]["serve"].QueryScheduler(max_concurrent=4, queue_depth=64)
            try:
                hs = [sched.submit_query(_query(pkg, session, multifile), label=f"c{i}")
                      for i in range(8)]
                outs = [h.result(60).to_pydict() for h in hs]
            finally:
                sched.shutdown()
            assert all(_bits(o) == direct for o in outs), pkg
            served[pkg] = outs[0]
        t, j = served["torch"], served["jax"]
        assert list(t) == list(j)
        assert [int(v) for v in t["n"]] == [int(v) for v in j["n"]]
        assert float(t["sx"][0]) == pytest.approx(float(j["sx"][0]), rel=REL)

    def test_cancel_running_releases_budget(self, multifile):
        """A cancelled mid-stream query unwinds at the next chunk boundary,
        raising QueryCancelledError through result() and returning every
        budget reservation and read-ahead future."""
        paths = sorted(os.path.join(str(multifile), "t", f)
                       for f in os.listdir(os.path.join(str(multifile), "t")))
        acct = tserve.reset_global_budget()
        started, cancelled = threading.Event(), threading.Event()

        def slow_stream():
            out = []
            for chunk in cio.iter_chunks(paths, ["k", "x"]):
                out.append(chunk.batch)
                started.set()
                cancelled.wait(10)  # hold mid-stream until the cancel lands
            return out

        sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=4)
        try:
            h = sched.submit(slow_stream, label="victim")
            assert started.wait(30)
            assert acct.held_bytes() > 0
            h.cancel()
            cancelled.set()
            with pytest.raises(tserve.QueryCancelledError):
                h.result(30)
            assert h.status == "cancelled"
            assert sched.state()["totals"]["cancelled"] == 1
            assert acct.held_bytes() == 0 and acct.check_consistency()
            assert acct.state()["streams"] == []
        finally:
            sched.shutdown()

    def test_stalled_low_priority_never_blocks_high_admission(self, multifile, monkeypatch):
        session = _session("torch", multifile)
        expected = _bits(_query("torch", session, multifile).collect().to_pydict())
        monkeypatch.setenv("HYPERSPACE_GLOBAL_BUDGET_MB", "0.0001")
        acct = tserve.reset_global_budget()
        hog = acct.stream("join", query="hog")
        assert hog.try_reserve(10**6)  # the ledger saturated by a low-priority hog
        sched = tserve.QueryScheduler(max_concurrent=2, queue_depth=8)
        try:
            h = sched.submit_query(_query("torch", session, multifile), priority=10,
                                   label="high")
            assert _bits(h.result(60).to_pydict()) == expected
        finally:
            sched.shutdown()
            hog.close()
        assert acct.held_bytes() == 0

    def test_injected_dispatch_fault_spares_the_neighbours(self, multifile):
        """An armed dispatch fault fails one query's device path; the port
        has no breaker, so that query fails with the injected error stored
        on its handle, and every neighbour's result stays exact."""
        session = _session("torch", multifile)
        expected = _bits(_query("torch", session, multifile, True).collect().to_pydict())
        TF.arm("device.dispatch:ioerror:n=1")
        sched = tserve.QueryScheduler(max_concurrent=4, queue_depth=32)
        try:
            hs = [sched.submit_query(_query("torch", session, multifile, True), label=f"c{i}")
                  for i in range(6)]
            sched.drain(60)
        finally:
            sched.shutdown()
            TF.disarm()
        failed = [h for h in hs if h.status == "failed"]
        assert len(failed) == 1
        with pytest.raises(TF.InjectedIOError):
            failed[0].result(1)
        for h in hs:
            if h.status != "failed":
                assert h.status == "done"
                assert _bits(h.result(1).to_pydict()) == expected


# ---------------------------------------------------------------------------
# the serving state
# ---------------------------------------------------------------------------


class TestServeState:
    def test_serve_state_idle_shape_matches(self):
        tserve.reset_scheduler()
        jserve.reset_scheduler()
        t, j = tserve.serve_state(), jserve.serve_state()
        assert t["budget"]["limit_bytes"] > 0
        assert sorted(t) == sorted(j)
        assert sorted(t["budget"]) == sorted(j["budget"])
        # one card: the port's device block has no per-device rollup
        assert sorted(t["device_budget"]) == sorted(j["device_budget"])

    def test_serving_state_string_renders(self):
        from hyperspace_tpu_torch.analysis.explain import serving_state_string

        s = serving_state_string()
        assert s.startswith("Serving (scheduler + global budget):")
        assert "budget:" in s and "device budget:" in s

    def test_scheduler_state_reports_active_and_queued(self):
        sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=8)
        gate = threading.Event()
        try:
            sched.submit(lambda: gate.wait(30), label="runner")
            sched.submit(lambda: 2, label="waiter", priority=3)
            deadline = time.time() + 5
            while time.time() < deadline:
                st = sched.state()
                if st["active"] and st["queued"]:
                    break
                time.sleep(0.01)
            assert [a["label"] for a in st["active"]] == ["runner"]
            assert [w["label"] for w in st["queued"]] == ["waiter"]
            assert st["queued"][0]["priority"] == 3
            gate.set()
            assert sched.drain(30)
        finally:
            gate.set()
            sched.shutdown()

    def test_default_scheduler_roundtrip(self):
        tserve.reset_scheduler()
        try:
            assert tserve.submit(lambda: 7, label="default").result(30) == 7
            assert tserve.serve_state()["totals"]["done"] >= 1
        finally:
            tserve.reset_scheduler()
        assert tserve.serve_state()["max_concurrent"] is None


# ---------------------------------------------------------------------------
# the device column cache's build race
# ---------------------------------------------------------------------------


def test_device_cache_lost_build_race_serves_the_resident_copy():
    """Two threads miss on one key at once and both build (the build runs
    outside the lock); the second to store gets the first's object, and
    the cache counts its bytes once."""
    from hyperspace_tpu_torch.utils.device_cache import DeviceColumnCache

    cache = DeviceColumnCache(1 << 20, "host_derived")
    src = np.arange(100, dtype=np.int64)
    barrier = threading.Barrier(2)
    got = [None, None]

    def build():
        barrier.wait(10)  # both builds are in flight before either stores
        return np.ones(1000, dtype=np.float64)

    def worker(i):
        got[i] = cache.get_or_put([src], "tag", build)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert got[0] is got[1]
    assert cache.check_consistency()
    assert cache.resident_bytes == 8000
    assert cache.misses == 2
    assert cache.get_or_put([src], "tag", build) is got[0]  # a hit now


# ---------------------------------------------------------------------------
# the smoke's serve phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_smoke_serve_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.serve_phase over a 200k-row lake with tpch_indexes, with
    the device tier on the CPU and a kernels shim whose launches are the
    plain versions' calls: every check of the phase holds (served results
    bit for bit the direct warm ones, the mid-stream cancel, conservation,
    the three endpoints, the journal, index_report), kernels 1-3's plain
    versions run in its window, and the knobs it sets are restored."""
    import importlib.util
    import types

    import torch

    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.ops import cuda_kernels

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_serve_rehearsal",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = tmp_path / "data"
    monkeypatch.setattr(smoke, "DATA_DIR", str(data))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    for knob in smoke.SERVE_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    # one chunk group per index file and four IO threads, so that q18's
    # scan of li_orderkey streams (at SF10 its files make several groups)
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    lake, warehouse = str(data / "lake"), str(data / "wh")
    tpch.generate_tpch(lake, rows_lineitem=200_000, seed=42)
    session = T.HyperspaceSession(warehouse)
    tpch.tpch_indexes(session, T.Hyperspace(session), lake)
    session.enable_hyperspace()
    fns = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES}
    warm = {q: smoke._result_form(q, fns[q](session, lake).collect())
            for q in smoke.SERVE_QUERIES}
    out = smoke.serve_phase(shim, {"lake": lake, "warehouse": warehouse,
                                   "warm_results": warm}, session, "cpu rehearsal")
    assert all(k not in os.environ for k in smoke.SERVE_KNOBS)
    assert sorted(out["tenants"]) == ["batch", "dash"]
    assert sum(t["queries"] for t in out["tenants"].values()) == smoke.SERVE_SUBMISSIONS
    assert out["cancel"]["held_after"] == {"read_ahead": 0, "device": 0, "pins": 0}
    assert out["journal_records"] == smoke.SERVE_SUBMISSIONS + 1
    assert out["health"] == "ok"
    assert all(out["launches"][k] > 0 for k in smoke.ON_PATH)
    assert out["index_report"]["li_shipdate_z"]["benefit_s"] > 0
    assert out["index_report"]["li_orderkey"]["benefit_s"] > 0
    assert T.telemetry.exporter.get_exporter() is None
