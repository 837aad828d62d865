"""The port's telemetry core (spans, the metrics registry, the RpcMeter and
the action events) held against the JAX package, and the
``HYPERSPACE_IO_THREADS`` repair.

- Over the golden TPC-H fixture (2,000 lineitem rows, seed 7,
  ``tpch_indexes`` plus ``li_ds_minmax``, built by the JAX package), with
  both device tiers on (the JAX package on its CPU backend, the port's
  plain kernel versions), each TPC-H query runs twice in each package:
  - the multiset of span names of each run equals the JAX package's, with
    the differences named in ``_COLD_SPAN_EXCEPTIONS`` on the first run;
  - the counters under ``_COMPARED_PREFIXES`` move by the same amounts;
  - the meter's dispatch and fetch counts are equal.
  ``cache.device.*`` is left out of the comparison by decision: the port
  counts the device entries it holds, and it holds no padded-mask entry
  (it fills those masks on the device), so its counts differ from the JAX
  package's by the mask lookups (utils/device_cache.py).
- The ``pruning.`` deltas of a point lookup, an absent key and a key
  range over ``li_orderkey`` equal the JAX package's under
  ``HYPERSPACE_PRUNE`` 1 and verify (``pruning.verified`` included).
- With tracing off every span is one shared no-op object and the hooks
  allocate nothing; ``HYPERSPACE_TRACE=1`` turns tracing on at import in a
  fresh interpreter, with ``HYPERSPACE_TRACE_FILE`` as its JSONL sink; a
  JSONL trace reads back to the tree it was written from; the CRUD events
  of create, delete, restore, refresh, optimize and vacuum have the JAX
  package's classes, messages and index names, through a logger named by
  the JAX package's class path.
- ``HYPERSPACE_IO_THREADS=1`` runs the work of each of the five IO pools
  the knob governs (the bucketed scan aggregate, the per-bucket join, the
  barrier pair loader, the bucket compaction and the bucket writer) on one
  thread, and a width of 4 spreads it.
"""

import collections
import os
import subprocess
import sys
import threading
import time
import tracemalloc

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry import trace as jtrace
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu.utils.rpc_meter import METER as JMETER
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.telemetry import plan_stats as tps
from hyperspace_tpu_torch.telemetry import trace as ttrace
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils.rpc_meter import METER as TMETER

_COMPARED_PREFIXES = ("rules.", "pruning.", "dataskipping.", "io.", "join.", "pipeline.",
                      "cache.index_chunk.", "cache.source_col.")

# span names whose counts may differ on a query's first run, and why
_COLD_SPAN_EXCEPTIONS = {
    "upload": "the port's fused join uploads each bucket pair's columns where the JAX "
              "package stacks a wave into one upload, and the JAX package's concat "
              "route ships its group ids unmetered",
    "compile": "the JAX package's kernel caches are process-wide, the port's belong to "
               "the session, so which first run builds depends on what ran before",
}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger; the
    module empties it when it is done."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from hyperspace_tpu.models.dataskipping import DataSkippingIndexConfig, MinMaxSketch

    root = str(tmp_path_factory.mktemp("tpch_telemetry"))
    jtpch.generate_tpch(root, rows_lineitem=2000, seed=7)
    js = J.HyperspaceSession(warehouse_dir=root)
    hs = J.Hyperspace(js)
    jtpch.tpch_indexes(js, hs, root)
    hs.create_index(js.read.parquet(os.path.join(root, "lineitem")),
                    DataSkippingIndexConfig("li_ds_minmax", [MinMaxSketch("l_shipdate")]))
    js.enable_hyperspace()
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    return root, js, ts


def _names(cap) -> collections.Counter:
    out = collections.Counter()

    def walk(s):
        out[s.name] += 1
        for c in s.children:
            walk(c)

    for r in cap.roots:
        walk(r)
    return out


def _counters(reg) -> dict:
    return {name: v for name, kind, v in reg.export()
            if kind == "counter" and name.startswith(_COMPARED_PREFIXES)}


def _traced(trace, reg, meter, df):
    before = _counters(reg)
    with meter.measure() as m, trace.capture() as cap:
        df.collect()
    after = _counters(reg)
    moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return _names(cap), moved, m.delta


def _cold_key(name: str) -> str:
    return name.split(":")[0]


@pytest.mark.parametrize("q", sorted(ttpch.TPCH_QUERIES))
def test_spans_counters_and_meter_equal_the_jax_packages(golden, q):
    root, js, ts = golden
    for run in ("first", "warm"):
        jn, jc, jm = _traced(jtrace, JREG, JMETER, jtpch.TPCH_QUERIES[q](js, root))
        tn, tc, tm = _traced(ttrace, TREG, TMETER, ttpch.TPCH_QUERIES[q](ts, root))
        if run == "first":
            jn = {k: v for k, v in jn.items() if _cold_key(k) not in _COLD_SPAN_EXCEPTIONS}
            tn = {k: v for k, v in tn.items() if _cold_key(k) not in _COLD_SPAN_EXCEPTIONS}
        assert dict(tn) == dict(jn), run
        assert tc == jc, run
        assert (tm["dispatches"], tm["fetches"]) == (jm["dispatches"], jm["fetches"]), run
        assert tn["query"] == 1 and tn["plan"] == 1 and tn["rule:ApplyHyperspace"] == 1
    # warm, the uploads are the JAX package's too (a warm q10 re-stacks its
    # probe keys in both)
    assert tm["uploads"] == jm["uploads"]


def _lookups(X, root: str, key: int) -> dict:
    """tests/test_pruning.py's verify-mode shape over the golden lineitem:
    a filter the li_orderkey index prunes, then a projection."""
    c = X.col

    def read(s, cond):
        return s.read.parquet(os.path.join(root, "lineitem")).filter(cond).select(
            "l_orderkey", "l_quantity")

    return {
        "point": lambda s: read(s, c("l_orderkey") == key),
        "absent": lambda s: read(s, c("l_orderkey") == -1000),
        "range": lambda s: read(s, (c("l_orderkey") >= key) & (c("l_orderkey") < key + 600)),
    }


@pytest.mark.parametrize("mode", ["1", "verify"])
@pytest.mark.parametrize("q", ["point", "absent", "range"])
def test_pruning_counters_equal_the_jax_packages_in_each_prune_mode(golden, q, mode,
                                                                    monkeypatch):
    """The ``pruning.`` deltas of a pruned lookup are the JAX package's under
    ``HYPERSPACE_PRUNE`` 1 and verify; a verify-mode point lookup counts
    ``pruning.verified`` once in both."""
    root, js, ts = golden
    monkeypatch.setenv("HYPERSPACE_PRUNE", mode)
    key = ttpch.first_orderkey(root)
    moved = {}
    for label, X, s, reg in (("jax", JX, js, JREG), ("torch", TX, ts, TREG)):
        before = _counters(reg)
        rows = _lookups(X, root, key)[q](s).to_pydict()
        after = _counters(reg)
        moved[label] = ({k: v - before.get(k, 0) for k, v in after.items()
                         if k.startswith("pruning.") and v != before.get(k, 0)}, rows)
    assert moved["torch"] == moved["jax"]
    counts, rows = moved["torch"]
    assert counts["pruning.files_kept"] < counts["pruning.files_total"] or q == "range"
    if q == "point":
        assert rows["l_orderkey"] and set(rows["l_orderkey"]) == {key}
        assert counts.get("pruning.verified", 0) == (1 if mode == "verify" else 0)


def test_traced_runs_give_the_plain_runs_bits_and_kernel_calls(golden):
    from hyperspace_tpu_torch.ops import cuda_kernels as K

    root, _js, ts = golden
    for q in sorted(ttpch.TPCH_QUERIES) + ["q6_count", "q1_sums"]:
        fn = ttpch.TPCH_QUERIES.get(q) or ttpch.QUERIES[q]
        fn(ts, root).collect()  # warm
        before = dict(K.PLAIN_CALLS)
        plain = fn(ts, root).collect().to_pydict()
        plain_calls = {k: K.PLAIN_CALLS[k] - before[k] for k in before}
        before = dict(K.PLAIN_CALLS)
        with ttrace.capture():
            traced = fn(ts, root).collect().to_pydict()
        assert {k: K.PLAIN_CALLS[k] - before[k] for k in before} == plain_calls, q
        assert repr(traced) == repr(plain), q


def test_profile_renders_the_span_tree_and_metrics(golden):
    root, _js, ts = golden
    out = T.Hyperspace(ts).profile(ttpch.TPCH_QUERIES["q6"](ts, root))
    for part in ("Query profile (spans + metrics):", "query", "plan", "rule:ApplyHyperspace",
                 "exec:Aggregate", "kernel:fused_agg", "fetch", "metrics:",
                 "Estimator accuracy (process-wide):"):
        assert part in out, part
    assert "breaker" not in out


# ---------------------------------------------------------------------------
# the disabled path, the environment switch, the JSONL sink
# ---------------------------------------------------------------------------


def test_disabled_path_shares_one_noop_span_and_allocates_nothing():
    assert not ttrace.enabled()
    assert ttrace.span("anything", a=1) is ttrace.span("else") is ttrace.NOOP_SPAN
    assert ttrace.current_span() is None and tps.current() is None
    files = {ttrace.__file__, tps.__file__}

    def hooks():
        for _ in range(2000):
            with ttrace.span("kernel:fused_agg", rows=1) as sp:
                sp.set_attr("k", 1)
                ttrace.add_attr("nbytes", 2)
            tps.note_route(7, "device")
            tps.note_scan(7, 1, 2)
            tps.note_flag("x")

    hooks()
    tracemalloc.start()
    try:
        hooks()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    blocks = [s for s in snap.statistics("filename") if s.traceback[0].filename in files]
    assert blocks == []


def test_plain_collect_allocates_no_collector_and_the_env_forces_one(golden, monkeypatch):
    root, _js, ts = golden
    df = ttpch.TPCH_QUERIES["q6"](ts, root)
    df.collect()
    ttrace.drain_roots()  # what earlier traced runs left
    allocs = TREG.counter("plan_stats.collectors").value
    df.collect()
    assert TREG.counter("plan_stats.collectors").value == allocs
    assert ttrace.drain_roots() == []
    monkeypatch.setenv("HYPERSPACE_PLAN_STATS", "1")
    df.collect()
    assert TREG.counter("plan_stats.collectors").value == allocs + 1


def test_trace_env_enables_tracing_at_import(tmp_path):
    out = str(tmp_path / "t.jsonl")
    env = dict(os.environ, HYPERSPACE_TRACE="1", HYPERSPACE_TRACE_FILE=out)
    code = ("import sys\n"
            "from hyperspace_tpu_torch.telemetry import trace\n"
            "assert trace.enabled()\n"
            "with trace.span('probe'):\n"
            "    with trace.span('inner'):\n"
            "        pass\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'hyperspace_tpu')]\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    roots = ttrace.read_jsonl_trace(out)
    assert [s["name"] for s in roots] == ["probe"]
    assert [c["name"] for c in roots[0]["children"]] == ["inner"]


def test_jsonl_round_trip(golden, tmp_path):
    root, _js, ts = golden
    path = str(tmp_path / "trace.jsonl")
    ttrace.drain_roots()
    ttrace.enable(ttrace.JsonlTraceSink(path))
    try:
        ttpch.TPCH_QUERIES["q6"](ts, root).collect()
    finally:
        ttrace.disable()
    mem = [r for r in ttrace.drain_roots() if r.name == "query"]
    file_roots = [r for r in ttrace.read_jsonl_trace(path) if r["name"] == "query"]
    assert len(mem) == len(file_roots) == 1

    def names_mem(s):
        return (s.name, tuple(names_mem(c) for c in s.children))

    def names_file(d):
        return (d["name"], tuple(names_file(c) for c in d["children"]))

    assert names_file(file_roots[0]) == names_mem(mem[0])
    assert file_roots[0]["attrs"]["rows_out"] == mem[0].attrs["rows_out"] == 1
    assert file_roots[0]["rpc"] == mem[0].rpc
    # both forms render
    assert ttrace.profile_string(file_roots, include_metrics=False).splitlines()[0] \
        .startswith("query ")


# ---------------------------------------------------------------------------
# action events
# ---------------------------------------------------------------------------


class CapturingLogger:
    events: list = []

    def log_event(self, event) -> None:
        CapturingLogger.events.append(event)


def _lake(root: str) -> str:
    rng = np.random.default_rng(4)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    for i in range(3):
        pq.write_table(pa.table({"k": rng.integers(0, 100, 200), "v": rng.uniform(0, 1, 200)}),
                       os.path.join(root, "d", f"p{i}.parquet"))
    return os.path.join(root, "d")


def _events(pkg, mod, C, warehouse, lake):
    import importlib

    canonical = importlib.import_module("test_torch_telemetry").CapturingLogger
    canonical.events.clear()
    s = mod.HyperspaceSession(warehouse, device="cpu") if pkg == "torch" \
        else mod.HyperspaceSession(warehouse_dir=warehouse)
    s.set_conf(C.EVENT_LOGGER_CLASS, "test_torch_telemetry.CapturingLogger")
    hs = mod.Hyperspace(s)
    hs.create_index(s.read.parquet(lake), mod.CoveringIndexConfig("idx", ["k"], ["v"]))
    hs.refresh_index("idx", "full")  # nothing changed: a no-op
    hs.optimize_index("idx", "full")
    hs.delete_index("idx")
    hs.restore_index("idx")
    hs.delete_index("idx")
    hs.vacuum_index("idx")
    return [(type(e).__name__, e.message, e.index_name, sorted(vars(e)))
            for e in canonical.events]


def test_action_events_have_the_jax_packages_shape(tmp_path):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        lake = _lake(str(tmp_path))
        want = _events("jax", J, JC, str(tmp_path / "wj"), lake)
        got = _events("torch", T, TC, str(tmp_path / "wt"), lake)
    finally:
        sys.path.remove(os.path.dirname(__file__))
    assert got == want
    assert ("CreateActionEvent", "started", "idx") == got[0][:3]
    assert any(e[0] == "VacuumActionEvent" and e[1] == "succeeded" for e in got)


def test_event_logger_conf_maps_the_jax_class_names(tmp_path):
    from hyperspace_tpu_torch.telemetry import logger as tlog

    s = T.HyperspaceSession(str(tmp_path), device="cpu")
    s.set_conf(TC.EVENT_LOGGER_CLASS, "hyperspace_tpu.telemetry.logger.PythonLoggingEventLogger")
    assert isinstance(tlog.event_logger_for(s), tlog.PythonLoggingEventLogger)
    tlog.clear_event_logger_cache(s)
    s.unset_conf(TC.EVENT_LOGGER_CLASS)
    assert isinstance(tlog.event_logger_for(s), tlog.NoOpEventLogger)


# ---------------------------------------------------------------------------
# HYPERSPACE_IO_THREADS at the five pools
# ---------------------------------------------------------------------------


def _recording(fn, seen: list):
    def wrapper(*a, **k):
        seen.append(threading.get_ident())
        time.sleep(0.01)  # overlap the tasks, so a wider pool spreads them
        return fn(*a, **k)
    return wrapper


@pytest.fixture(scope="module")
def bucketed(tmp_path_factory):
    """Two bucketed indexes (8 buckets) over an orders-like and a
    lineitem-like table, built by the port."""
    root = str(tmp_path_factory.mktemp("io_threads"))
    rng = np.random.default_rng(9)
    for name, n in (("l", 4000), ("o", 1000)):
        os.makedirs(os.path.join(root, name))
        pq.write_table(pa.table({f"{name}_key": rng.integers(0, 1000, n),
                                 f"{name}_v": rng.uniform(0, 1, n)}),
                       os.path.join(root, name, "part-0.parquet"))
    s = T.HyperspaceSession(os.path.join(root, "wh"), {TC.INDEX_NUM_BUCKETS: 8}, device="cpu")
    hs = T.Hyperspace(s)
    hs.create_index(s.read.parquet(os.path.join(root, "l")),
                    T.CoveringIndexConfig("l_idx", ["l_key"], ["l_v"]))
    hs.create_index(s.read.parquet(os.path.join(root, "o")),
                    T.CoveringIndexConfig("o_idx", ["o_key"], ["o_v"]))
    return root


def _pool_work(pool, root, monkeypatch) -> list:
    """The thread idents the pool's work ran on."""
    from hyperspace_tpu_torch.models import covering
    from hyperspace_tpu_torch.plan import bucket_join

    seen: list = []
    s = T.HyperspaceSession(os.path.join(root, "wh"), {TC.INDEX_NUM_BUCKETS: 8},
                            device="cpu").enable_hyperspace()
    l_df = s.read.parquet(os.path.join(root, "l"))
    o_df = s.read.parquet(os.path.join(root, "o"))
    if pool == "scan_aggregate":
        s.set_conf(TC.EXEC_TPU_ENABLED, False)
        monkeypatch.setattr(bucket_join, "_load_side_bucket",
                            _recording(bucket_join._load_side_bucket, seen))
        l_df.group_by("l_key").agg(TX.Sum(TX.col("l_v")).alias("s")).collect()
    elif pool == "join_bucket":
        s.set_conf(TC.EXEC_TPU_ENABLED, False)
        monkeypatch.setattr(bucket_join, "_load_side_bucket",
                            _recording(bucket_join._load_side_bucket, seen))
        l_df.join(o_df, TX.col("l_key") == TX.col("o_key")).collect()
    elif pool == "load_all":  # the barrier loader of HYPERSPACE_PIPELINE=0
        monkeypatch.setenv("HYPERSPACE_PIPELINE", "0")
        monkeypatch.setattr(bucket_join, "_load_pair", _recording(bucket_join._load_pair, seen))
        l_df.join(o_df, TX.col("l_key") == TX.col("o_key")).collect()
    else:
        hs = T.Hyperspace(s)
        name = f"{pool}_{os.environ['HYPERSPACE_IO_THREADS']}"
        if pool == "write":
            monkeypatch.setattr(covering, "_write_sketch_sidecar",
                                _recording(covering._write_sketch_sidecar, seen))
            hs.create_index(l_df, T.CoveringIndexConfig(name, ["l_key"], ["l_v"]))
        else:  # compaction: two runs per bucket, then a full optimize
            hs.create_index(o_df, T.CoveringIndexConfig(name, ["o_key"], ["o_v"]))
            extra = os.path.join(root, "o", f"part-{name}.parquet")
            rng = np.random.default_rng(11)
            pq.write_table(pa.table({"o_key": rng.integers(0, 1000, 500),
                                     "o_v": rng.uniform(0, 1, 500)}), extra)
            try:
                hs.refresh_index(name, "incremental")
            finally:
                os.remove(extra)
            monkeypatch.setattr(covering, "_write_sketch_sidecar",
                                _recording(covering._write_sketch_sidecar, seen))
            hs.optimize_index(name, "full")
    return seen


@pytest.mark.parametrize("pool", ["scan_aggregate", "join_bucket", "load_all", "write",
                                  "compaction"])
def test_io_threads_knob_sizes_each_pool(bucketed, pool, monkeypatch):
    widths = {}
    for threads in ("1", "4"):
        monkeypatch.setenv("HYPERSPACE_IO_THREADS", threads)
        with monkeypatch.context() as m:
            seen = _pool_work(pool, bucketed, m)
        assert len(seen) >= 4, (pool, threads, len(seen))
        widths[threads] = len(set(seen))
    assert widths["1"] == 1, widths
    assert widths["4"] > 1, widths
