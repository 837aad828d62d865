"""The port's ingest-plane gates ingest_smoke, result_cache_smoke and
workload_smoke (hyperspace_tpu_torch/tools/) at a small size on the CPU,
held to the JAX package on the same seeded data:

- each gate's ``run()`` is ok (every served or pinned result equal to its
  serial or cold replay bit for bit, compaction, vacuum, hits and folds
  engaged, conservation, quiescence and the audits);
- ingest_smoke's ``bits[k]`` for every k equal the JAX package's serial
  replay of the same batches, and each crash cell's outcome (crashed,
  recovered clean, equal to its twin) equals the JAX package's;
- result_cache_smoke's cold TPC-H references equal the JAX package's over
  the same lake: counts and keys exact, f32 sums within relative 1e-4;
- workload_smoke's journal record keys, workload-block keys and
  ``phases_ms`` vocabulary, its ``index_report`` order, cold candidates
  and drift flags equal the JAX package's for the same mixed run;
- the race ingest_smoke found on the card: a writer removing the
  latestStable pointer between a reader's check and its open. The port's
  reader scans the log (the JAX package's raises FileNotFoundError, and
  its rewrite falls back to the original plan)."""

import os
import threading
import time

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu import ingest as jingest
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.index_manager import IndexCollectionManager as JManager
from hyperspace_tpu.meta.data_manager import IndexDataManager as JDataManager
from hyperspace_tpu.meta.log_manager import IndexLogManager as JLogManager
from hyperspace_tpu.meta.log_manager import STABLE_STATES as JSTABLE
from hyperspace_tpu.plan.expr import Count as JCount, Max as JMax, Min as JMin
from hyperspace_tpu.plan.expr import Sum as JSum, col as jcol, lit as jlit
from hyperspace_tpu.utils import faults as jfaults
from hyperspace_tpu_torch.tools import _common, ingest_smoke, result_cache_smoke
from hyperspace_tpu_torch.tools import workload_smoke

REL = 1e-4
INGEST = {"clients": 3, "batches": 6, "batch_rows": 600, "queries_per_client": 10}
RC_ROWS = 5_000
WL_ROWS = 4_000


def assert_close(got: dict, want: dict, what: str) -> None:
    assert list(got) == list(want), what
    for c, w in want.items():
        g = got[c]
        assert len(g) == len(w), (what, c)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=REL), (what, c)
            else:
                assert a == b, (what, c)


# ---------------------------------------------------------------------------
# ingest_smoke
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ingest_gate(tmp_path_factory):
    return ingest_smoke.run("cpu", root=str(tmp_path_factory.mktemp("ingest")),
                            **INGEST)


def test_ingest_gate_is_ok(ingest_gate):
    out = ingest_gate
    assert out["ok"], {k: v for k, v in out.items() if k != "bits"}
    assert out["compactions"] >= 1 and out["vacuumed_versions"] >= 1
    assert out["pinned_queries"] * 2 >= out["served_queries"] == 3 * 10
    assert out["debris"] == [] and out["pins_drained"] and out["lifecycle_leaks"] == []


def _jax_group(df):
    return (df.filter(df["k"] < 48).group_by("k")
            .agg(JSum(jcol("v")).alias("sv"), JCount(jlit(1)).alias("n"),
                 JMin(jcol("w")).alias("mn"), JMax(jcol("w")).alias("mx"))
            .sort("k").collect())


def _jax_point(df):
    return df.filter(df["k"] == 7).agg(JSum(jcol("v")).alias("sv"),
                                       JCount(jlit(1)).alias("n")).collect()


JAX_INGEST_QUERIES = {"group": _jax_group, "point": _jax_point}


def _jax_world(root: str, batch_rows: int):
    """The gate's warehouse made by the JAX package: the first batch and
    the covering index ``ev`` (k; v, w), 8 buckets."""
    src = os.path.join(root, "events")
    os.makedirs(src)
    jio.write_parquet(JBatch.from_pydict(ingest_smoke.batch(0, batch_rows)),
                      os.path.join(src, "part0.parquet"))
    s = J.HyperspaceSession(warehouse_dir=root)
    s.set_conf(JC.INDEX_NUM_BUCKETS, ingest_smoke.BUCKETS)
    hs = J.Hyperspace(s)
    hs.create_index(s.read.parquet(src), J.CoveringIndexConfig("ev", ["k"], ["v", "w"]))
    s.enable_hyperspace()
    return src, s, hs


def test_ingest_serial_bits_equal_the_jax_packages(ingest_gate, tmp_path):
    src, s, _hs = _jax_world(str(tmp_path), INGEST["batch_rows"])

    def now() -> dict:
        df = s.read.parquet(src)
        return {q: _common.bits(fn(df).to_pydict()) for q, fn in JAX_INGEST_QUERIES.items()}

    want = {0: now()}
    for k in range(1, INGEST["batches"] + 1):
        jingest.append_batch(s, "ev", ingest_smoke.batch(k, INGEST["batch_rows"]))
        want[k] = now()
    assert ingest_gate["bits"] == want


def _jax_debris(ws: str) -> list:
    ip = os.path.join(ws, JC.INDEXES_DIR, "ev")
    lm, dm = JLogManager(ip), JDataManager(ip)
    out = []
    tail = lm.get_latest_log()
    if tail is None or tail.state not in JSTABLE:
        out.append(f"unstable log tail: {getattr(tail, 'state', None)}")
    if dm.staged_versions():
        out.append(f"staging dirs: {dm.staged_versions()}")
    if lm.stale_temp_files():
        out.append("stale .tmp spool files")
    refs = JManager._referenced_versions(lm)
    orphans = [v for v in dm.get_all_versions() if v not in refs]
    if orphans:
        out.append(f"version dirs not referenced: {orphans}")
    return out


def _jax_crash_cell(root: str, action: str, spec: str, rows: int) -> dict:
    """The reference ingest_smoke's crash cell on the JAX package."""
    twin_src, ts, th = _jax_world(os.path.join(root, "twin"), rows)
    p = os.path.join(twin_src, "p1.parquet")
    jio.write_parquet(JBatch.from_pydict(ingest_smoke.batch(ingest_smoke.CRASH_SEED, rows)), p)
    th.append("ev", ts.read.parquet(p))
    if action == "compact":
        th.compact_index("ev", min_runs=2)
    twin_bits = _common.bits(_jax_group(ts.read.parquet(twin_src)).to_pydict())

    cell_ws = os.path.join(root, "cell")
    cell_src, s, h = _jax_world(cell_ws, rows)
    p = os.path.join(cell_src, "p1.parquet")
    jio.write_parquet(JBatch.from_pydict(ingest_smoke.batch(ingest_smoke.CRASH_SEED, rows)), p)
    if action == "compact":
        h.append("ev", s.read.parquet(p))
    jfaults.arm(spec)
    crashed = False
    try:
        if action == "compact":
            h.compact_index("ev", min_runs=2)
        else:
            h.append("ev", s.read.parquet(p))
    except jfaults.InjectedCrash:
        crashed = True
    finally:
        jfaults.disarm()
    s2 = J.HyperspaceSession(warehouse_dir=cell_ws)
    s2.set_conf(JC.INDEX_NUM_BUCKETS, ingest_smoke.BUCKETS)
    h2 = J.Hyperspace(s2)
    h2.recover(force=True)
    debris = _jax_debris(cell_ws)
    if action == "compact":
        h2.compact_index("ev", min_runs=2)
    else:
        h2.append("ev", s2.read.parquet(p))
    s2.enable_hyperspace()
    identical = _common.bits(_jax_group(s2.read.parquet(cell_src)).to_pydict()) == twin_bits
    return {"action": action, "spec": spec, "crashed": crashed,
            "recovered_clean": not debris, "identical": identical, "debris": debris}


@pytest.mark.parametrize("i", range(len(ingest_smoke.CRASH_CELLS)),
                         ids=[s for _a, s in ingest_smoke.CRASH_CELLS])
def test_ingest_crash_cells_equal_the_jax_packages(ingest_gate, tmp_path, i):
    action, spec = ingest_smoke.CRASH_CELLS[i]
    want = _jax_crash_cell(str(tmp_path), action, spec, INGEST["batch_rows"])
    assert ingest_gate["crash_cells"][i] == want
    assert want["crashed"] and want["recovered_clean"] and want["identical"]


# ---------------------------------------------------------------------------
# result_cache_smoke
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def result_cache_gate(tmp_path_factory):
    return result_cache_smoke.run("cpu", root=str(tmp_path_factory.mktemp("rc")), clients=2,
                                  repeats=2, rows=RC_ROWS, batches=3, batch_rows=500)


def test_result_cache_gate_is_ok(result_cache_gate):
    out = result_cache_gate
    assert out["ok"], {k: v for k, v in out.items() if k != "results"}
    assert out["hits"] > 0 and out["folds"] > 0 and out["replay_mismatches"] == 0
    assert out["zero_exec_on_hit"] and "cache:probe" in out["hit_spans"]
    assert not [n for n in out["hit_spans"] if n.startswith(result_cache_smoke.EXEC_SPANS)]


@pytest.fixture(scope="module")
def result_cache_jax(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rc_jax"))
    jtpch.generate_tpch(root, rows_lineitem=RC_ROWS, seed=result_cache_smoke.SEED)
    s = J.HyperspaceSession(warehouse_dir=root)
    s.set_conf(JC.INDEX_NUM_BUCKETS, result_cache_smoke.BUCKETS)
    s.set_conf(JC.EXEC_TPU_ENABLED, True)
    jtpch.tpch_indexes(s, J.Hyperspace(s), root)
    s.enable_hyperspace()
    return {q: fn(s, root).to_pydict() for q, fn in jtpch.TPCH_QUERIES.items()}


@pytest.mark.parametrize("q", list(jtpch.TPCH_QUERIES))
def test_result_cache_references_equal_the_jax_packages(result_cache_gate, result_cache_jax, q):
    assert_close(result_cache_gate["results"][q], result_cache_jax[q], q)


# ---------------------------------------------------------------------------
# workload_smoke
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workload_gate(tmp_path_factory):
    return workload_smoke.run("cpu", root=str(tmp_path_factory.mktemp("workload")),
                              rows=WL_ROWS)


def test_workload_gate_is_ok(workload_gate):
    out = workload_gate
    assert out["ok"], out["failures"]
    assert out["outcomes"] == ["cancelled", "done"]
    assert out["index_order"][0] == "ev_used_idx" and out["cold"] == ["ev_unused_idx"]


@pytest.fixture(scope="module")
def workload_jax(tmp_path_factory):
    """The reference workload_smoke's mixed run on the JAX package (the
    same events table, indexes, served, cancelled and drift runs), with
    its workload plane reset before and after."""
    from hyperspace_tpu import serve as jserve
    from hyperspace_tpu.telemetry import workload as jwl
    from hyperspace_tpu.telemetry.attribution import PHASES as JPHASES
    from hyperspace_tpu.telemetry.index_ledger import INDEX_LEDGER as JINDEX

    root = tmp_path_factory.mktemp("workload_jax")
    ws, wdir = str(root / "ws"), str(root / "journal")
    n = workload_smoke.DRIFT_N
    env = {"HYPERSPACE_WORKLOAD_DIR": wdir, "HYPERSPACE_WORKLOAD_BASELINE": str(n),
           "HYPERSPACE_WORKLOAD_WINDOW": str(n),
           "HYPERSPACE_WORKLOAD_DRIFT_MIN": str(max(4, n - 2)),
           "HYPERSPACE_WORKLOAD_DRIFT_FACTOR": "2.0", "HYPERSPACE_SKETCHES": "1",
           "HYPERSPACE_QOS_COST_MBPS": "4"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    jwl.reset_for_testing()
    try:
        rng = np.random.default_rng(workload_smoke.SEED)
        per = WL_ROWS // workload_smoke.FILES
        src = os.path.join(ws, "events")
        for i in range(workload_smoke.FILES):
            jio.write_parquet(JBatch.from_pydict({
                "ev_k": (np.arange(per, dtype=np.int64) + i * per).tolist(),
                "ev_q": rng.integers(1, 50, per).tolist(),
                "ev_v": rng.uniform(0, 100, per).tolist(),
                "ev_s": rng.choice(["a", "b", "c"], per).tolist()}),
                os.path.join(src, f"part-{i:02d}.parquet"))
        s = J.HyperspaceSession(warehouse_dir=ws)
        s.set_conf(JC.INDEX_NUM_BUCKETS, workload_smoke.BUCKETS)
        s.set_conf(JC.EXEC_TPU_ENABLED, True)
        hs = J.Hyperspace(s)
        hs.create_index(s.read.parquet(src),
                        J.CoveringIndexConfig("ev_used_idx", ["ev_k"], ["ev_q", "ev_v"]))
        hs.create_index(s.read.parquet(src),
                        J.CoveringIndexConfig("ev_unused_idx", ["ev_s"], ["ev_q"]))
        s.enable_hyperspace()
        k_point = WL_ROWS // 2 + 7
        lo, hi = WL_ROWS // 4, WL_ROWS // 4 + 1500

        def q_point():
            return s.read.parquet(src).filter(jcol("ev_k") == k_point).select(
                "ev_k", "ev_q", "ev_v").to_pydict()

        def q_range():
            return s.read.parquet(src).filter((jcol("ev_k") >= lo) & (jcol("ev_k") < hi)).select(
                "ev_k", "ev_v").to_pydict()

        for _ in range(4):
            q_point(), q_range()
        sched = jserve.QueryScheduler(max_concurrent=1, queue_depth=64)
        gate = threading.Event()
        try:
            blocker = sched.submit(lambda: gate.wait(30), label="blocker")
            victim = sched.submit(q_point, label="victim")
            sched.cancel(victim)
            gate.set()
            blocker.result(60)
            for i in range(4):
                sched.submit(q_point if i % 2 == 0 else q_range, label="served").result(60)
            fast = lambda: time.sleep(workload_smoke.FAST_S) or 1  # noqa: E731
            slow = lambda: time.sleep(workload_smoke.SLOW_S) or 1  # noqa: E731
            for _ in range(n):
                sched.submit(fast, label="drifting").result(30)
                sched.submit(fast, label="stable").result(30)
            for _ in range(n):
                sched.submit(slow, label="drifting").result(30)
                sched.submit(fast, label="stable").result(30)
            sched.drain(60)
        finally:
            sched.shutdown()
        jwl.JOURNAL.flush()
        records = jwl.JOURNAL.load()
        out = {"record_keys": sorted({k for r in records for k in r}),
               "workload_keys": sorted({k for r in records for k in (r.get("workload") or {})}),
               "phases": sorted({tuple(r.get("phases_ms", {})) for r in records}),
               "vocabulary": tuple(JPHASES),
               "outcomes": sorted({r.get("outcome") for r in records}),
               "index_order": [r["name"] for r in JINDEX.report()],
               "cold": JINDEX.cold_candidates(),
               "regressions": sorted((r["kind"], r["key"]) for r in jwl.DRIFT.regressions())}
    finally:
        jwl.reset_for_testing()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def test_workload_journal_schema_equals_the_jax_packages(workload_gate, workload_jax):
    assert workload_gate["record_keys"] == workload_jax["record_keys"]
    assert workload_gate["workload_keys"] == workload_jax["workload_keys"]
    assert workload_gate["phases"] == workload_jax["phases"] == [workload_jax["vocabulary"]]
    assert workload_gate["outcomes"] == workload_jax["outcomes"]


def test_workload_ranking_and_drift_equal_the_jax_packages(workload_gate, workload_jax):
    assert workload_gate["index_order"] == workload_jax["index_order"]
    assert workload_gate["cold"] == workload_jax["cold"]
    got = sorted((r["kind"], r["key"]) for r in workload_gate["regressions"])
    assert got == workload_jax["regressions"] == [("latency", "drifting")]


def test_stable_pointer_removed_mid_read_falls_back_to_the_log(tmp_path, monkeypatch):
    """The pointer seen by a reader's check and gone by its open: the
    latest stable entry comes from the log, as with no pointer."""
    from hyperspace_tpu_torch import constants as TC
    from hyperspace_tpu_torch.meta import log_manager as tlm

    world = ingest_smoke.World(str(tmp_path), "ptr_", "cpu", 200)
    lm = tlm.IndexLogManager(os.path.join(world.ws, TC.INDEXES_DIR, "ev"))
    want = lm.get_latest_stable_log()
    assert want is not None
    ptr = os.path.join(lm.log_dir, TC.LATEST_STABLE_LOG)
    lm.delete_latest_stable_log()
    real_exists = os.path.exists
    monkeypatch.setattr(tlm.os.path, "exists", lambda p: p == ptr or real_exists(p))
    got = lm.get_latest_stable_log()
    assert got is not None and got.to_dict() == want.to_dict()
    # the JAX package's reader raises in the same race
    _src, _s, _hs = _jax_world(str(tmp_path / "jax"), 200)
    jlm = JLogManager(os.path.join(str(tmp_path / "jax"), JC.INDEXES_DIR, "ev"))
    jptr = os.path.join(jlm.log_dir, JC.LATEST_STABLE_LOG)
    jlm.delete_latest_stable_log()
    monkeypatch.setattr(tlm.os.path, "exists", lambda p: p in (ptr, jptr) or real_exists(p))
    with pytest.raises(FileNotFoundError):
        jlm.get_latest_stable_log()
