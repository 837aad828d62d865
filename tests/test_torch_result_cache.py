"""The result cache and incremental view maintenance, the port against the
JAX package on the same inputs.

A small lake (one parquet file of 1500 rows, appended batches, numpy seed
per batch) and a covering index of 4 buckets, in each package:

- ``classify_plan`` gives the JAX package's FoldSpec (or None) over a table
  of plans;
- a hit is bit-identical (``.hex()`` precision) to a run with the cache
  off, and runs no exec, kernel or compile span and no dispatch;
- a fold over one append and over several equals a recompute and the JAX
  package's fold bit for bit, with the same ``cache.result.*`` counter
  deltas; the fold-depth cap, the NULL identity (a filter no base row
  passes), non-foldable forms, verify mode (clean and divergent), eviction
  by bytes, and a stale entry after vacuum, never served;
- the background refresh after an append, single-flight population, the
  EXPLAIN ANALYZE route notes and profile's ``== Result cache ==`` block;
- the scheduler cases of tests/test_result_cache.py: a served query
  cancelled while it waits leaves the cache clean and its follower
  computes the cold result, in each package alike, and the exporter's
  snapshot carries the cache's state with the JAX package's keys.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu import ingest as JI
from hyperspace_tpu.cache import result_cache as jrc
from hyperspace_tpu.cache import view_maintenance as jvm
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry import plan_stats as jps
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import ingest as TI
from hyperspace_tpu_torch.cache import result_cache as trc
from hyperspace_tpu_torch.cache import view_maintenance as tvm
from hyperspace_tpu_torch.columnar.table import Column, ColumnBatch
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan.kernel_cache import (
    plan_files_fingerprint,
    plan_structure_fingerprint,
)
from hyperspace_tpu_torch.telemetry import plan_stats as tps
from hyperspace_tpu_torch.telemetry import trace
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils.rpc_meter import METER

PKGS = {
    "jax": {"mod": J, "C": JC, "X": JX, "ingest": JI, "rc": jrc, "vm": jvm, "reg": JREG,
            "ps": jps},
    "torch": {"mod": T, "C": TC, "X": TX, "ingest": TI, "rc": trc, "vm": tvm, "reg": TREG,
              "ps": tps},
}
NAME = "ev"
CACHE_COUNTERS = ("cache.result.hits", "cache.result.misses", "cache.result.folds",
                  "cache.result.fold_rows", "cache.result.evictions",
                  "cache.result.verified", "cache.result.refreshes")


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture()
def cache_on(monkeypatch):
    """The result cache on, from an empty store in both packages."""
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "1")
    for p in PKGS.values():
        p["rc"].RESULT_CACHE.clear()
    yield
    for p in PKGS.values():
        p["rc"].RESULT_CACHE.clear()


@pytest.fixture()
def no_refresh(monkeypatch):
    """No background refresh after an append, in either package, so the
    foreground fold's accounting is deterministic (the refresh has a test
    of its own)."""
    for p in PKGS.values():
        monkeypatch.setattr(p["vm"], "maybe_refresh", lambda *a, **k: 0)


def _batch(seed: int, n: int = 1500, k_lo: int = 0, k_hi: int = 40) -> dict:
    r = np.random.default_rng(seed)
    return {
        "k": r.integers(k_lo, k_hi, n).tolist(),
        "v": r.integers(0, 1000, n).tolist(),
        "w": r.random(n).tolist(),
    }


def _mk(pkg: str, root):
    ws = str(root)
    src = os.path.join(ws, "events")
    os.makedirs(src, exist_ok=True)
    pq.write_table(pa.table(_batch(0)), os.path.join(src, "part0.parquet"))
    mod, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
    conf = {C.INDEX_NUM_BUCKETS: 4}
    if pkg == "torch":
        session = mod.HyperspaceSession(ws, conf=conf, device="cpu")
    else:
        session = mod.HyperspaceSession(ws, conf=conf)
    hs = mod.Hyperspace(session)
    hs.create_index(session.read.parquet(src), mod.CoveringIndexConfig(NAME, ["k"], ["v", "w"]))
    session.enable_hyperspace()
    return session, hs, src


def _append(pkg: str, session, seed: int, **kw) -> None:
    PKGS[pkg]["ingest"].append_batch(session, NAME, _batch(seed, **kw),
                                     filename=f"p{seed}.parquet")


def _agg(pkg: str, session, src: str, bound: int = 25, lower: bool = False):
    """The exactly-foldable fragment: count, int sum, min and max."""
    X = PKGS[pkg]["X"]
    df = session.read.parquet(src)
    cond = X.col("k") >= bound if lower else X.col("k") < bound
    return df.filter(cond).agg(
        X.Count(X.lit(1)).alias("n"), X.Sum(X.col("v")).alias("sv"),
        X.Min(X.col("v")).alias("mn"), X.Max(X.col("v")).alias("mx"),
    )


def _bits(d: dict) -> str:
    def one(x):
        x = x.item() if hasattr(x, "item") else x
        return x.hex() if isinstance(x, float) else x

    return repr({k: [one(x) for x in v] for k, v in d.items()})


def _val(pkg: str, name: str) -> int:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else int(m.value)


def _snap(pkg: str) -> dict:
    return {n: _val(pkg, n) for n in CACHE_COUNTERS}


def _deltas(pkg: str, before: dict) -> dict:
    return {n: _val(pkg, n) - before[n] for n in CACHE_COUNTERS}


def _cold(pkg: str, build, *a, **kw) -> str:
    """A run with the cache off."""
    os.environ["HYPERSPACE_RESULT_CACHE"] = "0"
    try:
        return _bits(build(pkg, *a, **kw).collect().to_pydict())
    finally:
        os.environ["HYPERSPACE_RESULT_CACHE"] = "1"


# ---------------------------------------------------------------------------
# keys and gating
# ---------------------------------------------------------------------------


def test_disabled_by_default_runs_as_before(tmp_path, monkeypatch):
    monkeypatch.delenv("HYPERSPACE_RESULT_CACHE", raising=False)
    trc.RESULT_CACHE.clear()
    session, _hs, src = _mk("torch", tmp_path)
    before = _snap("torch")
    with METER.measure() as m1:
        a = _agg("torch", session, src).collect().to_pydict()
    with METER.measure() as m2:
        b = _agg("torch", session, src).collect().to_pydict()
    assert len(trc.RESULT_CACHE) == 0
    assert _deltas("torch", before) == dict.fromkeys(CACHE_COUNTERS, 0)
    assert _bits(a) == _bits(b)
    assert m1.delta["dispatches"] == m2.delta["dispatches"] > 0  # both executed


def test_unpinned_plans_are_not_cached(tmp_path, cache_on):
    session, _hs, src = _mk("torch", tmp_path)
    session.disable_hyperspace()
    _agg("torch", session, src).collect()
    _agg("torch", session, src).collect()
    assert len(trc.RESULT_CACHE) == 0


def test_fingerprints(tmp_path, cache_on, no_refresh):
    """The structure fingerprint tells templates apart and stays across an
    append; the files fingerprint follows the append."""
    session, _hs, src = _mk("torch", tmp_path)
    X = TX
    df = session.read.parquet(src)
    a = df.filter(X.col("k") < 25).agg(X.Sum(X.col("v")).alias("s")).optimized_plan()
    a2 = df.filter(X.col("k") < 25).agg(X.Sum(X.col("v")).alias("s")).optimized_plan()
    b = df.filter(X.col("k") < 26).agg(X.Sum(X.col("v")).alias("s")).optimized_plan()
    c = df.filter(X.col("k") < 25).agg(X.Sum(X.col("w")).alias("s")).optimized_plan()
    assert plan_structure_fingerprint(a) == plan_structure_fingerprint(a2)
    assert plan_structure_fingerprint(a) != plan_structure_fingerprint(b)
    assert plan_structure_fingerprint(a) != plan_structure_fingerprint(c)
    p0 = _agg("torch", session, src).optimized_plan()
    _append("torch", session, 1)
    p1 = _agg("torch", session, src).optimized_plan()
    assert plan_structure_fingerprint(p0) == plan_structure_fingerprint(p1)
    assert plan_files_fingerprint(p0) != plan_files_fingerprint(p1)


# ---------------------------------------------------------------------------
# classify_plan
# ---------------------------------------------------------------------------


def _plans(pkg: str, session, src: str) -> dict:
    X = PKGS[pkg]["X"]
    df = session.read.parquet(src)
    f = df.filter(X.col("k") < 25)
    return {
        "count_sum_min_max": _agg(pkg, session, src),
        "count_only": f.agg(X.Count(X.lit(1)).alias("n")),
        "int_sum": f.agg(X.Sum(X.col("v")).alias("s")),
        "float_sum": f.agg(X.Sum(X.col("w")).alias("s")),
        "float_min_max": f.agg(X.Min(X.col("w")).alias("a"), X.Max(X.col("w")).alias("b")),
        "avg": f.agg(X.Avg(X.col("v")).alias("a")),
        "grouped": f.group_by("k").agg(X.Count(X.lit(1)).alias("n")),
        "no_filter": df.agg(X.Count(X.lit(1)).alias("n"), X.Max(X.col("k")).alias("m")),
        "projected": f.select((X.col("v") + X.lit(1)).alias("v1")).agg(
            X.Sum(X.col("v1")).alias("s")),
        "sorted": f.select("k", "v").sort("k"),
    }


def test_classify_plan_matches_the_reference(tmp_path):
    specs = {}
    for pkg in PKGS:
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        specs[pkg] = {}
        for name, df in _plans(pkg, session, src).items():
            spec = PKGS[pkg]["vm"].classify_plan(df.optimized_plan())
            specs[pkg][name] = None if spec is None else (spec.names, spec.kinds)
    assert specs["torch"] == specs["jax"]
    assert specs["torch"]["count_sum_min_max"] == (("n", "sv", "mn", "mx"),
                                                   ("count", "sum", "min", "max"))
    assert specs["torch"]["float_sum"] is None and specs["torch"]["grouped"] is None


# ---------------------------------------------------------------------------
# hits
# ---------------------------------------------------------------------------


def test_hit_is_bit_identical_and_runs_nothing(tmp_path, cache_on):
    session, _hs, src = _mk("torch", tmp_path)
    before = _snap("torch")
    first = _agg("torch", session, src).collect().to_pydict()
    with METER.measure() as m, trace.capture() as cap:
        second = _agg("torch", session, src).collect().to_pydict()
    d = _deltas("torch", before)
    assert (d["cache.result.misses"], d["cache.result.hits"]) == (1, 1)
    assert _bits(first) == _bits(second) == _cold("torch", _agg, session, src)
    assert m.delta["dispatches"] == m.delta["uploads"] == m.delta["fetches"] == 0
    names = [s.name for s in cap.sink.spans]
    assert "cache:probe" in names
    assert not [n for n in names if n.startswith(("exec:", "kernel:", "compile:", "pipeline:"))]


def test_route_notes_cached_and_folded(tmp_path, cache_on, no_refresh):
    """EXPLAIN ANALYZE's collector notes ``cached`` on a hit and ``folded``
    on a fold, as the JAX package's does."""
    routes = {}
    for pkg in PKGS:
        ps = PKGS[pkg]["ps"]
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        _agg(pkg, session, src).collect()
        with ps.collect_scope() as hit:
            _agg(pkg, session, src).collect()
        _append(pkg, session, 1)
        with ps.collect_scope() as fold:
            _agg(pkg, session, src).collect()
        routes[pkg] = (hit.nodes[hit.plan.plan_id].route, hit.annotation(hit.plan.plan_id),
                       fold.nodes[fold.plan.plan_id].route)
    assert routes["torch"] == routes["jax"] == ("cached", "[route=cached]", "folded")


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------


def _fold_chain(pkg: str, root, appends, query=_agg, **qkw):
    session, _hs, src = _mk(pkg, root)
    before = _snap(pkg)
    out = {"first": _bits(query(pkg, session, src, **qkw).collect().to_pydict())}
    for i, (seed, kw) in enumerate(appends):
        _append(pkg, session, seed, **kw)
        out[f"after_{i}"] = _bits(query(pkg, session, src, **qkw).collect().to_pydict())
        out[f"cold_{i}"] = _cold(pkg, query, session, src, **qkw)
    PKGS[pkg]["rc"].RESULT_CACHE.clear()
    out["recomputed"] = _bits(query(pkg, session, src, **qkw).collect().to_pydict())
    out["counters"] = _deltas(pkg, before)
    return out


@pytest.mark.parametrize("n_appends", [1, 3])
def test_fold_equals_recompute_and_the_reference(tmp_path, cache_on, no_refresh, n_appends):
    appends = [(10 + i, {}) for i in range(n_appends)]
    out = {pkg: _fold_chain(pkg, tmp_path / pkg, appends) for pkg in PKGS}
    assert out["torch"] == out["jax"]
    t = out["torch"]
    for i in range(n_appends):
        assert t[f"after_{i}"] == t[f"cold_{i}"]
    assert t[f"after_{n_appends - 1}"] == t["recomputed"]
    assert t["counters"]["cache.result.folds"] == n_appends
    assert t["counters"]["cache.result.fold_rows"] == 1500 * n_appends


def test_fold_null_identity_end_to_end(tmp_path, cache_on, no_refresh):
    """No base row passes ``k >= 40`` (min, max and sum are NULL); the first
    append brings passing rows, the second none: both fold, and equal the
    recompute and the JAX package's."""
    appends = [(20, {"k_lo": 40, "k_hi": 60}), (21, {})]
    out = {pkg: _fold_chain(pkg, tmp_path / pkg, appends, bound=40, lower=True)
           for pkg in PKGS}
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert "None" in t["first"] and "None" not in t["after_0"]
    assert t["after_0"] == t["cold_0"] and t["after_1"] == t["cold_1"] == t["recomputed"]
    assert t["counters"]["cache.result.folds"] == 2


def test_fold_results_null_identity_table():
    """fold_results over NULL and non-NULL sides, against the JAX
    package's on the same batches."""
    from hyperspace_tpu.columnar.table import Column as JColumn
    from hyperspace_tpu.columnar.table import ColumnBatch as JBatch

    def batches(ColumnCls, BatchCls):
        null = BatchCls({
            "n": ColumnCls(np.array([0], np.int64), "int64"),
            "s": ColumnCls(np.array([0], np.int64), "int64", np.array([False])),
            "m": ColumnCls(np.array([0.0]), "float64", np.array([False])),
        })
        val = BatchCls({
            "n": ColumnCls(np.array([3], np.int64), "int64"),
            "s": ColumnCls(np.array([42], np.int64), "int64"),
            "m": ColumnCls(np.array([-1.5]), "float64"),
        })
        return {"null": null, "val": val}

    def render(b):
        return {k: (c.dtype, c.data.tolist(),
                    None if c.validity is None else c.validity.tolist())
                for k, c in b.columns.items()}

    tb, jb = batches(Column, ColumnBatch), batches(JColumn, JBatch)
    tspec = tvm.FoldSpec(("n", "s", "m"), ("count", "sum", "min"))
    jspec = jvm.FoldSpec(("n", "s", "m"), ("count", "sum", "min"))
    for a in ("null", "val"):
        for b in ("null", "val"):
            got = render(tvm.fold_results(tb[a], tb[b], tspec))
            assert got == render(jvm.fold_results(jb[a], jb[b], jspec)), (a, b)
    assert render(tvm.fold_results(tb["val"], tb["val"], tspec))["s"] == ("int64", [84], None)
    assert render(tvm.fold_results(tb["null"], tb["null"], tspec))["s"][2] == [False]


def test_fold_dtype_drift_raises():
    spec = tvm.FoldSpec(("s",), ("sum",))
    a = ColumnBatch({"s": Column(np.array([1], np.int64), "int64")})
    b = ColumnBatch({"s": Column(np.array([1], np.int32), "int32")})
    with pytest.raises(HyperspaceError, match="dtype drift"):
        tvm.fold_results(a, b, spec)


def _depth_cap(pkg: str, root):
    session, _hs, src = _mk(pkg, root)
    rc = PKGS[pkg]["rc"]
    before = _snap(pkg)
    _agg(pkg, session, src).collect()
    _append(pkg, session, 21)
    _agg(pkg, session, src).collect()  # depth 0 -> 1: folds
    folds_1 = _deltas(pkg, before)["cache.result.folds"]
    # drop the depth-0 anchor (as eviction would): only the entry at the cap
    # is left, so the next advance recomputes
    with rc.RESULT_CACHE._lock:
        for e in [e for e in rc.RESULT_CACHE._d.values() if e.fold_depth == 0]:
            rc.RESULT_CACHE._unlink(e)
    _append(pkg, session, 22)
    got = _bits(_agg(pkg, session, src).collect().to_pydict())
    depths = sorted(e.fold_depth for e in rc.RESULT_CACHE._d.values())
    return {"folds_1": folds_1, "counters": _deltas(pkg, before), "depths": depths,
            "got": got, "cold": _cold(pkg, _agg, session, src)}


def test_fold_depth_cap_reanchors(tmp_path, cache_on, no_refresh, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE_FOLD_DEPTH", "1")
    out = {pkg: _depth_cap(pkg, tmp_path / pkg) for pkg in PKGS}
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert t["folds_1"] == 1 and t["counters"]["cache.result.folds"] == 1
    assert 0 in t["depths"]  # the recompute anchored again at depth 0
    assert t["got"] == t["cold"]


def _non_foldable(pkg, session, src):
    X = PKGS[pkg]["X"]
    df = session.read.parquet(src)
    return df.filter(X.col("k") < 25).agg(X.Sum(X.col("w")).alias("sw"),
                                          X.Avg(X.col("w")).alias("aw"))


def _grouped(pkg, session, src):
    X = PKGS[pkg]["X"]
    df = session.read.parquet(src)
    return df.filter(X.col("k") < 30).group_by("k").agg(
        X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n")).sort("k")


@pytest.mark.parametrize("query", [_non_foldable, _grouped], ids=["float_sum", "grouped"])
def test_non_foldable_forms_recompute(tmp_path, cache_on, no_refresh, query):
    out = {pkg: _fold_chain(pkg, tmp_path / pkg, [(4, {})], query=query) for pkg in PKGS}
    t = out["torch"]
    assert t["counters"] == out["jax"]["counters"]
    assert t["counters"]["cache.result.folds"] == 0
    assert t["counters"]["cache.result.misses"] == 3  # first, after the append, recomputed
    assert t["after_0"] == t["cold_0"] == t["recomputed"]
    if query is _grouped:  # exact integer results: the JAX package's bits
        assert t["after_0"] == out["jax"]["after_0"]


# ---------------------------------------------------------------------------
# staleness, verify mode, eviction
# ---------------------------------------------------------------------------


def _stale_after_vacuum(pkg, root):
    session, hs, src = _mk(pkg, root)
    rc = PKGS[pkg]["rc"]
    _agg(pkg, session, src).collect()
    entries_0 = len(rc.RESULT_CACHE)
    for i in range(3):
        _append(pkg, session, 30 + i)
    hs.compact_index(NAME, min_runs=2)
    hs.vacuum_outdated_index(NAME)
    left = len(rc.RESULT_CACHE)
    before = _snap(pkg)
    got = _bits(_agg(pkg, session, src).collect().to_pydict())
    return {"entries_0": entries_0, "left": left, "counters": _deltas(pkg, before),
            "got": got, "cold": _cold(pkg, _agg, session, src)}


def test_stale_entry_never_served_after_vacuum(tmp_path, cache_on, no_refresh):
    out = {pkg: _stale_after_vacuum(pkg, tmp_path / pkg) for pkg in PKGS}
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert (t["entries_0"], t["left"]) == (1, 0)
    assert t["counters"]["cache.result.hits"] == 0
    assert t["counters"]["cache.result.folds"] == 0  # compaction rewrote the runs
    assert t["got"] == t["cold"]


def test_verify_mode(tmp_path, cache_on, monkeypatch):
    """verify recomputes a hit and counts it; a tampered entry raises."""
    out = {}
    for pkg in PKGS:
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        _agg(pkg, session, src).collect()
        monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "verify")
        before = _snap(pkg)
        _agg(pkg, session, src).collect()
        clean = _deltas(pkg, before)["cache.result.verified"]
        entry = next(iter(PKGS[pkg]["rc"].RESULT_CACHE._d.values()))
        entry.result.column("sv").data[0] += 1
        try:
            _agg(pkg, session, src).collect()
            raised = None
        except Exception as e:
            raised = (type(e).__name__, "verify divergence" in str(e))
        out[pkg] = (clean, raised)
        monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "1")
        PKGS[pkg]["rc"].RESULT_CACHE.clear()
    assert out["torch"] == out["jax"] == (1, ("HyperspaceError", True))


def test_verify_mode_holds_a_fold(tmp_path, cache_on, no_refresh, monkeypatch):
    session, _hs, src = _mk("torch", tmp_path)
    _agg("torch", session, src).collect()
    _append("torch", session, 3)
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "verify")
    before = _snap("torch")
    _agg("torch", session, src).collect()
    d = _deltas("torch", before)
    assert (d["cache.result.folds"], d["cache.result.verified"]) == (1, 1)


def test_eviction_by_bytes(tmp_path, cache_on, monkeypatch):
    out = {}
    for pkg in PKGS:
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        rc = PKGS[pkg]["rc"]
        X = PKGS[pkg]["X"]
        df = session.read.parquet(src)
        df.filter(X.col("k") < 1).agg(X.Count(X.lit(1)).alias("n")).collect()
        per_entry = next(iter(rc.RESULT_CACHE._d.values())).nbytes
        rc.RESULT_CACHE.clear()
        monkeypatch.setenv("HYPERSPACE_RESULT_CACHE_MB", str(2.5 * per_entry / (1024 * 1024)))
        before = _snap(pkg)
        for lim in (1, 2, 3, 4):
            df.filter(X.col("k") < lim).agg(X.Count(X.lit(1)).alias("n")).collect()
        out[pkg] = (per_entry, _deltas(pkg, before)["cache.result.evictions"],
                    len(rc.RESULT_CACHE), rc.RESULT_CACHE.check_consistency())
        monkeypatch.delenv("HYPERSPACE_RESULT_CACHE_MB")
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == (2, 2, True)


# ---------------------------------------------------------------------------
# refresh, single flight, surfaces
# ---------------------------------------------------------------------------


def _wait_refresh(vm) -> None:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not vm.refresh_idle():
        time.sleep(0.02)
    assert vm.refresh_idle()


def test_background_refresh_on_append(tmp_path, cache_on):
    out = {}
    for pkg in PKGS:
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        _agg(pkg, session, src).collect()
        before = _snap(pkg)
        _append(pkg, session, 40)
        _wait_refresh(PKGS[pkg]["vm"])
        refreshed = _deltas(pkg, before)
        got = _bits(_agg(pkg, session, src).collect().to_pydict())
        out[pkg] = (refreshed, _deltas(pkg, before)["cache.result.hits"], got,
                    _cold(pkg, _agg, session, src))
    assert out["torch"] == out["jax"]
    refreshed, hits, got, cold = out["torch"]
    assert refreshed["cache.result.refreshes"] == refreshed["cache.result.folds"] == 1
    assert hits == 1 and got == cold


def test_single_flight_stampede_computes_once():
    cache = trc.ResultCache("result_test_stampede")
    calls = {"n": 0}
    barrier = threading.Barrier(8)

    def build():
        calls["n"] += 1
        time.sleep(0.2)  # hold the in-flight window open
        return trc.CachedResult("k", "s", ColumnBatch({}), (), (), None, 0, None, None)

    results = []

    def worker():
        barrier.wait()
        entry, _hit = cache.get_or_compute("k", build)
        results.append(entry)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls["n"] == 1
    assert len({id(e) for e in results}) == 1
    assert cache.check_consistency()


def test_failed_build_never_latches_inflight():
    """A build that dies with a BaseException clears its marker and wakes
    the waiter, which builds instead."""
    cache = trc.ResultCache("result_test_failed")
    started, release = threading.Event(), threading.Event()
    outcome = {}

    class Interrupted(BaseException):
        pass

    def failing_build():
        started.set()
        release.wait(5)
        raise Interrupted()

    def victim():
        try:
            cache.get_or_compute("k", failing_build)
        except Interrupted:
            outcome["failed"] = True

    def successor():
        started.wait(5)
        entry, hit = cache.get_or_compute(
            "k", lambda: trc.CachedResult("k", "s", ColumnBatch({}), (), (), None, 0,
                                          None, None))
        outcome["successor"] = (entry is not None, hit)

    t1, t2 = threading.Thread(target=victim), threading.Thread(target=successor)
    t1.start()
    t2.start()
    time.sleep(0.05)
    release.set()
    t1.join(5)
    t2.join(5)
    assert outcome == {"failed": True, "successor": (True, False)}
    assert not cache._inflight and cache.check_consistency()


def test_state_and_profile_block(tmp_path, cache_on):
    session, hs, src = _mk("torch", tmp_path)
    _agg("torch", session, src).collect()
    s = trc.RESULT_CACHE.state()
    assert s["entries"] == 1 and s["foldable_entries"] == 1 and s["bytes"] > 0
    assert sorted(s) == sorted(jrc.RESULT_CACHE.state())
    block = trc.result_cache_state_string()
    lines = block.splitlines()
    assert lines[0] == "== Result cache =="
    assert lines[1].startswith("mode=1 entries=1 (foldable=1) bytes=")
    assert "hit_ratio=" in lines[2] and lines[3].startswith("folds=")
    report = hs.profile(_agg("torch", session, src))
    assert "== Result cache ==" in report and "Query profile (spans + metrics):" in report
    os.environ["HYPERSPACE_RESULT_CACHE"] = "0"
    try:
        assert trc.result_cache_state_string() == jrc.result_cache_state_string() == (
            "== Result cache ==\ndisabled (HYPERSPACE_RESULT_CACHE=0)")
    finally:
        os.environ["HYPERSPACE_RESULT_CACHE"] = "1"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cancelled_served_query_leaves_cache_clean(tmp_path, cache_on, pkg):
    """A scheduler-cancelled query unwinds without latching a build; the
    same query, served next, computes the cold result."""
    serve = __import__(PKGS[pkg]["mod"].__name__ + ".serve", fromlist=["serve"])
    cache = PKGS[pkg]["rc"].RESULT_CACHE
    session, _hs, src = _mk(pkg, tmp_path)
    cold = _cold(pkg, _agg, session, src)
    sched = serve.QueryScheduler(max_concurrent=1, queue_depth=8)
    try:
        blocker = threading.Event()

        def slow():
            blocker.wait(5)
            return _agg(pkg, session, src).collect()

        h1 = sched.submit(slow, label="victim")
        h2 = sched.submit(lambda: _agg(pkg, session, src).collect(), label="follower")
        h1.cancel()
        blocker.set()
        with pytest.raises(serve.QueryCancelledError):
            h1.result(timeout=30)
        assert _bits(h2.result(timeout=30).to_pydict()) == cold
        assert h1.status == "cancelled" and h2.status == "done"
        assert not cache._inflight and cache.check_consistency()
    finally:
        sched.shutdown(wait=True)
        # the served query's ledger record and cost-model sample
        PKGS[pkg]["mod"].telemetry.attribution.LEDGER.reset_for_testing()
        serve.COST_MODEL.reset_for_testing()


def test_exporter_snapshot_carries_the_cache(tmp_path, cache_on):
    from hyperspace_tpu.telemetry.exporter import snapshot_dict as jsnap
    from hyperspace_tpu_torch.telemetry.exporter import snapshot_dict as tsnap

    for pkg in ("jax", "torch"):
        session, _hs, src = _mk(pkg, tmp_path / pkg)
        _agg(pkg, session, src).collect()
    j, t = jsnap(), tsnap()
    assert t["result_cache"]["entries"] == j["result_cache"]["entries"] == 1
    assert sorted(t["result_cache"]) == sorted(j["result_cache"])
    from hyperspace_tpu_torch.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()
