"""The adaptive executor, the port against the JAX package on the same
inputs (the counterparts of tests/test_adaptive.py and the adaptive cases
of tests/test_join_adaptive.py).

- the mode, the knobs and ``force_mode`` read alike; off, every hook
  returns the static answer and no ``adaptive.*`` counter moves;
- conjunct reordering: the mask equals the static one (Kleene NULLs
  included), and the switch (site, from, to, at, ratio) equals the JAX
  package's, in the plan statistics, EXPLAIN ANALYZE's ``[adapted: …]``
  line and the workload journal's ``adaptive`` block;
- join re-planning: ``JoinMemoryPlan`` observes and re-derives as the JAX
  one does, and a join over footer statistics planted 64x low flips
  banded→split with the JAX package's switches and the same bits;
- scan abort-and-replan: a streamed index scan that keeps more than its
  prune prediction aborts after the warmup chunk, is vetoed, and the
  re-planned query equals the raw scan bit for bit, by a sub-1 abort
  factor and by sketch NDVs planted 10^9 high; verify mode stays clean
  across the abort and raises on a planted divergence.
"""

import glob
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar.table import Column as JCol, ColumnBatch as JBatch
from hyperspace_tpu.exceptions import HyperspaceError as JErr
from hyperspace_tpu.models import covering as JCOV
from hyperspace_tpu.models.dataskipping import sketch_store as JSK
from hyperspace_tpu.plan import adaptive as JA
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import join_memory as JJM
from hyperspace_tpu.serve import budget as JB
from hyperspace_tpu.telemetry import plan_stats as JP
from hyperspace_tpu.telemetry import workload as JW
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar.table import Column as TCol, ColumnBatch as TBatch
from hyperspace_tpu_torch.exceptions import HyperspaceError as TErr
from hyperspace_tpu_torch.models import covering as TCOV
from hyperspace_tpu_torch.plan import adaptive as TA
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import join_memory as TJM
from hyperspace_tpu_torch.serve import budget as TB
from hyperspace_tpu_torch.telemetry import plan_stats as TP
from hyperspace_tpu_torch.telemetry import workload as TW
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG

PKGS = {
    "jax": {"mod": J, "C": JC, "X": JX, "A": JA, "JM": JJM, "B": JB, "P": JP, "W": JW,
            "reg": JREG, "Batch": JBatch, "Col": JCol, "Err": JErr, "cov": JCOV},
    "torch": {"mod": T, "C": TC, "X": TX, "A": TA, "JM": TJM, "B": TB, "P": TP, "W": TW,
              "reg": TREG, "Batch": TBatch, "Col": TCol, "Err": TErr, "cov": TCOV},
}
MTIME_NS = 1_700_000_000 * 10**9


@pytest.fixture(scope="module", autouse=True)
def _reset_process_wide_state():
    yield
    for p in PKGS.values():
        p["mod"].telemetry.attribution.LEDGER.reset_for_testing()
        p["W"].reset_for_testing()


@pytest.fixture(autouse=True)
def _fresh_device_ledger(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "0")
    yield
    for p in PKGS.values():
        p["B"].reset_device_budget()


def _bits(d: dict) -> str:
    return repr({k: [x.hex() if isinstance(x, float) else x for x in
                     (v.item() if hasattr(v, "item") else v for v in vals)]
                 for k, vals in d.items()})


def _val(pkg: str, name: str) -> float:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else m.value


def _write(path: str, table: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(table), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))
    return path


def _session(pkg: str, ws: str, device_tier: bool = False, **conf):
    p = PKGS[pkg]
    if pkg == "torch":
        return p["mod"].HyperspaceSession(ws, conf=conf, device="cpu")
    if device_tier:
        conf[p["C"].EXEC_TPU_ENABLED] = True
    return p["mod"].HyperspaceSession(ws, conf=conf)


def _switches(col) -> list:
    return [dict(sw) for sw in col.switches]


# --- mode and knobs ------------------------------------------------------------


@pytest.mark.parametrize("raw", ["0", "off", "", "no", "1", "true", "ON", "verify", " Verify "])
def test_mode_parses_alike(monkeypatch, raw):
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", raw)
    assert TA.mode() == JA.mode()
    assert TA.active() == JA.active()


def test_force_mode_and_knob_defaults(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", raising=False)
    monkeypatch.delenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", raising=False)
    for A in (JA, TA):
        assert (A.abort_factor(), A.warmup_chunks()) == (4.0, 2)
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "0")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", "0.5")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "1")
    for A in (JA, TA):
        assert (A.abort_factor(), A.warmup_chunks(), A.join_warmup_pairs()) == (0.5, 1, 1)
        with A.force_mode("0"):
            assert A.mode() == "0"
            with A.force_mode("verify"):
                assert A.mode() == "verify"
        assert A.mode() == "1"
    assert TA.SITE_UNITS == JA.SITE_UNITS


class _FakeScan:
    prune_spec = None
    index_info = None
    plan_id = -1


def test_off_hooks_return_static_answers(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_ADAPTIVE", raising=False)
    batch = TBatch.from_pydict({"a": np.random.default_rng(0).integers(0, 10, 4000).tolist()})
    assert TA.conjunct_mask((TX.col("a") > 1) & (TX.col("a") < 8), batch) is None
    chunks = iter(())
    assert TA.monitor_scan_chunks(chunks, _FakeScan(), ({}, [])) is chunks
    assert TA.vetoed_indexes() == frozenset()
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "1")
    # active, but outside a replan scope the monitor stays disarmed
    assert TA.monitor_scan_chunks(chunks, _FakeScan(), ({}, [])) is chunks


# --- site 2: conjunct reordering ---------------------------------------------------


@pytest.fixture()
def reorder_env(monkeypatch):
    """1024-row chunks and a one-chunk warmup, so a few thousand rows adapt."""
    for p in PKGS.values():
        monkeypatch.setattr(p["A"], "_REORDER_CHUNK_ROWS", 1024)
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "1")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "1")


def _nullable(Col, values):
    data = np.array([0 if v is None else v for v in values], dtype=np.int64)
    return Col(data, "int64", np.array([v is not None for v in values], dtype=bool))


@pytest.mark.parametrize("case", ["written_worst_first", "kleene_nulls", "already_best"])
def test_conjunct_mask_and_switch_match(reorder_env, case):
    rng = np.random.default_rng(11)
    n = 6000
    a, b = rng.integers(0, 100, n), rng.integers(0, 100, n)
    c = rng.uniform(0, 1, n)
    nulls_a = [None if rng.uniform() < 0.2 else int(x) for x in a]
    got = {}
    for pkg in PKGS:
        X, Col, Batch, A, P = (PKGS[pkg][k] for k in ("X", "Col", "Batch", "A", "P"))
        if case == "kleene_nulls":
            batch = Batch({"a": _nullable(Col, nulls_a), "b": Col(b.astype(np.int64), "int64"),
                           "c": Col(c, "float64")})
            cond = (X.col("a") > 5) & (X.col("b") < 30) & (X.col("c") < 0.5)
        elif case == "already_best":
            batch = Batch.from_pydict({"a": a.tolist(), "b": b.tolist(), "c": c.tolist()})
            cond = (X.col("c") < 0.05) & (X.col("b") < 50) & (X.col("a") >= 10)
        else:
            batch = Batch.from_pydict({"a": a.tolist(), "b": b.tolist(), "c": c.tolist()})
            cond = (X.col("a") >= 10) & (X.col("b") < 50) & (X.col("c") < 0.05)
        static = np.asarray(cond.eval(batch).data, dtype=bool)
        before = _val(pkg, "adaptive.reorder")
        with P.collect_scope() as col:
            mask = A.conjunct_mask(cond, batch)
        assert mask is not None and np.array_equal(mask, static)
        got[pkg] = (_switches(col), _val(pkg, "adaptive.reorder") - before)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == (0 if case == "already_best" else 1)


def test_static_cases_return_none(reorder_env):
    rng = np.random.default_rng(11)
    for pkg in PKGS:
        X, Batch, A = PKGS[pkg]["X"], PKGS[pkg]["Batch"], PKGS[pkg]["A"]
        big = Batch.from_pydict({"a": rng.integers(0, 100, 6000).tolist(),
                                 "b": rng.integers(0, 100, 6000).tolist()})
        small = Batch.from_pydict({"a": list(range(1500)), "b": list(range(1500))})
        assert A.conjunct_mask(X.col("a") > 3, big) is None
        assert A.conjunct_mask((X.col("a") > 3) | (X.col("b") > 3), big) is None
        assert A.conjunct_mask((X.col("a") > 3) & (X.col("b") > 3), small) is None


def _filter_lake(root: str, seed: int, cols=("a", "b", "c"), n: int = 9000) -> str:
    rng = np.random.default_rng(seed)
    _write(os.path.join(root, "t", "p.parquet"), {c: rng.integers(0, 100, n) for c in cols})
    return os.path.join(root, "t")


def _colcol(pkg: str, s, src: str):
    """Col-vs-col conjuncts: nothing pushes to the reader, so the host
    Filter sees every row."""
    X = PKGS[pkg]["X"]
    return s.read.parquet(src).filter(
        (X.col("a") != X.col("c")) & (X.col("a") > X.col("b")) & (X.col("b") >= X.col("c"))
    ).select("a", "b", "c")


def test_filter_query_bits_and_explain_analyze_match(tmp_path, reorder_env, monkeypatch):
    src = _filter_lake(str(tmp_path), 9)
    got = {}
    for pkg in PKGS:
        P, A = PKGS[pkg]["P"], PKGS[pkg]["A"]
        s = _session(pkg, str(tmp_path / pkg))
        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "1")
        with P.collect_scope() as col:
            on = _colcol(pkg, s, src).collect().to_pydict()
        lines = [ln for ln in P.summary_string(col).splitlines() if ln.startswith("[adapted:")]
        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0")
        off = _colcol(pkg, s, src).collect().to_pydict()
        assert _bits(on) == _bits(off)
        got[pkg] = (_bits(on), lines, _switches(col))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] and "@chunk" in got["torch"][1][0]


def test_off_query_is_bit_identical_and_counter_silent(tmp_path, reorder_env, monkeypatch):
    src = _filter_lake(str(tmp_path), 3)
    s = _session("torch", str(tmp_path / "torch"))
    before = {k: v for k, v in TREG.snapshot().items() if k.startswith("adaptive.")}
    monkeypatch.delenv("HYPERSPACE_ADAPTIVE", raising=False)
    unset = _colcol("torch", s, src).collect().to_pydict()
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0")
    explicit = _colcol("torch", s, src).collect().to_pydict()
    assert _bits(unset) == _bits(explicit)
    assert {k: v for k, v in TREG.snapshot().items() if k.startswith("adaptive.")} == before


def test_verify_mode_clean_and_catches_a_planted_divergence(tmp_path, reorder_env,
                                                           monkeypatch):
    src = _filter_lake(str(tmp_path), 17, cols=("a", "b"))
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "verify")
    for pkg in PKGS:
        X, A = PKGS[pkg]["X"], PKGS[pkg]["A"]
        s = _session(pkg, str(tmp_path / pkg))
        df = lambda: s.read.parquet(src).filter(
            (X.col("a") > X.col("b")) & (X.col("a") != X.col("b"))).select("a", "b")
        before = _val(pkg, "adaptive.verified")
        assert df().collect().num_rows > 0
        assert _val(pkg, "adaptive.verified") == before + 1
        real = A._conjunct_data_mask

        def corrupted(conj, batch, real=real):
            m = real(conj, batch).copy()
            if m.size:
                m[0] = not m[0]
            return m

        monkeypatch.setattr(A, "_conjunct_data_mask", corrupted)
        with pytest.raises(PKGS[pkg]["Err"], match="verify mismatch"):
            df().collect()
        monkeypatch.setattr(A, "_conjunct_data_mask", real)


def test_journal_adaptive_block_matches(tmp_path, monkeypatch):
    """A switch recorded inside a query's attribution scope rides its
    journal record's ``workload.adaptive`` block, as in the JAX package."""
    rows = {}
    for pkg in PKGS:
        mod, W, A = PKGS[pkg]["mod"], PKGS[pkg]["W"], PKGS[pkg]["A"]
        W.reset_for_testing()
        monkeypatch.setenv("HYPERSPACE_WORKLOAD_DIR", str(tmp_path / f"journal-{pkg}"))
        attr = mod.telemetry.attribution
        led = attr.QueryStatsLedger(window=8)
        st = led.begin(mod.serve.QueryContext(label="q"))
        with attr.scope(st):
            A.record_switch("reorder", "0,1,2", "2,1,0", ratio=0.95, at=1)
            A.record_switch("abort", "ev_idx", "replan", index="ev_idx", ratio=7.25, at=1)
        led.finish(st, "done")
        W.JOURNAL.flush()
        rows[pkg] = [r["workload"]["adaptive"] for r in W.JOURNAL.load()]
        W.reset_for_testing()
    assert rows["torch"] == rows["jax"] and len(rows["torch"][0]) == 2


# --- site 1: join re-planning ---------------------------------------------------------


def _mem_plan(JM, grant=1 << 20, estimates=None, strategies=None):
    estimates = estimates or {}
    strategies = strategies or {b: "banded" for b in estimates}
    split_by = {b: (0 if s == "broadcast" else 4096) for b, s in strategies.items()}
    return JM.JoinMemoryPlan(strategies, split_by, grant, 4096, None, estimates=estimates,
                             index_name="jx")


@pytest.mark.parametrize("case", ["off", "correction", "own_actuals", "broadcast",
                                  "unsplittable", "non_destructive"])
def test_join_memory_plan_replans_alike(monkeypatch, case):
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0" if case == "off" else "1")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "1")
    got = {}
    for pkg in PKGS:
        JM, P = PKGS[pkg]["JM"], PKGS[pkg]["P"]
        est = {0: (1000, 16000.0), 1: (2000, 32000.0)}
        strategies = None
        if case == "own_actuals":
            est = {0: (1000, 16000.0), 1: (100, 1600.0)}
        if case in ("broadcast", "unsplittable"):
            est, strategies = {0: (10, 160.0), 1: (1000, 16000.0)}, {0: "broadcast", 1: "banded"}
        plan = _mem_plan(JM, estimates=est, strategies=strategies)
        before = _val(pkg, "adaptive.replan")
        with P.collect_scope() as col:
            if case == "own_actuals":
                plan.observe_actual(0, 1000, 16000)
                plan.observe_actual(1, 60_000, 960_000)
            elif case in ("broadcast", "unsplittable"):
                plan.observe_actual(0, 90_000, 1_440_000)
            else:
                plan.observe_actual(0, 50_000, 800_000)
            plan.observe_actual(0, 9, 9)  # once per bucket
            plan.observe_actual(7, 1, 1)  # an unknown bucket is ignored
            out = [plan.split_rows(0), plan.split_rows(1, splittable=case != "unsplittable"),
                   plan.split_rows(1)]
        got[pkg] = (out, dict(plan.observed), dict(plan.estimates), _switches(col),
                    _val(pkg, "adaptive.replan") - before)
    assert got["torch"] == got["jax"]
    if case == "correction":
        assert got["torch"][0][1] == TJM.derive_split_rows(1 << 20, 16.0)
        assert got["torch"][4] == 2  # bucket 0 by its own actuals, 1 by the correction


def _join_lake(root: str) -> str:
    rng = np.random.default_rng(7)
    n = 30_000
    _write(os.path.join(root, "l", "l.parquet"),
           {"k": rng.integers(0, 600, n), "p": rng.uniform(0, 100, n)})
    _write(os.path.join(root, "r", "r.parquet"),
           {"rk": np.arange(500), "w": rng.uniform(size=500)})
    return root


def test_join_flips_banded_to_split_under_planted_misestimate(tmp_path, monkeypatch):
    """Footer byte statistics planted 64x low under a quarter-MiB grant: the
    adaptive run flips later pairs banded→split with the JAX package's
    switches, parks no more than the static run, and keeps the static bits
    (the JAX package's device tier, as the port's, computes in float32)."""
    src = _join_lake(str(tmp_path / "lake"))
    monkeypatch.setenv("HYPERSPACE_JOIN_BROADCAST_ROWS", "10")
    monkeypatch.setenv("HYPERSPACE_DEVICE_BUDGET_MB", "0.25")
    monkeypatch.setenv("HYPERSPACE_PARK_WAIT_MS", "1")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "1")
    got = {}
    for pkg in PKGS:
        M, C, X, JM, P = (PKGS[pkg][k] for k in ("mod", "C", "X", "JM", "P"))
        s = _session(pkg, str(tmp_path / pkg), **{C.INDEX_NUM_BUCKETS: 4})
        hs = M.Hyperspace(s)
        hs.create_index(s.read.parquet(os.path.join(src, "l")),
                        M.CoveringIndexConfig("jl", ["k"], ["p"]))
        hs.create_index(s.read.parquet(os.path.join(src, "r")),
                        M.CoveringIndexConfig("jr", ["rk"], ["w"]))
        s.enable_hyperspace()
        if pkg == "jax":
            s.set_conf(C.EXEC_TPU_ENABLED, True)
        real = JM._bucket_estimates
        monkeypatch.setattr(JM, "_bucket_estimates",
                            lambda side, b, real=real: (real(side, b)[0], real(side, b)[1] / 64.0))
        PKGS[pkg]["B"].reset_device_budget()

        def q():
            lhs = s.read.parquet(os.path.join(src, "l")).select("k", "p")
            rhs = s.read.parquet(os.path.join(src, "r")).select("rk", "w")
            return lhs.join(rhs, X.col("k") == X.col("rk")).group_by("k").agg(
                X.Count(X.lit(1)).alias("n"), X.Min(X.col("p")).alias("lo"),
                X.Max(X.col("p")).alias("hi")).sort("k")

        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0")
        parks0 = _val(pkg, "join.spill.parks")
        off = _bits(q().collect().to_pydict())
        parks_static = _val(pkg, "join.spill.parks") - parks0
        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "1")
        replans0, parks0 = _val(pkg, "adaptive.replan"), _val(pkg, "join.spill.parks")
        with P.collect_scope() as col:
            on = _bits(q().collect().to_pydict())
        replans = _val(pkg, "adaptive.replan") - replans0
        assert on == off
        assert replans > 0
        assert _val(pkg, "join.spill.parks") - parks0 <= parks_static
        got[pkg] = (on, [(w["site"], w["from"], w["to"], w["index"], w["at"])
                         for w in _switches(col)], replans)
    assert got["torch"] == got["jax"]


# --- site 3: scan abort-and-replan -------------------------------------------------------

N, N_FILES, RGS = 12_000, 4, 512


def _events(i: int, n_per: int, base: int) -> dict:
    rng = np.random.default_rng(100 + i)
    return {
        "ev_k": np.arange(base, base + n_per, dtype=np.int64),
        "ev_id": np.arange(10_000_000 + base, 10_000_000 + base + n_per, dtype=np.int64),
        "ev_cat": [f"c{(base + j) % 3}" for j in range(n_per)],
        "ev_v": rng.uniform(0, 1, n_per),
    }


@pytest.fixture()
def scan_lake(tmp_path, monkeypatch):
    """A covering index with sketch sidecars and several row groups per
    bucket, streamed in small chunks: where the abort monitor acts."""
    monkeypatch.setenv("HYPERSPACE_SKETCHES", "1")
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS", "1")
    for p in PKGS.values():
        monkeypatch.setattr(p["cov"], "INDEX_ROW_GROUP_SIZE", RGS)
    src = str(tmp_path / "events")
    per = N // N_FILES
    for i in range(N_FILES):
        _write(os.path.join(src, f"part-{i:02d}.parquet"), _events(i, per, i * per))
    return src


def _scan_session(pkg: str, ws: str, src: str):
    M, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
    s = _session(pkg, ws, device_tier=True, **{C.INDEX_NUM_BUCKETS: 2})
    M.Hyperspace(s).create_index(
        s.read.parquet(src), M.CoveringIndexConfig("ev_idx", ["ev_k"], ["ev_id", "ev_cat", "ev_v"]))
    s.enable_hyperspace()
    return s


def _agg_q(pkg: str, s, src: str):
    X = PKGS[pkg]["X"]
    return s.read.parquet(src).filter(X.col("ev_cat") == "c1").group_by("ev_cat").agg(
        X.Count(X.lit(1)).alias("n"), X.Min(X.col("ev_v")).alias("lo"),
        X.Max(X.col("ev_v")).alias("hi"))


def _raw_bits(pkg: str, s, src: str) -> str:
    s.disable_hyperspace()
    try:
        return _bits(_agg_q(pkg, s, src).collect().to_pydict())
    finally:
        s.enable_hyperspace()


def _tamper_ndv(ws: str) -> None:
    sides = sorted(glob.glob(os.path.join(ws, "indexes", "ev_idx", "**", "_sketch.*.json"),
                             recursive=True))
    assert sides, "the fixture writes sketch sidecars"
    for side in sides:
        with open(side) as f:
            raw = json.load(f)
        if "ev_cat" in raw.get("ndv", {}):
            raw["ndv"]["ev_cat"] = 10**9
            with open(side, "w") as f:
                json.dump(raw, f)


@pytest.mark.parametrize("trigger", ["abort_factor", "tampered_ndv", "verify"])
def test_scan_abort_replans_to_the_raw_bits(tmp_path, scan_lake, monkeypatch, trigger):
    got = {}
    for pkg in PKGS:
        A, P = PKGS[pkg]["A"], PKGS[pkg]["P"]
        ws = str(tmp_path / pkg)
        s = _scan_session(pkg, ws, scan_lake)
        raw = _raw_bits(pkg, s, scan_lake)
        if trigger == "tampered_ndv":
            _tamper_ndv(ws)
            if pkg == "jax":  # the port's cache keys on the file's mtime and size
                JSK._SIDECAR_CACHE.clear()
            monkeypatch.delenv("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", raising=False)
        else:
            monkeypatch.setenv("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", "0.1")
        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "verify" if trigger == "verify" else "1")
        c0 = {n: _val(pkg, n) for n in ("adaptive.abort", "adaptive.scan_replans",
                                       "adaptive.verified")}
        with P.collect_scope() as col:
            out = _agg_q(pkg, s, scan_lake).collect().to_pydict()
        deltas = {n: _val(pkg, n) - v for n, v in c0.items()}
        assert _bits(out) == raw
        assert deltas["adaptive.abort"] == deltas["adaptive.scan_replans"] == 1
        assert deltas["adaptive.verified"] == (1 if trigger == "verify" else 0)
        assert A.vetoed_indexes() == frozenset()
        sw = _switches(col)
        got[pkg] = (_bits(out), [(w["site"], w["from"], w["to"], w["index"], w["at"])
                                 for w in sw], [round(w["ratio"], 3) for w in sw])
        monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0")
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [("abort", "ev_idx", "replan", "ev_idx", 1)]


def test_scan_abort_disarmed_when_off(tmp_path, scan_lake, monkeypatch):
    s = _scan_session("torch", str(tmp_path / "torch"), scan_lake)
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE", "0")
    monkeypatch.setenv("HYPERSPACE_ADAPTIVE_ABORT_FACTOR", "0.1")
    before = _val("torch", "adaptive.abort")
    assert _bits(_agg_q("torch", s, scan_lake).collect().to_pydict()) == \
        _raw_bits("torch", s, scan_lake)
    assert _val("torch", "adaptive.abort") == before


@pytest.mark.parametrize("case", ["equal", "nan_payloads", "neg_zero", "f32_bit", "null_moved",
                                  "null_value_differs", "string", "int_value", "names", "dtype"])
def test_verify_comparison_equals_the_jax_packages(case):
    """The port's verify compares without building Python lists; on every
    case it says what the JAX package's ``.hex()`` comparison says."""
    from hyperspace_tpu.plan.pruning import _comparable as jcomparable

    nan2 = np.array([0x7FF8000000000001], dtype=np.uint64).view(np.float64)[0]

    def batches(Col, Batch):
        f = np.array([1.5, np.nan, 0.0, 2.25])
        valid = np.array([True, True, True, False])
        a = {"f": Col(f.copy(), "float64"), "g": Col(np.arange(4, dtype=np.float32), "float32"),
             "i": Col(np.arange(4, dtype=np.int64), "int64", valid.copy()),
             "s": Col(np.array([0, 1, 0, 1], dtype=np.int32), "string", None, ["x", "y"])}
        b = {k: Col(c.data.copy(), c.dtype, None if c.validity is None else c.validity.copy(),
                    c.dictionary) for k, c in a.items()}
        if case == "nan_payloads":
            b["f"].data[1] = nan2
        elif case == "neg_zero":
            b["f"].data[2] = -0.0
        elif case == "f32_bit":
            b["g"].data[3] = np.nextafter(np.float32(3), np.float32(4))
        elif case == "null_moved":
            b["i"].validity[:] = [True, True, False, True]
        elif case == "null_value_differs":
            b["i"].data[3] = 99  # under a null: not compared
        elif case == "string":
            # the same values under another dictionary
            b["s"] = Col(np.array([1, 0, 1, 0], dtype=np.int32), "string", None, ["y", "x"])
        elif case == "int_value":
            b["i"].data[0] = 7
        elif case == "names":
            b = {("j" if k == "i" else k): v for k, v in b.items()}
        elif case == "dtype":
            b["i"] = Col(b["i"].data.astype(np.int32), "int32", b["i"].validity)
        return Batch(a), Batch(b)

    ja, jb = batches(J.columnar.table.Column, JBatch)
    ta, tb = batches(TCol, TBatch)
    want = jcomparable(ja) == jcomparable(jb)
    assert TA.same_values(ta, tb) == want
    assert want == (case in ("equal", "nan_payloads", "null_value_differs", "string"))
