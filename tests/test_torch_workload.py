"""The workload plane, the port against the JAX package on the same inputs
(the counterpart of tests/test_workload.py).

- The journal: size-bound rotation and bounded retention, the torn tail of
  a crash between payload and newline (the ``workload.journal`` fault
  point) healed by the next process's first append and skipped by the
  reader, asynchronous appends landing after a flush.
- Off by default: with ``HYPERSPACE_WORKLOAD_DIR`` unset nothing is
  written, no drift series or ledger charge exists, and the query-log
  record has the same shape.
- The journal record: the same notes give each package a row with the
  same keys and the same ``workload`` block; done, failed and cancelled
  rows share one shape.
- The index utility ledger: the same index builds and queries (a lake of
  three files, two covering indexes of four buckets, one never applicable)
  give each package the same per-index queries, benefit bytes, pruned
  bytes and row groups, rules and maintenance actions, and the ledger's
  sums equal the ``workload.*`` counter deltas; persist, recover and
  recover-once; a result-cache hit credits the avoided index scan.
- Drift: the same latency and q-error series give the same transitions
  and regressions in both packages; the absolute floor; /healthz degrades
  while a regression stands.
- ``workload_report`` and ``index_report`` render the JAX package's
  strings for the same journal and ledger, modulo the journal directory.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
import hyperspace_tpu_torch as T
from hyperspace_tpu import constants as JC
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry import workload as jwl
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu.utils import faults as JF
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.serve.context import QueryContext
from hyperspace_tpu_torch.telemetry import attribution, workload
from hyperspace_tpu_torch.telemetry.attribution import PHASES, QueryStatsLedger
from hyperspace_tpu_torch.telemetry.index_ledger import INDEX_LEDGER, IndexUtilityLedger
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY
from hyperspace_tpu_torch.telemetry.workload import DRIFT, JOURNAL
from hyperspace_tpu_torch.utils import faults
from hyperspace_tpu_torch.utils.faults import InjectedCrash

PKGS = {"jax": {"mod": J, "C": JC, "X": JX, "wl": jwl, "reg": JREG, "faults": JF},
        "torch": {"mod": T, "C": TC, "X": TX, "wl": workload, "reg": REGISTRY,
                  "faults": faults}}
WL_COUNTERS = ("workload.index.applied", "workload.index.benefit_bytes",
               "workload.index.bytes_skipped", "workload.index.rowgroups_skipped",
               "workload.maintenance.actions")


def _reset_planes() -> None:
    for p in PKGS.values():
        mod = p["mod"]
        p["faults"].disarm()
        p["wl"].reset_for_testing()
        mod.telemetry.attribution.LEDGER.reset_for_testing()
        mod.serve.TENANTS.reset_for_testing()
        mod.serve.COST_MODEL.reset_for_testing()


@pytest.fixture(autouse=True)
def _pristine_workload(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_WORKLOAD_DIR", raising=False)
    _reset_planes()
    yield
    _reset_planes()


def _val(name: str, reg=REGISTRY) -> float:
    m = reg.get(name)
    return 0 if m is None else m.value


def _journal_on(monkeypatch, tmp_path, name="journal") -> str:
    d = str(tmp_path / name)
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_DIR", d)
    return d


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


class TestJournalDurability:
    def test_fault_point_registered(self):
        assert "workload.journal" in faults.POINTS

    def test_rotation_at_size_bound_and_retention(self, monkeypatch, tmp_path):
        _journal_on(monkeypatch, tmp_path)
        # ROTATE_MB clamps at 1024 bytes; ~420-byte records rotate every 3
        monkeypatch.setenv("HYPERSPACE_WORKLOAD_ROTATE_MB", "0")
        monkeypatch.setenv("HYPERSPACE_WORKLOAD_RETAIN", "2")
        for i in range(12):
            JOURNAL.append({"seq": i, "pad": "x" * 400})
        assert JOURNAL.state()["rotations"] >= 3
        rotated = [f for f in JOURNAL.files() if not f.endswith("workload.jsonl")]
        assert len(rotated) <= 2
        seqs = [r["seq"] for r in JOURNAL.load()]
        assert seqs == sorted(seqs) and seqs[-1] == 11 and len(seqs) < 12

    def test_torn_tail_crash_heal_and_skip(self, monkeypatch, tmp_path):
        d = _journal_on(monkeypatch, tmp_path)
        JOURNAL.append({"seq": 1})
        faults.arm("workload.journal:crash_after:n=1")
        with pytest.raises(InjectedCrash):
            JOURNAL.append({"seq": 2})
        faults.disarm()
        path = os.path.join(d, "workload.jsonl")
        assert not open(path, "rb").read().endswith(b"\n")
        JOURNAL.reset_for_testing()  # a restart: the first append heals
        JOURNAL.append({"seq": 3})
        assert [r["seq"] for r in JOURNAL.load()] == [1, 2, 3]
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"seq": 4, "trunca')
        torn_before = _val("workload.journal.torn_skipped")
        JOURNAL.reset_for_testing()
        JOURNAL.append({"seq": 5})
        assert [r["seq"] for r in JOURNAL.load()] == [1, 2, 3, 5]
        assert _val("workload.journal.torn_skipped") == torn_before + 1

    def test_async_submit_lands_after_flush(self, monkeypatch, tmp_path):
        _journal_on(monkeypatch, tmp_path)
        errors = _val("workload.journal.errors")
        for i in range(4):
            JOURNAL.submit({"seq": i})
        JOURNAL.flush()
        assert len(JOURNAL.load()) == 4
        assert _val("workload.journal.errors") == errors


# ---------------------------------------------------------------------------
# off by default
# ---------------------------------------------------------------------------


class TestDisabledInert:
    def test_no_writes_no_series_no_charges(self, tmp_path):
        assert not workload.enabled()
        rec_before = _val("workload.journal.records")
        led = QueryStatsLedger(window=4)
        s = led.begin(QueryContext(label="off"))
        with attribution.scope(s):
            workload.note_index_applied("idx", 1_000_000)
            workload.note_prune("idx", "bucket", "k:*", 500, 2)
            workload.note_candidate_reject(["idx"], "NO_APPLICABLE")
        rec = led.finish(s, "done")
        workload.observe_qerror("rows", 7.0)
        workload.charge_maintenance("/x/idx", "CreateAction", 0.5)
        assert _val("workload.journal.records") == rec_before
        assert JOURNAL.state() == {"enabled": False, "dir": None, "writes": 0,
                                   "rotations": 0, "current_bytes": 0, "files": 0}
        assert DRIFT.snapshot()["series"] == 0
        assert INDEX_LEDGER.totals()["queries"] == 0
        assert INDEX_LEDGER.totals()["maintenance_actions"] == 0
        assert not list(tmp_path.iterdir())
        snap = workload.snapshot()
        assert snap["enabled"] is False and snap["indexes"] == []
        assert workload.healthz_reasons() == []
        assert "workload" not in rec and s.workload_notes() == {}

    def test_report_strings_name_the_knob(self):
        from hyperspace_tpu_torch.analysis.explain import index_report_string

        assert workload.workload_report_string() == jwl.workload_report_string()
        assert "HYPERSPACE_WORKLOAD_DIR" in workload.workload_report_string()
        assert "HYPERSPACE_WORKLOAD_DIR" in index_report_string()


# ---------------------------------------------------------------------------
# the journal record
# ---------------------------------------------------------------------------


def _noted_rows(pkg: str, monkeypatch, tmp_path) -> list:
    mod, wl = PKGS[pkg]["mod"], PKGS[pkg]["wl"]
    _journal_on(monkeypatch, tmp_path, f"journal-{pkg}")
    attr = mod.telemetry.attribution
    led = attr.QueryStatsLedger(window=8)
    s = led.begin(mod.serve.QueryContext(label="q"))
    with attr.scope(s):
        wl.note_index_applied("idx_a", 1_000_000)
        wl.note_index_applied("idx_a", 2_000_000, rule="ResultCacheHit")
        wl.note_prune("idx_a", "bucket", "ev_k:*", 500, 0)
        wl.note_prune("idx_a", "sketch", "", 200, 3)
        wl.note_candidate_reject(["idx_b"], "NO_COMMON_KEYS")
        wl.observe_qerror("rows", 2.0)
    led.finish(s, "done")
    led.finish(led.begin(mod.serve.QueryContext(label="f")), "failed")
    led.record_unrun(mod.serve.QueryContext(label="c"))
    wl.JOURNAL.flush()
    # the appends run on the shared IO pool, so rows land in any order
    rows = sorted(wl.JOURNAL.load(), key=lambda r: r["seq"])
    for r in rows:  # the fields that name a run, not what it did
        for k in ("seq", "query_id", "started_s", "total_ms", "error"):
            r.pop(k)
    return rows


def test_journal_rows_equal_the_jax_packages(monkeypatch, tmp_path):
    j = _noted_rows("jax", monkeypatch, tmp_path)
    t = _noted_rows("torch", monkeypatch, tmp_path)
    assert t == j
    assert [r["outcome"] for r in t] == ["done", "failed", "cancelled"]
    assert len({frozenset(r) for r in t}) == 1  # one shape for every outcome
    done = t[0]
    assert tuple(done["phases_ms"]) == PHASES
    assert done["workload"]["chosen"] == [{"index": "idx_a", "rule": "ResultCacheHit",
                                           "raw_bytes": 2_000_000,
                                           "prune_kind": "bucket+sketch"}]
    assert {"index": "idx_b", "code": "NO_COMMON_KEYS"} in done["workload"]["candidates"]
    assert done["workload"]["adaptive"] == []


# ---------------------------------------------------------------------------
# the index utility ledger over real index builds and queries
# ---------------------------------------------------------------------------


def _lake(root) -> str:
    src = os.path.join(str(root), "events")
    os.makedirs(src, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(3):
        n = 1500 + 100 * i
        pq.write_table(pa.table({"k": rng.integers(0, 40, n), "v": rng.integers(0, 1000, n),
                                 "w": rng.random(n)}),
                       os.path.join(src, f"part{i}.parquet"), row_group_size=256)
        os.utime(os.path.join(src, f"part{i}.parquet"), ns=(1_700_000_000 * 10**9,) * 2)
    return src


def _utility(pkg: str, monkeypatch, tmp_path) -> dict:
    """Two index builds and five queries in one package, the plane on."""
    p = PKGS[pkg]
    mod, C, X, wl, reg = p["mod"], p["C"], p["X"], p["wl"], p["reg"]
    _journal_on(monkeypatch, tmp_path, f"journal-{pkg}")
    before = {n: _val(n, reg) for n in WL_COUNTERS}
    root = tmp_path / pkg
    src = _lake(root)
    conf = {C.INDEX_NUM_BUCKETS: 4}
    if pkg == "torch":
        session = mod.HyperspaceSession(str(root / "wh"), conf=conf, device="cpu")
    else:  # both device tiers on, as tests/test_torch_telemetry.py runs them
        session = mod.HyperspaceSession(str(root / "wh"), conf={**conf,
                                                                C.EXEC_TPU_ENABLED: True})
    hs = mod.Hyperspace(session)
    df = session.read.parquet(src)
    hs.create_index(df, mod.CoveringIndexConfig("ev_k", ["k"], ["v", "w"]))
    hs.create_index(df, mod.CoveringIndexConfig("ev_w", ["w"], ["v"]))
    session.enable_hyperspace()
    outs = []
    for bound in (3, 7, 7, 21):
        q = session.read.parquet(src).filter(X.col("k") == bound).select("k", "v")
        outs.append(sorted(q.collect().to_pydict()["v"]))
    grouped = session.read.parquet(src).filter(X.col("k") < 5).group_by("k").agg(
        X.Sum(X.col("v")).alias("sv")).sort("k")
    outs.append(grouped.collect().to_pydict())
    wl.JOURNAL.flush()
    rows = [{k: v for k, v in r.items() if k not in ("maintenance_s", "net_utility_s",
                                                     "last_used_s", "last_used_seq")}
            for r in wl.INDEX_LEDGER.report()]
    totals = wl.INDEX_LEDGER.totals()
    totals.pop("maintenance_s")
    deltas = {n: _val(n, reg) - before[n] for n in WL_COUNTERS}
    jrows = sorted(wl.JOURNAL.load(), key=lambda r: r["seq"])  # pool-written rows
    return {"rows": rows, "totals": totals, "deltas": deltas, "outs": outs,
            "cold": wl.INDEX_LEDGER.cold_candidates(),
            "journal": [(r["label"], r["outcome"], r["workload"]["chosen"],
                         sorted(r["workload"]["shapes"]), r["workload"]["pruned"])
                        for r in jrows]}


def test_index_utility_equals_the_jax_packages(monkeypatch, tmp_path):
    j = _utility("jax", monkeypatch, tmp_path)
    t = _utility("torch", monkeypatch, tmp_path)
    assert t["outs"][:4] == j["outs"][:4]
    assert t["journal"] == j["journal"]
    assert t["rows"] == j["rows"]
    assert t["totals"] == j["totals"]
    # never applied: cold in both (a used index is cold too while its
    # create's wall time, which differs per package, outweighs its benefit)
    assert "ev_w" in t["cold"] and "ev_w" in j["cold"]
    assert t["deltas"] == j["deltas"]
    row = {r["name"]: r for r in t["rows"]}
    assert row["ev_k"]["queries"] == 5 and row["ev_k"]["benefit_bytes"] > 0
    assert row["ev_k"]["bytes_skipped"] > 0
    assert row["ev_k"]["maintenance_actions"] == {"create": 1}
    assert row["ev_w"]["queries"] == 0
    # the ledger's sums are the global counters' deltas
    assert t["deltas"]["workload.index.applied"] == t["totals"]["queries"]
    assert t["deltas"]["workload.index.bytes_skipped"] == t["totals"]["bytes_skipped"]
    assert t["deltas"]["workload.index.rowgroups_skipped"] == t["totals"]["rowgroups_skipped"]
    assert t["deltas"]["workload.index.benefit_bytes"] == pytest.approx(
        t["totals"]["benefit_bytes"], abs=0.01)
    assert t["deltas"]["workload.maintenance.actions"] == t["totals"]["maintenance_actions"]


def test_benefit_is_counterfactual_minus_actual_share(monkeypatch, tmp_path):
    _journal_on(monkeypatch, tmp_path)
    led = QueryStatsLedger(window=8)
    s = led.begin(QueryContext(label="q"))
    with attribution.scope(s):
        workload.note_index_applied("idx_a", 1_000_000)
        REGISTRY.counter("io.bytes_decoded").inc(400_000)
    led.finish(s, "done")
    row = next(r for r in INDEX_LEDGER.report() if r["name"] == "idx_a")
    assert row["benefit_bytes"] == pytest.approx(600_000, abs=1)
    assert row["queries"] == 1 and row["rules"] == {"rewrite": 1}


def test_result_cache_hit_credits_the_avoided_scan(monkeypatch, tmp_path):
    from hyperspace_tpu_torch.cache.result_cache import RESULT_CACHE

    _journal_on(monkeypatch, tmp_path, "wl")
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "1")
    RESULT_CACHE.clear()
    src = _lake(tmp_path)
    session = T.HyperspaceSession(str(tmp_path / "wh"), conf={TC.INDEX_NUM_BUCKETS: 4},
                                  device="cpu")
    hs = T.Hyperspace(session)
    hs.create_index(session.read.parquet(src), T.CoveringIndexConfig("evc_idx", ["k"], ["v"]))
    session.enable_hyperspace()
    try:
        df = session.read.parquet(src)
        hits = _val("cache.result.hits")
        q = lambda: df.filter(TX.col("k") == 7).agg(TX.Count(TX.lit(1)).alias("n"))  # noqa: E731
        assert q().collect().to_pydict() == q().collect().to_pydict()
        assert _val("cache.result.hits") == hits + 1
    finally:
        RESULT_CACHE.clear()
    row = next(r for r in INDEX_LEDGER.report() if r["name"] == "evc_idx")
    assert row["rules"].get("ResultCacheHit", 0) >= 1


class TestUtilityLedger:
    @staticmethod
    def _ledgers():
        return {"jax": jwl.INDEX_LEDGER.__class__(), "torch": IndexUtilityLedger()}

    def test_used_ranks_above_never_applied(self):
        reports = {}
        for pkg, led in self._ledgers().items():
            led.charge_query("used", benefit_bytes=2e9, seq=5, when_s=100.0)
            led.charge_prune("used", bytes_skipped=1e6, rowgroups_skipped=3)
            led.charge_maintenance("used", "create", 0.01)
            led.charge_maintenance("unused", "create", 0.01)
            reports[pkg] = (led.report(), led.cold_candidates(), led.totals())
        assert reports["torch"] == reports["jax"]
        report, cold, _ = reports["torch"]
        assert [r["name"] for r in report] == ["used", "unused"] and cold == ["unused"]
        assert report[0]["net_utility_s"] > 0 and report[0]["last_used_seq"] == 5

    def test_persist_recover_round_trip(self, tmp_path):
        d = str(tmp_path)
        led = IndexUtilityLedger()
        led.charge_query("a", benefit_bytes=10.0, seq=1, when_s=1.0)
        led.charge_maintenance("b", "compact", 0.5)
        path = led.persist(d)
        assert not os.path.exists(path + ".tmp")  # tmp + rename
        fresh = IndexUtilityLedger()
        assert fresh.recover(d) == 2
        assert fresh.totals() == led.totals()
        # the JAX package reads the port's file to the same ledger
        other = jwl.INDEX_LEDGER.__class__()
        assert other.recover(d) == 2 and other.report() == fresh.report()
        fresh.charge_query("a", benefit_bytes=5.0, seq=2, when_s=2.0)
        fresh.recover(d)  # recovery is a floor: live numbers are kept
        assert fresh.totals()["queries"] == 2

    def test_maybe_recover_runs_once(self, tmp_path):
        d = str(tmp_path)
        led = IndexUtilityLedger()
        led.charge_query("a", benefit_bytes=10.0, seq=1, when_s=1.0)
        led.persist(d)
        fresh = IndexUtilityLedger()
        fresh.maybe_recover(d)
        assert fresh.totals()["queries"] == 1
        led.charge_query("a", benefit_bytes=10.0, seq=2, when_s=2.0)
        led.persist(d)
        fresh.maybe_recover(d)  # once: no re-read
        assert fresh.totals()["queries"] == 1


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------


@pytest.fixture()
def drift_knobs(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_BASELINE", "4")
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_WINDOW", "4")
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_DRIFT_MIN", "4")
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_DRIFT_FACTOR", "2.0")
    monkeypatch.setenv("HYPERSPACE_WORKLOAD_DRIFT_ABS_MS", "1.0")


_SERIES = (
    [("latency", "slowed", v) for v in [10.0] * 4 + [100.0] * 8 + [10.0] * 4 + [100.0] * 4]
    + [("latency", "stable", 10.0)] * 10
    + [("latency", "tiny", v) for v in [0.01] * 4 + [0.05] * 4]
    + [("estimator", "rows", q) for q in [1.5] * 4 + [8.0] * 4]
)


def test_drift_transitions_equal_the_jax_packages(drift_knobs):
    got = {}
    for pkg in PKGS:
        reg = PKGS[pkg]["reg"]
        det = PKGS[pkg]["wl"].DriftDetector()
        names = ("workload.drift.latency", "workload.drift.estimator",
                 "workload.drift.checks")
        before = {n: _val(n, reg) for n in names}
        trail = []
        for kind, key, v in _SERIES:
            (det.observe_latency if kind == "latency" else det.observe_qerror)(key, v)
            trail.append(tuple((r["kind"], r["key"]) for r in det.regressions()))
        got[pkg] = {"trail": trail, "final": det.regressions(), "snapshot": det.snapshot(),
                    "counters": {n: _val(n, reg) - before[n] for n in names}}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["counters"] == {"workload.drift.latency": 2, "workload.drift.estimator": 1,
                             "workload.drift.checks": len(_SERIES)}
    assert [(r["kind"], r["key"]) for r in t["final"]] == [("estimator", "rows"),
                                                           ("latency", "slowed")]
    assert ("latency", "tiny") not in {x for step in t["trail"] for x in step}


def test_healthz_degrades_on_drift(monkeypatch, tmp_path, drift_knobs):
    from hyperspace_tpu_torch.telemetry import exporter

    _journal_on(monkeypatch, tmp_path)
    for v in [10.0] * 4 + [100.0] * 4:
        DRIFT.observe_latency("served_q", v)
    payload, status = exporter.health_dict()
    assert status == 503 and payload["status"] == "degraded"
    assert "workload_drift:latency:served_q" in payload["reasons"]
    monkeypatch.delenv("HYPERSPACE_WORKLOAD_DIR")
    payload, status = exporter.health_dict()
    assert status == 200 and payload["reasons"] == []


# ---------------------------------------------------------------------------
# the report strings
# ---------------------------------------------------------------------------


def _reports(pkg: str, monkeypatch, tmp_path, drift_knobs) -> tuple:
    mod, wl = PKGS[pkg]["mod"], PKGS[pkg]["wl"]
    d = _journal_on(monkeypatch, tmp_path, f"journal-{pkg}")
    for i, (label, outcome) in enumerate([("q6", "done"), ("q6", "done"), ("q1", "failed"),
                                          ("lookup", "done")]):
        wl.JOURNAL.append({"v": 1, "seq": i, "label": label, "outcome": outcome,
                           "workload": {"shapes": ["l_orderkey:eq"] if label == "lookup"
                                        else ["l_shipdate:range"]}})
    for v in [10.0] * 4 + [100.0] * 4:
        wl.DRIFT.observe_latency("q6", v)
    wl.INDEX_LEDGER.charge_query("li_shipdate_z", 3e8, seq=9, when_s=0.0, rule="rewrite")
    wl.INDEX_LEDGER.charge_prune("li_shipdate_z", bytes_skipped=2e6, rowgroups_skipped=7)
    wl.INDEX_LEDGER.charge_maintenance("li_shipdate_z", "create", 1.5)
    wl.INDEX_LEDGER.charge_maintenance("li_never", "create", 0.25)
    hs = mod.Hyperspace.__new__(mod.Hyperspace)  # the views read no session
    captured = []
    assert hs.index_report(redirect=captured.append) is None
    return (hs.workload_report().replace(d, "<dir>"), captured[0])


def test_report_strings_equal_the_jax_packages(monkeypatch, tmp_path, drift_knobs):
    j = _reports("jax", monkeypatch, tmp_path, drift_knobs)
    t = _reports("torch", monkeypatch, tmp_path, drift_knobs)
    assert t == j
    wl_report, idx_report = t
    assert wl_report.splitlines()[0] == "== Workload intelligence =="
    assert "REGRESSION latency:q6" in wl_report
    assert "top shapes: l_shipdate:range x3, l_orderkey:eq x1" in wl_report
    assert idx_report.splitlines()[0] == "== Index utility ledger =="
    assert "cold candidates: li_never" in idx_report
