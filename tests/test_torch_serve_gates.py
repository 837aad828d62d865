"""The port's serving-plane gates serve_smoke, qos_smoke and
plan_stats_smoke (hyperspace_tpu_torch/tools/) at a small size on the
CPU, held to the JAX package on the same seeded lakes:

- each gate's ``run()`` is ok: every served result equals the serial one
  bit for bit, each kernel-shaped query counted its kernel's plain version
  on the scheduler worker that served it, from at least two workers;
  conservation, quiescence, the scraper and the lock audit hold;
- the serial results of every served query (the TPC-H set and the
  kernel-shaped forms q6_count, q6_sum, q1_sums) equal the JAX package's
  over the same lake: counts and keys exact, f32 sums within relative
  1e-4; so do plan_stats_smoke's plain sections;
- qos_smoke's typed rejections and their ``serve.tenant.rejected.*``
  deltas equal the JAX package's for the same exercise;
- ``explain_analyze`` of plan_stats_smoke's pruned point query renders
  what the JAX package renders, timings masked (the covering-index scan's
  own rows are the named exception of tests/test_torch_plan_stats.py);
- the port's Prometheus parser returns the reference tool's errors
  (``tools/serve_smoke._parse_prometheus``) on a clean and a corrupted
  /metrics body."""

import importlib.util
import os
import re
import threading

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.plan.expr import Count as JCount, Sum as JSum, col as jcol, lit as jlit
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu_torch.telemetry import exporter
from hyperspace_tpu_torch.tools import _common, plan_stats_smoke, qos_smoke, serve_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 5_000
REL = 1e-4


def _jax_kernel_forms():
    """The JAX package's forms of the port's kernel-shaped queries."""

    def lineitem(s, root):
        return s.read.parquet(os.path.join(root, "lineitem"))

    def pred():
        return ((jcol("l_shipdate") >= 8766) & (jcol("l_shipdate") < 9131)
                & (jcol("l_discount") >= 0.05) & (jcol("l_discount") <= 0.07)
                & (jcol("l_quantity") < 24))

    def q6_count(s, root):
        return lineitem(s, root).filter(pred()).agg(
            JSum(jcol("l_extendedprice") * jcol("l_discount")).alias("revenue"),
            JCount(jlit(1)).alias("count"))

    def q6_sum(s, root):
        return lineitem(s, root).filter(pred()).agg(
            JSum(jcol("l_extendedprice")).alias("sum_price"), JCount(jlit(1)).alias("count"))

    def q1_sums(s, root):
        return (lineitem(s, root).filter(jcol("l_shipdate") <= 10470)
                .select("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount")
                .group_by("l_returnflag", "l_linestatus")
                .agg(JSum(jcol("l_quantity")).alias("sum_qty"),
                     JSum(jcol("l_extendedprice")).alias("sum_base_price"),
                     JSum(jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount")))
                     .alias("sum_disc_price"),
                     JCount(jlit(1)).alias("count_order"))
                .sort("l_returnflag", "l_linestatus"))

    return {"q6_count": q6_count, "q6_sum": q6_sum, "q1_sums": q1_sums}


JAX_SERVED = {**jtpch.TPCH_QUERIES, **_jax_kernel_forms()}


def _jax_results(root: str, seed: int) -> dict:
    """The JAX package's answers to the served set over a lake made as the
    gate makes its own (same rows, seed and buckets, tpch_indexes)."""
    jtpch.generate_tpch(root, rows_lineitem=ROWS, seed=seed)
    s = J.HyperspaceSession(warehouse_dir=root)
    s.set_conf(JC.INDEX_NUM_BUCKETS, 8)
    s.set_conf(JC.EXEC_TPU_ENABLED, True)
    jtpch.tpch_indexes(s, J.Hyperspace(s), root)
    s.enable_hyperspace()
    return {q: fn(s, root).to_pydict() for q, fn in JAX_SERVED.items()}


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


@pytest.fixture(scope="module")
def serve_gate(tmp_path_factory):
    return serve_smoke.run("cpu", root=str(tmp_path_factory.mktemp("serve")), clients=3,
                           repeats=2, rows=ROWS)


# the fairness window: at the reference's 60 results the ratio is
# dominated by the first dispatches (every clock is 0, so one tenant's
# whole backlog starts first) and the in-flight tail, and the reference's
# own tools/qos_smoke.py exceeds 1.8 in about one run in ten at this size
# on the CPU; 180 results measure the same shares over a longer window
# (the tolerance is the gate's own)
QOS_TARGET = 180


@pytest.fixture(scope="module")
def qos_gate(tmp_path_factory):
    return qos_smoke.run("cpu", root=str(tmp_path_factory.mktemp("qos")), rows=ROWS,
                         target=QOS_TARGET)


@pytest.fixture(scope="module")
def plan_stats_gate(tmp_path_factory):
    return plan_stats_smoke.run("cpu", root=str(tmp_path_factory.mktemp("plan_stats")),
                                rows=ROWS)


# ---------------------------------------------------------------------------
# serve_smoke
# ---------------------------------------------------------------------------


def test_serve_gate_is_ok(serve_gate):
    out = serve_gate
    assert out["ok"], {k: v for k, v in out.items() if k != "results"}
    assert out["served_runs"] == 3 * 2 * len(serve_smoke.served_queries())
    assert out["wave_runs"] == 3 * 4
    assert out["exporter"]["ok"] and out["exporter"]["scrapes"]["metrics"] > 0
    for q, kernel in serve_smoke.KERNEL_QUERIES.items():
        per = out["kernels"]["queries"][q]
        assert per["runs"] == 3 * 2 + 4 and per["launched_runs"] == per["runs"], q
        assert len(out["kernels"]["threads_by_kernel"][kernel]) >= 2, q


@pytest.fixture(scope="module")
def serve_jax(tmp_path_factory):
    return _jax_results(str(tmp_path_factory.mktemp("serve_jax")), serve_smoke.SEED)


@pytest.mark.parametrize("q", list(JAX_SERVED))
def test_serve_serial_results_equal_the_jax_packages(serve_gate, serve_jax, q):
    assert_close(serve_gate["results"][q], serve_jax[q], q)


# ---------------------------------------------------------------------------
# qos_smoke
# ---------------------------------------------------------------------------


def test_qos_gate_is_ok(qos_gate):
    out = qos_gate
    assert out["ok"], {k: v for k, v in out.items() if k != "results"}
    assert out["fairness_ratio"] <= qos_smoke.FAIR_TOL and out["served"] >= QOS_TARGET
    assert set(out["tenants"]) == set(qos_smoke.WEIGHTS)
    assert all(t["done"] > 0 for t in out["tenants"].values())


@pytest.fixture(scope="module")
def qos_jax(tmp_path_factory):
    return _jax_results(str(tmp_path_factory.mktemp("qos_jax")), qos_smoke.SEED)


@pytest.mark.parametrize("q", list(JAX_SERVED))
def test_qos_serial_results_equal_the_jax_packages(qos_gate, qos_jax, q):
    assert_close(qos_gate["results"][q], qos_jax[q], q)


def _jax_rejections() -> tuple:
    """The reference qos_smoke's rejection exercise on the JAX package's
    scheduler: the typed outcomes and the counter deltas."""
    from hyperspace_tpu import serve as jserve
    from hyperspace_tpu.serve import qos as jqos
    from hyperspace_tpu.serve.tenant import TENANTS as JTENANTS, TenantQuotaExceeded

    def val(n):
        m = JREG.get(n)
        return 0 if m is None else int(m.value)

    kinds = ("rate", "quota", "deadline")
    before = {k: val(f"serve.tenant.rejected.{k}") for k in kinds}
    out = {"quota": False, "rate": False, "deadline": False, "quota_not_admission": False}
    sched = jserve.QueryScheduler(max_concurrent=4, queue_depth=64)
    try:
        JTENANTS.configure("capped", max_in_flight=1)
        gate = threading.Event()
        running = sched.submit(lambda: gate.wait(30), tenant="capped", label="capped-runner")
        try:
            sched.submit(lambda: 1, tenant="capped", label="capped-over")
        except TenantQuotaExceeded as e:
            out["quota"] = True
            out["quota_not_admission"] = not isinstance(e, jserve.AdmissionRejected)
        gate.set()
        running.result(30)
        JTENANTS.configure("ratey", rate_qps=0.001, burst=1)
        sched.submit(lambda: 1, tenant="ratey", label="ratey-1").result(30)
        try:
            sched.submit(lambda: 2, tenant="ratey", label="ratey-2")
        except TenantQuotaExceeded:
            out["rate"] = True
        jqos.COST_MODEL.update("deadline-probe", 0.5)
        try:
            sched.submit(lambda: 3, label="deadline-probe", deadline_s=0.001)
        except jserve.DeadlineUnmeetable:
            out["deadline"] = True
        sched.drain(timeout=60)
    finally:
        sched.shutdown(wait=True)
        JTENANTS.reset_for_testing()
    return out, {k: val(f"serve.tenant.rejected.{k}") - before[k] for k in kinds}


def test_qos_typed_rejections_equal_the_jax_packages(qos_gate):
    typed, counters = _jax_rejections()
    assert qos_gate["typed_rejections"] == typed
    assert qos_gate["tenant_rejection_counters"] == counters
    assert all(typed.values()) and counters == {"rate": 1, "quota": 1, "deadline": 1}


# ---------------------------------------------------------------------------
# plan_stats_smoke
# ---------------------------------------------------------------------------


def test_plan_stats_gate_is_ok(plan_stats_gate):
    out = plan_stats_gate
    assert out["ok"], {k: v for k, v in out.items() if k not in ("results", "report")}
    assert out["sections"] == 3 + len(jtpch.TPCH_QUERIES) and out["served_records"] == 4
    assert out["estimator_observations"] > 0 and out["qerror_conserved"]


@pytest.fixture(scope="module")
def plan_stats_jax(tmp_path_factory):
    """The plan_stats lake made by the JAX package (TPC-H at the gate's
    seed, the events table from the same generator) with ev_k_idx; the
    sections' results and the point query's EXPLAIN ANALYZE."""
    root = str(tmp_path_factory.mktemp("plan_stats_jax"))
    jtpch.generate_tpch(root, rows_lineitem=ROWS, seed=plan_stats_smoke.SEED)
    rng = np.random.default_rng(plan_stats_smoke.EVENT_SEED)
    per = plan_stats_smoke.event_rows(ROWS) // plan_stats_smoke.EVENT_FILES
    for i in range(plan_stats_smoke.EVENT_FILES):
        jio.write_parquet(JBatch.from_pydict({
            "ev_k": (np.arange(per, dtype=np.int64) + i * per).tolist(),
            "ev_q": rng.integers(1, 50, per).tolist(),
            "ev_v": rng.uniform(0, 100, per).tolist()}),
            os.path.join(root, "events", f"part-{i:02d}.parquet"))
    s = J.HyperspaceSession(warehouse_dir=root)
    s.set_conf(JC.INDEX_NUM_BUCKETS, plan_stats_smoke.BUCKETS)
    s.set_conf(JC.EXEC_TPU_ENABLED, True)
    hs = J.Hyperspace(s)
    ev = lambda: s.read.parquet(os.path.join(root, "events"))  # noqa: E731
    hs.create_index(ev(), J.CoveringIndexConfig("ev_k_idx", ["ev_k"], ["ev_q", "ev_v"]))
    s.enable_hyperspace()
    k = plan_stats_smoke.keys(ROWS)
    point = ev().filter(jcol("ev_k") == k["point"]).select("ev_k", "ev_q", "ev_v")
    results = {
        "point": point.to_pydict(),
        "range": ev().filter((jcol("ev_k") >= k["lo"]) & (jcol("ev_k") < k["hi"]))
        .select("ev_k", "ev_v").to_pydict(),
        "in": ev().filter(jcol("ev_k").isin([3, k["point"], k["last"]]))
        .select("ev_k", "ev_q").to_pydict(),
        **{q: fn(s, root).to_pydict() for q, fn in jtpch.TPCH_QUERIES.items()},
    }
    return {"results": results, "report": hs.explain_analyze(point)}


@pytest.mark.parametrize("section", ["point", "range", "in", *jtpch.TPCH_QUERIES])
def test_plan_stats_sections_equal_the_jax_packages(plan_stats_gate, plan_stats_jax, section):
    assert_close(plan_stats_gate["results"][section], plan_stats_jax["results"][section],
                 section)


def _masked_report(text: str) -> str:
    """The query's own part of an EXPLAIN ANALYZE (the process-wide
    accuracy block after it depends on what ran before), timings masked."""
    text = text.split("Estimator accuracy (process-wide)")[0]
    text = re.sub(r"wall=[\d.]+ms", "wall=<t>", text)
    text = re.sub(r"in [\d.]+ ms", "in <t> ms", text)
    return re.sub(r"plan_id=\d+", "plan_id=<id>", text)


_SCAN_ROWS = re.compile(r"(FileScan .*?\]  \[rows=)(\d+)")


def test_explain_analyze_renders_the_jax_packages(plan_stats_gate, plan_stats_jax):
    """Equal but for the covering-index scan's own rows, the named
    exception of tests/test_torch_plan_stats.py: the JAX package's scan
    applies the pushed filter as the parquet reader's filter, the port's
    reads its kept row groups unfiltered (plan/executor._exec_file_scan)
    and the Filter above it applies the condition; its rows are at least
    the JAX package's, and the Filter's rows are equal."""
    got = _masked_report(plan_stats_gate["report"])
    want = _masked_report(plan_stats_jax["report"])
    assert "rows=" in got and "bytes=" in got and "scan_fraction" in got and "q=" in got
    (g_rows,), (w_rows,) = ([int(m.group(2)) for m in _SCAN_ROWS.finditer(t)]
                            for t in (got, want))
    assert g_rows >= w_rows
    assert _SCAN_ROWS.sub(r"\1<scan>", got) == _SCAN_ROWS.sub(r"\1<scan>", want)


# ---------------------------------------------------------------------------
# the Prometheus parser
# ---------------------------------------------------------------------------


def _reference_parser():
    spec = importlib.util.spec_from_file_location("reference_serve_smoke",
                                                  os.path.join(REPO, "tools", "serve_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._parse_prometheus


def test_prometheus_parser_returns_the_reference_tools_errors(serve_gate):
    clean = exporter.prometheus_text()
    assert "_bucket{" in clean  # the served window registered histograms
    lines = clean.splitlines()
    bucket = next(i for i, ln in enumerate(lines) if '{le="' in ln and "+Inf" not in ln)
    corrupted = lines[:bucket] + [
        lines[bucket].rsplit(" ", 1)[0] + " 1e9",  # no longer cumulative
        "hyperspace_bad_metric not_a_number",
        "a_line_without_a_value",
    ] + [ln for ln in lines[bucket + 1:] if "+Inf" not in ln]
    reference = _reference_parser()
    for text in (clean, "\n".join(corrupted)):
        assert _common.parse_prometheus(text) == reference(text)
    assert _common.parse_prometheus(clean) == []
    errors = _common.parse_prometheus("\n".join(corrupted))
    assert any("not cumulative" in e for e in errors)
    assert any("missing +Inf" in e for e in errors)
    assert any("non-numeric" in e for e in errors) and any("unparseable" in e for e in errors)
