"""The port's gates (hyperspace_tpu_torch/tools/) at a small size on the
CPU, held to the reference's tools where both run:

- the chaos query sweep over the TPC-H queries at 6,000 lineitem rows:
  each ``io.*`` spec's outcome (hits fired, runs bit for bit the clean
  run, typed errors) equals the JAX tool's loop over the same spec and
  lake; each ``device.*`` and ``kernel.compile`` spec fires and gives a
  typed error or the clean bits (the JAX package degrades those faults to
  the host through its breaker, which the port does not have: there the
  port's outcome is the typed error);
- one crash-matrix cell per maintenance action, recovered clean and equal
  to its never-crashed twin;
- race_stress with 4 threads;
- trace_report over a port trace renders the span tree (and the
  aggregate table) the reference's tool renders over the JAX package's
  trace of the same query, timings and plan ids masked;
- the reference's tools/hs_top.py renders a snapshot-sink JSONL written
  by the port's exporter, which has no breaker block."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.telemetry import trace as jtrace
from hyperspace_tpu.utils import device_cache as jdc
from hyperspace_tpu.utils import faults as jfaults
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.telemetry import trace as ttrace
from hyperspace_tpu_torch.tools import _common, chaos_stress, race_stress, trace_report
from hyperspace_tpu_torch.tools._common import bits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 6_000
IO_SPECS = [s for s in chaos_stress.QUERY_SPECS if s.startswith("io.")]
DEVICE_SPECS = [s for s in chaos_stress.QUERY_SPECS if not s.startswith("io.")]


@pytest.fixture(scope="module")
def port_sweep(tmp_path_factory):
    return chaos_stress.query_sweep("cpu", str(tmp_path_factory.mktemp("port_chaos")), ROWS)


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """The JAX tool's sweep loop (tools/chaos_stress.py) over the io specs,
    with the device tier on, each spec starting with cold chunk and column
    caches."""
    ws = str(tmp_path_factory.mktemp("jax_chaos"))
    jtpch.generate_tpch(ws, rows_lineitem=ROWS, seed=_common.TPCH_SEED)
    s = J.HyperspaceSession(warehouse_dir=ws)
    s.set_conf(JC.INDEX_NUM_BUCKETS, _common.TPCH_BUCKETS)
    s.set_conf(JC.EXEC_TPU_ENABLED, True)
    jtpch.tpch_indexes(s, J.Hyperspace(s), ws)
    s.enable_hyperspace()
    names = list(jtpch.TPCH_QUERIES)
    clean = {n: bits(jtpch.TPCH_QUERIES[n](s, ws).to_pydict()) for n in names}
    out = {}
    for spec in IO_SPECS:
        for cache in (jio._INDEX_CHUNK_CACHE, jio._SOURCE_COL_CACHE, jio._ROWGROUP_STATS_CACHE,
                      jdc.DEVICE_CACHE, jdc.HOST_DERIVED_CACHE):
            cache.clear()
        jfaults.arm(spec)
        outcome = {"identical": 0, "typed_error": 0}
        try:
            for n in names:
                try:
                    got = bits(jtpch.TPCH_QUERIES[n](s, ws).to_pydict())
                except JError:
                    outcome["typed_error"] += 1
                    continue
                assert got == clean[n], (spec, n)
                outcome["identical"] += 1
        finally:
            fired = sum(r["fired"] for r in jfaults.snapshot())
            jfaults.disarm()
        out[spec] = {"spec": spec, "fired": fired, **outcome}
    return out


@pytest.mark.parametrize("spec", IO_SPECS)
def test_io_fault_outcome_equals_the_jax_tools(port_sweep, jax_sweep, spec):
    got = {r["spec"]: r for r in port_sweep["query_sweep"]}[spec]
    assert got == jax_sweep[spec]
    assert not [f for f in port_sweep["failures"] if spec in f]


@pytest.mark.parametrize("spec", DEVICE_SPECS)
def test_device_fault_is_typed_or_bit_identical(port_sweep, spec):
    got = {r["spec"]: r for r in port_sweep["query_sweep"]}[spec]
    assert got["fired"] > 0
    assert got["identical"] + got["typed_error"] == len(ttpch.TPCH_QUERIES)
    # no breaker: the faulted query ends with its typed error
    assert got["typed_error"] >= 1
    assert not [f for f in port_sweep["failures"] if spec in f]


def test_sweep_leaves_every_cache_consistent(port_sweep):
    assert port_sweep["failures"] == []
    assert all(port_sweep["cache_consistency"].values())


CRASH_CELLS = [
    ("create", "data.publish:crash_after:n=1"),
    ("refresh", "log.write:crash_before:n=2"),
    ("optimize", "data.publish:crash_before:n=1"),
    ("delete", "log.write:crash_after:n=1"),
    ("append", "ingest.append:crash_after:n=1"),
    ("compact", "ingest.compact:crash_before:n=1"),
]


@pytest.mark.parametrize("action,spec", CRASH_CELLS, ids=[a for a, _ in CRASH_CELLS])
def test_crash_cell_recovers_clean_and_converges(tmp_path, monkeypatch, action, spec):
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "1")
    out = chaos_stress.crash_matrix("cpu", str(tmp_path), 500, matrix=[(action, [spec])])
    assert out["failures"] == []
    (cell,) = out["crash_matrix"]
    assert cell == {"action": action, "spec": spec, "fired": 1, "crashed": True,
                    "recovered_clean": True, "identical": True}


def test_race_stress_is_bit_identical_with_no_violation(tmp_path):
    out = race_stress.run("cpu", threads=4, repeats=1, rows=10_000, workdir=str(tmp_path))
    assert out["ok"], out
    assert out["runs"] == 4 * len(ttpch.TPCH_QUERIES) and out["lock_acquisitions"] > 0


# ---------------------------------------------------------------------------
# trace_report and hs_top
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """A JSONL trace of warm q6 and q1 from each package over one lake."""
    tmp = tmp_path_factory.mktemp("traces")
    lake = str(tmp / "lake")
    jtpch.generate_tpch(lake, rows_lineitem=20_000, seed=42)
    js = J.HyperspaceSession(str(tmp / "jwh"))
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    jtpch.tpch_indexes(js, J.Hyperspace(js), lake)
    ts = T.HyperspaceSession(str(tmp / "twh"), device="cpu")
    ttpch.tpch_indexes(ts, T.Hyperspace(ts), lake)
    out = {}
    for q in ("q6", "q1"):
        for pkg, s, tp, tr in (("jax", js, jtpch, jtrace), ("torch", ts, ttpch, ttrace)):
            s.enable_hyperspace()
            tp.TPCH_QUERIES[q](s, lake).collect()  # warm: no upload or compile span
            path = str(tmp / f"{pkg}_{q}.jsonl")
            tr.enable(tr.JsonlTraceSink(path))
            try:
                tp.TPCH_QUERIES[q](s, lake).collect()
            finally:
                tr.disable()
            out[(pkg, q)] = path
    return out


def _reference_report():
    spec = importlib.util.spec_from_file_location("reference_trace_report",
                                                  os.path.join(REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _render(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _reference_render(argv) -> str:
    ref = _reference_report()

    def main(args):
        saved = sys.argv
        sys.argv = ["trace_report.py", *args]
        try:
            ref.main()
        finally:
            sys.argv = saved

    return _render(main, argv)


def _masked(text: str) -> str:
    """Timings (span durations and ``*_ms``/``*_s`` attributes) and plan
    ids (each process's own counter) masked."""
    text = re.sub(r"\d+\.\d+ ms", "<ms>", text)
    text = re.sub(r"(_ms|_s)=[\d.e-]+", r"\1=<t>", text)
    return re.sub(r"plan_id=\d+", "plan_id=<id>", text)


def _agg_rows(text: str) -> list:
    """--agg's rows less the timing columns (total_ms, max_ms), sorted
    by span name: the table orders them by time."""
    rows = []
    for line in text.splitlines()[2:]:
        name, count, _total, _max, *rest = line.split()
        rows.append((name, count, *rest))
    return sorted(rows)


@pytest.mark.parametrize("q", ["q6", "q1"])
def test_trace_report_renders_the_references_tree(traces, q):
    want = _reference_render([traces[("jax", q)]])
    got = _render(trace_report.main, [traces[("torch", q)]])
    assert "exec:Aggregate" in got and "rule:ApplyHyperspace" in got
    assert _masked(got) == _masked(want)
    agg = ["--agg"]
    assert _agg_rows(_render(trace_report.main, [traces[("torch", q)], *agg])) == _agg_rows(
        _reference_render([traces[("jax", q)], *agg]))


def test_hs_top_renders_the_ports_snapshot_sink(tmp_path):
    from hyperspace_tpu_torch import serve
    from hyperspace_tpu_torch.telemetry import exporter

    lake = str(tmp_path / "lake")
    ttpch.generate_tpch(lake, rows_lineitem=5_000, seed=42)
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    ttpch.tpch_indexes(s, T.Hyperspace(s), lake)
    s.enable_hyperspace()
    sched = serve.QueryScheduler(max_concurrent=2, queue_depth=8)
    try:
        handles = [sched.submit_query(ttpch.TPCH_QUERIES[q](s, lake)) for q in ("q6", "q1", "q6")]
        for h in handles:
            h.result(timeout=120)
        path = str(tmp_path / "snapshots.jsonl")
        assert exporter.start_snapshot_sink(path, interval_s=60) is not None
    finally:
        exporter.stop_snapshot_sink()  # writes the final snapshot
        sched.shutdown()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "hs_top.py"), "--file", path],
                         capture_output=True, text=True, timeout=60, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "breaker=?" in out.stdout  # the port's snapshot has no breaker block
    assert "hs_top @" in out.stdout
