"""The port's plan statistics (EXPLAIN ANALYZE, the estimator-accuracy
ledger and estimator feedback) held against the JAX package on the same
inputs.

- An analyzed execution (the collector installed, as ``explain_analyze``
  installs it) gives ``collect()``'s bits, the same route and the same
  kernel calls, for every query of ``TPCH_QUERIES`` over the golden TPC-H
  fixture (2,000 lineitem rows, seed 7, built by the JAX package) and for
  pruned point, range and IN lookups over a bucketed index (8 buckets,
  8,000 rows in 4 files).
- The actual rows of each executed plan node equal the JAX package's for
  the same node (the plans render alike, so nodes pair by their preorder
  position), as do the routes it notes (both device tiers on), and the
  scan's files and bytes. One named exception: a covering-index scan on
  the host route. The JAX package's applies the pushed filter as the
  parquet reader's filter; the port's reads its kept row groups
  unfiltered, so that repeats get the chunk cache's same buffers for every
  predicate (plan/executor._exec_file_scan), and the Filter above it
  applies the condition. Its rows are then the kept row groups' rows, at
  least the JAX package's, and the Filter's rows are equal.
- The q-error, the correction factors and the snapshot of the accuracy
  ledger equal the JAX package's for the same observations.
- With ``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` a planted 8x misestimate of the
  bucket-pruned index re-ranks the filter rule's choice to the smaller
  index, as tests/test_plan_stats.py shows for the JAX package; off, it
  changes nothing, and the results stay the same either way.
"""

import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry import plan_stats as jps
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import pruning as tpr
from hyperspace_tpu_torch.telemetry import plan_stats as tps


def _bits(d: dict) -> str:
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger; the
    module empties it, and the accuracy ledgers it filled, when done."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()
    jps.ACCURACY.reset_for_testing()
    tps.ACCURACY.reset_for_testing()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from hyperspace_tpu.models.dataskipping import DataSkippingIndexConfig, MinMaxSketch

    root = str(tmp_path_factory.mktemp("tpch_plan_stats"))
    jtpch.generate_tpch(root, rows_lineitem=2000, seed=7)
    js = J.HyperspaceSession(warehouse_dir=root)
    hs = J.Hyperspace(js)
    jtpch.tpch_indexes(js, hs, root)
    hs.create_index(js.read.parquet(os.path.join(root, "lineitem")),
                    DataSkippingIndexConfig("li_ds_minmax", [MinMaxSketch("l_shipdate")]))
    js.enable_hyperspace()
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    return root, js, T.HyperspaceSession(root, device="cpu").enable_hyperspace()


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    """A bucketed covering index (k; q, v), 8 buckets, over 8,000 rows in
    4 files, built by the JAX package; both packages read it."""
    root = str(tmp_path_factory.mktemp("plan_stats_events"))
    rng = np.random.default_rng(5)
    n, n_files = 8000, 4
    per = n // n_files
    os.makedirs(os.path.join(root, "ev"))
    for i in range(n_files):
        pq.write_table(pa.table({"k": np.arange(per, dtype=np.int64) + i * per,
                                 "q": rng.integers(1, 50, per),
                                 "v": rng.uniform(0, 1, per)}),
                       os.path.join(root, "ev", f"part-{i}.parquet"))
    js = J.HyperspaceSession(warehouse_dir=root)
    js.set_conf(JC.INDEX_NUM_BUCKETS, 8)
    J.Hyperspace(js).create_index(js.read.parquet(os.path.join(root, "ev")),
                                  J.CoveringIndexConfig("k_idx", ["k"], ["q", "v"]))
    js.enable_hyperspace()
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    return root, js, T.HyperspaceSession(root, device="cpu").enable_hyperspace(), n


def _lookup(X, session, root, n, form):
    df = session.read.parquet(os.path.join(root, "ev"))
    if form == "point":
        return df.filter(X.col("k") == n // 2 + 3).select("k", "q", "v")
    if form == "range":
        return df.filter(X.col("k") < 100).select("k", "q")
    return df.filter(X.col("k").isin([5, 1234, 4321, 7777])).select("k", "v")


def _analyzed(plan_stats, df):
    with plan_stats.collect_scope() as col:
        out = df.collect().to_pydict()
    return out, col


def _plain_and_analyzed(df_fn):
    df_fn().collect()  # warm
    before = dict(K.PLAIN_CALLS)
    plain = df_fn().collect().to_pydict()
    plain_calls = {k: K.PLAIN_CALLS[k] - before[k] for k in before}
    before = dict(K.PLAIN_CALLS)
    analyzed, col = _analyzed(tps, df_fn())
    assert {k: K.PLAIN_CALLS[k] - before[k] for k in before} == plain_calls
    assert _bits(analyzed) == _bits(plain)
    return analyzed, col


def _per_node(col) -> list:
    """(kind, rows, route, files, bytes) of each plan node by preorder
    position; None for a node the run did not execute."""
    out = []
    for node in col.plan.preorder():
        ns = col.nodes.get(node.plan_id)
        out.append(None if ns is None or not ns.executed else
                   (node.kind, ns.rows_out, ns.route, ns.files_scanned, ns.bytes_scanned))
    return out


def _unfiltered_index_scan(node) -> bool:
    """The named exception: a covering-index scan with a pushed filter."""
    info = getattr(node, "index_info", None)
    return (node.kind == "FileScan" and node.pushed_filter is not None
            and info is not None and info.index_kind_abbr != "DS")


def _assert_nodes_match(tcol, jcol):
    assert tcol.plan.pretty() == jcol.plan.pretty()
    got, want = _per_node(tcol), _per_node(jcol)
    for i, node in enumerate(tcol.plan.preorder()):
        if got[i] is not None and want[i] is not None and _unfiltered_index_scan(node):
            assert got[i][1] >= want[i][1]
            got[i] = got[i][:1] + got[i][2:]
            want[i] = want[i][:1] + want[i][2:]
    assert got == want


@pytest.mark.parametrize("q", sorted(ttpch.TPCH_QUERIES))
def test_tpch_analyzed_runs_equal_collect_and_the_jax_nodes(golden, q):
    root, js, ts = golden
    out, tcol = _plain_and_analyzed(lambda: ttpch.TPCH_QUERIES[q](ts, root))
    assert tcol.nodes, q
    jtpch.TPCH_QUERIES[q](js, root).collect()  # warm, as the port's
    jout, jcol = _analyzed(jps, jtpch.TPCH_QUERIES[q](js, root))
    _assert_nodes_match(tcol, jcol)
    # the root's actual rows are the result's
    root_stats = tcol.nodes[tcol.plan.plan_id]
    assert root_stats.rows_out == len(next(iter(out.values())))


@pytest.mark.parametrize("form", ["point", "range", "in"])
def test_pruned_lookups_analyzed_equal_collect_and_the_jax_nodes(events, form):
    root, js, ts, n = events
    _out, tcol = _plain_and_analyzed(lambda: _lookup(TX, ts, root, n, form))
    js_df = _lookup(JX, js, root, n, form)
    js_df.collect()
    _jout, jcol = _analyzed(jps, _lookup(JX, js, root, n, form))
    _assert_nodes_match(tcol, jcol)
    # the pruning's q-errors land on the scan node, as the JAX package's
    qerrs = lambda col: sorted((est, round(p, 9), round(a, 9)) for ns in col.nodes.values()
                               for est, p, a, _q in ns.qerrors)
    assert qerrs(tcol) == qerrs(jcol)
    if form == "point":
        assert "scan_fraction" in {e for e, *_ in qerrs(tcol)}


def test_explain_analyze_report(events):
    root, _js, ts, n = events
    df = _lookup(TX, ts, root, n, "point")
    report = T.Hyperspace(ts).explain_analyze(df)
    for part in ("Plan statistics (EXPLAIN ANALYZE):", "rows=", "wall=", "bytes=",
                 "scan_fraction", "q=", "routes:", "result: 1 row(s)",
                 "Estimator accuracy (process-wide):"):
        assert part in report, part
    assert "FileScan" in df.explain()  # plain: no execution
    assert "rows=" in df.explain(analyze=True)
    sunk = []
    assert T.Hyperspace(ts).explain_analyze(df, redirect=sunk.append) is None
    assert "Plan statistics (EXPLAIN ANALYZE):" in sunk[0]


def test_annotation_and_summary_render_as_jax():
    class _N:
        plan_id = 7
        kind = "Filter"

    cols = []
    for ps in (jps, tps):
        col = ps.PlanStatsCollector()
        col.record_node(_N, 42, 0.00123)
        col.note_route(7, "pipelined")
        col.note_scan(8, 3, 4096, rows=10)
        col.note_qerror(7, "scan_fraction", 0.125, 0.25, 2.0)
        col.note_flag("spilled_waves", 2)
        col.note_join_plan({"buckets": 8, "banded": 8, "grant_bytes": 1 << 30})
        cols.append(col)
    for pid in (7, 8, 999):
        assert cols[1].annotation(pid) == cols[0].annotation(pid)
    assert tps.summary_string(cols[1]) == jps.summary_string(cols[0])
    assert "rows=42" in cols[1].annotation(7) and "route=pipelined" in cols[1].annotation(7)


# ---------------------------------------------------------------------------
# the accuracy ledger
# ---------------------------------------------------------------------------

_OBSERVATIONS = [
    ("e", 2.0, 8.0, "i1", "k:eq"), ("e", 8.0, 2.0, "i1", "k:eq"), ("e", 3.0, 3.0, "i1", ""),
    ("e", 1.0, 4.0, "i2", "k:in3"), ("f", 0.5, 0.0, "", ""), ("f", 0.0, 0.0, "", ""),
    ("scan_fraction", 0.125, 1.0, "idx_a", "a:eq"), ("g", 1e-12, 5.0, "x", "s"),
]


def test_qerror_math_and_corrections_equal_the_jax_packages():
    accs = (jps.EstimatorAccuracy(), tps.EstimatorAccuracy())
    for est, p, a, idx, shape in _OBSERVATIONS:
        qj = accs[0].observe(est, p, a, index=idx, shape=shape)
        qt = accs[1].observe(est, p, a, index=idx, shape=shape)
        assert qt == qj and math.isfinite(qt) and qt >= 1.0
    for key in (("e", "i1", "k:eq"), ("e", "i1", "other"), ("e", "i2", "k:in3"),
                ("e", "unknown", ""), ("scan_fraction", "idx_a", "a:eq"), ("unknown", "", "")):
        assert accs[1].correction(*key) == accs[0].correction(*key), key
    assert accs[1].correction("e", "i1", "k:eq") == pytest.approx(
        math.exp((math.log(4.0) + math.log(0.25)) / 2))
    sj, st = accs[0].snapshot(), accs[1].snapshot()
    for k in ("observations", "by_estimator", "correction_keys", "corrections"):
        assert st[k] == sj[k], k
    assert set(st["qerror"]) == set(sj["qerror"])


def test_predicate_shapes_equal_the_jax_packages():
    from hyperspace_tpu.plan import pruning as jpr

    cases = [(None, ("k",)), (lambda X: X.col("k") == 1, ("k",)),
             (lambda X: X.col("k").isin([1, 2, 3]), ("k",)),
             (lambda X: X.col("x") > 2, ("k",)),
             (lambda X: (X.col("a") == 1) & X.col("b").isin([1, 2]), ("a", "b")),
             (lambda X: X.col("k").is_null(), ("k",))]
    for cond, keys in cases:
        got = tpr.predicate_shape(None if cond is None else cond(TX), keys)
        assert got == jpr.predicate_shape(None if cond is None else cond(JX), keys)


# ---------------------------------------------------------------------------
# estimator feedback
# ---------------------------------------------------------------------------


@pytest.fixture()
def ranker(tmp_path):
    """tests/test_plan_stats._RankerFixture: idx_a (bigger, bucket-prunes
    a filter on ``a`` to 1/8) against idx_b (smaller, unprunable for it),
    built by the port."""
    rng = np.random.default_rng(2)
    n = 30_000
    os.makedirs(tmp_path / "R")
    pq.write_table(pa.table({"a": rng.integers(0, 1000, n), "b": rng.integers(0, 1000, n),
                             "v": rng.uniform(0, 1, n), "w": rng.uniform(0, 1, n)}),
                   str(tmp_path / "R" / "r.parquet"))
    s = T.HyperspaceSession(str(tmp_path / "wh"), {TC.INDEX_NUM_BUCKETS: 8}, device="cpu")
    hs = T.Hyperspace(s)
    df = s.read.parquet(str(tmp_path / "R"))
    hs.create_index(df, T.CoveringIndexConfig("idx_a", ["a"], ["b", "v", "w"]))
    hs.create_index(df, T.CoveringIndexConfig("idx_b", ["b"], ["a"]))
    return s.enable_hyperspace(), str(tmp_path / "R")


def _query(s, path, cols=("a", "b")):
    return s.read.parquet(path).filter((TX.col("a") == 7) & (TX.col("b") > 100)).select(*cols)


def _chosen(s, path) -> str:
    (scan,) = [n for n in _query(s, path).optimized_plan().preorder()
               if getattr(n, "index_info", None) is not None]
    return scan.index_info.index_name


def _plant(cond):
    """The ledger learns that idx_a's 1/8 estimate is 8 times too low for
    this predicate shape (reset first, so earlier runs cannot dilute it)."""
    tps.ACCURACY.reset_for_testing()
    shape = tpr.predicate_shape(cond, ("a",))
    assert shape == "a:eq"
    for _ in range(8):
        tps.ACCURACY.observe("scan_fraction", 0.125, 1.0, index="idx_a", shape=shape)


def test_feedback_off_a_planted_misestimate_changes_nothing(ranker, monkeypatch):
    s, path = ranker
    monkeypatch.delenv("HYPERSPACE_ESTIMATOR_FEEDBACK", raising=False)
    assert _chosen(s, path) == "idx_a"
    _plant((TX.col("a") == 7) & (TX.col("b") > 100))
    assert _chosen(s, path) == "idx_a"


def test_feedback_on_reranks_from_a_planted_misestimate(ranker, monkeypatch):
    s, path = ranker
    assert _chosen(s, path) == "idx_a"
    want = _bits(_query(s, path, ("a", "b", "v")).collect().to_pydict())
    _plant((TX.col("a") == 7) & (TX.col("b") > 100))
    monkeypatch.setenv("HYPERSPACE_ESTIMATOR_FEEDBACK", "1")
    # the corrected fraction is 0.125 * 8 = 1.0: the smaller idx_b wins
    assert _chosen(s, path) == "idx_b"
    assert _bits(_query(s, path, ("a", "b", "v")).collect().to_pydict()) == want


def test_corrected_fraction_is_the_estimate_when_off(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_ESTIMATOR_FEEDBACK", raising=False)

    class _DD:
        num_buckets = 0

    class _Entry:
        name = "x"
        derived_dataset = _DD()

    assert tpr.corrected_scan_fraction(None, _Entry()) == 1.0
