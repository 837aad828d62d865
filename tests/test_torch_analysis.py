"""The analysis views of the port (explain, whyNot, the display modes, the
applicable-index report and the min/max layout analyzer) held against the
JAX package on the same inputs.

- Over the golden fixture of tests/test_plan_stability.py (TPC-H, 2,000
  lineitem rows, seed 7, ``tpch_indexes`` plus ``li_ds_minmax``, built by
  the JAX package), the port's ``explain(q6, verbose=True)``,
  ``why_not(q3, extended=True)``, ``explain(q10, verbose=True)`` and
  ``why_not(q18)`` equal the approved files in tests/approved_plans after
  the same normalization. The files are read, never written.
- Over one warehouse that both packages share, each display mode (with
  and without the conf's highlight tags), each whyNot section and form,
  the applicable-index report and the min/max reports (text, verbose,
  HTML, comparison) are the JAX package's strings, character for
  character. These mirror tests/test_compat_and_analysis.py's
  TestDisplayModes, TestWhyNotSections, TestMinMaxAnalyzer* and
  TestApplicableInfoMemoSafety.
"""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.analysis import explain as jexplain
from hyperspace_tpu.analysis import minmax_analysis as jmm
from hyperspace_tpu.analysis import whynot as jwhynot
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.analysis import explain as texplain
from hyperspace_tpu_torch.analysis import minmax_analysis as tmm
from hyperspace_tpu_torch.analysis import whynot as twhynot
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.plan import expr as TX

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "approved_plans")


def normalize(s: str, root: str) -> str:
    """tests/test_plan_stability.normalize."""
    s = s.replace(root, "<ROOT>")
    s = re.sub(r"/tmp/[^/ ]+", "<TMP>", s)
    return s + "\n"


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """tests/test_plan_stability.tpch_golden_env, built by the JAX package;
    the port reads the same warehouse."""
    from hyperspace_tpu.models.dataskipping import DataSkippingIndexConfig, MinMaxSketch

    root = str(tmp_path_factory.mktemp("tpch_golden"))
    jtpch.generate_tpch(root, rows_lineitem=2000, seed=7)
    js = J.HyperspaceSession(warehouse_dir=root)
    hs = J.Hyperspace(js)
    jtpch.tpch_indexes(js, hs, root)
    hs.create_index(js.read.parquet(os.path.join(root, "lineitem")),
                    DataSkippingIndexConfig("li_ds_minmax", [MinMaxSketch("l_shipdate")]))
    return root


@pytest.mark.parametrize("name,query,verb,kwargs", [
    ("tpch_q6_explain", "q6", "explain", {"verbose": True}),
    ("tpch_q3_whynot", "q3", "why_not", {"extended": True}),
    ("tpch_q10_explain", "q10", "explain", {"verbose": True}),
    ("tpch_q18_whynot", "q18", "why_not", {}),
])
def test_tpch_views_equal_the_approved_files(golden, name, query, verb, kwargs):
    root = golden
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    ts.set_conf(TC.DISPLAY_MODE, "plaintext")
    hs = T.Hyperspace(ts)
    q = ttpch.TPCH_QUERIES[query](ts, root)
    got = normalize(getattr(hs, verb)(q, **kwargs), root)
    with open(os.path.join(GOLDEN_DIR, f"{name}.txt")) as f:
        approved = f.read()
    assert got == approved
    sunk = []
    assert getattr(hs, verb)(q, redirect=sunk.append, **kwargs) is None
    assert normalize(sunk[0], root) == approved


# ---------------------------------------------------------------------------
# one small warehouse both packages share
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Source ``d`` (k, v), ``other`` (x, y) and index i1 (k; v), i2 (v; k)
    over ``d`` and ix (x; y) over ``other``, built by the JAX package."""
    root = str(tmp_path_factory.mktemp("analysis"))
    os.makedirs(os.path.join(root, "d"))
    os.makedirs(os.path.join(root, "other"))
    pq.write_table(pa.table({"k": np.arange(50, dtype=np.int64),
                             "v": np.arange(50, dtype=np.float64)}),
                   os.path.join(root, "d", "p.parquet"))
    pq.write_table(pa.table({"x": np.array([1, 2, 3], dtype=np.int64),
                             "y": np.array([4.0, 5.0, 6.0])}),
                   os.path.join(root, "other", "p.parquet"))
    js = J.HyperspaceSession(warehouse_dir=root)
    hs = J.Hyperspace(js)
    d = js.read.parquet(os.path.join(root, "d"))
    hs.create_index(d, J.CoveringIndexConfig("i1", ["k"], ["v"]))
    hs.create_index(d, J.CoveringIndexConfig("i2", ["v"], ["k"]))
    hs.create_index(js.read.parquet(os.path.join(root, "other")),
                    J.CoveringIndexConfig("ix", ["x"], ["y"]))
    return root


def _pair(root):
    js = J.HyperspaceSession(warehouse_dir=root).enable_hyperspace()
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    jq = js.read.parquet(os.path.join(root, "d")).filter(JX.col("k") == 5).select("k", "v")
    tq = ts.read.parquet(os.path.join(root, "d")).filter(TX.col("k") == 5).select("k", "v")
    return js, jq, ts, tq


@pytest.mark.parametrize("mode", ["plaintext", "console", "html"])
@pytest.mark.parametrize("verbose", [False, True])
def test_display_modes_render_as_jax(shared, mode, verbose):
    js, jq, ts, tq = _pair(shared)
    js.set_conf(JC.DISPLAY_MODE, mode)
    ts.set_conf(TC.DISPLAY_MODE, mode)
    out = texplain.explain_string(ts, tq, verbose)
    assert out == jexplain.explain_string(js, jq, verbose)
    if mode == "html":
        assert out.startswith("<pre>") and out.endswith("</pre>") and "<br>" in out
    # the conf tags override the mode's only when both are set
    for key, val in ((TC.HIGHLIGHT_BEGIN_TAG, ">>>"), (TC.HIGHLIGHT_END_TAG, "<<<")):
        js.set_conf(key, val)
        ts.set_conf(key, val)
        assert texplain.explain_string(ts, tq, verbose) == jexplain.explain_string(js, jq, verbose)
    assert ">>>" in texplain.explain_string(ts, tq, verbose)


def test_verbose_explain_with_hyperspace_off_and_unknown_mode(shared):
    js, jq, ts, tq = _pair(shared)
    ts.set_conf(TC.APPLY_ENABLED, False)
    js.set_conf(JC.APPLY_ENABLED, False)
    out = T.Hyperspace(ts).explain(tq, verbose=True)
    assert out == J.Hyperspace(js).explain(jq, verbose=True)
    assert "Hyperspace(" not in out and "unavailable: hyperspace is disabled" in out
    ts.set_conf(TC.DISPLAY_MODE, "latex")
    with pytest.raises(HyperspaceError, match="display mode"):
        texplain.explain_string(ts, tq)


@pytest.mark.parametrize("index_name", [None, "i1", "i2", "ix"])
@pytest.mark.parametrize("extended", [False, True])
def test_why_not_sections_render_as_jax(shared, index_name, extended):
    js, jq, ts, tq = _pair(shared)
    out = twhynot.why_not_string(ts, tq, index_name, extended)
    assert out == jwhynot.why_not_string(js, jq, index_name, extended)
    if index_name is None:
        assert "- i1 (Type: CI, LogVersion: 1)" in out
        reasons = out.split("Index reasons:")[1]
        if extended:
            assert "COL_SCHEMA_MISMATCH" in reasons and "message" in reasons
        else:
            assert "COL_SCHEMA_MISMATCH rows hidden" in out
            assert "NO_CANDIDATE_LEAF" not in out
    # through the facade, with the index name as the facade takes it
    assert T.Hyperspace(ts).why_not(tq, index_name or "", extended) == out


def test_applicable_index_report_renders_as_jax_and_keeps_its_memo(shared, tmp_path):
    js, jq, ts, tq = _pair(shared)
    res = twhynot.collect_analysis(ts, tq)
    first = twhynot.applicable_index_info_string(ts, tq, res)
    assert first == twhynot.applicable_index_info_string(ts, tq, res)
    assert not any("(applied)" in str(r) for r in res.applicable_rows())
    assert first == jwhynot.applicable_index_info_string(js, jq)
    # no index applies to a table without any
    pq.write_table(pa.table({"a": np.array([1, 2, 3], dtype=np.int64)}),
                   str(tmp_path / "p.parquet"))
    q = ts.read.parquet(str(tmp_path)).filter(TX.col("a") == 1)
    assert (twhynot.applicable_index_info_string(ts, q)
            == "No applicable indexes. Try hyperspace.whyNot()")


# ---------------------------------------------------------------------------
# the min/max layout analyzer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Four files each of: ``t`` (k clustered per file, s scattered),
    ``before`` (every file spans the domain) and ``after`` (disjoint)."""
    root = tmp_path_factory.mktemp("layouts")
    for i in range(4):
        for d, table in (
            ("t", {"k": np.arange(i * 10, (i + 1) * 10), "s": np.arange(0, 100, 10)}),
            ("before", {"k": np.arange(0, 100, 3)}),
            ("after", {"k": np.arange(i * 25, (i + 1) * 25)}),
        ):
            os.makedirs(root / d, exist_ok=True)
            pq.write_table(pa.table({c: v.astype(np.int64) for c, v in table.items()}),
                           str(root / d / f"f{i}.parquet"))
    return str(root)


def _read(root, d):
    js = J.HyperspaceSession(warehouse_dir=os.path.join(root, "wh"))
    ts = T.HyperspaceSession(os.path.join(root, "wh"), device="cpu")
    return js.read.parquet(os.path.join(root, d)), ts.read.parquet(os.path.join(root, d))


@pytest.mark.parametrize("verbose", [False, True])
def test_minmax_report_renders_as_jax(layouts, verbose):
    jdf, tdf = _read(layouts, "t")
    out = tmm.analyze(tdf, ["k", "s"], verbose=verbose)
    assert out == jmm.analyze(jdf, ["k", "s"], verbose=verbose)
    lines = {l.split()[0]: l for l in out.splitlines() if l.startswith(("k ", "s "))}
    assert float(lines["k"].split()[2]) < 1.5 < 3.0 < float(lines["s"].split()[2])


def test_minmax_column_stats_equal_the_jax_packages(layouts):
    from hyperspace_tpu.models.covering import _single_file_scan as jscan
    from hyperspace_tpu_torch.models.covering import _single_file_scan as tscan

    jdf, tdf = _read(layouts, "t")
    for c in ("k", "s"):
        got, want = tmm.column_stats(tscan(tdf), c), jmm.column_stats(jscan(jdf), c)
        for f in ("n_files", "n_ranges", "avg_files_per_point", "max_overlap",
                  "skip_ratio_point", "skip_ratio_range1", "skip_ratio_range10",
                  "disjoint_sorted", "domain"):
            assert getattr(got, f) == getattr(want, f), f
        assert [w[1:] for w in got.widest_files] == [w[1:] for w in want.widest_files]
        if want.bucket_overlaps is None:
            assert got.bucket_overlaps is None
        else:
            assert np.array_equal(got.bucket_overlaps, want.bucket_overlaps)


@pytest.mark.parametrize("form", ["html", "comparison", "regression"])
def test_minmax_html_and_comparison_render_as_jax(layouts, form):
    jb, tb = _read(layouts, "before")
    ja, ta = _read(layouts, "after")
    if form == "html":
        out, want = tmm.analyze_html(tb, ["k"]), jmm.analyze_html(jb, ["k"])
        assert out.startswith("<html>") and "background:LightGreen" in out
    elif form == "comparison":
        out, want = tmm.analyze_comparison(tb, ta, ["k"]), jmm.analyze_comparison(jb, ja, ["k"])
        assert "------->>>" in out and "fewer files after re-layout" in out
    else:
        out, want = tmm.analyze_comparison(ta, tb, ["k"]), jmm.analyze_comparison(ja, jb, ["k"])
        assert "WARNING: layout regressed" in out
    assert out == want
