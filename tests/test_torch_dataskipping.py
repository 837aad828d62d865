"""The data-skipping index kind of the port (hyperspace_tpu_torch/models/
dataskipping/, ops/sketch.py) held against the JAX package's on the same
seeded inputs:

- the per-unit sketch tables of the five sketch kinds, column for column
  (bloom filters over int32, int64, float32 with -0.0 and NaN, float64 and
  strings; min-max with NaN rows; value lists past their bound; partition
  values with an empty unit; the z-region box);
- ``translate_filter``'s keep-masks on a case table (And, Or, an Or with an
  unboundable side, Ne on constant files, IN, Not through NNF);
- on a lake of four files with disjoint key ranges, indexes built by each
  package: the sketch files byte for byte, the optimized plans, the files
  kept (files pruned > 0 asserted) and the results, the JAX package's
  cases (MinMax, bloom, value list, a NaN row that must not skip its
  file); a covering index beats skipping; each package queries the
  other's data-skipping index;
- refresh, incremental and full, run by both packages on the same
  snapshot of an index either built: files byte for byte, log entries
  less their wall-clock fields, the same statistics;
- end to end on the CPU: TPC-H ``q6_tax_sum`` over li_shipdate_mm, and the
  bloom point query over a store_sales-shaped lake, each through
  filter_sum's plain version.

Tolerances: counts and keys exact; f32 sums within relative 1e-4.
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.models.dataskipping import sketches as jsk
from hyperspace_tpu.models.dataskipping.index import DataSkippingIndex as JDS
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.models.dataskipping import sketches as tsk
from hyperspace_tpu_torch.models.dataskipping.index import DataSkippingIndex as TDS
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import expr as TX

REL = 1e-4
NAME = "ds"
PKGS = {"jax": (J, JX), "torch": (T, TX)}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """This module's JAX queries must not leave the JAX package's
    process-wide query ledger full for the modules run after it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _session(pkg: str, warehouse: str):
    if pkg == "torch":
        return T.HyperspaceSession(warehouse, device="cpu")
    return J.HyperspaceSession(warehouse)


def _sketches(pkg: str, spec):
    mod = {"jax": jsk, "torch": tsk}[pkg]
    return [getattr(mod, kind)(*args) for kind, *args in spec]


# ---------------------------------------------------------------------------
# sketch tables
# ---------------------------------------------------------------------------

def _columns(values: np.ndarray, dtype: str):
    if dtype == "string":
        return JColumn.from_values(list(values)), TColumn.from_values(list(values))
    return JColumn(values, dtype), TColumn(values, dtype)


def _sketch_input(dtype: str):
    rng = np.random.default_rng(31)
    n = 600
    if dtype == "string":
        return np.asarray([f"s{v}" for v in rng.integers(0, 40, n)])
    if dtype.startswith("float"):
        v = rng.normal(0, 1e3, n).astype(dtype)
        v[[3, 77]] = np.nan
        v[[5, 90]] = -0.0
        v[11] = 0.0
        return v
    return rng.integers(-(2**40) if dtype == "int64" else -(2**30), 2**30, n).astype(dtype)


SKETCH_CASES = {
    "minmax_int64": (("MinMaxSketch", "c"), "int64"),
    "minmax_float64_nan": (("MinMaxSketch", "c"), "float64"),
    "minmax_string": (("MinMaxSketch", "c"), "string"),
    "bloom_int32": (("BloomFilterSketch", "c", 64, 0.01), "int32"),
    "bloom_int64": (("BloomFilterSketch", "c", 64, 0.01), "int64"),
    "bloom_float32": (("BloomFilterSketch", "c", 64, 0.05), "float32"),
    "bloom_float64": (("BloomFilterSketch", "c", 500, 0.01), "float64"),
    "bloom_string": (("BloomFilterSketch", "c", 64, 0.01), "string"),
    "valuelist_int64": (("ValueListSketch", "c"), "int64"),
    "valuelist_string": (("ValueListSketch", "c"), "string"),
    "partition_int32": (("PartitionSketch", "c"), "int32"),
}


@pytest.mark.parametrize("case", sorted(SKETCH_CASES))
def test_sketch_tables_equal_the_jax_packages(case):
    """Six units, the fourth empty; NaN and -0.0 among the floats."""
    spec, dtype = SKETCH_CASES[case]
    values = _sketch_input(dtype)
    if case.startswith("valuelist_int64"):
        values = values % 300  # one unit past the 256-value bound, the rest under it
    segments = np.repeat(np.array([0, 1, 2, 4, 5]), [150, 120, 30, 200, 100])
    jcol, tcol = _columns(values, dtype)
    want = _sketches("jax", [spec])[0].aggregate(jcol, segments, 6)
    got = _sketches("torch", [spec])[0].aggregate(tcol, segments, 6)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        g, w = got[name].decode(), want[name].decode()
        assert [repr(x) for x in g] == [repr(x) for x in w], name


def test_zregion_box_equals_the_jax_packages():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1000, 300)
    b = rng.uniform(-1, 1, 300)
    b[7] = np.nan
    segments = np.arange(300) // 64
    boxes = {}
    for pkg, Col, Batch in (("jax", JColumn, JBatch), ("torch", TColumn, TBatch)):
        sk = _sketches(pkg, [("ZRegionSketch", ["a", "b"])])[0]
        batch = Batch({"a": Col(a, "int64"), "b": Col(b, "float64")})
        boxes[pkg] = {k: v.data.tolist() for k, v in
                      sk.aggregate_batch(batch, segments, 5).items()}
    assert json.dumps(boxes["torch"]) == json.dumps(boxes["jax"])


def test_bloom_bits_equal_the_jax_packages_for_every_width():
    """A value probes the same bits whether it is stored narrow or wide."""
    from hyperspace_tpu.ops import sketch as jops
    from hyperspace_tpu_torch.ops import sketch as tops

    for expected, fpp in ((1, 0.5), (100, 0.01), (62_500, 0.01), (10**6, 1e-4)):
        assert tops.bloom_params(expected, fpp) == jops.bloom_params(expected, fpp)
    words = [np.arange(-50, 50, dtype=np.int64), np.linspace(-3, 3, 100)]
    m, k = tops.bloom_params(100, 0.01)
    np.testing.assert_array_equal(tops._bloom_positions_np(words, m, k),
                                  jops._bloom_positions_np(words, m, k))
    bits = (np.arange(64) % 3 == 0).astype(np.uint8)
    np.testing.assert_array_equal(tops.pack_bits(bits), jops.pack_bits(bits))


# ---------------------------------------------------------------------------
# translate_filter
# ---------------------------------------------------------------------------

TRANSLATE_CASES = {
    "eq": lambda X: X.col("k") == 150,
    "range_and": lambda X: (X.col("k") >= 120) & (X.col("k") < 210),
    "or": lambda X: (X.col("k") < 50) | (X.col("k") > 350),
    "or_unboundable_side": lambda X: (X.col("k") < 50) | (X.col("v") > 3.0),
    "and_partial": lambda X: (X.col("k") < 50) & (X.col("v") > 3.0),
    "ne_constant_files": lambda X: X.col("cat") != "c2",
    "in": lambda X: X.col("k").isin([5, 260, 999]),
    "in_strings": lambda X: X.col("cat").isin(["c1", "c9"]),
    "not_range": lambda X: X.Not((X.col("k") >= 100) | (X.col("cat") == "c0")),
    "bloom_eq": lambda X: X.col("b") == 333,
    "bloom_in": lambda X: X.col("b").isin([17, 345]),
    "unboundable": lambda X: X.col("v") > 3.0,
}


def _translate_table(Col, Batch):
    """A sketch table of four files: k in [100i, 100i + 99], cat "c<i>"
    in every row of file i, b a bloom filter of file i's b values."""
    table = {"k__min": Col(np.arange(4) * 100, "int64"),
             "k__max": Col(np.arange(4) * 100 + 99, "int64"),
             "cat__min": Col.from_values([f"c{i}" for i in range(4)]),
             "cat__max": Col.from_values([f"c{i}" for i in range(4)])}
    return Batch(table)


@pytest.mark.parametrize("case", sorted(TRANSLATE_CASES))
def test_translate_filter_keeps_what_the_jax_package_keeps(case):
    spec = [("MinMaxSketch", "k"), ("MinMaxSketch", "cat"), ("BloomFilterSketch", "b", 100, 0.01)]
    masks = {}
    for pkg, Col, Batch in (("jax", JColumn, JBatch), ("torch", TColumn, TBatch)):
        sketches = _sketches(pkg, spec)
        table = _translate_table(Col, Batch)
        bloom = sketches[2].aggregate(Col(np.arange(400) + 10, "int64"),
                                      np.arange(400) // 100, 4)
        table = Batch({**table.columns, **bloom})
        index = (JDS if pkg == "jax" else TDS)(sketches)
        fn = index.translate_filter(TRANSLATE_CASES[case](PKGS[pkg][1]))
        masks[pkg] = None if fn is None else np.asarray(fn(table)).tolist()
    assert masks["torch"] == masks["jax"]
    if case in ("or_unboundable_side", "unboundable"):
        assert masks["torch"] is None


# ---------------------------------------------------------------------------
# the rule over a lake of disjoint files
# ---------------------------------------------------------------------------

def _write_lake(src: str, nan_file: bool = True) -> None:
    """Four files with disjoint key ranges (the JAX package's test lake),
    plus an int32, a float32 and a b column; file 1 holds a NaN v."""
    for i in range(4):
        v = np.arange(100, dtype=np.float64)
        if nan_file and i == 1:
            v[3] = np.nan
        pq.write_table(pa.table({
            "k": np.arange(i * 100, (i + 1) * 100, dtype=np.int64),
            "v": v,
            "cat": [f"c{i}"] * 100,
            "k32": np.arange(i * 100, (i + 1) * 100, dtype=np.int32),
            "f32": (np.arange(100, dtype=np.float32) + 1000 * i),
            "b": np.arange(i * 100, (i + 1) * 100, dtype=np.int64) * 7,
        }), os.path.join(src, f"f{i}.parquet"))


INDEX_SPEC = [("MinMaxSketch", "k"), ("MinMaxSketch", "v"), ("BloomFilterSketch", "b", 100, 0.01),
              ("ValueListSketch", "cat"), ("MinMaxSketch", "cat"),
              ("BloomFilterSketch", "k32", 100, 0.01), ("BloomFilterSketch", "f32", 100, 0.01)]


@pytest.fixture(scope="module")
def ds_lake(tmp_path_factory):
    """The lake, and the data-skipping index built over it by each package
    into a warehouse of its own."""
    root = str(tmp_path_factory.mktemp("ds_lake"))
    src = os.path.join(root, "src")
    os.makedirs(src)
    _write_lake(src)
    for pkg in PKGS:
        s = _session(pkg, os.path.join(root, f"wh_{pkg}"))
        PKGS[pkg][0].Hyperspace(s).create_index(
            s.read.parquet(src),
            PKGS[pkg][0].DataSkippingIndexConfig(NAME, _sketches(pkg, INDEX_SPEC)))
    return root, src


def test_the_sketch_files_equal_the_jax_packages(ds_lake):
    root, _ = ds_lake
    files = {}
    for pkg in PKGS:
        wh = os.path.join(root, f"wh_{pkg}")
        for dirpath, _dirs, names in os.walk(wh):
            for fn in names:
                if fn.endswith(".parquet"):
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        files.setdefault(pkg, {})[os.path.relpath(
                            os.path.join(dirpath, fn), wh)] = f.read()
    assert list(files["torch"]) == ["indexes/ds/v__=0/sketches-0.parquet"]
    assert files["torch"] == files["jax"]


QUERIES = {
    # name: (query, files the skipping keeps)
    "point": (lambda X, d: d.filter(X.col("k") == 150).select("k", "v"), 1),
    "range": (lambda X, d: d.filter((X.col("k") >= 120) & (X.col("k") < 210))
              .select("k", "cat"), 2),
    "or": (lambda X, d: d.filter((X.col("k") < 50) | (X.col("k") > 350)).select("k"), 2),
    "or_unboundable": (lambda X, d: d.filter((X.col("k") < 50) | (X.col("v") > 98.0))
                       .select("k"), 4),
    "and_partial": (lambda X, d: d.filter((X.col("k") < 50) & (X.col("v") > 3.0))
                    .select("k", "v"), 1),
    "bloom": (lambda X, d: d.filter(X.col("b") == 7 * 233).select("k", "b"), 1),
    "bloom_int32": (lambda X, d: d.filter(X.col("k32") == 17).select("k"), 1),
    "bloom_float32": (lambda X, d: d.filter(X.col("f32") == 2005.0).select("k"), 1),
    "value_list_in": (lambda X, d: d.filter(X.col("cat").isin(["c1", "c3"])).select("k"), 2),
    "ne_constant": (lambda X, d: d.filter(X.col("cat") != "c0").select("k"), 3),
    # a NaN row must not give its file NaN bounds (which would skip it)
    "nan_file": (lambda X, d: d.filter(X.col("v") == 2.0).select("k", "v"), 4),
    "aggregate": (lambda X, d: d.filter(X.col("k") >= 310).agg(
        X.Sum(X.col("v")).alias("s"), X.Count(X.lit(1)).alias("n")), 1),
}


def _scan(plan):
    return [n for n in plan.preorder() if n.kind == "FileScan"][0]


def _rows(d: dict) -> list:
    return sorted(zip(*[[repr(v) for v in vals] for vals in d.values()]))


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_skipped_files_plans_and_results_equal_the_jax_packages(q, ds_lake):
    root, src = ds_lake
    build, kept = QUERIES[q]
    plans, files, results = {}, {}, {}
    for pkg, (mod, X) in PKGS.items():
        wh = os.path.join(root, f"wh_{pkg}")
        s = _session(pkg, wh).enable_hyperspace()
        df = build(X, s.read.parquet(src))
        plan = df.optimized_plan()
        plans[pkg] = plan.pretty().replace(wh, "<wh>")
        files[pkg] = sorted(os.path.basename(f.name) for f in _scan(plan).files)
        results[pkg] = df.collect().to_pydict()
    assert plans["torch"] == plans["jax"]
    assert files["torch"] == files["jax"] and len(files["torch"]) == kept
    if kept < 4:
        assert "Type: DS" in plans["torch"]  # files pruned > 0
    assert _rows(results["torch"]) == _rows(results["jax"])


def test_each_package_queries_the_others_index(ds_lake):
    root, src = ds_lake
    for reader, builder in (("torch", "jax"), ("jax", "torch")):
        X = PKGS[reader][1]
        s = _session(reader, os.path.join(root, f"wh_{builder}")).enable_hyperspace()
        df = s.read.parquet(src).filter((X.col("k") >= 120) & (X.col("k") < 210)).select("k")
        scan = _scan(df.optimized_plan())
        assert scan.index_info.index_name == NAME and len(scan.files) == 2
        assert sorted(df.collect().to_pydict()["k"]) == list(range(120, 210))
    stats = _session("torch", os.path.join(root, "wh_jax")).dataskipping_stats
    assert stats.files_pruned == 0  # a fresh session: nothing consulted yet


def test_covering_beats_skipping(tmp_path):
    src = str(tmp_path / "src")
    os.makedirs(src)
    _write_lake(src, nan_file=False)
    used = {}
    for pkg, (mod, X) in PKGS.items():
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        hs = mod.Hyperspace(s)
        hs.create_index(s.read.parquet(src), mod.DataSkippingIndexConfig(
            "ds_k", _sketches(pkg, [("MinMaxSketch", "k")])))
        hs.create_index(s.read.parquet(src), mod.CoveringIndexConfig("ci_k", ["k"], ["v"]))
        s.enable_hyperspace()
        plan = s.read.parquet(src).filter(X.col("k") == 150).select("k", "v").optimized_plan()
        used[pkg] = _scan(plan).index_info.index_name
    assert used == {"jax": "ci_k", "torch": "ci_k"}


def test_duplicate_sketches_are_refused_as_in_jax():
    for pkg, (mod, _X) in PKGS.items():
        with pytest.raises(Exception, match="Duplicate sketch"):
            mod.DataSkippingIndexConfig("d", [mod.MinMaxSketch("k"), mod.MinMaxSketch("K")])


# ---------------------------------------------------------------------------
# refresh
# ---------------------------------------------------------------------------

def _strip(x):
    """A log entry less its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("timestamp", "modifiedTime")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _capture(warehouse: str) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(warehouse):
        for fn in names:
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, warehouse)
            with open(p, "rb") as f:
                raw = f.read()
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


@pytest.mark.parametrize("mode", ["incremental", "full"])
@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_refresh_matches_across_packages(tmp_path, builder, mode):
    """Two files appended, one deleted; each package refreshes the index
    ``builder`` built, from the same snapshot."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    _write_lake(src)
    warehouse = str(tmp_path / "wh")
    spec = [("MinMaxSketch", "k"), ("BloomFilterSketch", "b", 100, 0.01)]
    s = _session(builder, warehouse)
    PKGS[builder][0].Hyperspace(s).create_index(
        s.read.parquet(src), PKGS[builder][0].DataSkippingIndexConfig(NAME, _sketches(builder, spec)))
    rng = np.random.default_rng(3)
    for i in (4, 5):
        pq.write_table(pa.table({
            "k": rng.integers(1000, 1200, 50), "v": rng.uniform(0, 1, 50),
            "cat": ["c9"] * 50, "k32": np.arange(50, dtype=np.int32),
            "f32": np.arange(50, dtype=np.float32), "b": rng.integers(0, 9, 50),
        }), os.path.join(src, f"f{i}.parquet"))
    os.unlink(os.path.join(src, "f2.parquet"))
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)
    captured, stats = {}, {}
    for pkg in PKGS:
        shutil.rmtree(warehouse)
        shutil.copytree(snapshot, warehouse)
        hs = PKGS[pkg][0].Hyperspace(_session(pkg, warehouse))
        hs.refresh_index(NAME, mode)
        captured[pkg] = _capture(warehouse)
        stats[pkg] = (hs.indexes().to_pydict(), hs.get_index_versions(NAME))
    assert sorted(captured["torch"]) == sorted(captured["jax"])
    for k in captured["jax"]:
        assert captured["torch"][k] == captured["jax"][k], k
    assert stats["torch"] == stats["jax"]
    X = TX
    s = _session("torch", warehouse).enable_hyperspace()
    df = s.read.parquet(src).filter(X.col("k") >= 1000).select("k")
    assert len(_scan(df.optimized_plan()).files) == 2  # only the appended files
    assert len(df.collect().to_pydict()["k"]) == 100


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def test_q6_tax_sum_over_li_shipdate_mm(tmp_path):
    """The port's own tpch_indexes over a lineitem split into four files by
    ship date: q6_tax_sum reads only li_shipdate_mm's kept files, runs
    filter_sum (its plain version on the CPU) and equals the JAX package's
    result over the raw files."""
    from hyperspace_tpu.benchmark import tpch as jtpch
    from hyperspace_tpu_torch.benchmark import tpch as ttpch

    root = str(tmp_path)
    jtpch.generate_tpch(root, rows_lineitem=8_000, seed=7)
    li = os.path.join(root, "lineitem")
    table = pq.read_table(li).sort_by("l_shipdate")
    for f in os.listdir(li):
        os.unlink(os.path.join(li, f))
    for i in range(4):
        pq.write_table(table.slice(i * 2000, 2000), os.path.join(li, f"part-{i}.parquet"))
    ts = T.HyperspaceSession(os.path.join(root, "wh_t"), device="cpu")
    ttpch.tpch_indexes(ts, T.Hyperspace(ts), root)
    ts.enable_hyperspace()
    plan = ttpch.q6_tax_sum(ts, root).optimized_plan()
    scan = _scan(plan)
    assert scan.index_info.index_name == "li_shipdate_mm" and 0 < len(scan.files) < 4
    before = K.PLAIN_CALLS["filter_sum"]
    got = ttpch.q6_tax_sum(ts, root).collect().to_pydict()
    assert K.PLAIN_CALLS["filter_sum"] == before + 1
    assert ts.device_stats.device_fragments == 1 and not ts.device_stats.declines
    assert ts.dataskipping_stats.last["files_pruned"] == 4 - len(scan.files)
    js = J.HyperspaceSession(os.path.join(root, "wh_j"))
    want = (js.read.parquet(li).filter((JX.col("l_shipdate") >= 8766)
                                       & (JX.col("l_shipdate") < 9131))
            .agg(JX.Sum(JX.col("l_tax")).alias("sum_tax"),
                 JX.Count(JX.lit(1)).alias("count")).collect().to_pydict())
    assert got["count"] == want["count"] and want["count"][0] > 0
    assert abs(got["sum_tax"][0] - want["sum_tax"][0]) <= REL * abs(want["sum_tax"][0])


def test_bloom_point_query_over_store_sales(tmp_path):
    """bench.py's config 5 at a small size: 16 files of file-local item
    keys, BloomFilterSketch(ss_item_sk, rows per file, 0.01); the point
    query prunes to the key's file in both packages and equals the raw
    scan."""
    src = str(tmp_path / "store_sales")
    os.makedirs(src)
    rng = np.random.default_rng(11)
    per = 2000
    for i in range(16):
        pq.write_table(pa.table({
            "ss_item_sk": rng.integers(i * 100_000, (i + 1) * 100_000, per),
            "ss_net_paid": rng.uniform(1, 300, per),
        }), os.path.join(src, f"part-{i:02d}.parquet"))
    key = int(pq.read_table(os.path.join(src, "part-03.parquet")).column("ss_item_sk")[5].as_py())
    out = {}
    for pkg, (mod, X) in PKGS.items():
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        mod.Hyperspace(s).create_index(s.read.parquet(src), mod.DataSkippingIndexConfig(
            "ss_bloom", [mod.BloomFilterSketch("ss_item_sk", per, 0.01)]))

        def q():
            return s.read.parquet(src).filter(X.col("ss_item_sk") == key).agg(
                X.Sum(X.col("ss_net_paid")).alias("s"), X.Count(X.lit(1)).alias("n"))

        raw = q().collect().to_pydict()
        s.enable_hyperspace()
        scan = _scan(q().optimized_plan())
        out[pkg] = (raw, q().collect().to_pydict(),
                    sorted(os.path.basename(f.name) for f in scan.files))
    assert out["torch"][2] == out["jax"][2] and "part-03.parquet" in out["torch"][2]
    assert len(out["torch"][2]) < 16
    for raw_or_indexed in (0, 1):
        got, want = out["torch"][raw_or_indexed], out["jax"][raw_or_indexed]
        assert got["n"] == want["n"] and want["n"][0] >= 1
        assert abs(got["s"][0] - want["s"][0]) <= REL * abs(want["s"][0])


def test_the_kinds_rules_register_in_the_jax_packages_order():
    """Ties go to the later rule, so the order changes plans where scores
    tie: data skipping, then z-order, before NoOp, as in the JAX package."""
    from hyperspace_tpu.rules import score_optimizer as jso
    from hyperspace_tpu_torch.rules import score_optimizer as tso

    assert [r.__name__ for r in tso._EXTRA_RULES] == [r.__name__ for r in jso._EXTRA_RULES]
    assert [r.__name__ for r in tso._EXTRA_RULES] == ["ApplyDataSkippingIndex",
                                                      "ZOrderFilterIndexRule"]
