"""Predicate-driven pruning of covering-index scans, held against the JAX
package on the same inputs.

- ``candidate_buckets`` of both packages on a table of predicate shapes:
  every key dtype, literals that cannot match (out of int32 range, a
  fraction on an int column, a string on a number), IN lists, IS NULL
  (numeric, and string, which cannot prune), intersections, two key
  columns, a candidate set past the point-lookup cap. The literal hash
  also equals the write-side bucket of the port's partition_batch.
- On one lake (TPC-H lineitem, 40,000 rows, seed 7) indexed by both
  packages on l_orderkey: the index files' row-group statistics, the
  optimized plans' text (``pruned[...]`` included), ``rowgroup_selection``'s
  kept files and row groups, and the results of the point lookup, the
  absent key and the key range (counts exact, f32 sums within relative
  1e-4) with the device tier on, which launches each lookup's kernel and
  declines the scan pruned to nothing, as the JAX package's does.
- Verify mode passes on the three lookups in both packages, and catches a
  broken bucket hash.
- The chunk cache never serves a pruned read for a full one; a file
  without statistics keeps every row group.
- Filter ranking: a larger index whose bucket key the filter pins beats a
  smaller one it cannot prune, in both packages.
- An index of a kind neither package loads leaves the port's rewrite to
  the other indexes; the JAX package's data-skipping index is loaded and
  used by the port.
"""

import json
import logging
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import Field as JField, Schema as JSchema
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import pruning as jpr
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.columnar.table import Field as TField, Schema as TSchema
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import pruning as tpr

REL = 1e-4

# ---------------------------------------------------------------------------
# candidate_buckets on a table of predicate shapes
# ---------------------------------------------------------------------------

_DTYPES = [("k64", "int64"), ("k32", "int32"), ("k16", "int16"), ("d", "date32"),
           ("f", "float64"), ("s", "string"), ("b", "bool")]


def _cases(X):
    c, lit = X.col, X.lit
    return {
        "eq_int64": (["k64"], [c("k64") == 5]),
        "eq_literal_first": (["k64"], [X.Eq(lit(5), c("k64"))]),
        "eq_negative": (["k64"], [c("k64") == -123456789012]),
        "int32_out_of_range": (["k32"], [c("k32") == 2**40]),
        "int32_whole_float": (["k32"], [c("k32") == 3.0]),
        "int32_fraction": (["k32"], [c("k32") == 3.5]),
        "int16": (["k16"], [c("k16") == -7]),
        "int16_out_of_range": (["k16"], [c("k16") == 40000]),
        "date_days": (["d"], [c("d") == 9000]),
        "float": (["f"], [c("f") == 1.5]),
        "float_int_literal": (["f"], [c("f") == 2]),
        "string": (["s"], [c("s") == "Brand#3"]),
        "string_unicode": (["s"], [c("s") == "日本語"]),
        "string_vs_int": (["s"], [c("s") == 3]),
        "int_vs_string": (["k64"], [c("k64") == "x"]),
        "bool": (["b"], [c("b") == True]),  # noqa: E712
        "in_ints": (["k64"], [X.In(c("k64"), [1, 2, 3, 99])]),
        "in_mixed": (["k32"], [X.In(c("k32"), [1, 2**40, 2.5, 7])]),
        "in_strings": (["s"], [X.In(c("s"), ["a", "b", "Brand#1"])]),
        "is_null_int": (["k64"], [X.IsNull(c("k64"))]),
        "is_null_date": (["d"], [X.IsNull(c("d"))]),
        "is_null_string": (["s"], [X.IsNull(c("s"))]),
        "intersection": (["k64"], [X.In(c("k64"), [1, 2, 3]), c("k64") == 2]),
        "empty_intersection": (["k64"], [X.In(c("k64"), [1, 2]), c("k64") == 3]),
        "two_keys": (["k64", "s"], [c("k64") == 4, X.In(c("s"), ["a", "b"])]),
        "two_keys_one_free": (["k64", "s"], [c("k64") == 4, c("f") > 1.0]),
        "past_the_cap": (["k64"], [X.In(c("k64"), list(range(65)))]),
        "at_the_cap": (["k64"], [X.In(c("k64"), list(range(64)))]),
        "range_only": (["k64"], [c("k64") > 3, c("k64") < 9]),
        "column_case": (["k64"], [c("K64") == 5]),
    }


_CASES = sorted(_cases(TX))


@pytest.mark.parametrize("num_buckets", [7, 8, 200])
@pytest.mark.parametrize("case", _CASES)
def test_candidate_buckets_equal_the_jax_packages(case, num_buckets):
    jkeys, jconj = _cases(JX)[case]
    tkeys, tconj = _cases(TX)[case]
    jspec = jpr.PruneSpec("i", num_buckets, tuple(jkeys), tuple(jkeys))
    tspec = tpr.PruneSpec("i", num_buckets, tuple(tkeys), tuple(tkeys))
    want = jpr.candidate_buckets(jconj, jspec, JSchema([JField(n, d) for n, d in _DTYPES]))
    got = tpr.candidate_buckets(tconj, tspec, TSchema([TField(n, d) for n, d in _DTYPES]))
    assert got == want
    # the row-group conjuncts of the same shapes, by their text
    assert ([repr(e) for e in tpr._rowgroup_conjuncts(tconj, tspec)]
            == [repr(e) for e in jpr._rowgroup_conjuncts(jconj, jspec)])


@pytest.mark.parametrize("num_buckets", [2, 8, 33])
def test_literal_hash_lands_in_the_written_bucket(num_buckets):
    from hyperspace_tpu_torch.ops.bucketize import partition_batch

    table = pa.table({
        "k": pa.array([0, 1, -1, 5, None, 2**40, -(2**33)], type=pa.int64()),
        "s": pa.array(["", "a", "bb", "Brand#3", "x", "日本語", "a" * 100]),
    })
    batch = tio.table_to_batch(table)
    for key in ("k", "s"):
        written = np.empty(batch.num_rows, dtype=np.int64)
        for b, rows in partition_batch(batch, [key], num_buckets):
            written[rows] = b
        dtype = batch.column(key).dtype
        for i, v in enumerate(table.column(key).to_pylist()):
            v = tpr._NULL if v is None else v
            assert tpr.bucket_of_literals([v], [dtype], num_buckets) == written[i], (key, v)


# ---------------------------------------------------------------------------
# one lake, li_orderkey built by each package with 2 buckets (two row
# groups per file at this size)
# ---------------------------------------------------------------------------

ROWS = 40_000
BUCKETS = 2


def _jax_lookups(root):
    """The JAX package's forms of the three lookups (its operators, the
    port's expressions)."""

    def lookup(s, key):
        return s.read.parquet(os.path.join(root, "lineitem")).filter(
            JX.col("l_orderkey") == key).agg(
            JX.Sum(JX.col("l_extendedprice") * JX.col("l_discount")).alias("revenue"),
            JX.Count(JX.lit(1)).alias("count"))

    def range_sum(s, a, width):
        return s.read.parquet(os.path.join(root, "lineitem")).filter(
            (JX.col("l_orderkey") >= a) & (JX.col("l_orderkey") < a + width)).agg(
            JX.Sum(JX.col("l_extendedprice")).alias("sum_price"),
            JX.Count(JX.lit(1)).alias("count"))

    k = ttpch.first_orderkey(root)
    return {
        "lookup_count": (lambda s: lookup(s, k), lambda s: ttpch.lookup_count(s, root)),
        "lookup_absent": (lambda s: lookup(s, -1), lambda s: ttpch.lookup_absent(s, root)),
        "range_sum": (lambda s: range_sum(s, k, 600),
                      lambda s: ttpch.range_sum(s, root, width=600)),
    }


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prune"))
    jtpch.generate_tpch(root, rows_lineitem=ROWS, seed=7)
    name, indexed, included = ttpch.LI_ORDERKEY
    built = {"jax": os.path.join(root, "wh_jax"), "torch": os.path.join(root, "wh_torch")}
    js = J.HyperspaceSession(built["jax"], conf={JC.INDEX_NUM_BUCKETS: BUCKETS})
    J.Hyperspace(js).create_index(js.read.parquet(os.path.join(root, "lineitem")),
                                  J.CoveringIndexConfig(name, indexed, included))
    ts = T.HyperspaceSession(built["torch"], conf={TC.INDEX_NUM_BUCKETS: BUCKETS},
                             device="cpu")
    T.Hyperspace(ts).create_index(ts.read.parquet(os.path.join(root, "lineitem")),
                                  T.CoveringIndexConfig(name, indexed, included))
    return root, built


def _sessions(warehouse):
    js = J.HyperspaceSession(warehouse, conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(warehouse, device="cpu")
    return js.enable_hyperspace(), ts.enable_hyperspace()


def _scan(plan):
    return next(n for n in plan.preorder() if type(n).__name__ == "FileScan")


def test_index_files_carry_the_jax_packages_row_group_stats(lake):
    root, built = lake
    dirs = {k: os.path.join(v, "indexes", "li_orderkey", "v__=0") for k, v in built.items()}
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["torch"])) and len(files) == BUCKETS
    cols = ["l_orderkey", "l_extendedprice", "l_discount"]
    for f in files:
        want = jio.read_rowgroup_stats(os.path.join(dirs["jax"], f), cols)
        got = tio.read_rowgroup_stats(os.path.join(dirs["torch"], f), cols)
        assert len(got) == 2  # sorted runs the lookups can skip between
        assert [g["num_rows"] for g in got] == [g["num_rows"] for g in want]
        assert [g["cols"] for g in got] == [g["cols"] for g in want]
        # statistics on the clustered column only
        assert all(g["cols"]["l_extendedprice"] is None for g in got)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("q", sorted(ttpch.LOOKUP_QUERIES))
def test_plans_and_kept_row_groups_equal_the_jax_packages(lake, built_by, q):
    root, built = lake
    js, ts = _sessions(built[built_by])
    jq, tq = _jax_lookups(root)[q]
    jplan, tplan = jq(js).optimized_plan(), tq(ts).optimized_plan()
    assert tplan.pretty() == jplan.pretty()
    jscan, tscan = _scan(jplan), _scan(tplan)
    assert tscan.prune_spec.describe() == jscan.prune_spec.describe()
    want_sel, want_files = jpr.rowgroup_selection(jscan)
    got_sel, got_files = tpr.rowgroup_selection(tscan)
    assert got_sel == want_sel
    assert [f.name for f in got_files] == [f.name for f in want_files]
    expect = {"lookup_count": (1, {1}), "lookup_absent": (0, set()),
              "range_sum": (BUCKETS, {1})}[q]
    assert len(got_files) == expect[0]
    assert {len(v) for v in (got_sel or {}).values()} <= expect[1]


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_lookup_results_equal_the_jax_packages(lake, built_by, monkeypatch):
    """The device tier of both packages: the present key and the range run
    the Pallas shape in the JAX package and the matching kernel in the
    port; the scan pruned to nothing declines in both."""
    from hyperspace_tpu.plan import tpu_exec as jtx

    root, built = lake
    monkeypatch.setenv("HYPERSPACE_FORCE_PALLAS", "1")
    routes = []
    real = jtx.try_execute_tpu

    def spy(plan, session):
        out = real(plan, session)
        frag = jtx._match_fragment(plan)
        agg_list, _names = jtx._agg_list_names(frag)
        routes.append((out is not None, jtx._pallas_shape(frag.pred, (), agg_list) is not None))
        return out

    monkeypatch.setattr(jtx, "try_execute_tpu", spy)
    js, ts = _sessions(built[built_by])
    kernel = {"lookup_count": "filter_weighted_sum", "range_sum": "filter_sum"}
    for q, (jq, tq) in _jax_lookups(root).items():
        before = dict(K.PLAIN_CALLS)
        declines = dict(ts.device_stats.declines)
        got, want = tq(ts).to_pydict(), jq(js).to_pydict()
        assert routes.pop() == ((True, True) if q in kernel else (False, True)), q
        ran = [k for k in K.PLAIN_CALLS if K.PLAIN_CALLS[k] != before[k]]
        assert ran == ([kernel[q]] if q in kernel else []), q
        empty = ts.device_stats.declines.get("empty", 0) - declines.get("empty", 0)
        assert empty == (q == "lookup_absent"), q
        assert list(got) == list(want)
        assert got["count"] == want["count"]
        assert (got["count"][0] == 0) == (q == "lookup_absent")
        for name in got:
            if name != "count":
                g, w = got[name][0], want[name][0]
                assert (g is None) == (w is None), (q, name)
                assert g is None or abs(g - w) <= REL * abs(w), (q, name, g, w)


def test_verify_mode_passes_on_the_lookups(lake, monkeypatch):
    root, built = lake
    monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
    js, ts = _sessions(built["torch"])
    js.set_conf(JC.EXEC_TPU_ENABLED, False)
    ts.set_conf(TC.EXEC_TPU_ENABLED, False)
    for q, (jq, tq) in _jax_lookups(root).items():
        scan = _scan(tq(ts).optimized_plan())
        assert tpr.is_verify(scan) and len(scan.prune_spec.verify_files) == BUCKETS, q
        assert tq(ts).to_pydict() == jq(js).to_pydict(), q


def test_verify_mode_catches_a_broken_bucket_hash(lake, monkeypatch):
    root, built = lake
    monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
    real = tpr.bucket_of_literals
    monkeypatch.setattr(tpr, "bucket_of_literals",
                        lambda v, d, nb: (real(v, d, nb) + 1) % nb)
    _js, ts = _sessions(built["torch"])
    ts.set_conf(TC.EXEC_TPU_ENABLED, False)
    with pytest.raises(HyperspaceError, match="prune verify mismatch"):
        ttpch.lookup_count(ts, root).collect()


@pytest.fixture(scope="module")
def join_warehouse(lake):
    """li_orderkey and od_orderkey, co-bucketed by the port."""
    root, _built = lake
    wh = os.path.join(root, "wh_join")
    ts = T.HyperspaceSession(wh, conf={TC.INDEX_NUM_BUCKETS: BUCKETS}, device="cpu")
    for table, (name, indexed, included) in ttpch.JOIN_INDEXES.items():
        T.Hyperspace(ts).create_index(ts.read.parquet(os.path.join(root, table)),
                                      T.CoveringIndexConfig(name, indexed, included))
    return wh


def _join_queries(X, root, key):
    c = X.col

    def join(s, cond):
        li = s.read.parquet(os.path.join(root, "lineitem")).filter(cond)
        return li.join(s.read.parquet(os.path.join(root, "orders")),
                       c("l_orderkey") == c("o_orderkey")).select(
            "l_orderkey", "l_extendedprice", "o_orderdate").sort(
            "l_orderkey", "l_extendedprice", "o_orderdate")

    return {
        "point": lambda s: join(s, c("l_orderkey") == key),
        "range": lambda s: join(s, (c("l_orderkey") >= key) & (c("l_orderkey") < key + 600)),
    }


@pytest.mark.parametrize("present", [True, False])
@pytest.mark.parametrize("q", ["point", "range"])
def test_verify_mode_passes_on_a_pruned_join_side(lake, join_warehouse, monkeypatch, q,
                                                  present):
    """The bucketed join reads a pruned side one bucket at a time; verify
    mode holds each bucket's read against that bucket's full files, so the
    answer is the JAX package's and nothing raises."""
    from hyperspace_tpu_torch.plan import bucket_join as tbj

    root, _built = lake
    key = ttpch.first_orderkey(root) if present else -1000
    js, ts = _sessions(join_warehouse)
    js.set_conf(JC.EXEC_TPU_ENABLED, False)
    ts.set_conf(TC.EXEC_TPU_ENABLED, False)
    want = _join_queries(JX, root, key)[q](js).to_pydict()
    monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
    loaded = []
    real = tbj._load_side_bucket
    monkeypatch.setattr(tbj, "_load_side_bucket",
                        lambda side, b, *a, **kw: loaded.append(b) or real(side, b, *a, **kw))
    tq = _join_queries(TX, root, key)[q](ts)
    scan = _scan(tq.optimized_plan())
    assert scan.index_info.index_name == "li_orderkey" and tpr.is_verify(scan)
    assert scan.prune_spec.describe() == {
        "point": "buckets=1/2,rowgroup_conjuncts=1", "range": "rowgroup_conjuncts=2"}[q]
    got = tq.to_pydict()
    assert loaded, "the per-bucket join did not run"
    assert got == want
    assert (len(got["l_orderkey"]) > 0) == present


def test_pruning_off_reads_every_file(lake, monkeypatch):
    root, built = lake
    _js, ts = _sessions(built["torch"])
    ts.set_conf(TC.EXEC_TPU_ENABLED, False)
    pruned = ttpch.lookup_count(ts, root).to_pydict()
    monkeypatch.setenv("HYPERSPACE_PRUNE", "0")
    scan = _scan(ttpch.lookup_count(ts, root).optimized_plan())
    assert scan.prune_spec is not None and not scan.prune_spec.active
    assert len(scan.files) == BUCKETS
    assert ttpch.lookup_count(ts, root).to_pydict() == pruned


def test_a_pruned_read_never_serves_a_full_one(lake):
    _root, built = lake
    d = os.path.join(built["torch"], "indexes", "li_orderkey", "v__=0")
    paths = [os.path.join(d, f) for f in sorted(os.listdir(d))]
    cache = tio.IndexChunkCache(1 << 30)
    part = tio.read_parquet(paths, ["l_orderkey"], cache=cache, row_groups={paths[0]: (1,)})
    full = tio.read_parquet(paths, ["l_orderkey"], cache=cache)
    again = tio.read_parquet(paths, ["l_orderkey"], cache=cache, row_groups={paths[0]: (1,)})
    n0 = pq.ParquetFile(paths[0]).metadata
    assert part.num_rows == n0.row_group(1).num_rows + pq.ParquetFile(paths[1]).metadata.num_rows
    assert full.num_rows == ROWS
    # the repeat is a cache hit: the same buffers
    assert again.column("l_orderkey") is part.column("l_orderkey")


def test_a_file_without_statistics_keeps_every_row_group(tmp_path):
    path = str(tmp_path / "part-0-b00000.parquet")
    pq.write_table(pa.table({"k": np.arange(40_000, dtype=np.int64)}), path,
                   row_group_size=16384, write_statistics=False)
    from hyperspace_tpu.meta.entry import FileInfo as JFileInfo
    from hyperspace_tpu.plan.nodes import FileScan as JScan
    from hyperspace_tpu_torch.meta.entry import FileInfo as TFileInfo
    from hyperspace_tpu_torch.plan.nodes import FileScan as TScan

    spec = ("i", 1, ("k",), ("k",))
    jscan = JScan([str(tmp_path)], "parquet", JSchema([JField("k", "int64")]),
                  [JFileInfo.from_path(path)], pushed_filter=JX.col("k") == 5,
                  prune_spec=jpr.PruneSpec(*spec))
    tscan = TScan([str(tmp_path)], "parquet", TSchema([TField("k", "int64")]),
                  [TFileInfo.from_path(path)], pushed_filter=TX.col("k") == 5,
                  prune_spec=tpr.PruneSpec(*spec))
    jscan = jpr.apply_pruning(jscan)
    tscan = tpr.apply_pruning(tscan)
    assert tscan.describe() == jscan.describe()
    got, want = tpr.rowgroup_selection(tscan), jpr.rowgroup_selection(jscan)
    assert got[0] is None and want[0] is None
    assert [f.name for f in got[1]] == [f.name for f in want[1]] == [path]


# ---------------------------------------------------------------------------
# filter ranking: the fraction pruning keeps prices a candidate
# ---------------------------------------------------------------------------

def test_filter_ranking_prefers_the_index_whose_bucket_key_is_pinned(tmp_path):
    """li_sd covers only the query's columns and is indexed on l_shipdate;
    li_ok covers those and two more, indexed on l_orderkey, so it is larger
    but under 8 times li_sd. ``l_orderkey == k AND l_shipdate > d`` pins
    li_ok's bucket key: it reads 1/8 of li_ok, all of li_sd."""
    root = str(tmp_path)
    jtpch.generate_tpch(root, rows_lineitem=20_000, seed=7)
    plans = {}
    for pkg, X in ((J, JX), (T, TX)):
        wh = os.path.join(root, f"wh_{pkg.__name__}")
        s = (T.HyperspaceSession(wh, device="cpu") if pkg is T
             else J.HyperspaceSession(wh))
        hs = pkg.Hyperspace(s)
        li = s.read.parquet(os.path.join(root, "lineitem"))
        hs.create_index(li, pkg.CoveringIndexConfig(
            "li_sd", ["l_shipdate"], ["l_orderkey", "l_extendedprice"]))
        hs.create_index(li, pkg.CoveringIndexConfig(
            "li_ok", ["l_orderkey"], ["l_shipdate", "l_extendedprice", "l_discount",
                                      "l_quantity"]))
        s.enable_hyperspace()
        q = (s.read.parquet(os.path.join(root, "lineitem"))
             .filter((X.col("l_orderkey") == 17) & (X.col("l_shipdate") > 9000))
             .select("l_orderkey", "l_shipdate", "l_extendedprice"))
        plans[pkg.__name__] = q.optimized_plan()
    from hyperspace_tpu_torch.index_manager import index_manager_for

    size = {e.name: e.index_data_size_in_bytes()
            for e in index_manager_for(T.HyperspaceSession(
                os.path.join(root, "wh_hyperspace_tpu_torch"), device="cpu")).get_indexes()}
    assert size["li_sd"] < size["li_ok"] < 8 * size["li_sd"]
    names = {k: _scan(p).index_info.index_name for k, p in plans.items()}
    assert names == {"hyperspace_tpu": "li_ok", "hyperspace_tpu_torch": "li_ok"}
    assert (_scan(plans["hyperspace_tpu_torch"]).prune_spec.describe()
            == _scan(plans["hyperspace_tpu"]).prune_spec.describe()
            == "buckets=1/8,rowgroup_conjuncts=1")


# ---------------------------------------------------------------------------
# an index kind the port does not load; the JAX package's data skipping
# ---------------------------------------------------------------------------

def test_a_data_skipping_index_leaves_the_rewrite_to_the_others(tmp_path, caplog):
    """An index of a kind neither package knows (a copy of a JAX log entry
    whose kind is renamed) is skipped with one warning naming it, and the
    other indexes still serve q3."""
    import shutil

    root = str(tmp_path)
    jtpch.generate_tpch(root, rows_lineitem=20_000, seed=7)
    js = J.HyperspaceSession(root)
    hs = J.Hyperspace(js)
    for table, (name, indexed, included) in ttpch.JOIN_INDEXES.items():
        hs.create_index(js.read.parquet(os.path.join(root, table)),
                        J.CoveringIndexConfig(name, indexed, included))
    system = os.path.join(root, "indexes")
    shutil.copytree(os.path.join(system, "od_orderkey"), os.path.join(system, "od_mystery"))
    log_dir = os.path.join(system, "od_mystery", "_hyperspace_log")
    for fn in os.listdir(log_dir):
        if fn.isdigit():
            path = os.path.join(log_dir, fn)
            with open(path) as f:
                entry = json.load(f)
            entry["name"] = "od_mystery"
            if "derivedDataset" in entry:
                entry["derivedDataset"]["kind"] = "MYSTERY"
            with open(path, "w") as f:
                json.dump(entry, f)
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    with caplog.at_level(logging.WARNING):
        plan = ttpch.q3(ts, root).optimized_plan()
    used = [n.index_info.index_name for n in plan.preorder()
            if getattr(n, "index_info", None) is not None]
    assert used == ["li_orderkey", "od_orderkey"]
    skipped = [r.getMessage() for r in caplog.records if "Skipping index" in r.getMessage()]
    assert len(skipped) == 1 and "'od_mystery'" in skipped[0] and "'MYSTERY'" in skipped[0]


def test_the_jax_data_skipping_index_is_loaded_and_used_by_the_port(tmp_path):
    """The JAX package's li_ds_minmax over a lineitem split into four files
    by ship date: the port loads it, prunes the files its sketches reject
    (the same files as the JAX package), and returns the same result."""
    from hyperspace_tpu.models.dataskipping import DataSkippingIndexConfig, MinMaxSketch

    root = str(tmp_path)
    jtpch.generate_tpch(root, rows_lineitem=8_000, seed=7)
    li_dir = os.path.join(root, "lineitem")
    table = pq.read_table(li_dir).sort_by("l_shipdate")
    for f in os.listdir(li_dir):
        os.unlink(os.path.join(li_dir, f))
    for i in range(4):
        pq.write_table(table.slice(i * 2000, 2000), os.path.join(li_dir, f"part-{i}.parquet"))
    js = J.HyperspaceSession(root)
    J.Hyperspace(js).create_index(
        js.read.parquet(li_dir),
        DataSkippingIndexConfig("li_ds_minmax", [MinMaxSketch("l_shipdate")]))
    cut = int(pc_max(table.slice(0, 2000), "l_shipdate"))
    results, scans = {}, {}
    for pkg, X, s in ((J, JX, js.enable_hyperspace()),
                      (T, TX, T.HyperspaceSession(root, device="cpu").enable_hyperspace())):
        q = (s.read.parquet(li_dir).filter(X.col("l_shipdate") <= cut)
             .agg(X.Sum(X.col("l_tax")).alias("t"), X.Count(X.lit(1)).alias("n")))
        scan = [n for n in q.optimized_plan().preorder() if n.kind == "FileScan"][0]
        scans[pkg.__name__] = (scan.index_info.index_name,
                               sorted(os.path.basename(f.name) for f in scan.files))
        results[pkg.__name__] = q.collect().to_pydict()
    assert scans["hyperspace_tpu_torch"] == scans["hyperspace_tpu"]
    assert scans["hyperspace_tpu_torch"][0] == "li_ds_minmax"
    assert 0 < len(scans["hyperspace_tpu_torch"][1]) < 4  # files were pruned
    got, want = results["hyperspace_tpu_torch"], results["hyperspace_tpu"]
    assert got["n"] == want["n"]
    assert abs(got["t"][0] - want["t"][0]) <= REL * abs(want["t"][0])


def pc_max(table, column):
    import pyarrow.compute as pc

    return pc.max(table.column(column)).cast(pa.int32()).as_py()
