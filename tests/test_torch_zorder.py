"""The z-order covering index and the reference's TPC-H index set, held
against the JAX package on the same inputs.

- Field codes (min-max and percentile, over ints, floats with NULLs,
  dates, bools and strings) and ``interleave_bits``: equal, exactly, with
  equal ``to_dict`` forms.
- Index files: a one-column z-order over TPC-H lineitem (20,000 rows,
  seed 7), a two-column one with a string column whose small
  ``targetSourceBytesPerPartition`` forces several parts, and one with
  percentile fields: both packages write the same file names, row order
  and values, and the same derived-dataset JSON in the log.
- Each package queries the other's z-order index to the same results, and
  the port queries an index the JAX package built with its streaming
  (out-of-core) build to the JAX package's results.
- Plans: over the golden fixture's index set (``tpch_indexes`` plus
  ``li_ds_minmax``, 2,000 rows, seed 7, built by the JAX package), the
  port's optimized plans of the six TPC-H queries render as the JAX
  package's, q6 reads li_shipdate_z and q1 li_flagstatus; the port-only
  forms (q6_count, q6_sum, q1_sums and the lookups), built with each
  package's operators, render alike too, ``pruned[...]`` included. On the
  port's own build of its whole set (seven indexes, the data-skipping
  ``li_shipdate_mm`` included) the same plans come out.

Tolerances: counts and keys exact; f32 sums within relative 1e-4.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.models import zorder as jz
from hyperspace_tpu.models.zorder import fields as jfields
from hyperspace_tpu.ops import zorder as jops
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.models.zorder import fields as tfields
from hyperspace_tpu_torch.models.zorder import index as tzindex
from hyperspace_tpu_torch.ops import zorder as tops
from hyperspace_tpu_torch.plan import expr as TX

REL = 1e-4

# ---------------------------------------------------------------------------
# field codes and bit interleaving
# ---------------------------------------------------------------------------


def _columns(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, n)
    floats = rng.normal(0, 1e3, n)
    return pa.table({
        "i64": pa.array(ints, pa.int64()),
        "f64_nulls": pa.array(floats, pa.float64(), mask=rng.random(n) < 0.1),
        "date": pa.array(rng.integers(8035, 10590, n).astype(np.int32), pa.date32()),
        "flag": pa.array(rng.random(n) < 0.3),
        "skewed": pa.array(np.exp(rng.normal(0, 3, n)), pa.float64()),
        "s": pa.array(rng.choice(["N", "A", "R", "", "Brand#3", "日本"], n)),
        "const": pa.array(np.full(n, 7, dtype=np.int32)),
    })


@pytest.mark.parametrize("percentile", [False, True])
@pytest.mark.parametrize("nbits", [1, 5, 16])
@pytest.mark.parametrize("column", ["i64", "f64_nulls", "date", "flag", "skewed", "s", "const"])
def test_field_codes_equal_the_jax_packages(column, nbits, percentile):
    table = _columns(3000, 5)
    jcol = jio.table_to_batch(table).column(column)
    tcol = tio.table_to_batch(table).column(column)
    jf = jfields.build_field(column, jcol, percentile, nbits)
    tf = tfields.build_field(column, tcol, percentile, nbits)
    assert tf.to_dict() == jf.to_dict()
    assert tfields.ZOrderField.from_dict(jf.to_dict()).to_dict() == jf.to_dict()
    got, want = tf.codes(tcol), jf.codes(jcol)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("widths", [(16,), (3, 7), (16, 16, 16), (1, 20, 5, 8), (32, 32)])
def test_interleave_bits_equals_the_jax_packages(widths):
    rng = np.random.default_rng(len(widths))
    fields = [(rng.integers(0, 1 << w, 5000, dtype=np.uint64), w) for w in widths]
    assert np.array_equal(tops.interleave_bits(fields), jops.interleave_bits(fields))
    vals = rng.normal(0, 10, 5000)
    assert np.array_equal(tops.scale_min_max(vals, -5.0, 5.0, 12),
                          jops.scale_min_max(vals, -5.0, 5.0, 12))
    bounds = np.sort(rng.normal(0, 10, 255))
    assert np.array_equal(tops.scale_percentile(vals, bounds, 8),
                          jops.scale_percentile(vals, bounds, 8))


# ---------------------------------------------------------------------------
# index files and cross-package queries
# ---------------------------------------------------------------------------

ROWS = 20_000


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zorder"))
    jtpch.generate_tpch(root, rows_lineitem=ROWS, seed=7)
    rng = np.random.default_rng(3)
    # a two-column z-order source: an int and a string indexed column (two
    # copies, one per index, so each query has one candidate)
    table = pa.table({
        "a": rng.integers(0, 5000, ROWS),
        "s": rng.choice([f"key{i:03d}" for i in range(40)], ROWS),
        "v": rng.uniform(0, 100, ROWS),
    })
    for d in ("z2", "z2q"):
        os.makedirs(os.path.join(root, d))
        pq.write_table(table, os.path.join(root, d, "part-0.parquet"))
    return root


# (name, table, indexed, included, target bytes per part or None, quantile)
_ZINDEXES = {
    "li_shipdate_z": ("lineitem", *ttpch.LI_SHIPDATE_Z[1:], None, False),
    "z2": ("z2", ["a", "s"], ["v"], 64 * 1024, False),
    "z2_quantile": ("z2q", ["s", "a"], ["v"], 100 * 1024, True),
}


@pytest.fixture(scope="module")
def built(lake):
    """Each z-order index, built by each package into its own warehouse;
    both take the part size and field kind from their session conf."""
    out = {}
    for pkg, C in ((J, JC), (T, TC)):
        wh = os.path.join(lake, f"wh_{pkg.__name__}")
        for name, (table, indexed, included, target, quantile) in _ZINDEXES.items():
            conf = {C.ZORDER_QUANTILE_ENABLED: quantile}
            if target is not None:
                conf[C.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION] = target
            if pkg is T:
                s = T.HyperspaceSession(wh, conf=conf, device="cpu")
            else:
                s = J.HyperspaceSession(wh, conf=conf)
            config = (T.ZOrderCoveringIndexConfig if pkg is T
                      else jz.ZOrderCoveringIndexConfig)
            pkg.Hyperspace(s).create_index(s.read.parquet(os.path.join(lake, table)),
                                           config(name, indexed, included))
        out["jax" if pkg is J else "torch"] = wh
    return out


def test_build_settings_default_to_the_jax_packages(tmp_path):
    conf = T.HyperspaceSession(str(tmp_path), device="cpu").conf
    jconf = J.HyperspaceSession(str(tmp_path)).conf
    assert (conf.zorder_target_source_bytes_per_partition
            == jconf.zorder_target_source_bytes_per_partition
            == JC.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION_DEFAULT)
    assert conf.zorder_quantile_enabled is jconf.zorder_quantile_enabled is False
    assert not hasattr(tzindex, "_TARGET_BYTES_PER_PARTITION")
    assert not hasattr(tzindex, "_QUANTILE")


@pytest.mark.parametrize("name", sorted(_ZINDEXES))
def test_both_packages_write_the_same_zorder_files(built, name):
    dirs = {k: os.path.join(v, "indexes", name, "v__=0") for k, v in built.items()}
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert files["jax"] == files["torch"]
    assert len(files["jax"]) == {"li_shipdate_z": 1, "z2": 7, "z2_quantile": 4}[name]
    for f in files["jax"]:
        a = pq.read_table(os.path.join(dirs["jax"], f))
        b = pq.read_table(os.path.join(dirs["torch"], f))
        assert a.equals(b), f
        # the same row-group statistics: every indexed column carries them
        indexed = _ZINDEXES[name][1]
        ja = jio.read_rowgroup_stats(os.path.join(dirs["jax"], f), indexed)
        ta = tio.read_rowgroup_stats(os.path.join(dirs["torch"], f), indexed)
        assert [g["cols"] for g in ta] == [g["cols"] for g in ja]
        assert all(g["cols"][c] is not None for g in ta for c in indexed)

    def derived(pkg):
        path = os.path.join(built[pkg], "indexes", name, "_hyperspace_log", "1")
        with open(path) as f:
            return json.load(f)["derivedDataset"]

    assert derived("torch") == derived("jax")
    assert derived("torch")["kind"] == "ZCI"


def _zqueries(X, root):
    c, lit = X.col, X.lit
    li = os.path.join(root, "lineitem")
    z2, z2q = os.path.join(root, "z2"), os.path.join(root, "z2q")
    return {
        "li_shipdate_z": lambda s: s.read.parquet(li).filter(
            (c("l_shipdate") >= 8766) & (c("l_shipdate") < 9131) & (c("l_quantity") < 24)
        ).agg(X.Sum(c("l_extendedprice") * c("l_discount")).alias("revenue"),
              X.Count(lit(1)).alias("count")),
        "z2": lambda s: s.read.parquet(z2).filter(
            (c("a") >= 1000) & (c("a") < 1800) & (c("s") == "key007")
        ).select("a", "s", "v").sort("a", "v"),
        "z2_quantile": lambda s: s.read.parquet(z2q).filter(c("s") == "key011").agg(
            X.Sum(c("v")).alias("v"), X.Count(lit(1)).alias("count")),
    }


def _assert_close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            if isinstance(b, (float, np.floating)):
                assert abs(a - b) <= REL * abs(b), (k, a, b)
            else:
                assert a == b, (k, a, b)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(_ZINDEXES))
def test_each_package_queries_the_others_zorder_index(lake, built, built_by, name):
    js = J.HyperspaceSession(built[built_by], conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(built[built_by], device="cpu")
    js.enable_hyperspace()
    ts.enable_hyperspace()
    jq, tq = _zqueries(JX, lake)[name](js), _zqueries(TX, lake)[name](ts)
    jplan, tplan = jq.optimized_plan().pretty(), tq.optimized_plan().pretty()
    assert tplan == jplan
    assert f"Hyperspace(Type: ZCI, Name: {name}," in tplan
    got = tq.to_pydict()
    assert len(next(iter(got.values()))) > 0
    _assert_close(got, jq.to_pydict())


def test_port_queries_a_streamed_jax_build(tmp_path):
    """The JAX package streams a z-order build past
    ``hyperspace.tpu.build.maxBytesInMemory`` (cut points from a sample, one
    sorted run per range and file group); the port reads that layout."""
    root = str(tmp_path)
    rng = np.random.default_rng(9)
    os.makedirs(os.path.join(root, "src"))
    for i in range(4):
        pq.write_table(pa.table({
            "x": rng.integers(0, 10_000, 5000),
            "y": rng.uniform(-50, 50, 5000),
            "v": rng.uniform(0, 1, 5000),
        }), os.path.join(root, "src", f"part-{i}.parquet"))
    js = J.HyperspaceSession(root, conf={
        JC.BUILD_MAX_BYTES_IN_MEMORY: 100_000,
        JC.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION: 64 * 1024,
    })
    J.Hyperspace(js).create_index(js.read.parquet(os.path.join(root, "src")),
                                  jz.ZOrderCoveringIndexConfig("zs", ["x", "y"], ["v"]))
    files = os.listdir(os.path.join(root, "indexes", "zs", "v__=0"))
    assert any(f.count("-") == 3 for f in files)  # part-0-z<range>-<group>: streamed
    js.enable_hyperspace()
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()

    def q(X, s):
        return s.read.parquet(os.path.join(root, "src")).filter(
            (X.col("x") < 2500) & (X.col("y") > 10.0)
        ).agg(X.Sum(X.col("v")).alias("v"), X.Count(X.lit(1)).alias("count"))

    jq, tq = q(JX, js), q(TX, ts)
    assert tq.optimized_plan().pretty() == jq.optimized_plan().pretty()
    assert "Name: zs," in tq.optimized_plan().pretty()
    got = tq.to_pydict()
    assert got["count"][0] > 0
    _assert_close(got, jq.to_pydict())


# ---------------------------------------------------------------------------
# plans over the reference's TPC-H index set
# ---------------------------------------------------------------------------


def _jax_port_only_forms(root):
    """The port-only query forms written with the JAX package's operators."""
    c, lit = JX.col, JX.lit

    def li(s):
        return s.read.parquet(os.path.join(root, "lineitem"))

    def q6_pred():
        return ((c("l_shipdate") >= 8766) & (c("l_shipdate") < 9131)
                & (c("l_discount") >= 0.05) & (c("l_discount") <= 0.07)
                & (c("l_quantity") < 24))

    def lookup(s, key):
        return li(s).filter(c("l_orderkey") == key).agg(
            JX.Sum(c("l_extendedprice") * c("l_discount")).alias("revenue"),
            JX.Count(lit(1)).alias("count"))

    k = ttpch.first_orderkey(root)
    return {
        "q6_count": lambda s: li(s).filter(q6_pred()).agg(
            JX.Sum(c("l_extendedprice") * c("l_discount")).alias("revenue"),
            JX.Count(lit(1)).alias("count")),
        "q6_sum": lambda s: li(s).filter(q6_pred()).agg(
            JX.Sum(c("l_extendedprice")).alias("sum_price"), JX.Count(lit(1)).alias("count")),
        "q1_sums": lambda s: (
            li(s).filter(c("l_shipdate") <= 10470)
            .select("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                    "l_discount")
            .group_by("l_returnflag", "l_linestatus")
            .agg(JX.Sum(c("l_quantity")).alias("sum_qty"),
                 JX.Sum(c("l_extendedprice")).alias("sum_base_price"),
                 JX.Sum(c("l_extendedprice") * (lit(1.0) - c("l_discount"))).alias(
                     "sum_disc_price"),
                 JX.Count(lit(1)).alias("count_order"))
            .sort("l_returnflag", "l_linestatus")),
        "lookup_count": lambda s: lookup(s, k),
        "lookup_absent": lambda s: lookup(s, -1),
        "range_sum": lambda s: li(s).filter(
            (c("l_orderkey") >= k) & (c("l_orderkey") < k + 200_000)).agg(
            JX.Sum(c("l_extendedprice")).alias("sum_price"), JX.Count(lit(1)).alias("count")),
    }


_PORT_ONLY = {**{q: ttpch.QUERIES[q] for q in ("q6_count", "q6_sum", "q1_sums")},
              **ttpch.LOOKUP_QUERIES}
_READS = {"q6": ["li_shipdate_z"], "q6_count": ["li_shipdate_z"],
          "q6_sum": ["li_shipdate_z"], "q1": ["li_flagstatus"], "q1_sums": ["li_flagstatus"],
          "lookup_count": ["li_orderkey"], "lookup_absent": ["li_orderkey"],
          "range_sum": ["li_orderkey"]}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden fixture's index set (tests/test_plan_stability.py):
    the JAX package's tpch_indexes plus li_ds_minmax, 2,000 rows, seed 7;
    and the port's tpch_indexes over the same lake (the whole set, its
    data-skipping li_shipdate_mm included)."""
    from hyperspace_tpu.models.dataskipping import DataSkippingIndexConfig, MinMaxSketch

    root = str(tmp_path_factory.mktemp("tpch_golden"))
    jtpch.generate_tpch(root, rows_lineitem=2000, seed=7)
    js = J.HyperspaceSession(warehouse_dir=root)
    hs = J.Hyperspace(js)
    jtpch.tpch_indexes(js, hs, root)
    hs.create_index(js.read.parquet(os.path.join(root, "lineitem")),
                    DataSkippingIndexConfig("li_ds_minmax", [MinMaxSketch("l_shipdate")]))
    twh = os.path.join(root, "wh_torch")
    ts = T.HyperspaceSession(twh, device="cpu")
    ttpch.tpch_indexes(ts, T.Hyperspace(ts), root)
    from hyperspace_tpu_torch.index_manager import index_manager_for

    kinds = {e.name: e.derived_dataset.kind for e in index_manager_for(ts).get_indexes()}
    assert kinds["li_shipdate_mm"] == "DS" and len(kinds) == len(ttpch.TPCH_INDEXES)
    return root, twh


def _used(plan) -> list:
    return [n.index_info.index_name for n in plan.preorder()
            if getattr(n, "index_info", None) is not None]


def _scan_pruning(plan) -> list:
    return [n.prune_spec.describe() for n in plan.preorder()
            if getattr(n, "prune_spec", None) is not None and n.prune_spec.active]


@pytest.mark.parametrize("q", sorted(ttpch.TPCH_QUERIES) + sorted(_PORT_ONLY))
def test_plans_over_the_reference_index_set_render_as_jax(golden, q):
    root, twh = golden
    js = J.HyperspaceSession(warehouse_dir=root).enable_hyperspace()
    ts = T.HyperspaceSession(root, device="cpu").enable_hyperspace()
    if q in ttpch.TPCH_QUERIES:
        jplan = getattr(jtpch, q)(js, root).optimized_plan()
        tplan = ttpch.TPCH_QUERIES[q](ts, root).optimized_plan()
    else:
        jplan = _jax_port_only_forms(root)[q](js).optimized_plan()
        tplan = _PORT_ONLY[q](ts, root).optimized_plan()
    assert tplan.pretty() == jplan.pretty()
    if q in _READS:
        assert _used(tplan) == _READS[q]
    if q in ttpch.LOOKUP_PRUNING:
        assert _scan_pruning(tplan) == [ttpch.LOOKUP_PRUNING[q]]
    # the port's own build of the whole set (li_shipdate_mm included) plans
    # alike: the z-order and covering rewrites beat data skipping's score 1
    own = T.HyperspaceSession(twh, device="cpu").enable_hyperspace()
    fn = ttpch.TPCH_QUERIES.get(q) or _PORT_ONLY[q]
    assert fn(own, root).optimized_plan().pretty().replace(twh, root) == tplan.pretty()
