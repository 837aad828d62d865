"""End to end: the covering-index query path through both packages.

A small TPC-H lake (200k lineitem rows, seed 42) goes through the JAX
package and the port: generate the lake, build the covering index
li_shipdate, enable Hyperspace and run q6, q6_count, q6_sum, q1 and q1_sums.
The JAX side runs its device tier with the Pallas route forced (interpret
mode); the port runs its device tier on the CPU (plain kernel versions).
Counts and group keys must be equal, in the same row order; float results
agree within relative 1e-4. Each package also queries an index the other
built: the on-disk format is shared. The same holds for the co-bucketed
join indexes li_orderkey and od_orderkey, which both packages write bucket
file for bucket file and query with q3_agg through the fused join path.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.plan.expr import Count as JCount, Sum as JSum, col as jcol, lit as jlit
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.ops import cuda_kernels as K

ROWS = 200_000
REL = 1e-4
# a covering index on q6's range column that only these tests build (the
# reference's set reads q6 through the z-order index li_shipdate_z)
INDEX = (
    "li_shipdate",
    ["l_shipdate"],
    ["l_quantity", "l_extendedprice", "l_discount", "l_returnflag", "l_linestatus"],
)


def _jax_queries():
    """The JAX package's forms of the five queries (q6 and q1 are its own;
    the kernel-shaped forms are written here with its expressions)."""

    def lineitem(s, root):
        return s.read.parquet(os.path.join(root, "lineitem"))

    def pred():
        return ((jcol("l_shipdate") >= 8766) & (jcol("l_shipdate") < 9131)
                & (jcol("l_discount") >= 0.05) & (jcol("l_discount") <= 0.07)
                & (jcol("l_quantity") < 24))

    def q6_count(s, root):
        return lineitem(s, root).filter(pred()).agg(
            JSum(jcol("l_extendedprice") * jcol("l_discount")).alias("revenue"),
            JCount(jlit(1)).alias("count"),
        )

    def q6_sum(s, root):
        return lineitem(s, root).filter(pred()).agg(
            JSum(jcol("l_extendedprice")).alias("sum_price"), JCount(jlit(1)).alias("count")
        )

    def q1_sums(s, root):
        return (
            lineitem(s, root).filter(jcol("l_shipdate") <= 10470)
            .select("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                    "l_discount")
            .group_by("l_returnflag", "l_linestatus")
            .agg(
                JSum(jcol("l_quantity")).alias("sum_qty"),
                JSum(jcol("l_extendedprice")).alias("sum_base_price"),
                JSum(jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))).alias(
                    "sum_disc_price"),
                JCount(jlit(1)).alias("count_order"),
            )
            .sort("l_returnflag", "l_linestatus")
        )

    return {"q6": jtpch.q6, "q6_count": q6_count, "q6_sum": q6_sum, "q1": jtpch.q1,
            "q1_sums": q1_sums}


JAX_QUERIES = _jax_queries()


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch")
    jlake, tlake = str(root / "jax_lake"), str(root / "torch_lake")
    jtpch.generate_tpch(jlake, rows_lineitem=ROWS, seed=42)
    ttpch.generate_tpch(tlake, rows_lineitem=ROWS, seed=42)
    return root, jlake, tlake


def _jax_session(warehouse):
    return J.HyperspaceSession(warehouse, conf={JC.EXEC_TPU_ENABLED: True})


def _torch_session(warehouse):
    return T.HyperspaceSession(warehouse, device="cpu")


def _build(pkg, session, lake):
    name, indexed, included = INDEX
    pkg.Hyperspace(session).create_index(
        session.read.parquet(os.path.join(lake, "lineitem")),
        pkg.CoveringIndexConfig(name, indexed, included),
    )


def _index_used(df) -> list:
    return [n.index_info.index_name for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


def _assert_results_match(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        g, w = list(got[name]), list(want[name])
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            if isinstance(b, (float, np.floating)):
                assert a == b or abs(a - b) <= REL * abs(b), (name, a, b)
            else:
                assert a == b, (name, a, b)


def test_generators_write_the_same_tables(lakes):
    _root, jlake, tlake = lakes
    for table in ("lineitem", "orders", "part"):
        jfiles = sorted(os.listdir(os.path.join(jlake, table)))
        assert jfiles == sorted(os.listdir(os.path.join(tlake, table)))
        for f in jfiles:
            assert pq.read_table(os.path.join(jlake, table, f)).equals(
                pq.read_table(os.path.join(tlake, table, f))
            )


@pytest.fixture(scope="module")
def indexes(lakes):
    """One warehouse per building package, both over the JAX lake."""
    root, jlake, _ = lakes
    built = {"jax": str(root / "wh_jax"), "torch": str(root / "wh_torch")}
    _build(J, _jax_session(built["jax"]), jlake)
    _build(T, _torch_session(built["torch"]), jlake)
    return jlake, built


def test_both_packages_write_the_same_index_data(indexes):
    _lake, built = indexes
    name = INDEX[0]
    dirs = {k: os.path.join(v, "indexes", name, "v__=0") for k, v in built.items()}
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert files["jax"] == files["torch"] and files["jax"]
    for f in files["jax"]:
        assert pq.read_table(os.path.join(dirs["jax"], f)).equals(
            pq.read_table(os.path.join(dirs["torch"], f))
        )


def test_both_packages_write_the_same_log_entries(indexes):
    """The committed log entries (transient and final) and the latestStable
    pointer agree key for key. Timestamps differ, and so do the index data
    files' modified times and the warehouse each index lives under; the
    content tree is compared as (path under the warehouse, size) pairs."""
    import json

    _lake, built = indexes

    def files(node, prefix):
        path = os.path.join(prefix, node["name"])
        out = [(os.path.join(path, f["name"]), f["size"], f["id"]) for f in node["files"]]
        for sub in node["subDirs"]:
            out += files(sub, path)
        return out

    def entry(pkg, name):
        path = os.path.join(built[pkg], "indexes", INDEX[0], "_hyperspace_log", name)
        with open(path) as f:
            d = json.load(f)
        d.pop("timestamp")
        if "content" in d:
            d["content"] = sorted(
                (os.path.relpath(p, built[pkg]), size, fid)
                for p, size, fid in files(d["content"]["root"], "")
            )
        return d

    for name in ("0", "1", "latestStable"):
        assert entry("jax", name) == entry("torch", name), name


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_queries_match_across_packages(indexes, built_by, monkeypatch):
    """Both packages query the index ``built_by`` built (so one side always
    reads the other package's index) and agree."""
    lake, built = indexes
    monkeypatch.setenv("HYPERSPACE_FORCE_PALLAS", "1")
    jsession = _jax_session(built[built_by]).enable_hyperspace()
    tsession = _torch_session(built[built_by]).enable_hyperspace()
    expected_kernel = {"q6_count": "filter_weighted_sum", "q6_sum": "filter_sum",
                       "q1_sums": "filter_grouped_multi_sum"}
    for q, tfn in ttpch.QUERIES.items():
        jdf, tdf = JAX_QUERIES[q](jsession, lake), tfn(tsession, lake)
        assert _index_used(jdf) == _index_used(tdf) == [INDEX[0]], q
        before = dict(K.PLAIN_CALLS)
        fragments = tsession.device_stats.device_fragments
        got = tdf.to_pydict()
        assert tsession.device_stats.device_fragments == fragments + 1, q
        ran = [k for k in K.PLAIN_CALLS if K.PLAIN_CALLS[k] != before[k]]
        assert ran == ([expected_kernel[q]] if q in expected_kernel else []), q
        _assert_results_match(got, jdf.to_pydict())


@pytest.fixture(scope="module")
def join_indexes(lakes):
    """li_orderkey and od_orderkey, one warehouse per building package."""
    from test_torch_join import build_join_indexes

    root, jlake, _ = lakes
    built = {"jax": str(root / "wh_jax_join"), "torch": str(root / "wh_torch_join")}
    build_join_indexes(J, _jax_session(built["jax"]), jlake)
    build_join_indexes(T, _torch_session(built["torch"]), jlake)
    return jlake, built


@pytest.mark.parametrize("name", [ttpch.LI_ORDERKEY[0], ttpch.OD_ORDERKEY[0]])
def test_both_packages_write_the_same_join_index_data(join_indexes, name):
    _lake, built = join_indexes
    dirs = {k: os.path.join(v, "indexes", name, "v__=0") for k, v in built.items()}
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert files["jax"] == files["torch"] and len(files["jax"]) == 8
    for f in files["jax"]:
        assert pq.read_table(os.path.join(dirs["jax"], f)).equals(
            pq.read_table(os.path.join(dirs["torch"], f))
        )


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_q3_agg_reads_the_other_packages_join_indexes(join_indexes, built_by):
    from test_torch_join import JAX_JOIN_QUERIES, assert_join_results_match, index_names

    lake, built = join_indexes
    jsession = _jax_session(built[built_by]).enable_hyperspace()
    tsession = _torch_session(built[built_by]).enable_hyperspace()
    jdf = JAX_JOIN_QUERIES["q3_agg"](jsession, lake)
    tdf = ttpch.JOIN_QUERIES["q3_agg"](tsession, lake)
    assert index_names(jdf) == index_names(tdf) == ["li_orderkey", "od_orderkey"]
    got = tdf.to_pydict()
    assert tsession.device_stats.device_join_fragments == 1
    assert not tsession.device_stats.declines
    assert_join_results_match("q3_agg", got, jdf.to_pydict())
