"""TPC-H data and the covering-index query path's queries (counterpart of
hyperspace_tpu/benchmark/tpch.py: ``generate_tpch``, ``q1``, ``q3`` and
``q6`` are copies, so the same seed writes the same tables).

``q6`` and ``q1`` as written reach no hand-written kernel: ``q6`` has one
Sum and no Count, and ``q1`` has an Avg. Their kernel-shaped forms do:

- ``q6_count``: Q6's predicate, sum(l_extendedprice*l_discount) and
  count(1), with no projection: filter_weighted_sum;
- ``q6_sum``: Q6's predicate, sum(l_extendedprice) and count(1):
  filter_sum;
- ``q1_sums``: Q1 without avg_qty, three float sums and a count over six
  groups: filter_grouped_multi_sum.

Two port-only forms take the pipelined executor's partial route (every
aggregate folds exactly across chunks), which no TPC-H form takes, since
each sums floats: ``q6_span`` (Q6's predicate over ``li_shipdate_z``;
count, min and max of l_shipdate) and ``q1_span`` (Q1's predicate and
groups over ``li_flagstatus``; the same three per group).

The lookups (``LOOKUP_QUERIES``) are port-only kernel-shaped forms over
``li_orderkey``, which predicate pruning narrows: ``lookup_count`` (a
point lookup, q6_count's shape), ``lookup_absent`` (the same with a key
no row holds) and ``range_sum`` (a key range, q6_sum's shape).
``tpch_indexes`` builds the reference's index set: q6's forms read the
z-order index ``li_shipdate_z``, q1's the covering index
``li_flagstatus`` through AggregateIndexRule. ``q6_tax_sum`` (port-only)
is served by the data-skipping index ``li_shipdate_mm`` alone.
The join form (``JOIN_QUERIES``) reads two co-bucketed covering indexes,
``li_orderkey`` and ``od_orderkey``, through JoinIndexRule: ``q3`` as the
reference writes it (top 10 orders by revenue), and ``q3_agg``, the same
query without the sort and limit, so every group is compared.
``q3_span`` (port-only) is q3_agg's join and groups with count, min and
max of l_quantity, aggregates that fold exactly across left chunks, so the
fused join splits its buckets where the strategy plan says so.
``q3_revenue`` (port-only) is q3_agg's join and filter with sum(revenue)
and count(1) and no groups: the sampled tier's shape.

``q10``, ``q17`` and ``q18`` are copies of the reference's: the plain
co-bucketed join (q10 over ``li_orderkey`` and ``od_orderkey``, q17 over
``li_partkey`` and ``pt_partkey``), and grouped aggregates over a bare
lineitem scan that AggregateIndexRule rewrites to a bucketed index (q17's
per-part average over ``li_partkey``, q18's per-order volume over
``li_orderkey``). ``TPCH_QUERIES`` holds the reference's six TPC-H
queries under the reference's names.

Scale: ``rows_lineitem`` drives everything (SF1 ~ 6M lineitem rows).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..plan.expr import Avg, Count, Max, Min, Sum, col, lit


def generate_tpch(root: str, rows_lineitem: int = 600_000, seed: int = 0) -> dict:
    """Write lineitem/orders/part parquet dirs under `root`; returns sizes.

    The draws are the reference's, in its order, so the same seed writes
    the same files. Two things differ in how, not what: a string column is
    an arrow ``take`` of the draws' indexes (``rng.choice`` over a list
    draws exactly ``rng.integers(0, len(values), n)``), not a numpy str
    array converted row by row; and the lineitem files are written on a
    thread pool while the next file's columns are drawn."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..utils.workers import io_pool, io_worker_count

    rng = np.random.default_rng(seed)
    n_orders = max(1, rows_lineitem // 4)
    n_parts = max(1, rows_lineitem // 30)

    def choice(values: list, n: int):
        return pa.array(values).take(pa.array(rng.integers(0, len(values), n)))

    sizes = {}
    li_dir = os.path.join(root, "lineitem")
    os.makedirs(li_dir, exist_ok=True)
    n_files = max(1, rows_lineitem // 500_000)
    per = rows_lineitem // n_files
    workers = io_worker_count(n_files)

    def write(t, f: str) -> int:
        pq.write_table(t, f)
        return os.path.getsize(f)

    pending = []
    with io_pool(workers, "hs-tpch-write") as pool:
        for i in range(n_files):
            t = pa.table(
                {
                    "l_orderkey": rng.integers(0, n_orders, per),
                    "l_partkey": rng.integers(0, n_parts, per),
                    "l_suppkey": rng.integers(0, max(1, n_parts // 4), per),
                    "l_quantity": rng.integers(1, 51, per).astype(np.float64),
                    "l_extendedprice": rng.uniform(900, 105_000, per),
                    "l_discount": np.round(rng.uniform(0.0, 0.1, per), 2),
                    "l_tax": np.round(rng.uniform(0.0, 0.08, per), 2),
                    "l_returnflag": choice(["A", "N", "R"], per),
                    "l_linestatus": choice(["O", "F"], per),
                    "l_shipdate": rng.integers(8035, 10590, per).astype(np.int32),
                }
            )
            f = os.path.join(li_dir, f"part-{i:04d}.parquet")
            pending.append(pool.submit(write, t, f))
            if len(pending) >= 2 * workers:  # bound the tables held in memory
                pending[-2 * workers].result()
        sizes["lineitem"] = sum(p.result() for p in pending)

    od_dir = os.path.join(root, "orders")
    os.makedirs(od_dir, exist_ok=True)
    t = pa.table(
        {
            "o_orderkey": np.arange(n_orders),
            "o_custkey": rng.integers(0, max(1, n_orders // 10), n_orders),
            "o_orderdate": rng.integers(8035, 10590, n_orders).astype(np.int32),
            "o_shippriority": rng.integers(0, 5, n_orders),
        }
    )
    f = os.path.join(od_dir, "part-0.parquet")
    pq.write_table(t, f)
    sizes["orders"] = os.path.getsize(f)

    pt_dir = os.path.join(root, "part")
    os.makedirs(pt_dir, exist_ok=True)
    t = pa.table(
        {
            "p_partkey": np.arange(n_parts),
            "p_brand": choice([f"Brand#{i}" for i in range(1, 6)], n_parts),
            "p_container": choice(["JUMBO PKG", "MED BOX", "SM CASE"], n_parts),
        }
    )
    f = os.path.join(pt_dir, "part-0.parquet")
    pq.write_table(t, f)
    sizes["part"] = os.path.getsize(f)
    return sizes


def _lineitem(session, root: str):
    return session.read.parquet(os.path.join(root, "lineitem"))


def _q6_predicate():
    return (
        (col("l_shipdate") >= 8766)
        & (col("l_shipdate") < 9131)
        & (col("l_discount") >= 0.05)
        & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24)
    )


def q1_of(li):
    """Pricing summary report over a lineitem DataFrame: grouped aggregates
    over a shipdate bound."""
    return (
        li.filter(col("l_shipdate") <= 10470)
        .select(
            "l_returnflag",
            "l_linestatus",
            "l_quantity",
            "l_extendedprice",
            "l_discount",
        )
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            Sum(col("l_quantity")).alias("sum_qty"),
            Sum(col("l_extendedprice")).alias("sum_base_price"),
            Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("sum_disc_price"),
            Avg(col("l_quantity")).alias("avg_qty"),
            Count(lit(1)).alias("count_order"),
        )
        .sort("l_returnflag", "l_linestatus")
    )


def q1(session, root: str):
    return q1_of(_lineitem(session, root))


def q1_sums_of(li):
    """Q1 without avg_qty: sums and a count only (the grouped kernel's shape)."""
    return (
        li.filter(col("l_shipdate") <= 10470)
        .select(
            "l_returnflag",
            "l_linestatus",
            "l_quantity",
            "l_extendedprice",
            "l_discount",
        )
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            Sum(col("l_quantity")).alias("sum_qty"),
            Sum(col("l_extendedprice")).alias("sum_base_price"),
            Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("sum_disc_price"),
            Count(lit(1)).alias("count_order"),
        )
        .sort("l_returnflag", "l_linestatus")
    )


def q1_sums(session, root: str):
    return q1_sums_of(_lineitem(session, root))


def q6(session, root: str):
    """Forecasting revenue change: tight range filter + global aggregate."""
    return (
        _lineitem(session, root)
        .filter(_q6_predicate())
        .select("l_shipdate", "l_extendedprice", "l_discount", "l_quantity")
        .agg(Sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))
    )


def q6_count_of(li):
    """Q6 as filter -> sum(a*b) + count (the weighted-sum kernel's shape)."""
    return li.filter(_q6_predicate()).agg(
        Sum(col("l_extendedprice") * col("l_discount")).alias("revenue"),
        Count(lit(1)).alias("count"),
    )


def q6_count(session, root: str):
    return q6_count_of(_lineitem(session, root))


def q6_sum_of(li):
    """Q6 as filter -> sum(a) + count (the single-measure kernel's shape)."""
    return li.filter(_q6_predicate()).agg(
        Sum(col("l_extendedprice")).alias("sum_price"),
        Count(lit(1)).alias("count"),
    )


def q6_sum(session, root: str):
    return q6_sum_of(_lineitem(session, root))


def q6_span(session, root: str):
    """Q6's predicate, count(1) and the ship-date span of the passing rows:
    exact aggregates only (the pipelined partial route)."""
    return _lineitem(session, root).filter(_q6_predicate()).agg(
        Count(lit(1)).alias("count"),
        Min(col("l_shipdate")).alias("first_ship"),
        Max(col("l_shipdate")).alias("last_ship"),
    )


def q1_span(session, root: str):
    """Q1's predicate and groups, with count(1) and the ship-date span per
    group: the grouped partial route."""
    return (
        _lineitem(session, root)
        .filter(col("l_shipdate") <= 10470)
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            Count(lit(1)).alias("count_order"),
            Min(col("l_shipdate")).alias("first_ship"),
            Max(col("l_shipdate")).alias("last_ship"),
        )
        .sort("l_returnflag", "l_linestatus")
    )


def q6_tax_sum(session, root: str):
    """Q6's shipdate range, sum(l_tax) and count(1): l_tax is in no
    covering index, so only li_shipdate_mm can serve it (filter_sum's
    shape over the raw lineitem scan its pruning keeps)."""
    return _lineitem(session, root).filter(
        (col("l_shipdate") >= 8766) & (col("l_shipdate") < 9131)
    ).agg(Sum(col("l_tax")).alias("sum_tax"), Count(lit(1)).alias("count"))


def q3_agg_of(li, od):
    """Q3 without the sort and limit over lineitem and orders DataFrames:
    revenue of every qualifying order."""
    return (
        li.select("l_orderkey", "l_extendedprice", "l_discount")
        .join(
            od.select("o_orderkey", "o_orderdate"),
            col("l_orderkey") == col("o_orderkey"),
        )
        .filter(col("o_orderdate") < 9500)
        .group_by("l_orderkey", "o_orderdate")
        .agg(Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("revenue"))
    )


def _q3_grouped(session, root: str):
    return q3_agg_of(_lineitem(session, root), session.read.parquet(os.path.join(root, "orders")))


def q3(session, root: str):
    """Shipping priority: join lineitem to orders, revenue per order."""
    return _q3_grouped(session, root).sort("revenue", ascending=False).limit(10)


def q3_agg(session, root: str):
    """Q3 without the sort and limit: revenue of every qualifying order."""
    return _q3_grouped(session, root)


def q3_revenue(session, root: str):
    """Q3's join and order-date filter with sum(revenue) and count(1), no
    groups (port-only): the shape the sampled tier answers over the two
    join indexes' twins (its groups are not the sampling key)."""
    li = _lineitem(session, root)
    od = session.read.parquet(os.path.join(root, "orders"))
    return (
        li.select("l_orderkey", "l_extendedprice", "l_discount")
        .join(od.select("o_orderkey", "o_orderdate"), col("l_orderkey") == col("o_orderkey"))
        .filter(col("o_orderdate") < 9500)
        .agg(Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("revenue"),
             Count(lit(1)).alias("count"))
    )


def q3_span(session, root: str):
    """Q3's join, filter and groups with count(1), min(l_quantity) and
    max(l_quantity) (port-only): every aggregate folds exactly across left
    chunks, so the fused device join may split its buckets."""
    li = _lineitem(session, root)
    od = session.read.parquet(os.path.join(root, "orders"))
    return (
        li.select("l_orderkey", "l_quantity")
        .join(od.select("o_orderkey", "o_orderdate"), col("l_orderkey") == col("o_orderkey"))
        .filter(col("o_orderdate") < 9500)
        .group_by("l_orderkey", "o_orderdate")
        .agg(Count(lit(1)).alias("lines"), Min(col("l_quantity")).alias("min_qty"),
             Max(col("l_quantity")).alias("max_qty"))
    )


def q17(session, root: str):
    """Small-quantity-order revenue: per-part average quantity joined back
    against lineitem; rows below 20% of their part's average contribute."""
    li = _lineitem(session, root)
    pt = session.read.parquet(os.path.join(root, "part"))
    avg_qty = (
        li.select("l_partkey", "l_quantity")
        .group_by("l_partkey")
        .agg(Avg(col("l_quantity")).alias("avg_qty"))
        .select(col("l_partkey").alias("ap_partkey"), col("avg_qty"))
    )
    return (
        li.select("l_partkey", "l_quantity", "l_extendedprice")
        .join(
            pt.filter(col("p_brand") == "Brand#3").select("p_partkey"),
            col("l_partkey") == col("p_partkey"),
        )
        .join(avg_qty, col("l_partkey") == col("ap_partkey"))
        .filter(col("l_quantity") < lit(0.2) * col("avg_qty"))
        .agg(Sum(col("l_extendedprice")).alias("total"))
        .select((col("total") / lit(7.0)).alias("avg_yearly"))
    )


def q10(session, root: str):
    """Returned-item reporting: returned lineitems joined to orders in a
    quarter, revenue per customer, top 20."""
    li = _lineitem(session, root)
    od = session.read.parquet(os.path.join(root, "orders"))
    return (
        li.filter(col("l_returnflag") == "R")
        .select("l_orderkey", "l_extendedprice", "l_discount")
        .join(
            od.select("o_orderkey", "o_custkey", "o_orderdate"),
            col("l_orderkey") == col("o_orderkey"),
        )
        .filter((col("o_orderdate") >= 8766) & (col("o_orderdate") < 8856))
        .group_by("o_custkey")
        .agg(
            Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias(
                "revenue"
            )
        )
        # o_custkey breaks revenue near-ties, so the top-20 cut does not
        # depend on the engine or the execution order
        .sort("revenue", "o_custkey", ascending=[False, True])
        .limit(20)
    )


def q18(session, root: str):
    """Large-volume customers: orders whose total quantity crosses the
    threshold (HAVING over a per-order aggregate), joined back to orders,
    largest first (quantity ties broken by order key)."""
    li = _lineitem(session, root)
    od = session.read.parquet(os.path.join(root, "orders"))
    big = (
        li.select("l_orderkey", "l_quantity")
        .group_by("l_orderkey")
        .agg(Sum(col("l_quantity")).alias("sum_qty"))
        .filter(col("sum_qty") > 300)
    )
    return (
        big.join(
            od.select("o_orderkey", "o_custkey", "o_orderdate"),
            col("l_orderkey") == col("o_orderkey"),
        )
        .select("o_custkey", "l_orderkey", "o_orderdate", "sum_qty")
        .sort("sum_qty", "l_orderkey", ascending=[False, True])
        .limit(100)
    )


def first_orderkey(root: str) -> int:
    """The l_orderkey of the lake's first lineitem row, read once per
    version of the file (so building a lookup costs no read of the lake)."""
    path = os.path.join(root, "lineitem", "part-0000.parquet")
    return _first_value(path, "l_orderkey", os.stat(path).st_mtime_ns)


@functools.lru_cache(maxsize=16)
def _first_value(path: str, column: str, _mtime_ns: int) -> int:
    import pyarrow.parquet as pq

    return int(pq.ParquetFile(path).read_row_group(0, columns=[column])[0][0].as_py())


def lookup_count(session, root: str, key: int | None = None):
    """Order-status lookup: one order's lines, sum(l_extendedprice *
    l_discount) and count(1) (q6_count's shape). The key defaults to the
    first lineitem row's, so it is present; bucket pruning keeps one bucket
    and row-group skipping the groups that can hold it."""
    k = first_orderkey(root) if key is None else key
    return _lineitem(session, root).filter(col("l_orderkey") == k).agg(
        Sum(col("l_extendedprice") * col("l_discount")).alias("revenue"),
        Count(lit(1)).alias("count"),
    )


def lookup_absent(session, root: str):
    """lookup_count of a key no order has (keys start at 0): every row
    group is skipped and the count is 0."""
    return lookup_count(session, root, key=-1)


def range_sum(session, root: str, start: int | None = None, width: int = 200_000):
    """Order-range report: sum(l_extendedprice) and count(1) over
    ``width`` order keys from ``start`` (the first row's key by default;
    q6_sum's shape). Every bucket is kept; row groups are skipped by their
    l_orderkey min and max."""
    a = first_orderkey(root) if start is None else start
    return _lineitem(session, root).filter(
        (col("l_orderkey") >= a) & (col("l_orderkey") < a + width)
    ).agg(Sum(col("l_extendedprice")).alias("sum_price"), Count(lit(1)).alias("count"))


QUERIES = {"q6": q6, "q6_count": q6_count, "q6_sum": q6_sum, "q1": q1, "q1_sums": q1_sums}
# the partial route's forms (port-only)
SPAN_QUERIES = {"q6_span": q6_span, "q1_span": q1_span}
JOIN_QUERIES = {"q3_agg": q3_agg, "q3": q3}
# Q3's join with aggregates that split (port-only)
SPLIT_JOIN_QUERIES = {"q3_span": q3_span}
# point and range lookups on li_orderkey's key (port-only forms)
LOOKUP_QUERIES = {"lookup_count": lookup_count, "lookup_absent": lookup_absent,
                  "range_sum": range_sum}
# the pruning each lookup's li_orderkey scan renders (8 buckets), as
# FileScan.describe shows it in pruned[...]
LOOKUP_PRUNING = {"lookup_count": "buckets=1/8,rowgroup_conjuncts=1",
                  "lookup_absent": "buckets=1/8,rowgroup_conjuncts=1",
                  "range_sum": "rowgroup_conjuncts=2"}
# the reference's TPC-H query set (hyperspace_tpu/benchmark/tpch.py)
TPCH_QUERIES = {"q1": q1, "q3": q3, "q6": q6, "q10": q10, "q17": q17, "q18": q18}

# the reference's tpch_indexes set as (name, indexed, included)
LI_SHIPDATE_Z = ("li_shipdate_z", ["l_shipdate"],
                 ["l_extendedprice", "l_discount", "l_quantity"])
LI_ORDERKEY = (
    "li_orderkey",
    ["l_orderkey"],
    ["l_extendedprice", "l_discount", "l_returnflag", "l_quantity"],
)
LI_PARTKEY = ("li_partkey", ["l_partkey"], ["l_quantity", "l_extendedprice"])
LI_FLAGSTATUS = ("li_flagstatus", ["l_returnflag", "l_linestatus"],
                 ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount"])
OD_ORDERKEY = ("od_orderkey", ["o_orderkey"], ["o_orderdate", "o_custkey"])
PT_PARTKEY = ("pt_partkey", ["p_partkey"], ["p_brand"])
# the co-bucketed join indexes the Q3 forms read
JOIN_INDEXES = {"lineitem": LI_ORDERKEY, "orders": OD_ORDERKEY}
# the reference's data-skipping index on Q6's range column, as (name,
# columns of its MinMax sketches)
LI_SHIPDATE_MM = ("li_shipdate_mm", ["l_shipdate"])
# (table, index kind, index) in the reference's build order: z-order
# ("ZCI"), covering ("CI") and data-skipping ("DS") indexes
TPCH_INDEXES = (
    ("lineitem", "ZCI", LI_SHIPDATE_Z),
    ("lineitem", "CI", LI_ORDERKEY),
    ("lineitem", "CI", LI_PARTKEY),
    ("lineitem", "CI", LI_FLAGSTATUS),
    ("orders", "CI", OD_ORDERKEY),
    ("part", "CI", PT_PARTKEY),
    ("lineitem", "DS", LI_SHIPDATE_MM),
)


def build_index(session, hs, root: str, table: str, kind: str, spec) -> None:
    """Create one index of TPCH_INDEXES over ``table`` of the lake."""
    from ..models.covering import CoveringIndexConfig
    from ..models.dataskipping import DataSkippingIndexConfig, MinMaxSketch
    from ..models.zorder import ZOrderCoveringIndexConfig

    if kind == "DS":
        name, columns = spec
        config = DataSkippingIndexConfig(name, [MinMaxSketch(c) for c in columns])
    else:
        config = (ZOrderCoveringIndexConfig if kind == "ZCI" else CoveringIndexConfig)(*spec)
    hs.create_index(session.read.parquet(os.path.join(root, table)), config)


def tpch_indexes(session, hs, root: str) -> None:
    """The JAX package's tpch_indexes set: z-order on Q6's range column,
    covering indexes on the join keys and on Q1's group keys, and min-max
    data skipping on Q6's range column."""
    for table, kind, spec in TPCH_INDEXES:
        build_index(session, hs, root, table, kind, spec)
