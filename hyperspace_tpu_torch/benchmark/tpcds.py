"""TPC-DS q1 data, indexes and queries (counterpart of
hyperspace_tpu/benchmark/tpcds.py: the same names, seeds and files).

The plan-stability corpus of the original system defines the whole
TPC-DS schema but enables one query, q1. This module generates the tables
q1 reads (store_returns, date_dim, store, customer) at a chosen scale and
writes q1's core on the port's DataFrame API: ``q1_customer_total_return``
(store_returns joined to date_dim filtered to one year, grouped by customer
and store) and ``q1_store_avg`` (the per-store mean of those totals, the
threshold q1's correlated subquery compares against). ``tpcds_indexes``
builds q1's index set: covering indexes on the join's date keys and a
bloom-filter data-skipping index on the customer key.

``generate_tpcds`` draws the reference's values in the reference's order,
so the same seed writes the same files byte for byte. String columns are
built by arrow (a ``take`` of the drawn indexes; the customer ids by
arrow's string kernels), not converted row by row, so that the generator
stays fast at realistic scale.
"""

from __future__ import annotations

import os

import numpy as np

from ..plan.expr import Avg, Sum, col


def generate_tpcds(root: str, rows_store_returns: int = 200_000, seed: int = 0) -> dict:
    """Write store_returns/date_dim/store/customer parquet dirs under
    `root`; returns each table's bytes."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_customers = max(1, rows_store_returns // 20)
    n_stores = 25
    n_dates = 365 * 3

    sizes = {}

    def write(name: str, table, part: int = 0) -> None:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        f = os.path.join(d, f"part-{part}.parquet")
        pq.write_table(table, f)
        sizes[name] = sizes.get(name, 0) + os.path.getsize(f)

    # store_returns over 8 files, each with a file-local customer range (as
    # ingest clusters keys), so that skipping has files to reject for a key
    n_files = 8
    per = rows_store_returns // n_files
    cust_span = max(1, n_customers // n_files)
    for i in range(n_files):
        write(
            "store_returns",
            pa.table(
                {
                    "sr_returned_date_sk": rng.integers(0, n_dates, per),
                    "sr_customer_sk": rng.integers(i * cust_span, (i + 1) * cust_span, per),
                    "sr_store_sk": rng.integers(0, n_stores, per),
                    "sr_return_amt": np.round(rng.uniform(1, 500, per), 2),
                }
            ),
            part=i,
        )
    write(
        "date_dim",
        pa.table(
            {
                "d_date_sk": np.arange(n_dates),
                "d_year": 1998 + (np.arange(n_dates) // 365),
            }
        ),
    )
    # rng.choice over a list draws exactly rng.integers(0, len(list), n)
    states = pa.array(["TN", "CA", "WA"]).take(pa.array(rng.integers(0, 3, n_stores)))
    write("store", pa.table({"s_store_sk": np.arange(n_stores), "s_state": states}))
    # f"AAAAAAAA{i:08d}": the number's digits left-padded with zeros to 8
    digits = pc.utf8_lpad(pc.cast(pa.array(np.arange(n_customers)), pa.string()), 8, "0")
    write(
        "customer",
        pa.table(
            {
                "c_customer_sk": np.arange(n_customers),
                "c_customer_id": pc.binary_join_element_wise("AAAAAAAA", digits, ""),
            }
        ),
    )
    return sizes


def tpcds_indexes(session, hs, root: str) -> None:
    """q1's index set: covering join indexes on the store_returns date key
    and the date_dim key, and a bloom-filter skipping index on the
    high-cardinality customer key."""
    from ..models.covering import CoveringIndexConfig
    from ..models.dataskipping import BloomFilterSketch, DataSkippingIndexConfig

    sr = session.read.parquet(os.path.join(root, "store_returns"))
    dd = session.read.parquet(os.path.join(root, "date_dim"))
    hs.create_index(
        sr,
        CoveringIndexConfig(
            "sr_datekey",
            ["sr_returned_date_sk"],
            ["sr_customer_sk", "sr_store_sk", "sr_return_amt"],
        ),
    )
    hs.create_index(dd, CoveringIndexConfig("dd_datekey", ["d_date_sk"], ["d_year"]))
    hs.create_index(
        sr,
        DataSkippingIndexConfig(
            "sr_cust_bloom", [BloomFilterSketch("sr_customer_sk", 50_000, 0.01)]
        ),
    )


def q1_customer_total_return(session, root: str):
    """TPC-DS q1's CTE: per-(customer, store) return totals for one year."""
    sr = session.read.parquet(os.path.join(root, "store_returns"))
    dd = session.read.parquet(os.path.join(root, "date_dim"))
    return (
        sr.select("sr_returned_date_sk", "sr_customer_sk", "sr_store_sk", "sr_return_amt")
        .join(
            dd.select("d_date_sk", "d_year").filter(col("d_year") == 2000),
            col("sr_returned_date_sk") == col("d_date_sk"),
        )
        .group_by("sr_customer_sk", "sr_store_sk")
        .agg(Sum(col("sr_return_amt")).alias("ctr_total_return"))
    )


def q1_store_avg(session, root: str):
    """q1's correlated subquery, decorrelated: the per-store mean of the
    customer totals (the threshold q1 compares against)."""
    return (
        q1_customer_total_return(session, root)
        .group_by("sr_store_sk")
        .agg(Avg(col("ctr_total_return")).alias("avg_return"))
    )


TPCDS_QUERIES = {
    "q1_customer_total_return": q1_customer_total_return,
    "q1_store_avg": q1_store_avg,
}
