"""TPC-H answers by an independent engine, pandas (counterpart of
hyperspace_tpu/benchmark/external.py: the same names and answers).

Each query reads the same parquet inputs as the port's queries, end to
end, IO included, and computes its answer with pandas alone: code this
package does not share. They serve as the external denominator of a
benchmark's speed-up and as a correctness reference for the port's
``collect()`` of the same TPC-H query (``PANDAS_TPCH`` by query name).
"""

from __future__ import annotations

import os


def _li(root):
    import pandas as pd

    return pd.read_parquet(os.path.join(root, "lineitem"))


def pandas_q1(root):
    df = _li(root)
    df = df[df["l_shipdate"] <= 10470]
    g = df.assign(
        disc_price=df["l_extendedprice"] * (1.0 - df["l_discount"])
    ).groupby(["l_returnflag", "l_linestatus"], as_index=False)
    out = g.agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        avg_qty=("l_quantity", "mean"),
        count_order=("l_quantity", "size"),
    )
    return out.sort_values(["l_returnflag", "l_linestatus"])


def pandas_q3(root):
    import pandas as pd

    li = _li(root)[["l_orderkey", "l_extendedprice", "l_discount"]]
    od = pd.read_parquet(os.path.join(root, "orders"))[["o_orderkey", "o_orderdate"]]
    od = od[od["o_orderdate"] < 9500]
    j = li.merge(od, left_on="l_orderkey", right_on="o_orderkey")
    j["revenue"] = j["l_extendedprice"] * (1.0 - j["l_discount"])
    g = j.groupby(["l_orderkey", "o_orderdate"], as_index=False)["revenue"].sum()
    return g.nlargest(10, "revenue")


def pandas_q6(root):
    df = _li(root)
    m = (
        (df["l_shipdate"] >= 8766)
        & (df["l_shipdate"] < 9131)
        & (df["l_discount"] >= 0.05)
        & (df["l_discount"] <= 0.07)
        & (df["l_quantity"] < 24)
    )
    sub = df[m]
    return float((sub["l_extendedprice"] * sub["l_discount"]).sum())


def pandas_q17(root):
    import pandas as pd

    li = _li(root)[["l_partkey", "l_quantity", "l_extendedprice"]]
    pt = pd.read_parquet(os.path.join(root, "part"))
    pt = pt[pt["p_brand"] == "Brand#3"][["p_partkey"]]
    avg_qty = (
        li.groupby("l_partkey", as_index=False)["l_quantity"]
        .mean()
        .rename(columns={"l_partkey": "ap_partkey", "l_quantity": "avg_qty"})
    )
    j = li.merge(pt, left_on="l_partkey", right_on="p_partkey")
    j = j.merge(avg_qty, left_on="l_partkey", right_on="ap_partkey")
    j = j[j["l_quantity"] < 0.2 * j["avg_qty"]]
    return float(j["l_extendedprice"].sum() / 7.0)


def pandas_q10(root):
    import pandas as pd

    li = _li(root)
    li = li[li["l_returnflag"] == "R"][["l_orderkey", "l_extendedprice", "l_discount"]]
    od = pd.read_parquet(os.path.join(root, "orders"))[
        ["o_orderkey", "o_custkey", "o_orderdate"]
    ]
    od = od[(od["o_orderdate"] >= 8766) & (od["o_orderdate"] < 8856)]
    j = li.merge(od, left_on="l_orderkey", right_on="o_orderkey")
    j["revenue"] = j["l_extendedprice"] * (1.0 - j["l_discount"])
    g = j.groupby("o_custkey", as_index=False)["revenue"].sum()
    return g.sort_values(["revenue", "o_custkey"], ascending=[False, True]).head(20)


def pandas_q18(root):
    import pandas as pd

    li = _li(root)[["l_orderkey", "l_quantity"]]
    big = li.groupby("l_orderkey", as_index=False)["l_quantity"].sum()
    big = big[big["l_quantity"] > 300].rename(columns={"l_quantity": "sum_qty"})
    od = pd.read_parquet(os.path.join(root, "orders"))[
        ["o_orderkey", "o_custkey", "o_orderdate"]
    ]
    j = big.merge(od, left_on="l_orderkey", right_on="o_orderkey")
    return j.sort_values(["sum_qty", "l_orderkey"], ascending=[False, True]).head(100)


PANDAS_TPCH = {
    "q1": pandas_q1,
    "q3": pandas_q3,
    "q6": pandas_q6,
    "q10": pandas_q10,
    "q17": pandas_q17,
    "q18": pandas_q18,
}


def answer_columns(answer, names: list) -> dict:
    """A pandas answer as numpy columns under the port's result column
    ``names``, in that order: a scalar answer (q6, q17) is one row of the
    first name; a frame's columns are taken by name, so its own order and
    extra join keys (q18's o_orderkey) do not matter."""
    import numpy as np

    if isinstance(answer, float):
        return {names[0]: np.array([answer])}
    return {n: answer[n].to_numpy() for n in names}
