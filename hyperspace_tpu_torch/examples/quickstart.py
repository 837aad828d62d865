"""Hitchhiker's-guide-style walkthrough on the port: create, use, inspect,
maintain and drop every index kind on a toy dataset (counterpart of the
reference repo's ``examples/quickstart.py``).

Run:  python -m hyperspace_tpu_torch.examples.quickstart [--device cpu]
"""

import os
import tempfile

import numpy as np

from hyperspace_tpu_torch import (
    BloomFilterSketch,
    CoveringIndexConfig,
    DataSkippingIndexConfig,
    Hyperspace,
    HyperspaceSession,
    MinMaxSketch,
    ZOrderCoveringIndexConfig,
)
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.examples import cli, same_rows
from hyperspace_tpu_torch.plan import Count, Sum, col, lit


def main(device=None, workdir=None) -> dict:
    ws = tempfile.mkdtemp(prefix="hs_example_", dir=workdir)
    rng = np.random.default_rng(0)
    n = 100_000

    # ------------------------------------------------------------------ data
    for i in range(4):
        sl = slice(i * n // 4, (i + 1) * n // 4)
        rows = n // 4
        cio.write_parquet(
            ColumnBatch.from_pydict(
                {
                    "order_id": list(range(sl.start, sl.stop)),
                    "customer": rng.integers(0, 5000, rows).tolist(),
                    "amount": rng.uniform(1, 1000, rows).tolist(),
                    "day": rng.integers(i * 90, (i + 1) * 90, rows).tolist(),
                }
            ),
            os.path.join(ws, "orders", f"part-{i}.parquet"),
        )

    session = HyperspaceSession(warehouse_dir=ws, device=device)
    hs = Hyperspace(session)
    orders = session.read.parquet(os.path.join(ws, "orders"))

    # --------------------------------------------------------------- indexes
    hs.create_index(orders, CoveringIndexConfig("by_customer", ["customer"], ["amount"]))
    hs.create_index(orders, ZOrderCoveringIndexConfig("by_day_amount", ["day", "amount"]))
    hs.create_index(
        orders,
        DataSkippingIndexConfig(
            "skip_day", [MinMaxSketch("day"), BloomFilterSketch("customer", 2000, 0.01)]
        ),
    )
    print(hs.indexes().to_pandas()[["name", "kind", "indexedColumns", "state"]], "\n")

    # ---------------------------------------------------------------- queries
    session.enable_hyperspace()
    orders = session.read.parquet(os.path.join(ws, "orders"))

    q = (
        orders.filter(col("customer") == 42)
        .select("customer", "amount")
        .agg(Sum(col("amount")).alias("total"), Count(lit(1)).alias("n"))
    )
    total = same_rows(session, q)
    print("customer 42 total:", total)
    print(hs.explain(orders.filter(col("customer") == 42).select("customer", "amount")))

    # why didn't an index apply?
    print(hs.why_not(orders.select("order_id"), extended=True).splitlines()[6])

    # ------------------------------------------------------------ maintenance
    cio.write_parquet(
        ColumnBatch.from_pydict(
            {"order_id": [n], "customer": [42], "amount": [999.0], "day": [1]}
        ),
        os.path.join(ws, "orders", "part-new.parquet"),
    )
    hs.refresh_index("by_customer", "incremental")
    hs.optimize_index("by_customer", "quick")
    # NOTE: a DataFrame pins its file listing when created; re-read after
    # source mutations (Spark re-lists per query, this frontend does not)
    orders = session.read.parquet(os.path.join(ws, "orders"))
    q2 = (
        orders.filter(col("customer") == 42)
        .select("customer", "amount")
        .agg(Sum(col("amount")).alias("total"), Count(lit(1)).alias("n"))
    )
    after = same_rows(session, q2)
    print("\nafter refresh:", after)
    if after["n"][0] != total["n"][0] + 1:
        raise AssertionError(f"the refreshed index lost the appended row: {after}")

    hs.delete_index("skip_day")
    hs.vacuum_index("skip_day")
    remaining = hs.indexes().to_pydict()["name"]
    print("\nremaining:", remaining)
    return {"workspace": ws, "total": total, "after_refresh": after, "remaining": remaining}


if __name__ == "__main__":
    cli(main, __doc__)
