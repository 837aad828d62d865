"""The full-lifecycle tour on the port, every user-facing subsystem in one
script (counterpart of the reference repo's ``examples/tour.py``, itself
the analogue of the "Hitchhiker's Guide to Hyperspace" notebooks): create
indexes, watch queries rewrite, inspect with explain/whyNot/statistics,
mutate the source and use Hybrid Scan + incremental refresh, compact with
optimize, then walk the delete -> restore -> vacuum lifecycle.

Run:  python -m hyperspace_tpu_torch.examples.tour [--device cpu]
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
)
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.examples import cli, same_rows
from hyperspace_tpu_torch.plan import Count, Sum, col, lit


def section(title: str) -> None:
    print(f"\n{'=' * 70}\n{title}\n{'=' * 70}")


def write_sales(path: str, start: int, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    cio.write_parquet(
        ColumnBatch.from_pydict(
            {
                "order_id": list(range(start, start + n)),
                "customer_id": rng.integers(0, 500, n).tolist(),
                "amount": np.round(rng.uniform(5, 500, n), 2).tolist(),
                "region": rng.choice(["NA", "EU", "APAC"], n).tolist(),
            }
        ),
        path,
    )


def main(device=None, workdir=None) -> dict:
    ws = tempfile.mkdtemp(prefix="hs_tour_", dir=workdir)
    sales = os.path.join(ws, "sales")
    for i in range(4):
        write_sales(os.path.join(sales, f"part-{i}.parquet"), i * 25_000, 25_000, i)

    session = HyperspaceSession(warehouse_dir=ws, device=device)
    session.set_conf(C.INDEX_LINEAGE_ENABLED, True)  # deletes need lineage
    hs = Hyperspace(session)
    df = session.read.parquet(sales)

    # --- 1. create: one index per kind -----------------------------------
    section("1. createIndex — covering, data-skipping (MinMax + Bloom)")
    hs.create_index(df, CoveringIndexConfig("by_customer", ["customer_id"], ["amount"]))
    hs.create_index(df, DataSkippingIndexConfig("sk_order", [MinMaxSketch("order_id")]))
    hs.create_index(
        df,
        DataSkippingIndexConfig("sk_bloom", [BloomFilterSketch("customer_id", 500, 0.01)]),
    )
    print(hs.indexes().to_pydict()["name"])

    # --- 2. transparent rewrite ------------------------------------------
    section("2. enableHyperspace — the same query now reads the index")
    session.enable_hyperspace()
    q = (
        session.read.parquet(sales)
        .filter(col("customer_id") == 42)
        .agg(Sum(col("amount")).alias("total"), Count(lit(1)).alias("orders"))
    )
    print("result:", same_rows(session, q))
    print(q.explain_plan())

    # --- 3. explain / whyNot / statistics --------------------------------
    section("3. explain(verbose) — plan diff + operator stats")
    print(hs.explain(q, verbose=True))
    section("3b. whyNot — why indexes did NOT serve a query")
    other = session.read.parquet(sales).filter(col("region") == "EU").select("region")
    print(hs.why_not(other))
    section("3c. index statistics")
    print({k: v[0] for k, v in hs.index("by_customer").to_pydict().items()})

    # --- 4. hybrid scan + incremental refresh ----------------------------
    section("4. append source files — Hybrid Scan serves the stale index")
    write_sales(os.path.join(sales, "part-append.parquet"), 100_000, 10_000, 99)
    session.set_conf(C.HYBRID_SCAN_ENABLED, True)
    hybrid = same_rows(session, q)
    print("with appended data:", hybrid)
    hs.refresh_index("by_customer", "incremental")
    refreshed = same_rows(session, q)
    print("after incremental refresh:", refreshed)
    session.set_conf(C.HYBRID_SCAN_ENABLED, False)

    # --- 5. optimize ------------------------------------------------------
    section("5. optimizeIndex — compact the refresh's small bucket files")
    before = len(hs.get_index("by_customer").index_data_files())
    hs.optimize_index("by_customer", "full")
    after = len(hs.get_index("by_customer").index_data_files())
    print(f"index data files: {before} -> {after}")

    # --- 6. delete / restore / vacuum ------------------------------------
    section("6. lifecycle — delete is soft, restore undoes, vacuum is final")

    def states():
        d = hs.indexes().to_pydict()
        return {str(n): str(s) for n, s in zip(d["name"], d["state"])}

    hs.delete_index("sk_bloom")
    print("after delete:", states())  # DELETED but still listed
    hs.restore_index("sk_bloom")
    print("after restore:", states())
    hs.delete_index("sk_bloom")
    hs.vacuum_index("sk_bloom")
    final = states()
    print("after vacuum:", final)  # gone for good
    if "sk_bloom" in final:
        raise AssertionError(f"sk_bloom survived its vacuum: {final}")

    section("tour complete")
    print(f"workspace: {ws} (indexes under {ws}/indexes)")
    return {"workspace": ws, "hybrid": hybrid, "refreshed": refreshed,
            "files": (before, after), "states": final}


if __name__ == "__main__":
    cli(main, __doc__)
