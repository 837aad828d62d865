"""Walkthrough on the port: snapshot tables with index time travel, and
Hybrid Scan over a drifting plain-file source (counterpart of the
reference repo's ``examples/snapshots_and_hybrid_scan.py``).

Run:  python -m hyperspace_tpu_torch.examples.snapshots_and_hybrid_scan [--device cpu]
"""

import os
import tempfile

from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.examples import cli, same_rows
from hyperspace_tpu_torch.plan import col
from hyperspace_tpu_torch.sources.delta import SnapshotTable


def main(device=None, workdir=None) -> dict:
    ws = tempfile.mkdtemp(prefix="hs_snap_", dir=workdir)
    session = HyperspaceSession(warehouse_dir=ws, device=device)
    session.set_conf(C.INDEX_LINEAGE_ENABLED, True)
    hs = Hyperspace(session)

    # ------------------------------------------------ snapshot time travel
    events = SnapshotTable(os.path.join(ws, "events"))
    events.commit(ColumnBatch.from_pydict({"id": [1, 2, 3], "amt": [10.0, 20.0, 30.0]}))
    hs.create_index(events.scan(session), CoveringIndexConfig("ev_id", ["id"], ["amt"]))

    events.commit(ColumnBatch.from_pydict({"id": [4], "amt": [40.0]}))  # v1
    hs.refresh_index("ev_id", "full")  # index now tracks v1

    session.enable_hyperspace()
    latest = events.scan(session).filter(col("id") == 4).select("amt")
    old = events.scan(session, version=0).filter(col("id") == 2).select("amt")
    latest_rows, old_rows = same_rows(session, latest), same_rows(session, old)
    print("latest snapshot query:", latest_rows)
    print("v0 time-travel query :", old_rows)
    v0_plan = old.optimized_plan()
    used = [n.index_info.log_version for n in v0_plan.preorder()
            if getattr(n, "index_info", None)]
    print("v0 served by OLD index log version:", used, "\n")

    # --------------------------------------------------------- hybrid scan
    src = os.path.join(ws, "sales")
    cio.write_parquet(
        ColumnBatch.from_pydict({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}),
        os.path.join(src, "p1.parquet"),
    )
    df = session.read.parquet(src)
    session.disable_hyperspace()
    hs.create_index(df, CoveringIndexConfig("sales_k", ["k"], ["v"]))

    # the source drifts: one file appended, nothing refreshed yet
    cio.write_parquet(
        ColumnBatch.from_pydict({"k": [9], "v": [90.0]}),
        os.path.join(src, "p2.parquet"),
    )
    session.enable_hyperspace()
    session.set_conf(C.HYBRID_SCAN_ENABLED, True)
    # tiny demo files: the appended file is ~half the source bytes, above the
    # default 30% ceiling — raise it so the drifted index still qualifies
    session.set_conf(C.HYBRID_SCAN_MAX_APPENDED_RATIO, 0.9)
    q = session.read.parquet(src).filter(col("k") >= 1).select("k", "v")
    hybrid = same_rows(session, q)
    print("hybrid scan result (appended row merged at query time):")
    print(" ", hybrid)
    hybrid_used = [n.index_info.index_name for n in q.optimized_plan().preorder()
                   if getattr(n, "index_info", None)]
    print("index serving the hybrid query:", hybrid_used or "(none — ratio exceeded)")

    # quick refresh records the delta so hybrid applies even with the
    # global toggle off
    session.set_conf(C.HYBRID_SCAN_ENABLED, False)
    hs.refresh_index("sales_k", "quick")
    q2 = session.read.parquet(src).filter(col("k") >= 1).select("k", "v")
    keys = sorted(same_rows(session, q2)["k"])
    print("after quick refresh (toggle off):", keys)
    if keys != [1, 2, 3, 9] or hybrid_used != ["sales_k"]:
        raise AssertionError(f"hybrid scan: served by {hybrid_used}, keys {keys}")
    return {"workspace": ws, "latest": latest_rows, "old": old_rows, "old_versions": used,
            "hybrid": hybrid, "hybrid_used": hybrid_used, "quick_refresh_keys": keys}


if __name__ == "__main__":
    cli(main, __doc__)
