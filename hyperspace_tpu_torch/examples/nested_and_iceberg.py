"""Nested columns and the Iceberg-style snapshot source, on the port
(counterpart of the reference repo's ``examples/nested_and_iceberg.py``).

Run:  python -m hyperspace_tpu_torch.examples.nested_and_iceberg [--device cpu]

Covers two capabilities:
1. Indexing nested (struct) fields: struct leaves flatten to
   `__hs_nested.<path>` columns at the reader boundary and bare dotted
   references like col("nested.cnt") resolve to them everywhere.
2. The Iceberg-shaped snapshot table: metadata files + manifest lists +
   manifests, random snapshot ids with parent ancestry, time travel by
   snapshot id or timestamp, and ancestry-based index-version matching.
"""

import os
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.examples import cli, same_rows
from hyperspace_tpu_torch.plan import col
from hyperspace_tpu_torch.sources.iceberg import IcebergStyleTable


def main(device=None, workdir=None) -> dict:
    ws = tempfile.mkdtemp(prefix="hs_example_", dir=workdir)
    session = HyperspaceSession(warehouse_dir=ws, device=device)
    hs = Hyperspace(session)

    # --- 1. nested columns --------------------------------------------------
    rng = np.random.default_rng(0)
    n = 10_000
    nested_table = pa.table(
        {
            "id": pa.array(np.arange(n)),
            "nested": pa.StructArray.from_arrays(
                [pa.array(rng.integers(0, 100, n)), pa.array(rng.uniform(0, 1, n))],
                names=["cnt", "score"],
            ),
        }
    )
    src = os.path.join(ws, "events")
    os.makedirs(src)
    pq.write_table(nested_table, os.path.join(src, "part-0.parquet"))

    df = session.read.parquet(src)
    print("flattened schema:", df.schema.names)

    # index the nested field by its dotted path; the index column is the
    # normalized __hs_nested.nested.cnt
    hs.create_index(df, CoveringIndexConfig("ev_cnt", ["nested.cnt"], ["id"]))
    session.enable_hyperspace()
    out = same_rows(session, session.read.parquet(src).filter(col("nested.cnt") == 7)
                    .select("id", "nested.cnt"))
    print("rows with nested.cnt == 7:", len(out["id"]))
    print(hs.why_not(session.read.parquet(src).select("id")))
    session.disable_hyperspace()

    # --- 2. iceberg-style snapshots ----------------------------------------
    t = IcebergStyleTable(os.path.join(ws, "sales"))
    s0 = t.commit(ColumnBatch.from_pydict({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}))
    s1 = t.commit(ColumnBatch.from_pydict({"k": [4], "v": [4.0]}))
    print("snapshots:", s0, "->", s1, "(parent:", t.parent_of(s1), ")")

    hs.create_index(t.scan(session), CoveringIndexConfig("sales_k", ["k"], ["v"]))
    session.enable_hyperspace()
    current, first = t.scan(session).count(), t.scan(session, snapshot_id=s0).count()
    print("current rows:", current)
    print("time travel to first snapshot:", first)
    # the filter over the old snapshot still uses the index version recorded
    # against an ancestor snapshot (ancestry-walk matching)
    old = same_rows(session, t.scan(session, snapshot_id=s0).filter(col("k") == 2)
                    .select("k", "v"))
    print("old-snapshot lookup:", old)
    if (current, first, old) != (4, 3, {"k": [2], "v": [2.0]}):
        raise AssertionError(f"snapshot reads: {current}, {first}, {old}")
    return {"workspace": ws, "nested_rows": len(out["id"]), "current": current,
            "first": first, "old": old}


if __name__ == "__main__":
    cli(main, __doc__)
