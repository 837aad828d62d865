"""Layout analysis walkthrough on the port: use the MinMax layout analyzer
to decide which index kind fits a table, then verify the decision with
explain() (counterpart of the reference repo's
``examples/layout_analysis.py``).

Run:  python -m hyperspace_tpu_torch.examples.layout_analysis [--device cpu]
"""

import os
import tempfile

import numpy as np

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ZOrderCoveringIndexConfig
from hyperspace_tpu_torch.analysis.minmax_analysis import analyze
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.examples import cli, same_rows
from hyperspace_tpu_torch.plan import Sum, col


def main(device=None, workdir=None) -> dict:
    ws = tempfile.mkdtemp(prefix="hs_layout_", dir=workdir)
    rng = np.random.default_rng(0)

    # Ingest-clustered table: `event_day` arrives in order (disjoint per
    # file), `user_id` is scattered across every file.
    for i in range(8):
        n = 50_000
        cio.write_parquet(
            ColumnBatch.from_pydict(
                {
                    "event_day": (rng.integers(0, 30, n) + i * 30).tolist(),
                    "user_id": rng.integers(0, 100_000, n).tolist(),
                    "amount": rng.uniform(1, 500, n).tolist(),
                }
            ),
            os.path.join(ws, "events", f"part-{i}.parquet"),
        )

    session = HyperspaceSession(warehouse_dir=ws, device=device)
    df = session.read.parquet(os.path.join(ws, "events"))

    # 1) Ask the analyzer which columns the layout already serves.
    report = analyze(df, ["event_day", "user_id"], verbose=True)
    print(report)

    # 2) Follow its advice: user_id needs re-clustering; event_day does not.
    hs = Hyperspace(session)
    hs.create_index(df, ZOrderCoveringIndexConfig("by_user", ["user_id"], ["amount"]))

    # 3) Verify the rewrite with explain().
    q = df.filter(col("user_id") == 4242).agg(Sum(col("amount")).alias("s"))
    session.enable_hyperspace()
    plan = hs.explain(q, verbose=True)
    print(plan)
    if "by_user" not in plan:
        raise AssertionError("the z-order index does not serve the point query")
    result = same_rows(session, q)
    print("result:", result)
    return {"workspace": ws, "report": report, "result": result}


if __name__ == "__main__":
    cli(main, __doc__)
