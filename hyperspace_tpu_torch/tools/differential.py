"""The randomized differential harness: random filter, join, aggregate,
top-k, sort and union plans over covering, z-order and data-skipping
indexes must return the same rows with ``enable_hyperspace()`` as
without it (counterpart of the reference repo's
``tests/test_differential.py:26-149``).

``random_predicate`` and ``random_query`` make the reference's draws draw
for draw, so seed s builds the same plan in both packages over the same
world (``write_world``: the reference's seeded fact and dimension files).
Floats compare at the engine's contract, 1e-6 relative (``rows_close``).

The kernel-shaped leg (``write_kernel_world``, ``kernel_query``) adds the
three plan shapes that reach the hand-written kernels (an ungrouped
``Sum(x)`` or ``Sum(x*y)`` beside a ``Count`` over a predicate, and
sums and a count grouped by the 3-valued ``cat``), which ``random_query``
never draws: it has no ungrouped aggregate and groups by ``k``'s 200
values, more than the grouped kernel's 16 slots.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from .. import (
    CoveringIndexConfig,
    DataSkippingIndexConfig,
    Hyperspace,
    HyperspaceSession,
    MinMaxSketch,
    ZOrderCoveringIndexConfig,
)
from .. import constants as C
from ..columnar import io as cio
from ..columnar.table import ColumnBatch
from ..plan import Count, Min, Sum, col, lit
from ..plan.expr import Not

FACT_ROWS = 5000
WORLD_SEED = 99
CATS = ["red", "green", "blue"]
# the mesh tier's logical devices, as the reference forces 8 host devices
MESH_DEVICES = 8
# the reference's appended file (tools/differential_soak.py:76-82)
SOAK_APPENDED = {"k": [5, 6], "d": [100, 2000], "x": [1.5, 2.5], "cat": ["red", "blue"]}
KERNEL_SHAPES = ("filter_sum", "filter_weighted_sum", "filter_grouped_multi_sum")
KERNEL_REL = 1e-4  # f32 sums against the host's f64


def canon(d: dict) -> list:
    keys = sorted(d.keys())
    rows = [
        tuple(round(v, 7) if isinstance(v, float) else v for v in row)
        for row in zip(*[d[k] for k in keys])
    ]
    return sorted(rows, key=repr)


def rows_close(got: list, expected: list, rel: float = 1e-6) -> bool:
    """Row-wise comparison at the engine's float contract (1e-6 relative):
    device tiers accumulate in f32, and the index scan's row order differs
    from raw, so last-bit sums legitimately differ."""
    if len(got) != len(expected):
        return False
    for g, e in zip(got, expected):
        if len(g) != len(e):
            return False
        for a, b in zip(g, e):
            if isinstance(a, float) and isinstance(b, float):
                if abs(a - b) > rel * max(1.0, abs(b)):
                    return False
            elif a != b:
                return False
    return True


def write_world(root: str) -> None:
    """The reference's world: 5000 fact rows over 4 files (``d`` disjoint
    per file), a 200-row dimension in 1, from ``default_rng(99)``."""
    rng = np.random.default_rng(WORLD_SEED)
    n = FACT_ROWS
    for i in range(4):
        sl = n // 4
        cio.write_parquet(
            ColumnBatch.from_pydict(
                {
                    "k": rng.integers(0, 200, sl).tolist(),
                    "d": rng.integers(i * 600, (i + 1) * 600, sl).tolist(),
                    "x": rng.uniform(0, 100, sl).tolist(),
                    "cat": rng.choice(CATS, sl).tolist(),
                }
            ),
            os.path.join(root, "fact", f"f{i}.parquet"),
        )
    cio.write_parquet(
        ColumnBatch.from_pydict({"rk": list(range(200)), "w": rng.uniform(size=200).tolist()}),
        os.path.join(root, "dim", "d.parquet"),
    )


def build_world(root: str, device=None, soak: bool = False) -> HyperspaceSession:
    """Write the world under ``root`` and index it with lineage on, in a
    session whose device tier runs on ``device`` (None: the card) and
    starts off (the host tier). The test set is the reference test's
    (ci_k, z_d, ds_d, ci_rk); ``soak`` builds the soak's (ci, cd, z, ds)
    and then appends its file, so hybrid seeds meet stale indexes."""
    write_world(root)
    session = HyperspaceSession(warehouse_dir=root, device=device)
    session.set_conf(C.INDEX_LINEAGE_ENABLED, True)
    hs = Hyperspace(session)
    fact = session.read.parquet(os.path.join(root, "fact"))
    dim = session.read.parquet(os.path.join(root, "dim"))
    if soak:
        hs.create_index(fact, CoveringIndexConfig("ci", ["k"], ["x", "cat", "d"]))
        hs.create_index(dim, CoveringIndexConfig("cd", ["rk"], ["w"]))
        hs.create_index(fact, ZOrderCoveringIndexConfig("z", ["d"], ["x", "k"]))
        hs.create_index(fact, DataSkippingIndexConfig("ds", [MinMaxSketch("d")]))
        cio.write_parquet(ColumnBatch.from_pydict(SOAK_APPENDED),
                          os.path.join(root, "fact", "appended.parquet"))
    else:
        hs.create_index(fact, CoveringIndexConfig("ci_k", ["k"], ["x", "d"]))
        hs.create_index(fact, ZOrderCoveringIndexConfig("z_d", ["d"], ["x", "k"]))
        hs.create_index(fact, DataSkippingIndexConfig("ds_d", [MinMaxSketch("d")]))
        hs.create_index(dim, CoveringIndexConfig("ci_rk", ["rk"], ["w"]))
    set_tier(session, "host")
    return session


def set_tier(session, tier: str, slices: int = 1) -> None:
    """host: the device tier off; device: on; mesh: on, over the
    ``MESH_DEVICES`` ordinals of ``virtual_devices`` (the caller's
    block), ``slices`` of them hierarchical."""
    session.set_conf(C.EXEC_TPU_ENABLED, tier != "host")
    session.set_conf(C.EXEC_MESH_DEVICES, MESH_DEVICES if tier == "mesh" else 0)
    session.set_conf(C.EXEC_MESH_SLICES, slices)


def random_predicate(rng):
    choices = [
        lambda: col("k") == int(rng.integers(0, 200)),
        lambda: col("k") > int(rng.integers(0, 200)),
        lambda: col("d") < int(rng.integers(0, 2400)),
        lambda: (col("d") >= int(rng.integers(0, 1200)))
        & (col("d") < int(rng.integers(1200, 2400))),
        lambda: col("x") > float(rng.uniform(0, 100)),
        lambda: col("cat") == str(rng.choice(CATS)),
        lambda: col("k").isin([int(v) for v in rng.integers(0, 200, 5)]),
        lambda: Not(col("k") == int(rng.integers(0, 200))),
        lambda: (col("k") > int(rng.integers(0, 100)))
        | (col("d") < int(rng.integers(0, 600))),
    ]
    return choices[rng.integers(0, len(choices))]()


def random_query(session, root, rng):
    fact = session.read.parquet(root + "/fact")
    df = fact
    for _ in range(int(rng.integers(0, 3))):
        df = df.filter(random_predicate(rng))
    shape = rng.integers(0, 7)
    if shape == 0:
        return df.select("k", "d", "x")
    if shape == 1:
        dim = session.read.parquet(root + "/dim")
        return df.select("k", "x").join(dim.select("rk", "w"), col("k") == col("rk"))
    if shape == 2:
        return df.select("k", "x").group_by("k").agg(
            Sum(col("x")).alias("s"), Count(lit(1)).alias("n")
        )
    if shape == 3:
        # ORDER BY ... LIMIT over a grouped aggregate (top-k path)
        return (
            df.select("k", "x")
            .group_by("k")
            .agg(Sum(col("x")).alias("s"))
            .sort("s", ascending=bool(rng.integers(0, 2)))
            .limit(int(rng.integers(1, 30)))
        )
    if shape == 4:
        # multi-key sort incl. string column
        return df.select("k", "cat", "x").sort("cat", "x").limit(50)
    if shape == 5:
        # union of two filtered halves
        lo = df.filter(col("d") < 1200).select("k", "x")
        hi = df.filter(col("d") >= 1200).select("k", "x")
        return lo.union(hi).group_by("k").agg(Count(lit(1)).alias("n"))
    dim = session.read.parquet(root + "/dim")
    return (
        df.select("k", "x")
        .join(dim.select("rk", "w"), col("k") == col("rk"))
        .group_by("k")
        .agg(Sum(col("x")).alias("s"), Min(col("w")).alias("mw"))
    )


def differential(session, query) -> tuple:
    """(got, expected): the query's canonical rows with Hyperspace on, and
    with it off; the session is left with Hyperspace off."""
    session.disable_hyperspace()
    expected = canon(query.to_pydict())
    session.enable_hyperspace()
    try:
        got = canon(query.to_pydict())
    finally:
        session.disable_hyperspace()
    return got, expected


# ---------------------------------------------------------------------------
# the kernel-shaped leg
# ---------------------------------------------------------------------------

def write_kernel_world(root: str, rows: int, files: int, seed: int) -> None:
    """The world's fact schema at ``rows`` rows in ``files`` files (``d``
    disjoint per file over the same 0-2400 domain), plus ``y``, a float
    beside ``x`` for the weighted shape; made in bulk from ``seed``."""
    rng = np.random.default_rng(seed)
    per, span = rows // files, 2400 // files
    os.makedirs(os.path.join(root, "fact"), exist_ok=True)
    for i in range(files):
        n = per if i < files - 1 else rows - per * (files - 1)
        pq.write_table(pa.table({
            "k": rng.integers(0, 200, n),
            "d": rng.integers(i * span, (i + 1) * span, n),
            "x": rng.uniform(0, 100, n),
            "y": rng.uniform(0, 1, n),
            "cat": pa.array(np.asarray(CATS)[rng.integers(0, len(CATS), n)]),
        }), os.path.join(root, "fact", f"f{i:02d}.parquet"))


def build_kernel_world(root: str, rows: int, files: int, seed: int,
                       device=None) -> HyperspaceSession:
    """``write_kernel_world`` with ``ci_k`` and ``z_d`` built over it (the
    world's two fact indexes, covering ``y`` and ``cat`` too, so a plan of
    any shape can read them)."""
    write_kernel_world(root, rows, files, seed)
    session = HyperspaceSession(warehouse_dir=root, device=device)
    hs = Hyperspace(session)
    fact = session.read.parquet(os.path.join(root, "fact"))
    hs.create_index(fact, CoveringIndexConfig("ci_k", ["k"], ["x", "d", "y", "cat"]))
    hs.create_index(fact, ZOrderCoveringIndexConfig("z_d", ["d"], ["x", "k", "y", "cat"]))
    return session


def kernel_query(session, root: str, rng, shape: str):
    """One or two of the reference's random predicates in one filter (a
    fragment is one Filter over the scan: two stacked filters run on the
    host, in the JAX package too), then the plan shape that reaches
    ``shape``'s kernel on the device tier."""
    pred = random_predicate(rng)
    for _ in range(int(rng.integers(0, 2))):
        pred = pred & random_predicate(rng)
    df = session.read.parquet(root + "/fact").filter(pred)
    if shape == "filter_sum":
        return df.agg(Sum(col("x")).alias("s"), Count(lit(1)).alias("n"))
    if shape == "filter_weighted_sum":
        return df.agg(Sum(col("x") * col("y")).alias("s"), Count(lit(1)).alias("n"))
    if shape == "filter_grouped_multi_sum":
        return df.group_by("cat").agg(Sum(col("x")).alias("s"), Sum(col("y")).alias("sy"),
                                      Count(lit(1)).alias("n"))
    raise ValueError(f"unknown kernel shape {shape!r}")


def kernel_differential(session, query) -> tuple:
    """(got, expected): the query with Hyperspace and the device tier on,
    and on the host executor (Hyperspace off, the device tier off)."""
    session.disable_hyperspace()
    session.set_conf(C.EXEC_TPU_ENABLED, False)
    expected = canon(query.to_pydict())
    session.set_conf(C.EXEC_TPU_ENABLED, True)
    session.enable_hyperspace()
    try:
        got = canon(query.to_pydict())
    finally:
        session.disable_hyperspace()
    return got, expected
