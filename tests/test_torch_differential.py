"""The reference's differential tests (tests/test_differential.py) on the
port: randomized plans return the same rows with ``enable_hyperspace()``
as without it, with the same seeds and tolerances. Host seeds 0-39;
device and mesh tiers 100-139 (the device tier on the CPU, the mesh over
``virtual_devices(8, "cpu")``, 2 slices where seed % 4 == 1); hybrid scan
40-59 over an appended file; nested columns 200-214; Iceberg-style
snapshots 215-224."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
from hyperspace_tpu_torch import IcebergStyleTable
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.columnar import io as cio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.parallel.mesh import virtual_devices
from hyperspace_tpu_torch.plan import Count, Sum, col, lit
from hyperspace_tpu_torch.tools.differential import (
    MESH_DEVICES,
    build_world,
    canon,
    differential,
    random_query,
    rows_close,
    set_tier,
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("diff"))
    return build_world(root, "cpu"), root


class TestDifferential:
    @pytest.mark.parametrize("seed", range(40))
    def test_indexed_matches_raw(self, world, seed):
        session, root = world
        q = random_query(session, root, np.random.default_rng(seed))
        got, expected = differential(session, q)
        assert got == expected, f"divergence at seed {seed}"

    @pytest.mark.parametrize("seed", range(100, 140))
    def test_indexed_matches_raw_device_tiers(self, world, seed):
        """The device tier (even seeds) and the mesh route (odd seeds; half
        of them 2-slice). Floats compare at the 1e-6 relative contract."""
        session, root = world
        set_tier(session, "mesh" if seed % 2 else "device", 2 if seed % 4 == 1 else 1)
        try:
            with virtual_devices(MESH_DEVICES, "cpu"):
                q = random_query(session, root, np.random.default_rng(seed))
                got, expected = differential(session, q)
        finally:
            set_tier(session, "host")
        assert rows_close(got, expected), f"device-tier divergence at seed {seed}"

    @pytest.mark.parametrize("seed", range(40, 60))
    def test_indexed_matches_raw_hybrid(self, world, seed):
        """Hybrid scan on, over a source with a file appended after the
        builds."""
        session, root = world
        appended = root + "/fact/appended.parquet"
        if not os.path.exists(appended):
            cio.write_parquet(
                ColumnBatch.from_pydict(
                    {"k": [5, 6], "d": [100, 200], "x": [1.5, 2.5], "cat": ["red", "blue"]}
                ),
                appended,
            )
        session.set_conf(C.HYBRID_SCAN_ENABLED, True)
        try:
            q = random_query(session, root, np.random.default_rng(seed))
            got, expected = differential(session, q)
        finally:
            session.set_conf(C.HYBRID_SCAN_ENABLED, False)
        assert got == expected, f"hybrid divergence at seed {seed}"


class TestDifferentialNestedAndSnapshot:
    @pytest.fixture(scope="class")
    def nested_world(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("diffn")
        rng = np.random.default_rng(5)
        n = 4000
        t = pa.table(
            {
                "id": pa.array(np.arange(n)),
                "m": pa.StructArray.from_arrays(
                    [pa.array(rng.integers(0, 50, n)), pa.array(rng.uniform(0, 100, n))],
                    names=["k", "x"],
                ),
            }
        )
        (root / "src").mkdir()
        pq.write_table(t, str(root / "src" / "p.parquet"))
        session = HyperspaceSession(warehouse_dir=str(root), device="cpu")
        session.set_conf(C.EXEC_TPU_ENABLED, False)
        hs = Hyperspace(session)
        df = session.read.parquet(str(root / "src"))
        hs.create_index(df, CoveringIndexConfig("nci", ["m.k"], ["m.x", "id"]))
        return session, str(root / "src")

    @pytest.mark.parametrize("seed", range(200, 215))
    def test_nested_indexed_matches_raw(self, nested_world, seed):
        session, src = nested_world
        rng = np.random.default_rng(seed)
        lo = int(rng.integers(0, 40))

        def q():
            df = session.read.parquet(src)
            df = df.filter((col("m.k") >= lo) & (col("m.k") < lo + int(rng.integers(2, 10))))
            if rng.integers(0, 2):
                return df.select("id", "m.k", "m.x")
            return df.group_by("m.k").agg(Sum(col("m.x")).alias("s"), Count(lit(1)).alias("n"))

        rng = np.random.default_rng(seed)
        session.disable_hyperspace()
        expected = canon(q().to_pydict())
        rng = np.random.default_rng(seed)
        session.enable_hyperspace()
        try:
            got = canon(q().to_pydict())
        finally:
            session.disable_hyperspace()
        assert rows_close(got, expected), f"nested divergence at seed {seed}"

    @pytest.mark.parametrize("seed", range(215, 225))
    def test_iceberg_snapshot_indexed_matches_raw(self, tmp_path, seed):
        rng = np.random.default_rng(seed)
        session = HyperspaceSession(warehouse_dir=str(tmp_path), device="cpu")
        session.set_conf(C.EXEC_TPU_ENABLED, False)
        hs = Hyperspace(session)
        t = IcebergStyleTable(str(tmp_path / "tbl"))
        n = 800
        t.commit(ColumnBatch.from_pydict({"k": rng.integers(0, 50, n).tolist(),
                                          "x": rng.uniform(size=n).tolist()}))
        hs.create_index(t.scan(session), CoveringIndexConfig("ici", ["k"], ["x"]))
        s0 = t.current_snapshot_id()
        t.commit(ColumnBatch.from_pydict({"k": [1, 2], "x": [9.0, 9.5]}))
        hs.refresh_index("ici", "incremental")
        kv = int(rng.integers(0, 50))

        def q(snapshot_id=None):
            return t.scan(session, snapshot_id=snapshot_id).filter(col("k") == kv).select("k", "x")

        for sid in (None, s0):
            got, expected = differential(session, q(sid))
            assert got == expected, f"snapshot divergence seed {seed} sid {sid}"
