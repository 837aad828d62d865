"""The differential harness held to the JAX package: over the same source
files, each package indexed in its own warehouse (the reference test's
ci_k, z_d, ds_d and ci_rk),

- for host seeds 0-39 the port's rows with Hyperspace on equal the JAX
  package's exactly, and for device-tier seeds 100-119 (the device tier
  on even seeds, the mesh route over 8 devices on odd ones, 2 slices
  where seed % 4 == 1) within the 1e-6 relative contract; the JAX side
  runs as its own tests run it, on the CPU's 8 forced host devices;
- for seeds 0-199 the port's ``random_query`` builds the reference's
  plan: the logical plans and the optimized plans (warehouse paths
  aside) render the same."""

import os
import sys

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.parallel.mesh import virtual_devices
from hyperspace_tpu_torch.tools import differential as D

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_differential as JD  # noqa: E402  (the reference's harness)


def _index(pkg, C, session, src: str) -> None:
    session.set_conf(C.INDEX_LINEAGE_ENABLED, True)
    hs = pkg.Hyperspace(session)
    fact = session.read.parquet(os.path.join(src, "fact"))
    dim = session.read.parquet(os.path.join(src, "dim"))
    hs.create_index(fact, pkg.CoveringIndexConfig("ci_k", ["k"], ["x", "d"]))
    hs.create_index(fact, pkg.ZOrderCoveringIndexConfig("z_d", ["d"], ["x", "k"]))
    hs.create_index(fact, pkg.DataSkippingIndexConfig("ds_d", [pkg.MinMaxSketch("d")]))
    hs.create_index(dim, pkg.CoveringIndexConfig("ci_rk", ["rk"], ["w"]))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("diffparity")
    src = str(base / "src")
    D.write_world(src)
    js = J.HyperspaceSession(warehouse_dir=str(base / "jwh"))
    _index(J, JC, js, src)
    ts = T.HyperspaceSession(warehouse_dir=str(base / "twh"), device="cpu")
    _index(T, TC, ts, src)
    D.set_tier(ts, "host")
    return {"src": src, "jax": js, "torch": ts, "jwh": js.warehouse_dir,
            "twh": ts.warehouse_dir}


def _jax_tier(js, seed: int) -> None:
    js.set_conf(JC.EXEC_TPU_ENABLED, True)
    js.set_conf(JC.EXEC_MESH_DEVICES, 8 if seed % 2 else 0)
    js.set_conf(JC.EXEC_MESH_SLICES, 2 if seed % 4 == 1 else 1)


def _jax_host(js) -> None:
    js.set_conf(JC.EXEC_TPU_ENABLED, False)
    js.set_conf(JC.EXEC_MESH_DEVICES, 0)
    js.set_conf(JC.EXEC_MESH_SLICES, 1)


def _indexed_rows(session, query, canon) -> list:
    session.enable_hyperspace()
    try:
        return canon(query.to_pydict())
    finally:
        session.disable_hyperspace()


@pytest.mark.parametrize("seed", range(40))
def test_host_rows_equal_the_jax_packages(worlds, seed):
    src = worlds["src"]
    jq = JD.random_query(worlds["jax"], src, np.random.default_rng(seed))
    tq = D.random_query(worlds["torch"], src, np.random.default_rng(seed))
    want = _indexed_rows(worlds["jax"], jq, JD.canon)
    got = _indexed_rows(worlds["torch"], tq, D.canon)
    assert got == want, f"seed {seed}"


@pytest.mark.parametrize("seed", range(100, 120))
def test_device_tier_rows_equal_the_jax_packages(worlds, seed):
    src, js, ts = worlds["src"], worlds["jax"], worlds["torch"]
    _jax_tier(js, seed)
    D.set_tier(ts, "mesh" if seed % 2 else "device", 2 if seed % 4 == 1 else 1)
    try:
        with virtual_devices(D.MESH_DEVICES, "cpu"):
            jq = JD.random_query(js, src, np.random.default_rng(seed))
            tq = D.random_query(ts, src, np.random.default_rng(seed))
            want = _indexed_rows(js, jq, JD.canon)
            got = _indexed_rows(ts, tq, D.canon)
    finally:
        _jax_host(js)
        D.set_tier(ts, "host")
    assert D.rows_close(got, want), f"seed {seed}"


@pytest.mark.parametrize("block", range(10))
def test_random_query_builds_the_reference_plan(worlds, block):
    """Seeds 20*block .. 20*block+19: the logical plan, and the optimized
    plan with Hyperspace on (each warehouse's path masked)."""
    src = worlds["src"]
    for seed in range(20 * block, 20 * block + 20):
        jq = JD.random_query(worlds["jax"], src, np.random.default_rng(seed))
        tq = D.random_query(worlds["torch"], src, np.random.default_rng(seed))
        assert tq.plan.pretty() == jq.plan.pretty(), f"seed {seed}"
        worlds["jax"].enable_hyperspace()
        worlds["torch"].enable_hyperspace()
        try:
            jopt = jq.optimized_plan().pretty().replace(worlds["jwh"], "<wh>")
            topt = tq.optimized_plan().pretty().replace(worlds["twh"], "<wh>")
        finally:
            worlds["jax"].disable_hyperspace()
            worlds["torch"].disable_hyperspace()
        assert topt == jopt, f"seed {seed}"
