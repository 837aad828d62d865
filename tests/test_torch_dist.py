"""The distributed aggregate against the JAX package's, on the same inputs.

The JAX side runs on the 8 host devices tests/conftest.py makes XLA fake
(each JAX mesh kernel compiles for seconds there, so each runs once per
module); the port's on ``virtual_devices(8, "cpu")``.

- ``build_distributed_grouped_kernel`` over a ragged row count (not a
  multiple of the shards), a flat 8-shard mesh and a 2 x 4 hierarchical
  one: per-group counts, global first passing rows, integer sums and
  averages (8-bit chunk sums, values above 2^24) exact; f32 sums and
  averages within relative 1e-4; min and max exact; equal to the JAX
  package's and to the one-device grouped body of plan/gpu_exec.py.
- ``distributed_filter_aggregate`` of the Q6 shape (a range predicate over
  three columns, sum(a * b) and count) equal to the JAX package's.
- ``shard_columns`` pads and masks as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hyperspace_tpu.parallel import dist_agg as jdist
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu_torch.ops.intsum import combine_int_chunks
from hyperspace_tpu_torch.parallel import dist_agg as tdist
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import gpu_exec as tgpu

REL = 1e-4
N = 8 * 1000 + 13  # ragged
SEG_PAD = 16
GROUPS = 6
AGGS = (("count", None), ("sum", "x"), ("sum", "q"), ("min", "d"), ("max", "x"),
        ("avg", "y"), ("avg", "q"), ("min", "x"), ("max", "q"))


def _columns(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(0, 1, N).astype(np.float32),
        "y": rng.uniform(-50, 50, N).astype(np.float32),
        "q": (rng.integers(0, 1 << 10, N) + (1 << 24)).astype(np.int32),
        "d": rng.integers(8000, 10000, N).astype(np.int32),
    }


def _gids(seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, GROUPS, N).astype(np.int32)


def _pred(c):
    return (c["x"] > 0.3) & (c["d"] < 9000)


def _agg_list():
    return [(kind, None if col is None else (lambda c, col=col: c[col])) for kind, col in AGGS]


def _padded_gids(d: int) -> np.ndarray:
    padded = -(-N // d) * d
    g = np.full(padded, SEG_PAD - 1, np.int32)
    g[:N] = _gids()
    return g


def _host(results) -> list:
    out = []
    for v in results:
        out.append(combine_int_chunks([np.asarray(p) for p in v]) if isinstance(v, tuple)
                   else np.asarray(v))
    return out


def _jax_grouped(mesh) -> tuple:
    cols, mask = jdist.shard_columns(mesh, _columns())
    axis = jmesh.mesh_row_axes(mesh)
    gids = jax.device_put(jnp.asarray(_padded_gids(jmesh.num_shards(mesh))),
                          NamedSharding(mesh, P(axis)))
    kernel = jdist.build_distributed_grouped_kernel(mesh, _pred, _agg_list(), SEG_PAD)
    counts, first, results = kernel(cols, gids, mask)
    return np.asarray(counts), np.asarray(first), _host(results)


def _torch_grouped(mesh) -> tuple:
    cols, mask = tdist.shard_columns(mesh, _columns())
    gids = tmesh.shard_rows(mesh, _padded_gids(tmesh.num_shards(mesh)))
    kernel = tdist.build_distributed_grouped_kernel(mesh, _pred, _agg_list(), SEG_PAD)
    counts, first, results = kernel(cols, gids, mask)
    return counts.numpy(), first.numpy(), _host(results)


@pytest.fixture(scope="module")
def jax_results():
    """Each JAX mesh kernel once: the grouped kernel on a flat and a
    hierarchical mesh, and the Q6-shaped filter aggregate."""
    flat = _jax_grouped(jmesh.device_mesh(8))
    hier = _jax_grouped(jmesh.hierarchical_mesh(2, 4))
    q6 = _jax_q6(jmesh.device_mesh(8))
    return {"flat": flat, "hier": hier, "q6": q6}


@pytest.fixture
def vdev():
    with tmesh.virtual_devices(8, "cpu") as devices:
        yield devices


def _assert_grouped(got, want) -> None:
    gc, gf, gr = got
    wc, wf, wr = want
    assert (gc == wc).all()
    assert (gf[:GROUPS] == wf[:GROUPS]).all()
    for (kind, col), g, w in zip(AGGS, gr, wr):
        g, w = g[:GROUPS], w[:GROUPS]
        if col in ("x", "y") and kind in ("sum", "avg"):
            np.testing.assert_allclose(g, w, rtol=REL, err_msg=f"{kind}({col})")
        else:
            assert (g == w).all(), f"{kind}({col})"


@pytest.mark.parametrize("shape", ["flat", "hier"])
def test_grouped_kernel_equals_the_jax_packages(vdev, jax_results, shape):
    mesh = tmesh.device_mesh(8) if shape == "flat" else tmesh.hierarchical_mesh(2, 4)
    got = _torch_grouped(mesh)
    _assert_grouped(got, jax_results[shape])
    # the integer sums above 2^24 need the chunks: exact against numpy
    cols, gids = _columns(), _gids()
    m = _pred(cols)
    want_q = np.bincount(gids[m], weights=None, minlength=GROUPS)
    assert (got[0][:GROUPS] == want_q).all()
    q_sum = np.zeros(GROUPS, np.int64)
    np.add.at(q_sum, gids[m], cols["q"][m].astype(np.int64))
    assert (got[2][2][:GROUPS] == q_sum).all()
    first = [int(np.flatnonzero(m & (gids == g))[0]) for g in range(GROUPS)]
    assert got[1][:GROUPS].tolist() == first


@pytest.mark.parametrize("devices", [2, 8])
def test_grouped_kernel_equals_the_one_device_body(vdev, devices):
    mesh = tmesh.device_mesh(devices)
    got = _torch_grouped(mesh)
    padded = -(-N // devices) * devices
    cols = {k: torch.from_numpy(np.pad(v, (0, padded - N))) for k, v in _columns().items()}
    spec = [(kind, None if col is None else TX.col(col)) for kind, col in AGGS]
    pred = (TX.col("x") > 0.3) & (TX.col("d") < 9000)
    counts, first, results = tgpu._generic_grouped_compute(
        pred, (), spec, SEG_PAD, cols, torch.from_numpy(_padded_gids(devices)),
        torch.arange(padded) < N)
    want = (counts.numpy(), first.numpy(), _host(results))
    _assert_grouped(got, want)


def _q6_fns(where):
    def rev(c, m):
        return where(m, c["x"] * c["y"], 0.0).sum()

    def cnt(c, m):
        return m.sum()

    return {"revenue": rev, "count": cnt}


def _q6_pred(c):
    return (c["d"] >= 8766) & (c["d"] < 9131) & (c["x"] >= 0.05) & (c["x"] <= 0.7)


def _jax_q6(mesh) -> dict:
    cols, mask = jdist.shard_columns(mesh, _columns())
    out = jdist.distributed_filter_aggregate(mesh, cols, mask, _q6_pred, _q6_fns(jnp.where))
    return {k: np.asarray(v) for k, v in out.items()}


def test_q6_filter_aggregate_equals_the_jax_packages(vdev, jax_results):
    mesh = tmesh.device_mesh(8)
    cols, mask = tdist.shard_columns(mesh, _columns())
    got = tdist.distributed_filter_aggregate(mesh, cols, mask, _q6_pred,
                                             _q6_fns(torch.where))
    want = jax_results["q6"]
    assert int(got["count"]) == int(want["count"]) > 0
    np.testing.assert_allclose(float(got["revenue"]), float(want["revenue"]), rtol=REL)
    c = _columns()
    m = _q6_pred(c)
    assert int(got["count"]) == int(m.sum())


def test_shard_columns_pads_and_masks_as_the_jax_package(vdev):
    jm, tm = jmesh.device_mesh(8), tmesh.device_mesh(8)
    jcols, jmask = jdist.shard_columns(jm, {"q": _columns()["q"]})
    tcols, tmask = tdist.shard_columns(tm, {"q": _columns()["q"]})
    assert (np.concatenate([p.numpy() for p in tcols["q"]]) == np.asarray(jcols["q"])).all()
    assert (np.concatenate([p.numpy() for p in tmask]) == np.asarray(jmask)).all()
    assert [p.device for p in tcols["q"]] == [d.device for d in tm.flat]
