"""The port's meshes and skew-aware placement against the JAX package's.

The JAX side runs on the 8 host devices that tests/conftest.py makes XLA
fake; the port's side on ``virtual_devices(8, "cpu")``, its counterpart.

- Meshes: flat and hierarchical meshes have the JAX package's axis names,
  shapes, shard counts, row axes, device ordinals and slice submeshes;
  ``active_mesh`` answers the conf keys ``meshDevices``/``meshSlices`` as
  the JAX package's does (None below two devices or with too few devices,
  that decline counted in the port's ``device_stats``; a bad slicing
  raises in both).
- ``visible_devices``: the virtual ordinals, capped like the JAX package's;
  none outside the context on a host with no card. ``shard_rows`` lays
  rows out on the ordinals as the JAX package's row sharding does (row
  major over ``("dcn", "ici")``), and ``replicated`` copies an array to
  every ordinal.
- Placement: for the same estimates, device count and offset, the same
  assignments of every bucket and chunk (hot buckets split across devices,
  unseen buckets round robin), the same ``mesh.placement.*`` counters and
  gauges, the same greedy chunk placements, and the same answers to the
  ``HYPERSPACE_MESH``/``HYPERSPACE_MESH_DEVICES`` knobs and to the query's
  home device.
"""

import types

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu.parallel import placement as jplace
from hyperspace_tpu.serve import context as jctx
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.exceptions import HyperspaceError as THSError
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.parallel import placement as tplace
from hyperspace_tpu_torch.serve import context as tctx
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu.exceptions import HyperspaceError as JHSError

MB = 2**20


@pytest.fixture
def vdev():
    with tmesh.virtual_devices(8, "cpu") as devices:
        yield devices


def _ids(grid) -> list:
    return [[d.id for d in row] for row in np.atleast_2d(grid)]


def _form(mesh, pkg) -> dict:
    m = jmesh if pkg == "jax" else tmesh
    return {
        "axes": tuple(mesh.axis_names),
        "shape": {a: int(mesh.shape[a]) for a in mesh.axis_names},
        "num_shards": m.num_shards(mesh),
        "row_axes": m.mesh_row_axes(mesh),
        "hier": m.is_hierarchical(mesh),
        "ids": _ids(mesh.devices),
        "slices": [_ids(s.devices) for s in m.slice_submeshes(mesh)],
        "slice_axes": [tuple(s.axis_names) for s in m.slice_submeshes(mesh)],
    }


@pytest.mark.parametrize("shape", [(8,), (4,), (2, 4), (4, 2), (2, 2)])
def test_meshes_match_the_jax_packages(vdev, shape):
    if len(shape) == 1:
        j, t = jmesh.device_mesh(shape[0]), tmesh.device_mesh(shape[0])
    else:
        j, t = jmesh.hierarchical_mesh(*shape), tmesh.hierarchical_mesh(*shape)
    assert _form(t, "torch") == _form(j, "jax")
    # one Mesh object per devices and axes: its identity keys the probe cache
    again = tmesh.device_mesh(shape[0]) if len(shape) == 1 else tmesh.hierarchical_mesh(*shape)
    assert again is t


def test_too_many_devices_raise_in_both(vdev):
    for m in (jmesh, tmesh):
        with pytest.raises(ValueError):
            m.device_mesh(9)
        with pytest.raises(ValueError):
            m.hierarchical_mesh(3, 3)


@pytest.mark.parametrize("cap", [0, 1, 3, 8, 20])
def test_visible_devices_match_and_cap(vdev, cap):
    assert [d.id for d in tmesh.visible_devices(cap)] == \
        [d.id for d in jmesh.visible_devices(cap)]


def test_virtual_devices_nest_and_restore():
    import torch

    outside = tmesh.visible_devices()
    assert outside == ([] if not torch.cuda.is_available() else outside)
    with tmesh.virtual_devices(4, "cpu") as four:
        assert [d.id for d in four] == [0, 1, 2, 3]
        with tmesh.virtual_devices(2, "cpu"):
            assert len(tmesh.visible_devices()) == 2
        assert tmesh.visible_devices() == four
        assert all(d.device == torch.device("cpu") for d in four)
        assert len({d.tag for d in four}) == 4
    assert tmesh.visible_devices() == outside


def _sessions(tmp_path, conf: dict):
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={getattr(JC, k): v for k, v in conf.items()})
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu",
                             conf={getattr(TC, k): v for k, v in conf.items()})
    return js, ts


@pytest.mark.parametrize("devices,slices", [(0, 1), (1, 1), (8, 1), (4, 1), (8, 2), (4, 2),
                                            (8, 4), (16, 1), (16, 2)])
def test_active_mesh_answers_the_conf_keys_as_the_jax_package(vdev, tmp_path, devices,
                                                              slices):
    js, ts = _sessions(tmp_path, {"EXEC_MESH_DEVICES": devices, "EXEC_MESH_SLICES": slices})
    j, t = jmesh.active_mesh(js), tmesh.active_mesh(ts)
    assert (j is None) == (t is None)
    if t is not None:
        assert _form(t, "torch") == _form(j, "jax")
    declined = ts.device_stats.declines.get("mesh_too_few_devices", 0)
    assert declined == (1 if devices > 8 else 0)
    assert jmesh.active_mesh(None) is None and tmesh.active_mesh(None) is None


@pytest.mark.parametrize("devices,slices", [(8, 3), (8, 0), (6, 4)])
def test_a_bad_slicing_raises_in_both(vdev, tmp_path, devices, slices):
    js, ts = _sessions(tmp_path, {"EXEC_MESH_DEVICES": devices, "EXEC_MESH_SLICES": slices})
    with pytest.raises(JHSError):
        js.conf.exec_mesh_slices
    with pytest.raises(THSError):
        ts.conf.exec_mesh_slices


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _estimates(case: str) -> dict:
    rng = np.random.default_rng(7)
    if case == "uniform":
        return {b: 10 * MB for b in range(8)}
    if case == "hot":
        return {0: 30 * MB, **{b: 10 * MB for b in range(1, 8)}}
    if case == "very_hot":
        return {3: 500 * MB, 5: MB, 9: 2 * MB}
    if case == "random16":
        return {b: int(rng.integers(1, 50)) * MB for b in range(16)}
    if case == "sparse":
        return {0: MB, 1: MB}
    if case == "zeros":
        return {0: 0, 1: 0, 2: 5}
    return {}


def _counters(reg) -> tuple:
    return (reg.counter("mesh.placement.buckets").value,
            reg.counter("mesh.placement.fallbacks").value)


@pytest.mark.parametrize("case", ["uniform", "hot", "very_hot", "random16", "sparse",
                                  "zeros", "empty"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("offset", [0, 3])
def test_bucket_placement_equals_the_jax_packages(case, ndev, offset):
    est = _estimates(case)
    devs = [f"dev{i}" for i in range(ndev)]
    j0, t0 = _counters(JREG), _counters(TREG)
    jp = jplace.plan_bucket_placement(dict(est), devices=devs, offset=offset)
    tp = tplace.plan_bucket_placement(dict(est), devices=devs, offset=offset)
    got, want = [], []
    for b in list(range(20)) + [99]:  # planned and unseen buckets
        for c in range(6):
            got.append(tp.slot_for(b, c))
            want.append(jp.slot_for(b, c))
    assert got == want
    assert tp.device_for(0) == jp.device_for(0)
    j1, t1 = _counters(JREG), _counters(TREG)
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    if est:
        for g in ("mesh.placement.devices_used", "mesh.placement.bytes_imbalance_ratio"):
            assert TREG.gauge(g).value == JREG.gauge(g).value, g


def test_hot_bucket_spans_devices_and_balances(vdev):
    est = _estimates("hot")
    p = tplace.plan_bucket_placement(est, devices=[f"d{i}" for i in range(8)])
    assert len({p.ordinal_for(0, chunk=c) for c in range(8)}) >= 2
    assert TREG.gauge("mesh.placement.devices_used").value >= 4
    assert TREG.gauge("mesh.placement.bytes_imbalance_ratio").value < 2.0
    assert tplace.plan_bucket_placement(est, devices=["d0"]) is None
    assert jplace.plan_bucket_placement(est, devices=["d0"]) is None


@pytest.mark.parametrize("ndev,offset,seed", [(4, 0, 1), (8, 5, 2), (3, 1, 3), (2, 0, 4)])
def test_chunk_placer_equals_the_jax_packages(ndev, offset, seed):
    sizes = np.random.default_rng(seed).integers(0, 1 << 20, 40)
    devs = [f"dev{i}" for i in range(ndev)]
    jp, tp = jplace.ChunkPlacer(devs, offset), tplace.ChunkPlacer(devs, offset)
    assert [tp.next(int(n)) for n in sizes] == [jp.next(int(n)) for n in sizes]


@pytest.mark.parametrize("mesh,cap", [(None, None), ("0", None), ("1", None), ("1", "0"),
                                      ("1", "1"), ("1", "2"), ("1", "3"), ("1", "20"),
                                      ("1", "x"), ("true", None)])
def test_mesh_knobs_answer_as_the_jax_packages(vdev, monkeypatch, mesh, cap):
    for knob, v in (("HYPERSPACE_MESH", mesh), ("HYPERSPACE_MESH_DEVICES", cap)):
        if v is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, v)
    assert tplace.mesh_enabled() == jplace.mesh_enabled()
    assert tplace.mesh_size() == jplace.mesh_size()
    assert [d.id for d in tplace.mesh_devices()] == [d.id for d in jplace.mesh_devices()]
    assert (tplace.chunk_placer() is None) == (jplace.chunk_placer() is None)
    strategy = types.SimpleNamespace(estimates={0: (100, 5 * MB), 1: (10, MB)})
    tp, jp = tplace.plan_for_strategy(strategy), jplace.plan_for_strategy(strategy)
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert [tp.ordinal_for(b, c) for b in range(4) for c in range(3)] == \
            [jp.ordinal_for(b, c) for b in range(4) for c in range(3)]


@pytest.mark.parametrize("home", [None, 0, 5])
def test_placement_starts_at_the_query_home_device(vdev, monkeypatch, home):
    monkeypatch.setenv("HYPERSPACE_MESH", "1")
    est = {0: MB}
    out = {}
    for name, ctx, place in (("jax", jctx, jplace), ("torch", tctx, tplace)):
        q = ctx.QueryContext(label="home")
        q.device_home = home
        with ctx.query_scope(q):
            assert place._query_offset() == (home or 0)
            strategy = types.SimpleNamespace(estimates={b: (1, v) for b, v in est.items()})
            p = place.plan_for_strategy(strategy)
            cp = place.chunk_placer()
            out[name] = ([p.ordinal_for(b) for b in range(4)], [cp.next(1)[0] for _ in range(5)])
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_rows_shard_and_replicate_as_the_jax_package_lays_them_out(vdev, shape):
    import jax

    rows = np.arange(8 * 5, dtype=np.int32)
    if len(shape) == 1:
        j, t = jmesh.device_mesh(8), tmesh.device_mesh(8)
    else:
        j, t = jmesh.hierarchical_mesh(*shape), tmesh.hierarchical_mesh(*shape)
    placed = jax.device_put(rows, jmesh.shard_rows(j))
    want = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    got = {d.id: p.numpy() for d, p in zip(t.flat, tmesh.shard_rows(t, rows))}
    assert sorted(got) == sorted(want)
    for ordinal in want:
        assert (got[ordinal] == want[ordinal]).all(), ordinal
    # a ragged host array pads with zeros, as shard_columns pads
    ragged = tmesh.shard_rows(t, np.arange(13, dtype=np.int32))
    assert [len(p) for p in ragged] == [2] * 8
    assert np.concatenate([p.numpy() for p in ragged]).tolist() == list(range(13)) + [0] * 3
    copies = tmesh.replicated(t, rows)
    assert len(copies) == 8 and all((c.numpy() == rows).all() for c in copies)
    assert [c.device for c in copies] == [d.device for d in t.flat]
