"""chip_smoke.mesh_phase rehearsed on the CPU: over a 200k-row lake with
tpch_indexes, the device tier on the CPU, four virtual mesh ordinals over
it and a kernels shim whose launches are the plain versions' calls, every
check of the phase holds (placed joins and streamed first runs bit for bit
the mesh-off results, the grouped kernel launched once per placed chunk,
the mesh route within tolerance, the mesh join bit for bit, the
mesh-partitioned build byte for byte the host build, the per-slice runs
the host build's rows, the dry run, every ledger drained), kernels 1-3's
plain versions run in its window, and the knobs, conf keys and ledgers it
sets are restored."""

import importlib.util
import os
import types

import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.serve import budget as serve_budget
from hyperspace_tpu_torch.benchmark import tpch
from hyperspace_tpu_torch.ops import cuda_kernels
from hyperspace_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_mesh_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh_rehearsal",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = tmp_path / "data"
    monkeypatch.setattr(smoke, "DATA_DIR", str(data))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    for knob in smoke.MESH_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    # several chunk groups per index scan, as the SF10 files make
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    lake, warehouse = str(data / "lake"), str(data / "wh")
    tpch.generate_tpch(lake, rows_lineitem=200_000, seed=42)
    session = T.HyperspaceSession(warehouse)
    tpch.tpch_indexes(session, T.Hyperspace(session), lake)
    session.enable_hyperspace()
    out = smoke.mesh_phase(torch, shim, {"lake": lake, "warehouse": warehouse}, session,
                           "cpu rehearsal")
    assert all(k not in os.environ for k in smoke.MESH_KNOBS)
    assert session.get_conf(TC.EXEC_MESH_DEVICES) is None
    assert session.get_conf(TC.EXEC_MESH_SLICES) is None
    assert set(serve_budget.device_budgets()) == {0}
    assert tmesh.visible_devices() == []
    pl = out["placement"]
    assert len(pl["placed_waves"]) >= 2 and len(pl["placed_chunks"]) >= 2
    assert pl["grouped_kernel_launches"]["q1_count"] == pl["placed_chunks_by_query"]["q1_count"]
    assert pl["spans"].get("mesh:dispatch", 0) > 0 and pl["spans"].get("mesh:place", 0) > 0
    assert out["route"]["spans"].get("kernel:mesh_agg", 0) == 2 * len(smoke.MESH_ROUTE)
    assert out["hierarchical_route"]["mesh_fragments"] == 2 * len(smoke.MESH_ROUTE)
    assert out["join"]["spans"].get("kernel:mesh_join_probe", 0) >= 2
    assert out["build"]["mesh"]["spans"].get("kernel:bucket_exchange", 0) >= 1
    assert out["dryrun"]["mesh_fragments"] == 2
    assert all(out["launches"][k] > 0 for k in smoke.ON_PATH)
    assert not os.path.exists(os.path.join(str(data), "mesh"))
