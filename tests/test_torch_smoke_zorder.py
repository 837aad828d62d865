"""chip_smoke.zorder_leg rehearsed on the CPU: over a 65,536-row table,
the device tier on the CPU and a kernels shim whose launches are the plain
versions' calls, both z-order builds take the conf keys (percentile fields
only under quantile.enabled, several files each at the leg's target), each
box query reads its own index, equals the host executor and runs
filter_weighted_sum's plain version once per run, and the leg removes its
files."""

import importlib.util
import os
import types

import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.ops import cuda_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_zorder_leg_rehearses_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_zorder_rehearsal",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS)
    out = smoke.zorder_leg(shim, "cpu rehearsal", rows=1 << 16)
    assert set(out["builds"]) == set(smoke.ZORDER_BUILDS)
    for name, build in out["builds"].items():
        assert build["quantile"] is smoke.ZORDER_BUILDS[name]
        assert 1 < build["files"] <= smoke.ZORDER_PARTS
        q = out["queries"][f"zorder_{name}"]
        assert q["index"] == name and q["matches_host"]
        assert q["launches"]["filter_weighted_sum"] == 2
    assert out["knobs"] == 69
    assert not os.path.exists(tmp_path / "data" / "zorder_lake")
