"""chip_smoke.gates_phase rehearsed on the CPU at a tiny size: 30
differential seeds over the three tiers and the hybrid mix, the
kernel-shaped leg at 2^14 rows (each of the three kernels' plain versions
called, which the kernels shim counts as launches), the chaos query sweep
at 6,000 lineitem rows, race_stress with 4 threads at 10,000 rows and the
five examples; every check of the phase holds, and it removes its data."""

import importlib.util
import os
import types

from hyperspace_tpu_torch.ops import cuda_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_gates_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_gates_rehearsal",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = tmp_path / "data"
    monkeypatch.setattr(smoke, "DATA_DIR", str(data))
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    out = smoke.gates_phase(shim, "cpu rehearsal", device="cpu", seeds=30,
                            kernel_rows=1 << 14, chaos_rows=6_000,
                            race={"threads": 4, "rows": 10_000})
    diff = out["differential"]
    assert diff["seeds"] == 30 and diff["hybrid_seeds"] == 6 and not diff["failures"]
    assert {t: v["seeds"] for t, v in diff["by_tier"].items()} == {
        "host": 10, "device": 10, "mesh": 10}
    for shape, r in out["kernel_leg"]["shapes"].items():
        assert r["launches"][shape] > 0, shape
        assert r["max_rel_err"] <= 1e-4, shape
    assert out["chaos"]["query_runs"] == 66
    for r in out["chaos"]["query_sweep"]:
        if r["spec"].startswith(("device.", "kernel.")):
            assert r["fired"] > 0 and r["typed_error"] >= 1, r
    assert out["race"]["threads"] == 4 and out["race"]["lock_violations"] == 0
    assert set(out["parts_s"]) == {"differential", "kernel_world", "kernel_leg", "chaos",
                                   "race", "examples"}
    assert set(out["launches"]) == set(cuda_kernels.PLAIN_CALLS)
    assert not os.path.exists(os.path.join(str(data), "gates"))
