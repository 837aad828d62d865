"""chip_smoke.gates_phase rehearsed on the CPU at a tiny size: 30
differential seeds over the three tiers and the hybrid mix, the
kernel-shaped leg at 2^14 rows (each of the three kernels' plain versions
called, which the kernels shim counts as launches), the chaos query sweep
at 6,000 lineitem rows, race_stress with 4 threads at 10,000 rows, the
five examples and the six serving-plane gates at small sizes (serve_smoke
and qos_smoke serving the kernel-shaped queries from several workers);
every check of the phase holds, and it removes its data."""

import importlib.util
import os
import types

from hyperspace_tpu_torch.ops import cuda_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part (f)'s gates at small sizes
FEATURES = {"serve": {"rows": 6_000, "clients": 3},
            "qos": {"rows": 6_000},
            "plan_stats": {"rows": 6_000},
            "workload": {"rows": 4_000},
            "result_cache": {"rows": 6_000, "clients": 2, "repeats": 2, "batches": 3,
                             "batch_rows": 500},
            "ingest": {"clients": 3, "batches": 6, "batch_rows": 600,
                       "queries_per_client": 10}}


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
                            race={"threads": 4, "rows": 10_000}, features=FEATURES)
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
                                   "race", "examples", "features"}
    assert list(out["features"]) == [name for name, _kw in smoke.FEATURE_GATES]
    for name in ("serve", "qos"):
        f = out["features"][name]
        assert all(f["launches"][k] > 0 for k in smoke.ON_PATH), (name, f["launches"])
        assert all(len(f["kernel_threads"][k]) >= 2 for k in smoke.ON_PATH), name
    assert out["features"]["qos"]["fairness_ratio"] <= 1.8
    assert out["features"]["result_cache"]["hits"] > 0
    assert out["features"]["ingest"]["compactions"] >= 1
    assert set(out["launches"]) == set(cuda_kernels.PLAIN_CALLS)
    assert not os.path.exists(os.path.join(str(data), "gates"))
