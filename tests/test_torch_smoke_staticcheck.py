"""chip_smoke.staticcheck_phase rehearsed on the CPU: over a 200k-row lake
with tpch_indexes, the device tier on the CPU and a kernels shim whose
launches are the plain versions' calls, every check of the phase holds
(served results under the lock-order and lifecycle audits bit for bit the
warm ones, the mid-stream cancel, quiescence, every plan verified, the mix
under the kernel audit bit for bit), kernels 1-3's plain versions run in
its window, and the knobs and audit switches it sets are restored."""

import importlib.util
import os
import types

import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch
from hyperspace_tpu_torch.ops import cuda_kernels
from hyperspace_tpu_torch.staticcheck import concurrency, lifecycle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_staticcheck_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_staticcheck_rehearsal",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = tmp_path / "data"
    monkeypatch.setattr(smoke, "DATA_DIR", str(data))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    for knob in smoke.STATICCHECK_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    # one chunk group per index file and four IO threads, so that q18's
    # scan of li_orderkey streams (at SF10 its files make several groups)
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    lake, warehouse = str(data / "lake"), str(data / "wh")
    tpch.generate_tpch(lake, rows_lineitem=200_000, seed=42)
    session = T.HyperspaceSession(warehouse)
    tpch.tpch_indexes(session, T.Hyperspace(session), lake)
    session.enable_hyperspace()
    fns = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES}
    warm = {q: smoke._result_form(q, fns[q](session, lake).collect())
            for q in smoke.STATICCHECK_MIX}
    audits = (concurrency.audit_enabled(), lifecycle.audit_enabled())
    out = smoke.staticcheck_phase(shim, {"lake": lake, "warehouse": warehouse,
                                         "warm_results": warm}, session, "cpu rehearsal")
    assert all(k not in os.environ for k in smoke.STATICCHECK_KNOBS)
    assert (concurrency.audit_enabled(), lifecycle.audit_enabled()) == audits
    assert out["locks"]["violations"] == 0 and out["locks"]["acquisitions"] > 0
    assert out["lifecycle"]["leaks"] == 0
    assert out["lifecycle"]["acquires"] == out["lifecycle"]["releases"] > 0
    assert out["plans"]["violations"] == 0 and out["plans"]["nodes"] > 0
    assert set(out["plans"]["queries"]) >= set(tpch.TPCH_QUERIES)
    assert out["kernels"]["audited"] > 0
    assert out["served"]["stream_open"] in ("read-ahead", "device")
    assert all(out["launches"][k] > 0 for k in smoke.ON_PATH)
    for q in smoke.STATICCHECK_TIMED:
        assert len(out["warm_ms"][q]["on"]["runs"]) == len(out["warm_ms"][q]["off"]["runs"]) == 2
