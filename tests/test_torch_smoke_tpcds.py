"""chip_smoke.tpcds_phase rehearsed on the CPU: at 40,000 store_returns
rows, the device tier on the CPU and a kernels shim whose launches are the
plain versions' calls, every check of the phase holds (both TPC-DS q1
plans read sr_datekey and dd_datekey, every run takes the batched plain
join with the first run's bits and equals the host executor, and the four
device forms equal their numpy forms on the phase's device), and the
phase removes its lake."""

import importlib.util
import os
import types

import torch

import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.ops import cuda_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_tpcds_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_tpcds_rehearsal",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = tmp_path / "data"
    monkeypatch.setattr(smoke, "DATA_DIR", str(data))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    out = smoke.tpcds_phase(torch, shim, "cpu rehearsal", rows=40_000)
    for q, r in out["queries"].items():
        assert r["indexes"] == ["sr_datekey", "dd_datekey"], q
        assert r["join_paths"] == {"batched": 1 + smoke.TPCDS_WARM_RUNS}, q
        assert len(r["warm_ms"]) == smoke.TPCDS_WARM_RUNS and r["rows_out"] > 0, q
    assert out["queries"]["q1_store_avg"]["rows_out"] == 25
    forms = out["device_forms"]
    assert forms["rows"] == 40_000 and 0 < forms["bloom_hit_share"] < 1
    assert set(forms["device_ms"]) == {
        "segment_min_max_torch:sr_return_amt", "segment_min_max_torch:sr_customer_sk",
        "bloom_build_bits_torch", "bloom_probe_bits_torch", "interleave_bits_torch"}
    assert set(out["launches"]) == set(cuda_kernels.PLAIN_CALLS)
    assert not os.path.exists(os.path.join(str(data), "tpcds"))


def _smoke(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_pandas_check_rehearses_on_cpu(tmp_path):
    """The end-to-end phase's pandas check over a 20,000-row lake: the
    device tier's (on the CPU) q6, q1 and q3 equal PANDAS_TPCH's answers,
    and a q6 revenue off by 1e-3 is caught."""
    import pytest

    from hyperspace_tpu_torch.benchmark import tpch

    smoke = _smoke("chip_smoke_pandas_rehearsal")
    lake = str(tmp_path / "lake")
    tpch.generate_tpch(lake, rows_lineitem=20_000, seed=42)
    session = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    tpch.tpch_indexes(session, T.Hyperspace(session), lake)
    session.enable_hyperspace()
    results = {q: smoke._floats(tpch.TPCH_QUERIES[q](session, lake).to_pydict())
               for q in ("q6", "q1")}
    results["q3"] = smoke._columns(tpch.TPCH_QUERIES["q3"](session, lake).collect())
    seconds = smoke.pandas_check(lake, results, "cpu rehearsal")
    assert list(seconds) == list(smoke.PANDAS_CHECKED)
    results["q6"] = {"revenue": [results["q6"]["revenue"][0] * (1 + 1e-3)]}
    with pytest.raises(RuntimeError, match="q6.revenue"):
        smoke.pandas_check(lake, results, "cpu rehearsal")


def test_smoke_kernel_compositions_compute_the_kernels_functions():
    """Each composition the kernel phase times computes its kernel's
    function: held to the plain version on CPU tensors by the phase's own
    check."""
    from hyperspace_tpu_torch.ops import reference as R

    smoke = _smoke("chip_smoke_composition_rehearsal")
    gen = torch.Generator().manual_seed(5)
    n = 100_003
    pred = torch.rand(n, generator=gen) < 0.3
    xs = [torch.rand(n, generator=gen) * 1000 for _ in range(3)]
    gids = torch.randint(0, 16, (n,), generator=gen, dtype=torch.int32)
    mm_x = (torch.rand(n, generator=gen) - 0.5) * 2000
    mm_valid = torch.rand(n, generator=gen) < 0.5
    plain = {"filter_weighted_sum": lambda: R.filter_weighted_sum(pred, xs[0], xs[1]),
             "filter_sum": lambda: R.filter_sum(pred, xs[0]),
             "filter_grouped_multi_sum": lambda: R.filter_grouped_multi_sum(pred, gids, xs, 16),
             "masked_min_max": lambda: R.masked_min_max(mm_x, mm_valid)}
    compositions = smoke.kernel_compositions(torch, pred, xs, gids, mm_x, mm_valid)
    assert set(compositions) == set(plain) == set(smoke.KERNEL_ROWS)
    for name, labelled in compositions.items():
        assert len(labelled) == 2, name
        for label, fn in labelled.items():
            smoke.check_composition(torch, name, label, fn(), plain[name]())
