"""The kernel audit and the retrace watchdog of the port
(staticcheck/kernel_audit.py), against the JAX package's where both have
the same input:

- one planted closure per hazard code is caught through the port's
  KernelCache under ``HYPERSPACE_KERNEL_AUDIT=1`` (and order-free integer
  and min/max reductions are not), audited once, its result unchanged;
- the integer avg of the fused join bodies: the one f64 the audit finds on
  the port's paths, allowed (``F64_ALLOW``) because the port's avg equals
  both packages' host executors bit for bit, where the JAX package's device
  tier divides in f32;
- the watchdog's message for the same key tuples is the JAX watchdog's,
  and the fingerprints that do not end with a dtype signature are grouped
  by the one the cache names;
- the warm mix over a small TPC-H lake returns the same bits with all four
  audits on as with all off.
"""

import numpy as np
import pytest
import torch

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.plan import device_join as jdj
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import nodes as JN
from hyperspace_tpu.staticcheck import kernel_audit as jka
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import kernel_cache as tkc
from hyperspace_tpu_torch.plan import nodes as TN
from hyperspace_tpu_torch.staticcheck import concurrency as TCC
from hyperspace_tpu_torch.staticcheck import kernel_audit as tka
from hyperspace_tpu_torch.staticcheck import lifecycle as TLC
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG


def _val(name: str) -> int:
    m = TREG.get(name)
    return 0 if m is None else int(m.value)


@pytest.fixture()
def audit_on(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_KERNEL_AUDIT", "1")
    tka.reset_hazards()
    yield
    tka.reset_hazards()


X_I32 = torch.arange(1, 9, dtype=torch.int32)
IDX = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3])

PLANTED = {
    "item": ("HOST_CALLBACK", "aten._local_scalar_dense",
             lambda x: x.sum() + x[0].item()),
    "item_in_expr": ("HOST_CALLBACK", "aten._local_scalar_dense",
                     lambda x: x * int(x.max())),
    "to_f64": ("IMPLICIT_F64", "aten._to_copy", lambda x: x.to(torch.float64).sum()),
    "f64_factory": ("IMPLICIT_F64", "aten.zeros",
                    lambda x: torch.zeros(4, dtype=torch.float64) + 1),
    "float_index_add": ("NONDETERMINISTIC", "aten.index_add_",
                        lambda x: torch.zeros(4).index_add_(0, IDX, x.float())),
    "float_scatter_add": ("NONDETERMINISTIC", "aten.scatter_add",
                          lambda x: torch.zeros(4).scatter_add(0, IDX, x.float())),
    "float_index_put_acc": ("NONDETERMINISTIC", "aten.index_put_",
                            lambda x: torch.zeros(4).index_put_((IDX,), x.float(),
                                                                accumulate=True)),
    "float_scatter_reduce_sum": ("NONDETERMINISTIC", "aten.scatter_reduce",
                                 lambda x: torch.zeros(4).scatter_reduce(0, IDX, x.float(),
                                                                         "sum")),
    "random": ("NONDETERMINISTIC", "aten.rand", lambda x: x.float() * 0 + torch.rand(8)),
}


def _build(kind: str, fn, key_tail=("sig",)):
    cache = tkc.KernelCache("sc_test", 256)
    return cache.get_or_build(("planted", kind) + key_tail, lambda: fn, kind)


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_hazard_is_caught_once_and_the_result_is_unchanged(case, audit_on):
    code, prim, fn = PLANTED[case]
    assert getattr(tka, code) == getattr(jka, code) == code
    h0, a0 = _val(f"staticcheck.kernel.hazard.{code}"), _val("staticcheck.kernel.audited")
    kernel = _build(f"planted_{case}", fn)
    torch.manual_seed(0)
    got = kernel(X_I32)
    torch.manual_seed(0)
    assert torch.equal(got, fn(X_I32))
    kernel(X_I32)  # audited once
    found = [(h.code, h.primitive) for h in tka.hazards_found()]
    assert (code, prim) in found
    assert _val(f"staticcheck.kernel.hazard.{code}") == h0 + sum(c == code for c, _p in found)
    assert _val("staticcheck.kernel.audited") == a0 + 1
    assert all(h.kind == f"planted_{case}" for h in tka.hazards_found())


CLEAN = {
    "int_index_add": lambda x: torch.zeros(4, dtype=torch.int32).index_add_(0, IDX, x),
    "scatter_amin": lambda x: torch.full((4,), 99.0).scatter_reduce(0, IDX, x.float(), "amin"),
    "float_sum": lambda x: x.float().sum(),
    "segment_sum": lambda x: torch.segment_reduce(x.float(), "sum",
                                                  lengths=torch.tensor([4, 4])),
    "int_scatter_add": lambda x: torch.zeros(4, dtype=torch.int32).scatter_add(0, IDX, x),
}


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_order_free_closure_has_no_hazard(case, audit_on):
    kernel = _build(f"clean_{case}", CLEAN[case])
    assert torch.equal(kernel(X_I32), CLEAN[case](X_I32))
    assert tka.hazards_found() == []


def test_audit_off_returns_the_built_closure(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_KERNEL_AUDIT", raising=False)
    fn = PLANTED["item"][2]
    a0 = _val("staticcheck.kernel.audited")
    assert _build("planted_off", fn) is fn
    assert _val("staticcheck.kernel.audited") == a0


# --- the integer avg of the fused join bodies -----------------------------------


def _int_avg_batches():
    rng = np.random.default_rng(5)
    n_l, n_r = 4000, 700
    left = {"k": np.sort(rng.integers(0, 1000, n_l)).astype(np.int64),
            "q": rng.integers(1, 51, n_l)}
    right = {"rk": np.sort(rng.permutation(1000)[:n_r]).astype(np.int64),
             "w": rng.uniform(0, 10, n_r)}
    out = []
    for Col, Batch in ((JColumn, JBatch), (TColumn, TBatch)):
        out.append((Batch({n: Col(a, str(a.dtype)) for n, a in left.items()}),
                    Batch({n: Col(a, str(a.dtype)) for n, a in right.items()})))
    return out


def _avg_plan(M, N, lb, rb):
    return N.Aggregate([M.col("k")], [M.Avg(M.col("q")).alias("a"), M.Count(M.lit(1)).alias("n")],
                       N.Join(N.InMemoryScan(lb), N.InMemoryScan(rb), M.col("k") == M.col("rk")))


def test_join_int_avg_is_f64_allowed_and_equals_both_hosts(tmp_path, audit_on, monkeypatch):
    (jl, jr), (tl, tr) = _int_avg_batches()
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu")
    tplan, jplan = _avg_plan(TX, TN, tl, tr), _avg_plan(JX, JN, jl, jr)
    got = tdj.try_device_join_agg(tplan, tl, tr, ["k"], ["rk"], [], ts, True, True).to_pydict()
    assert tka.hazards_found() == []  # the body's int64 -> f64 is allowed
    t_host = tdj.try_host_join_agg(tplan, tl, tr, ["k"], ["rk"], [], ts, True).to_pydict()
    j_host = jdj.try_host_join_agg(jplan, jl, jr, ["k"], ["rk"], [], js, True).to_pydict()
    j_dev = jdj.try_device_join_agg(jplan, jl, jr, ["k"], ["rk"], [], js, True).to_pydict()
    a = np.asarray(got["a"], dtype=np.float64)
    assert len(a) > 100 and a.tobytes() == np.asarray(t_host["a"], np.float64).tobytes()
    assert a.tobytes() == np.asarray(j_host["a"], np.float64).tobytes()
    # the JAX package's device tier divides in f32 (x64 is off on a TPU)
    jd = np.asarray(j_dev["a"], dtype=np.float64)
    assert (jd != a).any()
    np.testing.assert_allclose(jd, a, rtol=2.0**-22)
    # without the allowance the audit names the op
    monkeypatch.setattr(tka, "F64_ALLOW", {})
    ts2 = T.HyperspaceSession(str(tmp_path / "t2"), device="cpu")
    tdj.try_device_join_agg(tplan, tl, tr, ["k"], ["rk"], [], ts2, True, True)
    assert {(h.kind, h.code, h.primitive) for h in tka.hazards_found()} == {
        ("join_agg", "IMPLICIT_F64", "aten._to_copy")}


# --- the retrace watchdog -------------------------------------------------------


def test_watchdog_message_equals_the_reference(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_RETRACE_WARN", "2")
    sig = (("x", "float32"),)
    keys = [(True, f"(x > {i})", (), (("sum", "x"),), sig) for i in range(4)]
    msgs = {}
    for name, mod in (("jax", jka), ("torch", tka)):
        mod.reset_watchdog()
        try:
            msgs[name] = [mod.WATCHDOG.record("kernel", "fused_agg", k) for k in keys]
            assert mod.WATCHDOG.record("kernel", "fused_agg", keys[0]) is None  # seen
        finally:
            mod.reset_watchdog()
    assert msgs["torch"] == msgs["jax"]
    assert msgs["torch"][:2] == [None, None] and msgs["torch"][3] is None
    assert "accumulated 3 distinct fingerprints" in msgs["torch"][2]


def test_fingerprint_signatures_group_the_misses(monkeypatch):
    """Every fingerprint form names its dtype signature: the forms that end
    with one, by their last element; the stacked join body by its key
    dtype; the dtype-free plain-join and sort bodies by ()."""
    sig = (("x", "float32"),)
    grouped = ("grouped", "cuda", ("FileScan",), 8, "p", (), (), sig)  # its form
    assert tkc.fingerprint_dtype_signature(grouped) == sig
    join = tkc.join_fingerprint("cuda", "<i4", [("sum", "x")], [], [], [], (("a",), ("b",), ()))
    assert tkc.fingerprint_dtype_signature(join) == (("key", "<i4"),)
    assert tkc.fingerprint_dtype_signature(tkc.plain_join_fingerprint("cuda", "expand", 64)) == ()
    assert tkc.fingerprint_dtype_signature(tkc.order_fingerprint("cuda", "sort", 3)) == ()
    topk = tkc.order_fingerprint("cuda", "topk", 10, True, "<f4")
    assert tkc.fingerprint_dtype_signature(topk) == "<f4"
    bucket = tkc.bucket_join_fingerprint("cuda", "bucket_agg", 64, "<i4", [], [], sig)
    assert tkc.fingerprint_dtype_signature(bucket) == sig
    # the expand body's pads are one group: a storm past the threshold
    monkeypatch.setenv("HYPERSPACE_RETRACE_WARN", "2")
    tka.reset_watchdog()
    s0 = _val("staticcheck.kernel.retrace_storm")
    cache = tkc.KernelCache("sc_storm", 256)
    try:
        for pad in (64, 128, 256):
            cache.get_or_build(tkc.plain_join_fingerprint("cuda", "expand", pad),
                               lambda: (lambda: None), "join_expand")
        assert _val("staticcheck.kernel.retrace_storm") == s0 + 1
    finally:
        tka.reset_watchdog()


# --- the warm mix under every audit ---------------------------------------------


MIX = ("q6_count", "q6_sum", "q1_sums", "lookup_count", "range_sum", "q3_agg")


def _bits(batch) -> dict:
    return {k: np.asarray(v).tobytes() for k, v in batch.to_pydict().items()}


def test_warm_mix_bits_equal_with_every_audit_on_and_off(tmp_path, monkeypatch):
    lake = str(tmp_path / "lake")
    ttpch.generate_tpch(lake, rows_lineitem=40_000, seed=42)
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    ttpch.tpch_indexes(s, T.Hyperspace(s), lake)
    s.enable_hyperspace()
    fns = {**ttpch.QUERIES, **ttpch.LOOKUP_QUERIES, **ttpch.JOIN_QUERIES}
    off = {q: _bits(fns[q](s, lake).collect()) for q in MIX}
    s.kernel_cache.clear()
    prev = (TCC.set_audit(True), TLC.set_audit(True))
    monkeypatch.setenv("HYPERSPACE_VERIFY_PLAN", "1")
    monkeypatch.setenv("HYPERSPACE_KERNEL_AUDIT", "1")
    a0, r0 = _val("staticcheck.kernel.audited"), _val("staticcheck.plan.runs")
    try:
        for _run in range(2):  # the audited first calls, then warm
            on = {q: _bits(fns[q](s, lake).collect()) for q in MIX}
            assert on == off
        TLC.check_quiescent()
    finally:
        TCC.set_audit(prev[0])
        TLC.set_audit(prev[1])
    assert _val("staticcheck.kernel.audited") > a0
    assert _val("staticcheck.plan.runs") >= r0 + 2 * len(MIX)
