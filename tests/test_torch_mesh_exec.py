"""The mesh tier end to end: the port's query paths over a mesh against the
JAX package's, and against the port with the mesh off.

The JAX side runs on the 8 host devices tests/conftest.py makes XLA fake,
the port's on ``virtual_devices(8, "cpu")``. Over one JAX-built TPC-H lake
(20,000 lineitem rows, seed 3, the JAX package's index set):

- with ``meshDevices`` = 8 (the mesh route: fragments shard their rows,
  the plain join probes one bucket per shard), every query of the JAX
  package's TPCH_QUERIES and the kernel-shaped q6_count, q6_sum and
  q1_sums equals the JAX package's under the same conf, and the port's
  with the mesh off (counts and integers exact, f32 sums within relative
  1e-4); the fragments took the mesh route (``mesh_fragments``) and q10
  the mesh join;
- with ``HYPERSPACE_MESH=1`` (placement only: join band waves and
  partial-route chunks spread over the devices), every result equals the
  port's with the mesh off bit for bit, and the JAX package's under the
  same knob within the tolerance; waves and chunks were placed.

Over a skewed lake (40% of the left rows on one key, 8 buckets), the plain
and the fused join are bit for bit the mesh-off results with the work
spread over at least 4 devices and an imbalance below 2, as the JAX
package's own test asks.

Also: ``mesh_join_probe`` equals the JAX package's on random waves; the
per-device ledgers are named, isolated and conserved as the JAX package's
(a full device parks its own wave, never a neighbour's); the scheduler's
home device and the snapshot's ``devices`` block equal the JAX package's;
the mesh tier's lock and guarded names are the JAX package's.
"""

import os
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.parallel import dist_join as jdj
from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan.join_memory import DeviceLedger as JLedger
from hyperspace_tpu.serve import budget as jbudget
from hyperspace_tpu.serve import scheduler as jsched
from hyperspace_tpu.staticcheck import concurrency as jcc
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.parallel import dist_join as tdj
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan.join_memory import DeviceLedger as TLedger
from hyperspace_tpu_torch.serve import budget as tbudget
from hyperspace_tpu_torch.serve import scheduler as tsched
from hyperspace_tpu_torch.staticcheck import concurrency as tcc
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG

REL = 1e-4
ROWS = 20_000
MB = 2**20


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """Keep the JAX package's process-wide query ledger from filling up
    for the test files a worker runs after this one."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture
def vdev():
    with tmesh.virtual_devices(8, "cpu") as devices:
        yield devices


def _bits(d: dict) -> str:
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


def _assert_close(got: dict, want: dict, what) -> None:
    assert list(got) == list(want), what
    for name in want:
        g, w = got[name], want[name]
        assert len(g) == len(w), (what, name)
        for a, b in zip(g, w):
            if isinstance(b, float) and not isinstance(a, bool):
                assert a == pytest.approx(b, rel=REL), (what, name)
            else:
                assert a == b, (what, name)


def _kernel_shaped(X):
    """q6_count, q6_sum and q1_sums, written with one package's operators
    (the JAX package has none of them), and the partial route's q6_span and
    q1_span."""

    def li(s, root):
        return s.read.parquet(os.path.join(root, "lineitem"))

    def q6_pred():
        return ((X.col("l_shipdate") >= 8766) & (X.col("l_shipdate") < 9131)
                & (X.col("l_discount") >= 0.05) & (X.col("l_discount") <= 0.07)
                & (X.col("l_quantity") < 24))

    return {
        "q6_count": lambda s, r: li(s, r).filter(q6_pred()).agg(
            X.Sum(X.col("l_extendedprice") * X.col("l_discount")).alias("revenue"),
            X.Count(X.lit(1)).alias("count")),
        "q6_sum": lambda s, r: li(s, r).filter(q6_pred()).agg(
            X.Sum(X.col("l_extendedprice")).alias("sum_price"),
            X.Count(X.lit(1)).alias("count")),
        "q1_sums": lambda s, r: li(s, r).filter(X.col("l_shipdate") <= 10470).select(
            "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
        ).group_by("l_returnflag", "l_linestatus").agg(
            X.Sum(X.col("l_quantity")).alias("sum_qty"),
            X.Sum(X.col("l_extendedprice")).alias("sum_base_price"),
            X.Sum(X.col("l_extendedprice") * (X.lit(1.0) - X.col("l_discount"))).alias(
                "sum_disc_price"),
            X.Count(X.lit(1)).alias("count_order"),
        ).sort("l_returnflag", "l_linestatus"),
        "q6_span": lambda s, r: li(s, r).filter(q6_pred()).agg(
            X.Count(X.lit(1)).alias("count"),
            X.Min(X.col("l_shipdate")).alias("first_ship"),
            X.Max(X.col("l_shipdate")).alias("last_ship")),
        "q1_span": lambda s, r: li(s, r).filter(X.col("l_shipdate") <= 10470).group_by(
            "l_returnflag", "l_linestatus").agg(
            X.Count(X.lit(1)).alias("count_order"),
            X.Min(X.col("l_shipdate")).alias("first_ship"),
            X.Max(X.col("l_shipdate")).alias("last_ship"),
        ).sort("l_returnflag", "l_linestatus"),
    }


JQ = {**jtpch.TPCH_QUERIES, **_kernel_shaped(JX)}
TQ = {**ttpch.TPCH_QUERIES, **_kernel_shaped(TX)}
MESH_QUERIES = ("q1", "q3", "q6", "q10", "q17", "q18", "q6_count", "q6_sum", "q1_sums")
PLACED_QUERIES = MESH_QUERIES + ("q6_span", "q1_span")


@pytest.fixture(scope="module")
def tpch_lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_tpch"))
    lake = os.path.join(root, "lake")
    jtpch.generate_tpch(lake, rows_lineitem=ROWS, seed=3)
    wh = os.path.join(root, "wh")
    s = J.HyperspaceSession(wh, conf={JC.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION: 64 * 1024})
    jtpch.tpch_indexes(s, J.Hyperspace(s), lake)
    return lake, wh


def _runs(lake, wh, monkeypatch, mesh_devices: int, knob: str) -> dict:
    """name -> (JAX result, port result, port result with the mesh off, port stats)."""
    monkeypatch.setenv("HYPERSPACE_MESH", knob)
    jconf = {JC.EXEC_TPU_ENABLED: True, JC.EXEC_MESH_DEVICES: mesh_devices}
    js = J.HyperspaceSession(wh, conf=jconf).enable_hyperspace()
    ts = T.HyperspaceSession(wh, device="cpu",
                             conf={TC.EXEC_MESH_DEVICES: mesh_devices}).enable_hyperspace()
    queries = MESH_QUERIES if mesh_devices else PLACED_QUERIES
    out = {q: [JQ[q](js, lake).collect().to_pydict(), TQ[q](ts, lake).collect().to_pydict()]
           for q in queries}
    monkeypatch.setenv("HYPERSPACE_MESH", "0")
    off = T.HyperspaceSession(wh, device="cpu").enable_hyperspace()
    for q in queries:
        out[q].append(TQ[q](off, lake).collect().to_pydict())
    return out, ts.device_stats


def test_mesh_route_equals_the_jax_package_and_the_mesh_off_port(vdev, tpch_lake,
                                                                  monkeypatch):
    lake, wh = tpch_lake
    runs, stats = _runs(lake, wh, monkeypatch, 8, "0")
    for q, (want, got, off) in runs.items():
        _assert_close(got, want, q)
        _assert_close(got, off, q)
    # the filter-aggregate fragments (q1, q6 and their forms, q17's and
    # q18's aggregates) ran on the mesh; q10's plain join probed on it
    assert stats.mesh_fragments >= 6
    assert stats.mesh_joins >= 1 and stats.join_paths.get("mesh", 0) >= 1
    assert stats.pipelined_queries == 0  # an active mesh takes the whole batch


def test_placement_is_bit_for_bit_the_mesh_off_port(vdev, tpch_lake, monkeypatch):
    lake, wh = tpch_lake
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.001")  # partial routes stream
    buckets0 = TREG.counter("mesh.placement.buckets").value
    runs, stats = _runs(lake, wh, monkeypatch, 0, "1")
    for q, (want, got, off) in runs.items():
        assert _bits(got) == _bits(off), q
        _assert_close(got, want, q)
    assert TREG.counter("mesh.placement.buckets").value > buckets0
    assert len(stats.placed_waves) >= 2 and len(stats.placed_chunks) >= 2
    assert stats.mesh_fragments == 0 and stats.mesh_joins == 0


# ---------------------------------------------------------------------------
# a skewed co-bucketed join
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def skew_lake(tmp_path_factory):
    """40% of the left rows on ONE key over 8 buckets: one-bucket-per-device
    placement would pin one device; the fair-share split must spread it."""
    root = tmp_path_factory.mktemp("mesh_skew")
    rng = np.random.default_rng(101)
    n = 24_000
    k = rng.integers(0, 400, n)
    k[: int(n * 0.4)] = 7
    os.makedirs(root / "l")
    os.makedirs(root / "r")
    pq.write_table(pa.table({"k": k, "p": rng.uniform(0, 100, n)}), str(root / "l" / "l.parquet"))
    pq.write_table(pa.table({"rk": np.arange(200), "w": rng.uniform(size=200)}),
                   str(root / "r" / "r.parquet"))
    s = T.HyperspaceSession(str(root / "wh"), device="cpu", conf={TC.INDEX_NUM_BUCKETS: 8})
    hs = T.Hyperspace(s)
    hs.create_index(s.read.parquet(str(root / "l")), T.CoveringIndexConfig("jl", ["k"], ["p"]))
    hs.create_index(s.read.parquet(str(root / "r")), T.CoveringIndexConfig("jr", ["rk"], ["w"]))
    return root


def _skew_queries(s, root):
    lt = s.read.parquet(str(root / "l")).select("k", "p")
    rt = s.read.parquet(str(root / "r")).select("rk", "w")
    joined = lt.join(rt, TX.col("k") == TX.col("rk"))
    return {
        "plain": joined.select("k", "p", "w"),
        "agg": joined.group_by("k").agg(
            TX.Sum(TX.col("p")).alias("s"), TX.Count(TX.col("p")).alias("c"),
            TX.Min(TX.col("w")).alias("mn"), TX.Max(TX.col("w")).alias("mx")),
    }


@pytest.mark.parametrize("q", ["plain", "agg"])
def test_skewed_join_placement_is_bit_for_bit_and_balanced(vdev, skew_lake, monkeypatch, q):
    def run(knob):
        monkeypatch.setenv("HYPERSPACE_MESH", knob)
        s = T.HyperspaceSession(str(skew_lake / "wh"), device="cpu").enable_hyperspace()
        return _bits(_skew_queries(s, skew_lake)[q].collect().to_pydict()), s.device_stats

    usage0 = TREG.counter("rules.usage.MeshBucketedExec").value
    off, _ = run("0")
    on, stats = run("1")
    assert on == off
    assert len(stats.placed_waves) >= 4
    assert TREG.gauge("mesh.placement.devices_used").value >= 4
    assert TREG.gauge("mesh.placement.bytes_imbalance_ratio").value < 2.0
    assert TREG.counter("rules.usage.MeshBucketedExec").value > usage0


# ---------------------------------------------------------------------------
# the mesh join probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_mesh_join_probe_equals_the_jax_packages(vdev, dtype):
    rng = np.random.default_rng(13)
    S, pad_l, pad_r = 8, 1024, 1024
    pad_val = np.iinfo(dtype).max if np.dtype(dtype).kind == "i" else np.float32(np.inf)
    lk = np.full((S, pad_l), pad_val, dtype=dtype)
    rk = np.full((S, pad_r), pad_val, dtype=dtype)
    n_r = np.zeros(S, np.int64)
    for i in range(S):
        nl, nr = int(rng.integers(0, pad_l)), int(rng.integers(0, pad_r))
        lk[i, :nl] = np.sort(rng.integers(0, 300, nl)).astype(dtype)
        rk[i, :nr] = np.sort(rng.integers(0, 300, nr)).astype(dtype)
        n_r[i] = nr
    want = jdj.mesh_join_probe(jmesh.device_mesh(8), lk, rk, n_r)
    got = tdj.mesh_join_probe(tmesh.device_mesh(8), lk, rk, n_r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and (g == w).all()
    assert len(tdj._PROBE_CACHE._d) > 0


# ---------------------------------------------------------------------------
# per-device ledgers, the home device, the snapshot's devices block
# ---------------------------------------------------------------------------

@pytest.fixture
def small_device_budget(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_DEVICE_BUDGET_MB", "1")
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()
    yield MB
    monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()


def _ledger_story(budget_mod, Ledger, reg, budget: int) -> dict:
    """Admissions and releases on three ordinals, a full device's park and
    spill, and what each ledger held at each step."""
    seen: dict = {"names": {o: budget_mod.device_budget(o).name for o in (0, 3)}}
    a0, a3 = budget_mod.device_budget(), budget_mod.device_budget(3)
    seen["isolated"] = (a0 is budget_mod.device_budget(0), a3 is not a0,
                        sorted(budget_mod.device_budgets()))
    ledger = Ledger("t-story")
    spilled = []

    def spill_one():
        if spilled:
            return False
        spilled.append(True)
        ledger.release(budget - 1024, device=1)
        return True

    held = lambda: {o: a.held_bytes() for o, a in sorted(budget_mod.device_budgets().items())}  # noqa: E731
    try:
        ledger.admit(300_000, lambda: False, device=1)
        ledger.admit(400_000, lambda: False, device=2)
        ledger.admit(200_000, lambda: False, device=1)
        seen["held_1"] = held()
        ledger.release(300_000, device=1)
        ledger.release(400_000, device=2)
        ledger.release(200_000, device=1)
        seen["held_2"] = held()
        ledger.admit(budget - 1024, spill_one, device=1)  # fills d1
        parks0 = reg.counter("join.spill.parks").value
        ledger.admit(budget // 2, lambda: False, device=2)  # a neighbour never parks
        seen["neighbour_parks"] = reg.counter("join.spill.parks").value - parks0
        ledger.admit(budget // 2, spill_one, device=1)  # d1 parks, spills, resumes
        seen["d1_parks"] = reg.counter("join.spill.parks").value - parks0
        seen["held_3"] = held()
        seen["snapshot_devices"] = {
            k: {f: v[f] for f in ("held_bytes", "limit_bytes")}
            for k, v in (jsched if budget_mod is jbudget else tsched)
            ._device_budget_state()["devices"].items()}
        ledger.release(budget // 2, device=1)
        ledger.release(budget // 2, device=2)
    finally:
        ledger.close()
    seen["held_end"] = held()
    seen["consistent"] = all(a.check_consistency() for a in budget_mod.device_budgets().values())
    budget_mod.device_budget(5)
    seen["before_reset"] = sorted(budget_mod.device_budgets())
    budget_mod.reset_device_budget()
    seen["after_reset"] = sorted(budget_mod.device_budgets())
    return seen


def test_per_device_ledgers_equal_the_jax_packages(small_device_budget):
    want = _ledger_story(jbudget, JLedger, JREG, small_device_budget)
    got = _ledger_story(tbudget, TLedger, TREG, small_device_budget)
    assert got == want
    assert got["names"] == {0: "serve.device_budget", 3: "serve.device_budget.d3"}
    assert got["neighbour_parks"] == 0 and got["d1_parks"] == 1
    assert all(v == 0 for v in got["held_end"].values()) and got["consistent"]


def _fake_active(homes, tenant="default") -> dict:
    return {i: types.SimpleNamespace(ctx=types.SimpleNamespace(device_home=h, tenant=tenant))
            for i, h in enumerate(homes)}


@pytest.mark.parametrize("knob", ["0", "1"])
def test_home_device_equals_the_jax_packages(vdev, monkeypatch, knob):
    monkeypatch.setenv("HYPERSPACE_MESH", knob)
    out = {}
    for name, mod in (("jax", jsched), ("torch", tsched)):
        sched = mod.QueryScheduler(max_concurrent=2, queue_depth=8)
        try:
            homes = [sched._home_device_locked()]
            for active in ([0, 0, 1, 3], list(range(8)), [None, 2, 2, 9]):
                sched._active = _fake_active(active)
                homes.append(sched._home_device_locked())
        finally:
            sched._active = {}
            sched.shutdown(wait=True)
        out[name] = homes
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([None] * 4 if knob == "0" else [0, 2, 0, 0])


def test_served_query_gets_a_home_device(vdev, tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_MESH", "1")
    pq.write_table(pa.table({"a": [1, 2, 3]}), str(tmp_path / "t.parquet"))
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    sched = T.serve.QueryScheduler(max_concurrent=1, queue_depth=4)
    try:
        h = sched.submit_query(s.read.parquet(str(tmp_path / "t.parquet")).select("a"),
                               label="home-probe")
        h.result(timeout=60)
        assert h.ctx.device_home is not None and 0 <= h.ctx.device_home < 8
    finally:
        sched.shutdown(wait=True)


def test_mesh_lock_and_guard_names_are_the_jax_packages(small_device_budget):
    jbudget.device_budget(2)
    tbudget.device_budget(2)
    names = ("kernel_cache.kernel_mesh", "serve.device_budget.d2", "serve.budget_singleton")
    jl, tl = set(jcc.registered_locks()), set(tcc.registered_locks())
    for n in names:
        assert n in jl and n in tl, n
    jg = {g.name for g in jcc.guarded_state()}
    tg = {g.name for g in tcc.guarded_state()}
    assert "serve.budget._DEVICES" in jg and "serve.budget._DEVICES" in tg
    assert "serve.budget._DEVICE" not in tg
