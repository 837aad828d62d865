"""The port's join strategy plan and memory-adaptive join execution
(hyperspace_tpu_torch/plan/join_memory.py) held against the JAX package's
(tests/test_join_adaptive.py's cases) on the same numpy-seeded inputs.

- Strategies from planted footer statistics (broadcast, banded, split),
  the grant-derived split row count, the ``HYPERSPACE_JOIN_SPLIT_ROWS``
  override and a disabled ledger: the port's plan equals the JAX
  package's, bucket by bucket. ``derive_split_rows`` and
  ``classify_bucket`` equal the reference's over a grid.
- The band scheduler parks a wave that does not fit and spills the one in
  flight first; waves that fit never park.
- End to end over a skewed co-bucketed lake: the plans both packages make
  at the default grant, at a small grant and under the override are equal;
  an over-budget plain and fused join completes, parks, spills, drains
  the ledger and gives the default grant's bits; ``HYPERSPACE_PIPELINE`` 0
  against serial against 1 gives the same bits.
"""

import os
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import join_memory as jjm
from hyperspace_tpu.serve import budget as jbudget
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import join_memory as tjm
from hyperspace_tpu_torch.serve import budget as tbudget


def hex_rows(d: dict) -> str:
    """Bit-exact rendering: floats as hex."""
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


def _set_grant(monkeypatch, mb: str):
    """Both packages' device ledgers at ``mb`` MiB; returns the port's."""
    monkeypatch.setenv("HYPERSPACE_DEVICE_BUDGET_MB", mb)
    jbudget.reset_device_budget()
    return tbudget.reset_device_budget()


@pytest.fixture(autouse=True)
def _fresh_ledgers(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_JOIN_SPLIT_ROWS", raising=False)
    monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
    monkeypatch.setenv("HYPERSPACE_PARK_WAIT_MS", "1")
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()
    yield
    monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()


# ---------------------------------------------------------------------------
# strategies from planted footer stats
# ---------------------------------------------------------------------------

class _FakeSide:
    """A side the planner reads: ``spec.num_buckets`` and
    ``files_for_bucket`` (objects with ``name`` and ``size``)."""

    def __init__(self, files_by_bucket: dict, num_buckets: int):
        self._files = files_by_bucket
        self.spec = types.SimpleNamespace(num_buckets=num_buckets)

    def files_for_bucket(self, b):
        return self._files.get(b, [])


def _plant(tmp_path, name: str, rows: int, row_group: int = 1 << 20):
    path = str(tmp_path / "planted" / f"{name}.parquet")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(rows)
    pq.write_table(pa.table({"k": rng.integers(0, 1000, rows),
                             "p": rng.uniform(size=rows)}), path, row_group_size=row_group)
    return types.SimpleNamespace(name=path, size=os.path.getsize(path))


def _planted_sides(tmp_path):
    """Bucket 0 tiny, 1 mid, 2 large, 3 two runs (a refreshed bucket, its
    estimate over both files and several row groups), 4 empty on the
    right, 5 absent on the left."""
    left = _FakeSide({0: [_plant(tmp_path, "l0", 50)], 1: [_plant(tmp_path, "l1", 2000)],
                      2: [_plant(tmp_path, "l2", 6000)],
                      3: [_plant(tmp_path, "l3a", 3000, 700), _plant(tmp_path, "l3b", 2500)],
                      4: [_plant(tmp_path, "l4", 900)]}, num_buckets=6)
    right = _FakeSide({0: [_plant(tmp_path, "r0", 40)], 1: [_plant(tmp_path, "r1", 500)],
                       2: [_plant(tmp_path, "r2", 500)], 3: [_plant(tmp_path, "r3", 300)],
                       5: [_plant(tmp_path, "r5", 300)]}, num_buckets=6)
    return left, right


def _plan_fields(plan) -> dict:
    return {"strategies": plan.strategies, "split_rows": plan.split_rows_by_bucket,
            "grant": plan.grant, "derived": plan.derived_split_rows,
            "override": plan.override_split_rows,
            "per_bucket": {b: (plan.strategy(b), plan.split_rows(b)) for b in range(7)}}


@pytest.mark.parametrize("grant,override,broadcast", [
    ("1", None, "100"), ("4096", None, None), ("0.5", None, None), ("64", "10000", "100"),
    ("1", "0", "100"), ("1", "3000", None), ("1", "junk", "junk"),
])
def test_strategies_from_planted_footer_stats_match_jax(tmp_path, monkeypatch, grant,
                                                        override, broadcast):
    for name, val in (("HYPERSPACE_JOIN_SPLIT_ROWS", override),
                      ("HYPERSPACE_JOIN_BROADCAST_ROWS", broadcast)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    _set_grant(monkeypatch, grant)
    left, right = _planted_sides(tmp_path)
    tplan = tjm.plan_join_memory(left, right, session=None)
    jplan = jjm.plan_join_memory(left, right, session=None)
    assert _plan_fields(tplan) == _plan_fields(jplan)
    assert tplan.counts() == jplan.counts()
    assert tplan.estimates == jplan.estimates
    assert set(tplan.strategies) == {0, 1, 2, 3}  # empty pairs are not planned


def test_planted_strategies_at_a_one_mb_grant(tmp_path, monkeypatch):
    """Tiny pair -> broadcast, mid -> banded, oversized left -> split, at
    the 4096-row floor a 1 MiB grant derives."""
    monkeypatch.setenv("HYPERSPACE_JOIN_BROADCAST_ROWS", "100")
    _set_grant(monkeypatch, "1")
    left, right = _planted_sides(tmp_path)
    plan = tjm.plan_join_memory(left, right, session=None)
    assert [plan.strategy(b) for b in range(4)] == ["broadcast", "banded", "split", "split"]
    assert plan.derived_split_rows == tjm._SPLIT_ROWS_FLOOR
    assert plan.split_rows(0) == 0 and plan.split_rows(2) == plan.derived_split_rows
    assert plan.estimates[3][0] == 5500  # both runs of the refreshed bucket
    assert plan.summary()["split"] == 2


def test_explicit_knob_overrides_grant(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_JOIN_BROADCAST_ROWS", "100")
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "10000")
    _set_grant(monkeypatch, "1")
    left = _FakeSide({0: [_plant(tmp_path, "lo", 6000)]}, num_buckets=1)
    right = _FakeSide({0: [_plant(tmp_path, "ro", 500)]}, num_buckets=1)
    plan = tjm.plan_join_memory(left, right, session=None)
    assert plan.override_split_rows == 10000
    assert plan.strategy(0) == "banded" and plan.split_rows(0) == 10000
    assert tjm.split_rows_override() == jjm.split_rows_override() == 10000


def test_disabled_ledger_disables_planning(tmp_path, monkeypatch):
    _set_grant(monkeypatch, "0")
    left = _FakeSide({0: [_plant(tmp_path, "ld", 50)]}, num_buckets=1)
    assert tjm.plan_join_memory(left, left, session=None) is None
    assert jjm.plan_join_memory(left, left, session=None) is None
    assert tjm.grant_bytes() == 0


def test_derive_split_rows_shape_matches_jax():
    assert tjm.derive_split_rows(0, 16.0) == 0
    small = tjm.derive_split_rows(1 << 20, 16.0)
    big = tjm.derive_split_rows(1 << 30, 16.0)
    assert small == tjm._SPLIT_ROWS_FLOOR and big > small and big & (big - 1) == 0
    assert tjm.derive_split_rows(1 << 40, 1.0) == tjm._SPLIT_ROWS_CEIL
    for grant in (0, 1, 1 << 20, 3 << 26, 1 << 30, 4 << 30, 1 << 40):
        for row_bytes in (0.5, 1.0, 7.3, 16.0, 40.0, 1e6):
            for wave in (1, 8, 13):
                assert (tjm.derive_split_rows(grant, row_bytes, wave)
                        == jjm.derive_split_rows(grant, row_bytes, wave))
    for est_l in (0, 10, 4096, 4097, 70_000):
        for est_r in (0, 4096, 5000):
            for split in (0, 4096, 65536):
                assert (tjm.classify_bucket(est_l, est_r, split, 4096)
                        == jjm.classify_bucket(est_l, est_r, split, 4096))


# ---------------------------------------------------------------------------
# park / spill on the band scheduler
# ---------------------------------------------------------------------------

def test_second_wave_parks_and_spills_the_first(monkeypatch):
    acct = _set_grant(monkeypatch, str(150 / 2**20))  # a 150-byte grant
    events = []
    ledger = tjm.DeviceLedger("join")
    try:
        sched = tdj._BandScheduler(
            lambda pads, items: events.append(("dispatch", tuple(items))) or f"rec-{items[0]}",
            ledger, lambda pads, items: 100,
            lambda w: events.append(("spill", tuple(w.items))) or f"done-{w.items[0]}",
            banded=True, wave=1,
        )
        sched.add("a", 10, 10)  # fits: 100 <= 150
        sched.add("b", 10, 10)  # parks, spills wave a, resumes
        waves = sched.finish()
        assert ledger.parks == 1 and sched.spills == 1
        sched.release_reservations()
    finally:
        ledger.close()
    assert events == [("dispatch", ("a",)), ("spill", ("a",)), ("dispatch", ("b",))]
    assert [w.done for w in waves] == ["done-a", None]
    assert acct.held_bytes() == 0


def test_fitting_waves_never_park_and_one_wave_when_unbanded(monkeypatch):
    _set_grant(monkeypatch, "64")
    ledger = tjm.DeviceLedger("join")
    try:
        sched = tdj._BandScheduler(lambda pads, items: "rec", ledger, lambda p, i: 100,
                                   lambda w: pytest.fail("must not spill under budget"),
                                   banded=True, wave=1)
        for item in ("a", "b", "c"):
            sched.add(item, 10, 10)
        assert len(sched.finish()) == 3 and ledger.parks == 0
        flat = tdj._BandScheduler(lambda pads, items: pads, ledger, lambda p, i: 100,
                                  lambda w: None, banded=False)
        for item, n_l in (("a", 10), ("b", 5000), ("c", 3)):
            flat.add(item, n_l, 2000)
        (wave,) = flat.finish()  # ONE wave at the global pads
        assert wave.items == ["a", "b", "c"] and wave.rec == (8192, 2048)
    finally:
        ledger.close()


# ---------------------------------------------------------------------------
# end to end over a skewed co-bucketed lake
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def skew_lake(tmp_path_factory):
    """40% of the left rows on one hot key (one bucket dwarfs the rest),
    right keys only below 200, so some buckets join to nothing; both
    packages' indexes (4 buckets) in their own warehouses."""
    root = tmp_path_factory.mktemp("join_memory")
    rng = np.random.default_rng(101)
    n = 24_000
    k = rng.integers(0, 400, n)
    k[: int(n * 0.4)] = 7
    for side, table in (("l", {"k": k, "p": rng.uniform(0, 100, n)}),
                        ("r", {"rk": np.arange(200), "w": rng.uniform(size=200)})):
        os.makedirs(root / side)
        pq.write_table(pa.table(table), str(root / side / f"{side}.parquet"))
    for pkg, wh, kw in ((J, "wj", {}), (T, "wt", {"device": "cpu"})):
        session = pkg.HyperspaceSession(str(root / wh), **kw)
        session.set_conf(JC.INDEX_NUM_BUCKETS, 4)
        hs = pkg.Hyperspace(session)
        hs.create_index(session.read.parquet(str(root / "l")),
                        pkg.CoveringIndexConfig("jl", ["k"], ["p"]))
        hs.create_index(session.read.parquet(str(root / "r")),
                        pkg.CoveringIndexConfig("jr", ["rk"], ["w"]))
    return root


def _query(M, session, root, kind: str):
    left = session.read.parquet(str(root / "l")).select("k", "p")
    right = session.read.parquet(str(root / "r")).select("rk", "w")
    joined = left.join(right, M.col("k") == M.col("rk"))
    if kind == "plain":
        return joined.select("k", "p", "w")
    if kind == "sum":
        return joined.group_by("k").agg(M.Sum(M.col("p")).alias("s"))
    return joined.group_by("k").agg(M.Count(M.lit(1)).alias("n"), M.Min(M.col("p")).alias("lo"),
                                    M.Max(M.col("p")).alias("hi"))


def _run_port(root, kind: str):
    session = T.HyperspaceSession(str(root / "wt"), device="cpu").enable_hyperspace()
    return _query(TX, session, root, kind).to_pydict(), session.device_stats


def _run_jax(root, kind: str):
    session = J.HyperspaceSession(str(root / "wj"), conf={JC.EXEC_TPU_ENABLED: True})
    return _query(JX, session.enable_hyperspace(), root, kind).to_pydict()


@pytest.mark.parametrize("grant,override", [("4096", None), ("1", None), ("4096", "1024"),
                                            ("0.05", "2048")])
@pytest.mark.parametrize("kind", ["plain", "span"])
def test_end_to_end_plans_match_jax(skew_lake, monkeypatch, grant, override, kind):
    if override is not None:
        monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", override)
    _set_grant(monkeypatch, grant)
    plans = {"jax": [], "torch": []}
    for mod, key in ((jjm, "jax"), (tjm, "torch")):
        orig = mod.plan_join_memory

        def spy(left, right, session, orig=orig, key=key):
            plan = orig(left, right, session)
            plans[key].append(plan)
            return plan

        monkeypatch.setattr(mod, "plan_join_memory", spy)
    want = _run_jax(skew_lake, kind)
    got, stats = _run_port(skew_lake, kind)
    assert hex_rows(got) == hex_rows(want) if kind == "plain" else got == want
    (jplan,), (tplan,) = plans["jax"], plans["torch"]
    assert _plan_fields(tplan) == _plan_fields(jplan)
    assert list(stats.join_plans) == [tplan.summary()]
    assert stats.join_strategies == {s: c for s, c in tplan.counts().items() if c}
    assert len(tplan.strategies) == 4


@pytest.mark.parametrize("kind", ["plain", "span", "sum"])
def test_over_budget_join_completes_parks_spills_and_drains(skew_lake, monkeypatch, kind):
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "1024")  # several waves
    _set_grant(monkeypatch, "4096")
    ref, ref_stats = _run_port(skew_lake, kind)
    assert ref_stats.join_parks == 0 and ref_stats.join_spills == 0
    acct = _set_grant(monkeypatch, "0.01")
    got, stats = _run_port(skew_lake, kind)
    assert hex_rows(got) == hex_rows(ref)
    assert stats.join_parks > 0 and stats.join_spills > 0
    assert acct.held_bytes() == 0  # every reservation came back
    path = "batched" if kind == "plain" else "stacked_agg"
    assert stats.join_paths == {path: 1} and not stats.declines


@pytest.mark.parametrize("kind", ["plain", "span", "sum"])
def test_pipeline_modes_give_the_same_bits(skew_lake, monkeypatch, kind):
    """0 (barrier, one global wave, unsplit) against serial and 1 (streamed,
    banded, split at the override), at a small grant that spills."""
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "1024")
    _set_grant(monkeypatch, "0.05")
    out = {}
    for mode in ("0", "serial", "1"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        out[mode], stats = _run_port(skew_lake, kind)
        assert not stats.declines
        if mode == "0":
            assert stats.join_waves == 1 and stats.join_splits == 0
        else:
            assert stats.join_waves > 1
            assert (stats.join_splits > 0) == (kind != "sum")  # sums never split
    assert hex_rows(out["serial"]) == hex_rows(out["0"]) == hex_rows(out["1"])
