"""The port's plain co-bucketed join, AggregateIndexRule and TPC-H Q10, Q17
and Q18 held against the JAX package on the same numpy-seeded inputs.

- The three plain-join bodies (hyperspace_tpu_torch/plan/device_join.py
  ``_build_plain_probe_kernel``, ``_build_stacked_probe_kernel``,
  ``_build_stacked_expand_kernel``) against the JAX package's on the CPU,
  exactly: duplicate keys on both sides, empty runs at the start, middle
  and end, disjoint keys, pads, INT32_MAX keys, a split bucket, and a
  bucket whose pair count reaches 2^31.
- ``try_batched_plain_join`` and ``try_device_plain_join`` against the JAX
  ones, exactly and in row order; an over-budget device ledger parks and
  spills and gives the same rows.
- The declines: f64 and string keys, fewer than 4096 rows, int32 overflow
  of the pair count, a skewed expansion.
- AggregateIndexRule: the optimized plans of q10, q17 and q18 render as the
  JAX package's on the same lake, and the bucketed scan aggregate gives
  the JAX package's groups.
- q10, q17 and q18 end to end in both packages with the device tier on
  (the port's on the CPU): the same results, f32-accumulated aggregates
  within relative 1e-4, and the reference's routes.
- The host string comparisons the side filters run (by the ranks of the
  dictionary entries) equal the JAX package's.
- The streamed and banded plain join over a skewed co-bucketed lake: pairs
  stream into the probe under ``HYPERSPACE_PIPELINE`` 1 and serial (a
  barrier list under 0), a set ``HYPERSPACE_JOIN_SPLIT_ROWS`` splits as
  often as the JAX package splits and dispatches as many band waves, the
  rows are the JAX package's in its order under every mode, and empty and
  disjoint buckets give the JAX package's rows and path.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import jax.numpy as jnp

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.plan import bucket_join as jbj
from hyperspace_tpu.plan import device_join as jdj
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.plan import bucket_join as tbj
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.serve import budget as tbudget

import torch

REL = 1e-4
I32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# (a) the three bodies
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(10, int(np.ceil(np.log2(max(1, n)))))


def _padded(a, pad, fill):
    out = np.full(pad, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _key_cases():
    """(left keys, right keys) per case, both sorted int32."""
    rng = np.random.default_rng(3)
    dup = (np.sort(rng.integers(0, 300, 2000)), np.sort(rng.integers(0, 300, 900)))
    # left keys below, between and above the right keys: empty runs at the
    # start, in the middle and at the end of the bucket
    runs = (np.array([1, 2, 5, 5, 7, 9, 9, 12, 40, 41]), np.array([5, 5, 5, 9, 12, 12]))
    disjoint = (np.arange(0, 500, 2), np.arange(1, 501, 2))
    i32max = (np.array([3, 8, I32_MAX - 1, I32_MAX, I32_MAX]),
              np.array([3, 3, I32_MAX, I32_MAX]))
    empty_left_runs = (np.array([0, 0, 1]), np.array([5, 6]))
    return {
        "dup_both_sides": dup,
        "empty_runs": runs,
        "disjoint": disjoint,
        "int32_max_keys": i32max,
        "no_match": empty_left_runs,
    }


def _i32(a):
    return np.asarray(a, dtype=np.int32)


@pytest.mark.parametrize("case", sorted(_key_cases()))
def test_plain_probe_matches_jax(case):
    lk, rk = (_i32(a) for a in _key_cases()[case])
    pad_l, pad_r = _pow2(len(lk)), _pow2(len(rk))
    lk_p, rk_p = _padded(lk, pad_l, I32_MAX), _padded(rk, pad_r, I32_MAX)
    jlo, jcnt = jdj._build_plain_probe_kernel()(jnp.asarray(lk_p), jnp.asarray(rk_p),
                                                jnp.int32(len(rk)))
    tlo, tcnt = tdj._build_plain_probe_kernel()(torch.from_numpy(lk_p),
                                                torch.from_numpy(rk_p), len(rk))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tlo.dtype == tcnt.dtype == torch.int32


def _stacked_inputs(cases, split: int = 0):
    """One band wave: every case as an item (chunks of ``split`` left rows
    when set), stacked at the wave's pads."""
    items = []
    for c in cases:
        lk, rk = (_i32(a) for a in _key_cases()[c])
        if split:
            items += [(lk[i:i + split], rk) for i in range(0, len(lk), split)]
        else:
            items.append((lk, rk))
    pad_l = _pow2(max(len(lk) for lk, _ in items))
    pad_r = _pow2(max(len(rk) for _, rk in items))
    lk = np.stack([_padded(a, pad_l, I32_MAX) for a, _ in items])
    rk = np.stack([_padded(b, pad_r, I32_MAX) for _, b in items])
    n_l = np.array([len(a) for a, _ in items], np.int32)
    n_r = np.array([len(b) for _, b in items], np.int32)
    return lk, rk, n_r, n_l, pad_l, pad_r


@pytest.mark.parametrize("split", [0, 3, 700])
def test_stacked_probe_and_expansion_match_jax(split):
    cases = sorted(_key_cases())
    lk, rk, n_r, n_l, pad_l, pad_r = _stacked_inputs(cases, split)
    jlo, joffs, jtot, jok = jdj._build_stacked_probe_kernel(pad_l, pad_r)(
        jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(n_r), jnp.asarray(n_l))
    tlo, toffs, ttot, tok = tdj._build_stacked_probe_kernel()(
        torch.from_numpy(lk), torch.from_numpy(rk), torch.from_numpy(n_r),
        torch.from_numpy(n_l))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(toffs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert bool(tok.all())
    totals = ttot.numpy()
    out_pad = tdj._pow2(int(totals.max()))
    jli, jri = jdj._build_stacked_expand_kernel(out_pad)(jlo, joffs, jnp.asarray(totals))
    tli, tri = tdj._build_stacked_expand_kernel(out_pad)(tlo, toffs, ttot)
    np.testing.assert_array_equal(tli.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jri))
    # and the pairs are the host merge join's
    from hyperspace_tpu_torch.ops.join import host_merge_join_indices

    for i in range(len(n_l)):
        li, ri = host_merge_join_indices(lk[i, :n_l[i]], rk[i, :n_r[i]])
        t = int(totals[i])
        np.testing.assert_array_equal(tli.numpy()[i, :t], li)
        np.testing.assert_array_equal(tri.numpy()[i, :t], ri)


def test_stacked_probe_overflow_flag_matches_jax():
    """A bucket whose pairs reach 2^31 (65536 x 32768 equal keys) is flagged
    in both; its neighbour in the wave is not."""
    lk = np.full((2, 65536), 7, np.int32)
    lk[1] = np.arange(65536, dtype=np.int32)
    rk = np.full((2, 65536), I32_MAX, np.int32)
    rk[:, :32768] = 7
    n_l = np.array([65536, 65536], np.int32)
    n_r = np.array([32768, 32768], np.int32)
    _jlo, _joffs, jtot, jok = jdj._build_stacked_probe_kernel(65536, 65536)(
        jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(n_r), jnp.asarray(n_l))
    _tlo, _toffs, ttot, tok = tdj._build_stacked_probe_kernel()(
        torch.from_numpy(lk), torch.from_numpy(rk), torch.from_numpy(n_r),
        torch.from_numpy(n_l))
    assert list(np.asarray(jok)) == list(tok.numpy()) == [False, True]
    assert int(ttot[0]) == 2**31 and int(ttot[1]) == int(np.asarray(jtot)[1]) == 32768


# ---------------------------------------------------------------------------
# (b) the batched and per-bucket joins
# ---------------------------------------------------------------------------

def _bucket_pairs(seed: int, sizes, key_dtype=np.int64, key_hi: int = 400):
    """Per bucket (left cols, right cols): sorted duplicate keys both sides,
    a few payload columns of mixed dtypes."""
    rng = np.random.default_rng(seed)
    out = []
    for n_l, n_r in sizes:
        left = {"k": np.sort(rng.integers(0, key_hi, n_l)).astype(key_dtype),
                "v": rng.uniform(0, 100, n_l), "q": rng.integers(1, 51, n_l)}
        right = {"rk": np.sort(rng.integers(0, key_hi, n_r)).astype(key_dtype),
                 "w": rng.uniform(-5, 5, n_r).astype(np.float32),
                 "d": rng.integers(8000, 9000, n_r).astype(np.int32)}
        out.append((left, right))
    return out


def _batches(pairs, Col, Batch):
    return [(Batch({n: Col(a, str(a.dtype)) for n, a in lc.items()}),
             Batch({n: Col(a, str(a.dtype)) for n, a in rc.items()})) for lc, rc in pairs]


def _sessions(tmp_path):
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu")
    return js, ts


def _run_batched(pairs, tmp_path, residual=None):
    js, ts = _sessions(tmp_path)
    jwork = [jbj._prep_plain_work(b, lb, rb, ["k"], ["rk"], True, True)
             for b, (lb, rb) in enumerate(_batches(pairs, JColumn, JBatch))]
    twork = [tbj._prep_plain_work(b, lb, rb, ["k"], ["rk"], True, True, ts)
             for b, (lb, rb) in enumerate(_batches(pairs, TColumn, TBatch))]
    jres = [residual(JX)] if residual else []
    tres = [residual(TX)] if residual else []
    jout = jdj.try_batched_plain_join([w for w in jwork if w is not None], jres, js)
    tout = tdj.try_batched_plain_join([w for w in twork if w is not None], tres, ts)
    return jout, tout, ts


def _assert_parts_equal(jout, tout):
    assert jout is not None and tout is not None
    assert sorted(jout) == sorted(tout)
    for b in jout:
        jd, td = jout[b].to_pydict(), tout[b].to_pydict()
        assert list(jd) == list(td)
        for name in jd:
            np.testing.assert_array_equal(np.asarray(td[name]), np.asarray(jd[name]))


@pytest.mark.parametrize("sizes,residual", [
    (((3000, 500), (2500, 800), (0, 40), (1800, 1)), None),
    (((5000, 700), (4100, 300)), lambda M: M.col("d") < 8600),
])
def test_batched_plain_join_matches_jax(sizes, residual, tmp_path):
    pairs = _bucket_pairs(1, sizes)
    jout, tout, ts = _run_batched(pairs, tmp_path, residual)
    _assert_parts_equal(jout, tout)
    assert ts.device_stats.plain_join_fetches == 2
    # the rows are the host merge join's, bucket by bucket, in its order
    for b, (lb, rb) in enumerate(_batches(pairs, TColumn, TBatch)):
        if b in tout:
            host = tbj._merge_join_batches(lb, rb, ["k"], ["rk"], True, True)
            if residual is not None:
                host = host.filter(np.asarray(residual(TX).eval(host).data, dtype=bool))
            for name, vals in host.to_pydict().items():
                np.testing.assert_array_equal(np.asarray(tout[b].to_pydict()[name]),
                                              np.asarray(vals))


def test_batched_plain_join_split_buckets_match_jax(tmp_path, monkeypatch):
    """Buckets above the split threshold probe in left chunks; the chunks
    concatenate into the unsplit bucket's rows."""
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "1000")  # the JAX package's
    monkeypatch.setattr(tdj, "_JOIN_SPLIT_ROWS", 1000)
    pairs = _bucket_pairs(2, ((4500, 600), (3100, 900), (200, 50)))
    jout, tout, _ts = _run_batched(pairs, tmp_path)
    _assert_parts_equal(jout, tout)
    monkeypatch.undo()
    _j2, unsplit, _ = _run_batched(pairs, tmp_path / "unsplit")
    _assert_parts_equal(unsplit, tout)


@pytest.mark.parametrize("seed,sizes", [
    (4, ((5000, 700), (6000, 500), (4100, 300))),
    (5, ((4200, 4100), (300, 20), (7000, 900), (4096, 4096))),
])
def test_over_budget_ledger_parks_spills_and_matches(tmp_path, monkeypatch, seed, sizes):
    """A device ledger far below one wave's footprint parks every wave and
    spills the earlier ones; the rows stay the same, and the ledger drains."""
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "1024")  # the JAX package's
    monkeypatch.setattr(tdj, "_JOIN_SPLIT_ROWS", 1024)
    monkeypatch.setenv("HYPERSPACE_PARK_WAIT_MS", "1")
    acct = tbudget.BudgetAccountant(10_000)
    monkeypatch.setattr(tbudget, "_DEVICES", {0: acct})
    pairs = _bucket_pairs(seed, sizes)
    jout, tout, ts = _run_batched(pairs, tmp_path)
    _assert_parts_equal(jout, tout)
    assert ts.device_stats.join_spills > 0
    assert ts.device_stats.plain_join_fetches > 2
    assert acct.held_bytes() == 0


@pytest.mark.parametrize("l_sorted,r_sorted", [(True, True), (False, False), (True, False)])
def test_per_bucket_device_plain_join_matches_jax(l_sorted, r_sorted, tmp_path):
    (left, right), = _bucket_pairs(5, ((6000, 900),), key_dtype=np.int32)
    rng = np.random.default_rng(6)
    if not l_sorted:
        left = {n: a[rng.permutation(len(a))] if n == "k" else a for n, a in left.items()}
    if not r_sorted:
        right = {n: a[rng.permutation(len(a))] for n, a in right.items()}
    (jl, jr), = _batches([(left, right)], JColumn, JBatch)
    (tl, tr), = _batches([(left, right)], TColumn, TBatch)
    js, ts = _sessions(tmp_path)
    jout = jdj.try_device_plain_join(jl, jr, ["k"], ["rk"], js, l_sorted, r_sorted)
    tout = tdj.try_device_plain_join(tl, tr, ["k"], ["rk"], ts, l_sorted, r_sorted)
    host = tbj._merge_join_batches(tl, tr, ["k"], ["rk"], l_sorted, r_sorted)
    assert tout.num_rows == jout.num_rows == host.num_rows > 6000
    for other in (jout, host):
        for name, vals in other.to_pydict().items():
            np.testing.assert_array_equal(np.asarray(tout.to_pydict()[name]), np.asarray(vals))
    # small buckets and f64 keys decline in both
    assert tdj.try_device_plain_join(tl.take(np.arange(4000)), tr, ["k"], ["rk"], ts,
                                     l_sorted, r_sorted) is None
    fl = TBatch({**tl.columns, "k": TColumn(left["k"].astype(np.float64), "float64")})
    assert tdj.try_device_plain_join(fl, tr, ["k"], ["rk"], ts, l_sorted, r_sorted) is None


def test_batched_plain_join_declines_by_data(tmp_path):
    """Fewer than 4096 left rows in all, a pair count that reaches 2^31, and
    an expansion whose one hot bucket would pad the wave's readback: the
    port declines where the reference declines, and says why."""
    small = _bucket_pairs(7, ((1500, 200), (2000, 300)))
    jout, tout, ts = _run_batched(small, tmp_path / "small")
    assert jout is None and tout is None
    assert ts.device_stats.declines == {"plain_join_small": 1}

    hot = {"k": np.full(65536, 7, np.int64), "v": np.zeros(65536)}
    hot_r = {"rk": np.full(32768, 7, np.int64), "w": np.zeros(32768, np.float32)}
    jout, tout, ts = _run_batched([(hot, hot_r)], tmp_path / "overflow")
    assert jout is None and tout is None
    assert ts.device_stats.declines == {"plain_join_overflow": 1}

    rng = np.random.default_rng(8)
    skew = [({"k": np.full(4096, 7, np.int64)}, {"rk": np.full(1100, 7, np.int64)})]
    skew += [({"k": np.sort(rng.integers(0, 5000, 4096))},
              {"rk": np.sort(rng.permutation(5000)[:1100])}) for _ in range(2)]
    jout, tout, ts = _run_batched(skew, tmp_path / "skew")
    assert jout is None and tout is None
    assert ts.device_stats.declines == {"plain_join_skew": 1}


# ---------------------------------------------------------------------------
# (c) plain joins through the plan: declines by key type and size
# ---------------------------------------------------------------------------

def _write(path, table):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(table, path)


@pytest.fixture(scope="module")
def key_lake(tmp_path_factory):
    """A plain join of two relations per case: int keys (the batched device
    path), f64 keys, string keys, and too few rows."""
    root = tmp_path_factory.mktemp("plain_keys")
    rng = np.random.default_rng(12)
    n_l, n_r = 9000, 1500
    lkeys, rkeys = rng.integers(0, 2000, n_l), rng.permutation(2000)[:n_r]
    cases = {
        "int": (lkeys, rkeys),
        "f64": (lkeys.astype(np.float64), rkeys.astype(np.float64)),
        "string": (np.array([f"k{k}" for k in lkeys]), np.array([f"k{k}" for k in rkeys])),
        "small": (lkeys[:3000], rkeys),
    }
    for case, (lk, rk) in cases.items():
        _write(str(root / case / "left" / "p.parquet"),
               pa.table({"k": lk, "v": rng.uniform(0, 100, len(lk))}))
        _write(str(root / case / "right" / "p.parquet"),
               pa.table({"rk": rk, "w": rng.integers(0, 9, len(rk))}))
    return str(root)


def _plain_join_query(M, session, lake):
    left = session.read.parquet(os.path.join(lake, "left"))
    right = session.read.parquet(os.path.join(lake, "right"))
    return left.join(right, M.col("k") == M.col("rk")).filter(M.col("w") < 7)


@pytest.mark.parametrize("case,path,declines", [
    ("int", "batched", {}),
    ("f64", "per_bucket", {"plain_join_key": 1}),
    ("string", "per_bucket", {"plain_join_plan_screen": 1}),
    ("small", "per_bucket", {"plain_join_small": 1}),
])
def test_plain_join_through_the_plan_matches_jax(key_lake, case, path, declines, tmp_path):
    lake = os.path.join(key_lake, case)
    outs = {}
    for pkg, M, kw, conf in ((J, JX, {}, {JC.EXEC_TPU_ENABLED: True}),
                             (T, TX, {"device": "cpu"}, {})):
        session = pkg.HyperspaceSession(str(tmp_path / pkg.__name__), conf=conf, **kw)
        hs = pkg.Hyperspace(session)
        hs.create_index(session.read.parquet(os.path.join(lake, "left")),
                        pkg.CoveringIndexConfig("l_k", ["k"], ["v"]))
        hs.create_index(session.read.parquet(os.path.join(lake, "right")),
                        pkg.CoveringIndexConfig("r_k", ["rk"], ["w"]))
        session.enable_hyperspace()
        outs[pkg] = _plain_join_query(M, session, lake).to_pydict()
        if pkg is T:
            stats = session.device_stats
            assert stats.join_paths == {path: 1}
            assert stats.declines == declines
            assert stats.plain_join_fetches == (2 if path == "batched" else 0)
    got, want = outs[T], outs[J]
    assert list(got) == list(want) and len(got["k"]) > 100
    for name in want:  # bit for bit, in the reference's row order
        assert list(got[name]) == list(want[name]), name


# ---------------------------------------------------------------------------
# (d) AggregateIndexRule, and q10 / q17 / q18 end to end
# ---------------------------------------------------------------------------

ROWS = 40_000
INDEXES = {"lineitem": (ttpch.LI_ORDERKEY, ttpch.LI_PARTKEY),
           "orders": (ttpch.OD_ORDERKEY,), "part": (ttpch.PT_PARTKEY,)}


def _build_indexes(pkg, session, lake):
    hs = pkg.Hyperspace(session)
    for table, specs in INDEXES.items():
        for name, indexed, included in specs:
            hs.create_index(session.read.parquet(os.path.join(lake, table)),
                            pkg.CoveringIndexConfig(name, indexed, included))


@pytest.fixture(scope="module")
def tpch_lakes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_plain")
    lake = str(root / "lake")
    jtpch.generate_tpch(lake, rows_lineitem=ROWS, seed=42)
    jwh, twh = str(root / "wh_jax"), str(root / "wh_torch")
    _build_indexes(J, J.HyperspaceSession(jwh), lake)
    _build_indexes(T, T.HyperspaceSession(twh, device="cpu"), lake)
    return lake, jwh, twh


def _index_names(df) -> list:
    return [n.index_info.index_name for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


EXPECTED_INDEXES = {
    "q10": ["li_orderkey", "od_orderkey"],
    "q17": ["li_partkey", "pt_partkey", "li_partkey"],
    "q18": ["li_orderkey"],
}


@pytest.mark.parametrize("q", sorted(ttpch.TPCH_QUERIES))
def test_optimized_plans_render_as_jax(tpch_lakes, q):
    lake, jwh, twh = tpch_lakes
    jsession = J.HyperspaceSession(jwh).enable_hyperspace()
    tsession = T.HyperspaceSession(twh, device="cpu").enable_hyperspace()
    jplan = jtpch.TPCH_QUERIES[q](jsession, lake).optimized_plan().pretty()
    tplan = ttpch.TPCH_QUERIES[q](tsession, lake).optimized_plan().pretty()
    assert tplan.replace(twh, "<wh>") == jplan.replace(jwh, "<wh>")
    if q in EXPECTED_INDEXES:
        assert _index_names(ttpch.TPCH_QUERIES[q](tsession, lake)) == EXPECTED_INDEXES[q]


def _columns(d: dict) -> dict:
    return {k: np.asarray(v) for k, v in d.items()}


def assert_tpch_results_match(q, got: dict, want: dict, sort_keys):
    """Every column equal, floats within REL, and the leading sort key
    within REL on every row. The other columns of a row may differ from the
    reference's only where its neighbours' leading sort keys differ but lie
    within REL (both packages order the same values, summed in other
    orders); exact ties are broken by the next sort key, so they are held."""
    got, want = _columns(got), _columns(want)
    assert list(got) == list(want)
    n = len(next(iter(want.values())))
    assert n > 0 and all(len(v) == n for v in got.values())
    near = np.zeros(n, dtype=bool)
    lead = sort_keys[0] if sort_keys else None
    if lead is not None:
        w = want[lead].astype(np.float64)
        d = np.abs(np.diff(w))
        pair = (d > 0) & (d <= REL * np.abs(w[1:]))
        near[1:] |= pair
        near[:-1] |= pair
    for name in want:
        held = np.ones(n, dtype=bool) if name == lead else ~near
        if want[name].dtype.kind == "f":
            np.testing.assert_allclose(got[name][held], want[name][held], rtol=REL)
        else:
            assert (got[name] == want[name])[held].all(), (q, name)


SORT_KEYS = {"q10": ("revenue",), "q17": (), "q18": ("sum_qty",)}


@pytest.mark.parametrize("q", ["q10", "q17", "q18"])
def test_tpch_query_matches_jax_through_the_device_routes(tpch_lakes, q, monkeypatch):
    lake, jwh, twh = tpch_lakes
    jsession = J.HyperspaceSession(jwh, conf={JC.EXEC_TPU_ENABLED: True}).enable_hyperspace()
    tsession = T.HyperspaceSession(twh, device="cpu").enable_hyperspace()
    routes = {"batched": [], "tpu": []}

    def spy(name, orig):
        def f(*a, **kw):
            out = orig(*a, **kw)
            routes[name].append(out is not None)
            return out
        return f

    from hyperspace_tpu.plan import tpu_exec as jtx

    monkeypatch.setattr(jdj, "try_batched_plain_join",
                        spy("batched", jdj.try_batched_plain_join))
    monkeypatch.setattr(jtx, "try_execute_tpu", spy("tpu", jtx.try_execute_tpu))
    want = jtpch.TPCH_QUERIES[q](jsession, lake).to_pydict()
    got = ttpch.TPCH_QUERIES[q](tsession, lake).to_pydict()
    assert_tpch_results_match(q, got, want, SORT_KEYS[q])
    stats = tsession.device_stats
    # the port takes the routes the reference took
    n_batched = sum(routes["batched"])
    assert stats.join_paths == ({"batched": n_batched} if n_batched else {})
    assert stats.plain_join_fetches == 2 * n_batched
    assert stats.device_fragments == sum(routes["tpu"])
    assert {"q10": 1, "q17": 1, "q18": 0}[q] == n_batched
    assert {"q10": 0, "q17": 1, "q18": 1}[q] == stats.device_fragments
    assert not stats.declines
    # a warm run repeats bit for bit
    again = ttpch.TPCH_QUERIES[q](tsession, lake).to_pydict()
    for name in got:
        np.testing.assert_array_equal(np.asarray(again[name]), np.asarray(got[name]))


def test_bucketed_scan_aggregate_matches_jax(tpch_lakes, monkeypatch):
    """With the device tier off, q18's per-order aggregate over li_orderkey
    aggregates bucket by bucket in both packages."""
    lake, jwh, twh = tpch_lakes
    jsession = J.HyperspaceSession(jwh, conf={JC.EXEC_TPU_ENABLED: False}).enable_hyperspace()
    tsession = T.HyperspaceSession(
        twh, conf={TC.EXEC_TPU_ENABLED: False}, device="cpu").enable_hyperspace()
    ran = []
    orig = tbj.try_bucketed_scan_aggregate

    def spy(*a, **kw):
        out = orig(*a, **kw)
        ran.append(out is not None)
        return out

    monkeypatch.setattr(tbj, "try_bucketed_scan_aggregate", spy)
    outs = []
    for M, pkg_q, session in ((JX, jtpch, jsession), (TX, ttpch, tsession)):
        li = session.read.parquet(os.path.join(lake, "lineitem"))
        df = (li.select("l_orderkey", "l_quantity").group_by("l_orderkey")
              .agg(M.Sum(M.col("l_quantity")).alias("s"), M.Count(M.lit(1)).alias("n")))
        outs.append(df.to_pydict())
    assert ran == [True]
    want, got = outs
    assert list(got) == list(want) and len(got["l_orderkey"]) > 1000
    for name in want:  # the same host arithmetic: bit for bit, same order
        assert list(got[name]) == list(want[name]), name


# ---------------------------------------------------------------------------
# (e) the side filters' string comparisons (Q10's l_returnflag = 'R')
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["Eq", "Ne", "Lt", "Le", "Gt", "Ge"])
@pytest.mark.parametrize("shape", ["literal", "small_dicts", "large_dicts", "nulls"])
def test_string_comparisons_match_jax(op, shape):
    """By the ranks of the dictionary entries, against a literal or a column
    with a small or a large dictionary: the JAX package's results, validity
    included."""
    rng = np.random.default_rng(13)
    n = 3000
    vocab = [f"v{i:03d}" for i in range(400 if shape == "large_dicts" else 5)]
    a = rng.choice(vocab, n)
    b = rng.choice(vocab, n)
    valid = rng.random(n) < 0.8 if shape == "nulls" else None
    outs = []
    for M, Col, Batch in ((JX, JColumn, JBatch), (TX, TColumn, TBatch)):
        ca, cb = Col.from_values(list(a)), Col.from_values(list(b))
        if valid is not None:
            ca = Col(ca.data, ca.dtype, valid, ca.dictionary)
        batch = Batch({"a": ca, "b": cb})
        right = M.lit("v002") if shape == "literal" else M.col("b")
        outs.append(getattr(M, op)(M.col("a"), right).eval(batch))
    want, got = outs
    np.testing.assert_array_equal(got.data, want.data)
    if valid is None:
        assert got.validity is None and want.validity is None
    else:
        np.testing.assert_array_equal(got.validity, want.validity)
    assert 0 < int(got.data.sum()) < n


# ---------------------------------------------------------------------------
# (f) on the card: the bodies on CUDA tensors equal the same bodies on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [0, 3])
def test_cuda_plain_join_bodies_match_the_cpu(cuda_device, split):
    cases = sorted(_key_cases())
    lk, rk, n_r, n_l, _pad_l, _pad_r = _stacked_inputs(cases, split)
    on = {d: [torch.from_numpy(a).to(d) for a in (lk, rk, n_r, n_l)]
          for d in ("cpu", cuda_device)}
    probe = tdj._build_stacked_probe_kernel()
    cpu = probe(*on["cpu"])
    card = probe(*on[cuda_device])
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    out_pad = tdj._pow2(int(cpu[2].max()))
    expand = tdj._build_stacked_expand_kernel(out_pad)
    for a, b in zip(expand(cpu[0], cpu[1], cpu[2]), expand(card[0], card[1], card[2])):
        assert torch.equal(a, b.cpu())
    one = tdj._build_plain_probe_kernel()
    lk1, rk1 = torch.from_numpy(lk[0]), torch.from_numpy(rk[0])
    for a, b in zip(one(lk1, rk1, int(n_r[0])),
                    one(lk1.to(cuda_device), rk1.to(cuda_device), int(n_r[0]))):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_batched_plain_join_matches_the_cpu(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(tdj, "_JOIN_SPLIT_ROWS", 1000)
    pairs = _bucket_pairs(9, ((4500, 600), (3100, 900), (200, 50)))
    outs = []
    for device in ("cpu", None):
        ts = T.HyperspaceSession(str(tmp_path / str(device)), device=device)
        work = [tbj._prep_plain_work(b, lb, rb, ["k"], ["rk"], True, True, ts)
                for b, (lb, rb) in enumerate(_batches(pairs, TColumn, TBatch))]
        outs.append(tdj.try_batched_plain_join(work, [], ts))
        assert ts.device_stats.plain_join_fetches == 2
    _assert_parts_equal(*outs)


# ---------------------------------------------------------------------------
# (e) the streamed, banded plain join over co-bucketed lakes
# ---------------------------------------------------------------------------

def _two_sided_lake(root, left: dict, right: dict, buckets: int = 4):
    for side, table in (("l", left), ("r", right)):
        _write(str(root / side / f"{side}.parquet"), pa.table(table))
    for pkg, wh, kw in ((J, "wj", {}), (T, "wt", {"device": "cpu"})):
        session = pkg.HyperspaceSession(str(root / wh), **kw)
        session.set_conf(JC.INDEX_NUM_BUCKETS, buckets)
        hs = pkg.Hyperspace(session)
        hs.create_index(session.read.parquet(str(root / "l")),
                        pkg.CoveringIndexConfig("jl", ["k"], ["p"]))
        hs.create_index(session.read.parquet(str(root / "r")),
                        pkg.CoveringIndexConfig("jr", ["rk"], ["w"]))
    return root


@pytest.fixture(scope="module")
def skew_plain_lake(tmp_path_factory):
    """40% of the left rows on one hot key; right keys only below 200."""
    rng = np.random.default_rng(101)
    n = 24_000
    k = rng.integers(0, 400, n)
    k[: int(n * 0.4)] = 7
    return _two_sided_lake(tmp_path_factory.mktemp("skew_plain"),
                           {"k": k, "p": rng.uniform(0, 100, n)},
                           {"rk": np.arange(200), "w": rng.uniform(size=200)})


def _plain_q(M, session, root):
    left = session.read.parquet(str(root / "l")).select("k", "p")
    right = session.read.parquet(str(root / "r")).select("rk", "w")
    return left.join(right, M.col("k") == M.col("rk")).select("k", "p", "w")


def _run_plain_both(root, monkeypatch):
    from hyperspace_tpu.telemetry.metrics import REGISTRY

    counters = ("pipeline.join.splits", "pipeline.join.bands")
    before = {c: REGISTRY.counter(c).value for c in counters}
    js = J.HyperspaceSession(str(root / "wj"), conf={JC.EXEC_TPU_ENABLED: True})
    want = _plain_q(JX, js.enable_hyperspace(), root).to_pydict()
    jcounts = {c: REGISTRY.counter(c).value - before[c] for c in counters}
    works = []
    orig = tdj.try_batched_plain_join

    def spy(work, *a, **kw):
        works.append(type(work).__name__)
        return orig(work, *a, **kw)

    monkeypatch.setattr(tdj, "try_batched_plain_join", spy)
    ts = T.HyperspaceSession(str(root / "wt"), device="cpu").enable_hyperspace()
    got = _plain_q(TX, ts, root).to_pydict()
    monkeypatch.setattr(tdj, "try_batched_plain_join", orig)
    return want, got, jcounts, ts.device_stats, works


def _assert_rows_equal(got, want):
    assert list(got) == list(want)
    for name in want:  # bit for bit, in the reference's row order
        assert list(got[name]) == list(want[name]), name


@pytest.fixture
def device_grant(monkeypatch):
    """Sets both packages' device ledgers to a grant (MiB; "0" turns the
    ledger and the strategy plan off), and the default ones back after."""
    from hyperspace_tpu.serve import budget as jbudget

    def set_grant(mb):
        if mb is None:
            monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
        else:
            monkeypatch.setenv("HYPERSPACE_DEVICE_BUDGET_MB", mb)
        jbudget.reset_device_budget()
        tbudget.reset_device_budget()

    yield set_grant
    monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()


@pytest.mark.parametrize("grant", [None, "0"])
@pytest.mark.parametrize("split_rows", [None, "1024", "3000"])
@pytest.mark.parametrize("mode", ["1", "serial", "0"])
def test_streamed_plain_join_splits_and_bands_as_jax(skew_plain_lake, monkeypatch, device_grant,
                                                     mode, split_rows, grant):
    """With the strategy plan (the default grant) and without it (a grant of
    0), a set HYPERSPACE_JOIN_SPLIT_ROWS splits the buckets as the JAX
    package splits them."""
    monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
    device_grant(grant)
    if split_rows is not None:
        monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", split_rows)
    want, got, jcounts, stats, works = _run_plain_both(skew_plain_lake, monkeypatch)
    assert len(stats.join_plans) == (0 if grant == "0" else 1)
    _assert_rows_equal(got, want)
    assert stats.join_paths == {"batched": 1} and not stats.declines
    assert stats.plain_join_fetches == 2
    # pairs stream into the probe, except behind the barrier
    assert works == (["list"] if mode == "0" else ["generator"])
    assert stats.join_splits == jcounts["pipeline.join.splits"]
    assert stats.join_waves == jcounts["pipeline.join.bands"]
    assert (stats.join_splits > 0) == (split_rows is not None and mode != "0")
    if mode == "0":
        assert stats.join_waves == 1


def test_plain_join_modes_give_the_same_bits(skew_plain_lake, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "1024")
    out = {}
    for mode in ("serial", "1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        _want, out[mode], _j, _stats, _w = _run_plain_both(skew_plain_lake, monkeypatch)
    for name in out["0"]:
        np.testing.assert_array_equal(np.asarray(out["serial"][name]), np.asarray(out["0"][name]))
        np.testing.assert_array_equal(np.asarray(out["1"][name]), np.asarray(out["0"][name]))


@pytest.mark.parametrize("mode", ["1", "0"])
def test_plain_join_empty_and_disjoint_buckets_match_jax(tmp_path_factory, monkeypatch, mode):
    """Right keys in two buckets only: the JAX package's rows, on the
    device; disjoint keys: an empty result on the device path, as there."""
    monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
    rng = np.random.default_rng(5)
    n = 12_000
    left = {"k": rng.integers(0, 64, n), "p": rng.uniform(0, 10, n)}
    sparse = _two_sided_lake(tmp_path_factory.mktemp("sparse"), left,
                             {"rk": np.array([3, 11]), "w": np.array([1.5, 2.5])})
    disjoint = _two_sided_lake(tmp_path_factory.mktemp("disjoint"), left,
                               {"rk": np.arange(100, 140), "w": rng.uniform(size=40)})
    for root, keys in ((sparse, {3, 11}), (disjoint, set())):
        want, got, _j, stats, _w = _run_plain_both(root, monkeypatch)
        _assert_rows_equal(got, want)
        assert set(got["k"]) == keys
        assert stats.join_paths == {"batched": 1} and not stats.declines
