"""The port's bucketed join path held against the JAX package on the same
numpy-seeded inputs.

- The fused join+aggregate body (hyperspace_tpu_torch/plan/device_join.py
  ``stacked_join_body``) against the JAX package's
  ``device_join._build_stacked_kernel`` on the CPU, over side filters,
  residuals, duplicate keys, empty matches and every aggregate kind.
  Counts, group membership, min and max are exact; f32 sums agree within
  relative 1e-4 (the two add in different orders).
- The host join: ``join_indices`` and ``_merge_join_batches``, exactly.
- TPC-H ``q3_agg`` and ``q3`` end to end on a small lake, both packages
  reading their own li_orderkey / od_orderkey indexes with the device tier
  on (the port's on the CPU): the join indexes and the fused device path
  must be used.
- The declines: f64 join keys, and duplicate right keys where a right
  column is gathered, fall to the host and still match.
- The per-bucket fused body (``per_bucket_join_body``) against the JAX
  ``_build_kernel``, with and without ``dup`` and a residual, and
  ``try_device_join_agg`` against the JAX one: counts exact, f32 sums
  within relative 1e-4, min and max exact; the same declines.
- The per-bucket route: under ``HYPERSPACE_PIPELINE=0`` or with the device
  ledger off, a join whose index bytes exceed ``maxBytesInMemory`` takes
  the path the JAX package's ``_log_join_exec`` names, its buckets on the
  device.
- The stacked fused join over a skewed lake: a set
  ``HYPERSPACE_JOIN_SPLIT_ROWS`` splits count/min/max buckets as many
  times as the JAX package does, never a sum's; empty and disjoint
  buckets; ``HYPERSPACE_PIPELINE`` serial, 1 and 0 give the same bits.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.plan import bucket_join as jbj
from hyperspace_tpu.plan import device_join as jdj
from hyperspace_tpu.plan import executor as jex
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.plan import bucket_join as tbj
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import executor as tex
from hyperspace_tpu_torch.plan import expr as TX

REL = 1e-4


# ---------------------------------------------------------------------------
# (a) the fused body
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(10, int(np.ceil(np.log2(max(1, n)))))


def _side(rng, n: int, key_hi: int, unique: bool):
    keys = (rng.permutation(key_hi)[:n] if unique else rng.integers(0, key_hi, n))
    keys = np.sort(keys).astype(np.int32)
    return keys


def _body_inputs(seed: int, n_l: int, n_r: int, dup_right: bool, disjoint: bool = False):
    rng = np.random.default_rng(seed)
    lk = _side(rng, n_l, 1000, unique=False)  # duplicate left keys
    rk = _side(rng, n_r, 1000, unique=not dup_right)
    if disjoint:
        rk = rk + 2000
    lcols = {
        "price": rng.uniform(900, 105_000, n_l).astype(np.float32),
        "disc": np.round(rng.uniform(0, 0.1, n_l), 2).astype(np.float32),
        "qty": rng.integers(1, 51, n_l).astype(np.int32),
    }
    rcols = {
        "odate": rng.integers(8035, 10590, n_r).astype(np.int32),
        "rv": rng.uniform(-50, 50, n_r).astype(np.float32),
    }
    return lk, rk, lcols, rcols


def _aggs(M, left_only: bool):
    col, lit = M.col, M.lit
    aggs = [
        ("count", None),
        ("sum", col("price") * (lit(1.0) - col("disc"))),
        ("avg", col("price")),
        ("max", col("qty")),
        ("min", col("disc")),
    ]
    if not left_only:
        aggs += [("min", col("rv")), ("max", col("rv") + col("price")),
                 ("sum", col("rv"))]
    return aggs


_BODY_CASES = {
    # name: (left filters, right filters, residual, dup right keys, disjoint)
    "plain": ((), (), (), False, False),
    "left_filter": ((lambda M: M.col("qty") < 24,), (), (), False, False),
    "right_filter": ((), (lambda M: M.col("odate") < 9500,), (), False, False),
    "both_filters_residual": (
        (lambda M: M.col("disc") >= 0.03,), (lambda M: M.col("odate") >= 8500,),
        (lambda M: M.col("rv") < M.col("disc") * 300.0,), False, False),
    "dup_right_left_only": ((lambda M: M.col("qty") > 10,),
                            (lambda M: M.col("odate") < 9800,), (), True, False),
    "no_matches": ((), (), (), False, True),
}


def _run_jax_body(case, lk, rk, lcols, rcols, left_only):
    lf, rf, res, _dup, _dis = _BODY_CASES[case]
    aggs = _aggs(JX, left_only)
    right_gather = [] if left_only else ["rv"]
    pad_l, pad_r = _pow2(len(lk)), _pow2(len(rk))
    kernel = jdj._build_stacked_kernel(
        aggs, [r(JX) for r in res], [f(JX) for f in lf], [f(JX) for f in rf],
        right_gather, pad_l, pad_r,
    )

    def padded(a, pad, fill=0):
        out = np.full((1, pad), fill, dtype=a.dtype)
        out[0, : len(a)] = a
        return jnp.asarray(out)

    counts, outs = kernel(
        padded(lk, pad_l), padded(rk, pad_r, np.iinfo(np.int32).max),
        jnp.asarray([len(lk)], jnp.int32), jnp.asarray([len(rk)], jnp.int32),
        {c: padded(a, pad_l) for c, a in lcols.items()},
        {c: padded(a, pad_r) for c, a in rcols.items()},
    )
    n_r = len(rk)
    return np.asarray(counts)[0, :n_r], [np.asarray(o)[0, :n_r] for o in outs]


def _run_port_body(case, lk, rk, lcols, rcols, left_only, probe_sorted):
    lf, rf, res, _dup, _dis = _BODY_CASES[case]
    body = tdj.stacked_join_body(
        _aggs(TX, left_only), [r(TX) for r in res], [f(TX) for f in lf],
        [f(TX) for f in rf], [] if left_only else ["rv"],
    )
    counts, outs = body(
        torch.from_numpy(lk), torch.from_numpy(rk),
        {c: torch.from_numpy(a) for c, a in lcols.items()},
        {c: torch.from_numpy(a) for c, a in rcols.items()},
        probe_sorted,
    )
    return counts.numpy(), [o.numpy() for o in outs]


@pytest.mark.parametrize("case", sorted(_BODY_CASES))
def test_stacked_body_matches_jax(case):
    _lf, _rf, _res, dup, disjoint = _BODY_CASES[case]
    left_only = dup
    lk, rk, lcols, rcols = _body_inputs(len(case), 3000, 700, dup, disjoint)
    if dup:
        assert (rk[1:] == rk[:-1]).any()
    j_counts, j_outs = _run_jax_body(case, lk, rk, lcols, rcols, left_only)
    t_counts, t_outs = _run_port_body(case, lk, rk, lcols, rcols, left_only, True)
    # the sort the body skips for sorted left keys gives the same bits
    s_counts, s_outs = _run_port_body(case, lk, rk, lcols, rcols, left_only, False)
    np.testing.assert_array_equal(t_counts, s_counts)
    for a, b in zip(t_outs, s_outs):
        np.testing.assert_array_equal(a, b)

    assert t_counts.dtype == np.int32
    np.testing.assert_array_equal(t_counts, j_counts)
    if disjoint:
        assert not t_counts.any()
    else:
        assert t_counts.sum() > 0
    keep = t_counts > 0
    for (kind, _c), got, want in zip(_aggs(TX, left_only), t_outs, j_outs):
        got, want = got[keep], want[keep]
        if kind in ("sum", "avg"):
            np.testing.assert_allclose(got, want, rtol=REL)
        else:
            np.testing.assert_array_equal(got, want)


def test_stacked_body_on_an_empty_left_side():
    lk, rk, lcols, rcols = _body_inputs(5, 0, 300, False)
    j_counts, _ = _run_jax_body("plain", lk, rk, lcols, rcols, False)
    t_counts, t_outs = _run_port_body("plain", lk, rk, lcols, rcols, False, True)
    np.testing.assert_array_equal(t_counts, j_counts)
    assert not t_counts.any() and all(len(o) == len(rk) for o in t_outs)


# ---------------------------------------------------------------------------
# (b) the host join
# ---------------------------------------------------------------------------

def _key_batches(seed: int, n_l: int, n_r: int, kind: str):
    rng = np.random.default_rng(seed)
    lv = {"lval": rng.uniform(0, 1, n_l)}
    rv = {"rval": rng.integers(0, 9, n_r)}
    if kind == "string":
        vocab = [f"k{i}" for i in range(40)]
        lk = rng.choice(vocab, n_l).tolist()
        rk = rng.choice(vocab, n_r).tolist()
        lcols = {"lk": lk}
        rcols = {"rk": rk}
    else:
        lcols = {"lk": rng.integers(0, 300, n_l)}
        rcols = {"rk": rng.integers(0, 300, n_r)}
        if kind == "multi":
            lcols["lk2"] = rng.integers(0, 3, n_l)
            rcols["rk2"] = rng.integers(0, 3, n_r)
        elif kind == "multi_sparse":  # combined codes too sparse to count
            lcols["lk2"] = lcols["lk"] * 7 % 1009
            rcols["rk2"] = rcols["rk"] * 7 % 1009
    lnull = rng.random(n_l) < 0.05 if kind == "nulls" else None
    rnull = rng.random(n_r) < 0.05 if kind == "nulls" else None

    def batches(Col, Batch):
        def make(cols, vals, null):
            out = {}
            for name, v in cols.items():
                c = Col.from_values(v)
                if null is not None:
                    c = Col(c.data, c.dtype, ~null, c.dictionary)
                out[name] = c
            out.update({n: Col.from_values(list(v)) for n, v in vals.items()})
            return Batch(out)

        return make(lcols, lv, lnull), make(rcols, rv, rnull)

    return batches, [k for k in lcols], [k.replace("l", "r", 1) for k in lcols]


_JOIN_KINDS = [("int", 500, 400), ("int", 5000, 4500), ("string", 600, 500),
               ("multi", 800, 700), ("multi_sparse", 800, 700), ("nulls", 900, 800)]


@pytest.mark.parametrize("kind,n_l,n_r", _JOIN_KINDS)
def test_join_indices_match_jax(kind, n_l, n_r):
    batches, lkeys, rkeys = _key_batches(n_l, n_l, n_r, kind)
    jl, jr = batches(JColumn, JBatch)
    tl, tr = batches(TColumn, TBatch)
    jli, jri = jex.join_indices(jl, jr, lkeys, rkeys)
    tli, tri = tex.join_indices(tl, tr, lkeys, rkeys)
    assert len(tli) > 0
    np.testing.assert_array_equal(tli, jli)
    np.testing.assert_array_equal(tri, jri)


def test_join_building_blocks_match_jax():
    """ops/join.py: the host helpers exactly, the tensor primitives on the
    CPU against their jnp forms."""
    from hyperspace_tpu.ops import join as JO
    from hyperspace_tpu_torch.ops import join as TO

    rng = np.random.default_rng(3)
    for a in (rng.integers(-5, 5, 50), np.array([2**31], dtype=np.int64),
              rng.integers(0, 9, 20).astype(np.int16), np.array([1.5, np.nan], np.float32),
              rng.uniform(0, 1, 5).astype(np.float32), rng.uniform(0, 1, 5)):
        j, t = JO.exact_key32(a), TO.exact_key32(a)
        assert (j is None and t is None) or (t.dtype == j.dtype and np.array_equal(t, j))
    left = np.sort(rng.integers(0, 60, 300))
    right = np.sort(rng.integers(0, 60, 200))
    for got, want in zip(TO.host_merge_join_indices(left, right),
                         JO.host_merge_join_indices(left, right)):
        np.testing.assert_array_equal(got, want)
    starts, counts = rng.integers(0, 100, 40), rng.integers(0, 5, 40)
    np.testing.assert_array_equal(TO.expand_runs(starts, counts), JO.expand_runs(starts, counts))

    l32, r32 = left.astype(np.int32), right.astype(np.int32)
    tl, tr = torch.from_numpy(l32), torch.from_numpy(r32)
    for got, want in zip(TO.merge_match_counts(tl, tr),
                         JO.merge_match_counts(jnp.asarray(l32), jnp.asarray(r32))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.integers(0, 100, len(r32)).astype(np.int32)
    uniq = np.unique(r32)
    np.testing.assert_array_equal(
        TO.segment_sum_by_sorted_key(tr, torch.from_numpy(vals), torch.from_numpy(uniq)).numpy(),
        np.asarray(JO.segment_sum_by_sorted_key(jnp.asarray(r32), jnp.asarray(vals),
                                                jnp.asarray(uniq))),
    )
    table_vals = rng.uniform(0, 1, len(uniq)).astype(np.float32)
    got_v, got_f = TO.lookup_sorted(torch.from_numpy(uniq), torch.from_numpy(table_vals), tl, -1.0)
    want_v, want_f = JO.lookup_sorted(jnp.asarray(uniq), jnp.asarray(table_vals),
                                      jnp.asarray(l32), -1.0)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _pydict(batch):
    return {n: list(v) for n, v in batch.to_pydict().items()}


@pytest.mark.parametrize("l_sorted,r_sorted", [(True, True), (False, True), (True, False),
                                               (False, False)])
@pytest.mark.parametrize("kind", ["int", "string"])
def test_merge_join_batches_match_jax(kind, l_sorted, r_sorted):
    batches, lkeys, rkeys = _key_batches(7, 700, 600, kind)
    jl, jr = batches(JColumn, JBatch)
    tl, tr = batches(TColumn, TBatch)
    if kind == "int":  # the sorted flags promise the on-disk sort by key
        for flag, (jb, tb, key) in ((l_sorted, (jl, tl, "lk")), (r_sorted, (jr, tr, "rk"))):
            if flag:
                order = np.argsort(jb.column(key).data, kind="stable")
                jb.columns.update(jb.take(order).columns)
                tb.columns.update(tb.take(order).columns)
    jout = jbj._merge_join_batches(jl, jr, lkeys, rkeys, l_sorted, r_sorted)
    tout = tbj._merge_join_batches(tl, tr, lkeys, rkeys, l_sorted, r_sorted)
    assert tout.num_rows == jout.num_rows > 0
    assert _pydict(tout) == _pydict(jout)


# ---------------------------------------------------------------------------
# (c) q3_agg and q3 end to end
# ---------------------------------------------------------------------------

ROWS = 40_000


def _jax_q3_agg(session, root):
    li = session.read.parquet(os.path.join(root, "lineitem"))
    od = session.read.parquet(os.path.join(root, "orders"))
    return (
        li.select("l_orderkey", "l_extendedprice", "l_discount")
        .join(od.select("o_orderkey", "o_orderdate"),
              JX.col("l_orderkey") == JX.col("o_orderkey"))
        .filter(JX.col("o_orderdate") < 9500)
        .group_by("l_orderkey", "o_orderdate")
        .agg(JX.Sum(JX.col("l_extendedprice") * (JX.lit(1.0) - JX.col("l_discount")))
             .alias("revenue"))
    )


JAX_JOIN_QUERIES = {"q3_agg": _jax_q3_agg, "q3": jtpch.q3}


def build_join_indexes(pkg, session, lake):
    hs = pkg.Hyperspace(session)
    for table, (name, indexed, included) in ttpch.JOIN_INDEXES.items():
        hs.create_index(session.read.parquet(os.path.join(lake, table)),
                        pkg.CoveringIndexConfig(name, indexed, included))


def assert_join_results_match(q, got: dict, want: dict):
    """q3_agg: the same groups in the same order, revenue within REL; q3:
    revenues within REL in order, and keys equal except where neighbouring
    revenues tie within REL."""
    assert list(got) == list(want)
    assert len(got["revenue"]) == len(want["revenue"]) > 0
    for a, b in zip(got["revenue"], want["revenue"]):
        assert abs(a - b) <= REL * abs(b), (q, a, b)
    rev = want["revenue"]
    for i in range(len(rev)):
        tied = any(abs(rev[i] - rev[j]) <= REL * abs(rev[i])
                   for j in (i - 1, i + 1) if 0 <= j < len(rev))
        if q == "q3_agg" or not tied:
            for k in ("l_orderkey", "o_orderdate"):
                assert got[k][i] == want[k][i], (q, k, i)


def index_names(df) -> list:
    return [n.index_info.index_name for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


@pytest.fixture(scope="module")
def join_lakes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_join")
    lake = str(root / "lake")
    jtpch.generate_tpch(lake, rows_lineitem=ROWS, seed=42)
    jwh, twh = str(root / "wh_jax"), str(root / "wh_torch")
    build_join_indexes(J, J.HyperspaceSession(jwh), lake)
    build_join_indexes(T, T.HyperspaceSession(twh, device="cpu"), lake)
    return lake, jwh, twh


@pytest.mark.parametrize("q", ["q3_agg", "q3"])
def test_q3_through_the_fused_device_join_matches_jax(join_lakes, q, monkeypatch):
    lake, jwh, twh = join_lakes
    jsession = J.HyperspaceSession(jwh, conf={JC.EXEC_TPU_ENABLED: True}).enable_hyperspace()
    tsession = T.HyperspaceSession(twh, device="cpu").enable_hyperspace()
    stacked = []
    orig = jdj.try_stacked_join_agg

    def spy(*a, **kw):
        out = orig(*a, **kw)
        stacked.append(out is not None)
        return out

    monkeypatch.setattr(jdj, "try_stacked_join_agg", spy)
    jdf, tdf = JAX_JOIN_QUERIES[q](jsession, lake), ttpch.JOIN_QUERIES[q](tsession, lake)
    assert index_names(jdf) == index_names(tdf) == ["li_orderkey", "od_orderkey"]
    want = jdf.to_pydict()
    got = tdf.to_pydict()
    assert stacked == [True]
    stats = tsession.device_stats
    assert stats.device_join_fragments == 1 and not stats.declines
    assert_join_results_match(q, got, want)
    # the warm run reuses every upload, and repeats bit for bit
    up = tsession.device_cache.uploaded_bytes
    assert ttpch.JOIN_QUERIES[q](tsession, lake).to_pydict() == got
    assert tsession.device_cache.uploaded_bytes == up


# ---------------------------------------------------------------------------
# (d) declines
# ---------------------------------------------------------------------------

def _write(path, table):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(table, path)


@pytest.fixture(scope="module")
def decline_lake(tmp_path_factory):
    """Two small relations per case: f64 join keys, and duplicate right keys
    with a right column in the aggregate."""
    root = tmp_path_factory.mktemp("declines")
    rng = np.random.default_rng(11)
    n_l, n_r = 6000, 900
    lkeys = rng.integers(0, n_r, n_l)
    rkeys = np.arange(n_r)
    dup_rkeys = rng.integers(0, n_r // 2, n_r)
    lt = {"k": lkeys, "v": rng.uniform(0, 100, n_l)}
    rt = {"rk": rkeys, "w": rng.uniform(0, 10, n_r)}
    _write(str(root / "f64" / "left" / "p.parquet"),
           pa.table({**lt, "k": lkeys.astype(np.float64)}))
    _write(str(root / "f64" / "right" / "p.parquet"),
           pa.table({**rt, "rk": rkeys.astype(np.float64)}))
    _write(str(root / "dup" / "left" / "p.parquet"), pa.table(lt))
    _write(str(root / "dup" / "right" / "p.parquet"), pa.table({**rt, "rk": dup_rkeys}))
    return str(root)


def _decline_query(M, session, lake):
    left = session.read.parquet(os.path.join(lake, "left"))
    right = session.read.parquet(os.path.join(lake, "right"))
    return (
        left.join(right, M.col("k") == M.col("rk"))
        .group_by("k")
        .agg(M.Sum(M.col("v") * M.col("w")).alias("s"), M.Count(M.lit(1)).alias("n"))
    )


@pytest.mark.parametrize("case,reason", [("f64", "join_plan_screen"),
                                         ("dup", "join_dup_right_keys")])
def test_declines_fall_to_the_host_and_match(decline_lake, case, reason, tmp_path):
    lake = os.path.join(decline_lake, case)
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
        df = _decline_query(M, session, lake)
        assert index_names(df) == ["l_k", "r_k"]
        outs[pkg] = df.to_pydict()
        if pkg is T:
            stats = session.device_stats
            assert stats.device_join_fragments == 0
            assert stats.declines == {reason: 1}
    got, want = outs[T], outs[J]
    assert got["k"] == want["k"] and got["n"] == want["n"] and len(got["k"]) > 0
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9)


def test_fused_join_sorts_unsorted_bucket_sides(tmp_path):
    """A bucket side that is not sorted by key (a multi-file bucket) is
    sorted on the way in: the right side by a host order, the left side's
    segments in the body. The result equals the sorted sides' and the host
    twin's."""
    from hyperspace_tpu_torch.plan.nodes import Aggregate, InMemoryScan, Join

    rng = np.random.default_rng(5)
    n_l, n_r = 4000, 600
    left = {"k": np.sort(rng.integers(0, 900, n_l)), "v": rng.uniform(0, 100, n_l)}
    right = {"rk": np.sort(rng.permutation(900)[:n_r]), "w": rng.uniform(0, 10, n_r),
             "d": rng.integers(0, 50, n_r).astype(np.int32)}

    def batch(cols, order=None):
        return TBatch({n: TColumn.from_values(list(a if order is None else a[order]))
                       for n, a in cols.items()})

    lb, rb = batch(left), batch(right)
    lb_s, rb_s = batch(left, rng.permutation(n_l)), batch(right, rng.permutation(n_r))
    agg = Aggregate(
        [TX.col("k"), TX.col("d")],
        [TX.Sum(TX.col("v") * TX.col("w")).alias("s"), TX.Count(TX.lit(1)).alias("n"),
         TX.Max(TX.col("v")).alias("m")],
        Join(InMemoryScan(lb), InMemoryScan(rb), TX.col("k") == TX.col("rk")),
    )
    session = T.HyperspaceSession(str(tmp_path), device="cpu")

    def run(l_batch, r_batch, is_sorted):
        out = tdj.try_stacked_join_agg(
            iter([(0, l_batch, r_batch, is_sorted, is_sorted)]), ["k"], ["rk"], [],
            session, agg,
        )
        return {n: np.asarray(v) for n, v in out.to_pydict().items()}

    want = run(lb, rb, True)
    got = run(lb_s, rb_s, False)
    host = tdj.try_host_join_agg(agg, lb_s, rb_s, ["k"], ["rk"], [], session, False).to_pydict()
    assert session.device_stats.device_join_fragments == 2
    assert len(want["k"]) > 100
    for other in (got, {n: np.asarray(v) for n, v in host.items()}):
        for name in ("k", "d", "n"):
            np.testing.assert_array_equal(other[name], want[name])
        np.testing.assert_allclose(other["s"], want["s"], rtol=REL)
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_allclose(host["m"], want["m"], rtol=1e-7)  # the device's max is f32


# ---------------------------------------------------------------------------
# (e) the per-bucket fused body and try_device_join_agg
# ---------------------------------------------------------------------------

_PER_BUCKET_CASES = {
    # name: (residual, dup right keys, left keys sorted, disjoint)
    "plain": (None, False, True, False),
    "residual": (lambda M: M.col("rv") < M.col("disc") * 300.0, False, True, False),
    "unsorted_left": (None, False, False, False),
    "dup": (None, True, True, False),
    "dup_residual": (lambda M: M.col("qty") > 12, True, False, False),
    "no_matches": (None, False, True, True),
}


@pytest.mark.parametrize("case", sorted(_PER_BUCKET_CASES))
def test_per_bucket_body_matches_jax(case):
    res, dup, l_sorted, disjoint = _PER_BUCKET_CASES[case]
    lk, rk, lcols, rcols = _body_inputs(len(case) + 40, 3000, 700, dup, disjoint)
    if not l_sorted:
        perm = np.random.default_rng(1).permutation(len(lk))
        lk, lcols = lk[perm], {c: a[perm] for c, a in lcols.items()}
    left_only = dup
    n_l, n_r = len(lk), len(rk)
    pad_l, pad_r = _pow2(n_l), _pow2(n_r)
    right_names = [] if left_only else ["rv"]
    left_names = ["disc", "price", "qty"]
    if res is not None and "rv" in repr(res(TX)):
        right_names = ["rv"]

    def padded(a, pad, fill=0):
        out = np.full(pad, fill, dtype=a.dtype)
        out[:len(a)] = a
        return out

    host = {"lk": padded(lk, pad_l), "rk": padded(rk, pad_r, np.iinfo(np.int32).max),
            "mask": padded(np.ones(n_l, bool), pad_l, False)}
    host.update({"l_" + c: padded(lcols[c], pad_l) for c in left_names})
    host.update({"r_" + c: padded(rcols[c], pad_r) for c in right_names})
    jkernel = jdj._build_kernel(_aggs(JX, left_only), [res(JX)] if res else [], left_names,
                                right_names, pad_r, dup)
    j_counts, j_outs = jkernel({**{k: jnp.asarray(v) for k, v in host.items()},
                                "n_r": jnp.int32(n_r)})
    body = tdj.per_bucket_join_body(_aggs(TX, left_only), [res(TX)] if res else [],
                                    left_names, right_names, pad_r, dup)
    dev_in = {k: torch.from_numpy(v) for k, v in host.items()}
    t_counts, t_outs = body({**dev_in, "n_r": n_r, "sorted": l_sorted})
    again = body({**dev_in, "n_r": n_r, "sorted": l_sorted})
    np.testing.assert_array_equal(again[0].numpy(), t_counts.numpy())
    for a, b in zip(again[1], t_outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())  # the same bits
    t_counts = t_counts.numpy()[:n_r]
    np.testing.assert_array_equal(t_counts, np.asarray(j_counts)[:n_r])
    assert (t_counts.sum() == 0) == disjoint
    if dup:
        assert t_counts.max() > 1 and (rk[1:] == rk[:-1]).any()
    keep = t_counts > 0
    for (kind, _c), got, want in zip(_aggs(TX, left_only), t_outs, j_outs):
        got, want = got.numpy()[:n_r][keep], np.asarray(want)[:n_r][keep]
        if kind in ("sum", "avg"):
            np.testing.assert_allclose(got, want, rtol=REL)
        else:
            np.testing.assert_array_equal(got, want)


def _agg_batches(seed: int, r_sorted: bool, dup: bool = False, key_dtype=np.int64):
    rng = np.random.default_rng(seed)
    n_l, n_r = 5000, 800
    lk = np.sort(rng.integers(0, 1200, n_l)).astype(key_dtype)
    rk = (rng.integers(0, 600, n_r) if dup else rng.permutation(1200)[:n_r]).astype(key_dtype)
    rk = np.sort(rk) if r_sorted else rk
    left = {"k": lk, "v": rng.uniform(0, 100, n_l), "q": rng.integers(1, 51, n_l)}
    right = {"rk": rk, "d": rng.integers(8000, 9000, n_r).astype(np.int32),
             "w": rng.uniform(0, 10, n_r)}
    out = []
    for Col, Batch in ((JColumn, JBatch), (TColumn, TBatch)):
        out.append((Batch({n: Col(a, str(a.dtype)) for n, a in left.items()}),
                    Batch({n: Col(a, str(a.dtype)) for n, a in right.items()})))
    return out


def _agg_plan(M, groups, aggs, lb, rb):
    from hyperspace_tpu.plan import nodes as jnodes
    from hyperspace_tpu_torch.plan import nodes as tnodes

    N = jnodes if M is JX else tnodes
    return N.Aggregate([M.col(g) for g in groups], aggs(M),
                       N.Join(N.InMemoryScan(lb), N.InMemoryScan(rb), M.col("k") == M.col("rk")))


_DEVICE_AGG_CASES = {
    # name: (groups, aggregates, residual, r_sorted, dup, declines)
    "key_groups": (["k"], lambda M: [M.Sum(M.col("v") * M.col("w")).alias("s"),
                                     M.Count(M.lit(1)).alias("n"),
                                     M.Max(M.col("q")).alias("m")], None, True, False, False),
    "right_group_unsorted": (["k", "d"], lambda M: [M.Avg(M.col("v")).alias("a"),
                                                    M.Min(M.col("w")).alias("lo")],
                             lambda M: M.col("d") < 8700, False, False, False),
    "dup_left_only": (["k"], lambda M: [M.Sum(M.col("v")).alias("s"),
                                        M.Count(M.lit(1)).alias("n")], None, True, True, False),
    "dup_right_ref": (["k"], lambda M: [M.Sum(M.col("v") * M.col("w")).alias("s")], None,
                      True, True, True),
    "int_sum": (["k"], lambda M: [M.Sum(M.col("q")).alias("s")], None, True, False, True),
}


@pytest.mark.parametrize("case", sorted(_DEVICE_AGG_CASES))
def test_try_device_join_agg_matches_jax(case, tmp_path):
    groups, aggs, res, r_sorted, dup, declines = _DEVICE_AGG_CASES[case]
    (jl, jr), (tl, tr) = _agg_batches(len(case), r_sorted, dup)
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={JC.EXEC_TPU_ENABLED: True})
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu")
    jres = [res(JX)] if res else []
    tres = [res(TX)] if res else []
    jout = jdj.try_device_join_agg(_agg_plan(JX, groups, aggs, jl, jr), jl, jr, ["k"], ["rk"],
                                   jres, js, r_sorted)
    tout = tdj.try_device_join_agg(_agg_plan(TX, groups, aggs, tl, tr), tl, tr, ["k"], ["rk"],
                                   tres, ts, r_sorted, True)
    if declines:
        assert jout is None and tout is None
        return
    want, got = jout.to_pydict(), tout.to_pydict()
    assert list(got) == list(want) and len(got["k"]) > 100
    for name in want:
        if name in ("s", "a"):
            np.testing.assert_allclose(got[name], want[name], rtol=REL)
        else:
            assert got[name] == want[name], name
    # the host twin agrees too (its sums in f64)
    host = tdj.try_host_join_agg(_agg_plan(TX, groups, aggs, tl, tr), tl, tr, ["k"], ["rk"],
                                 tres, ts, r_sorted)
    if host is not None:
        for name, vals in host.to_pydict().items():
            np.testing.assert_allclose(got[name], vals, rtol=REL)


def test_try_device_join_agg_declines_as_jax(tmp_path):
    """f64 keys and int64 keys past the int32 range stay on the host."""
    ts = T.HyperspaceSession(str(tmp_path / "t"), device="cpu")
    js = J.HyperspaceSession(str(tmp_path / "j"), conf={JC.EXEC_TPU_ENABLED: True})
    aggs = lambda M: [M.Count(M.lit(1)).alias("n")]  # noqa: E731
    for dtype, shift in ((np.float64, 0), (np.int64, 2**40)):
        (jl, jr), (tl, tr) = _agg_batches(3, True, key_dtype=dtype)
        for b in (jl, tl):
            b.columns["k"] = type(b.columns["k"])(b.columns["k"].data + shift, str(dtype.__name__))
        assert jdj.try_device_join_agg(_agg_plan(JX, ["k"], aggs, jl, jr), jl, jr, ["k"], ["rk"],
                                       [], js, True) is None
        assert tdj.try_device_join_agg(_agg_plan(TX, ["k"], aggs, tl, tr), tl, tr, ["k"], ["rk"],
                                       [], ts, True) is None


# ---------------------------------------------------------------------------
# (f) the routes over co-bucketed lakes: per-bucket, split, modes
# ---------------------------------------------------------------------------

def hex_rows(d: dict) -> str:
    return repr({k: [x.hex() if isinstance(x, float) else x for x in v] for k, v in d.items()})


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
def skew_agg_lake(tmp_path_factory):
    """40% of the left rows on one hot key; right keys only below 200."""
    rng = np.random.default_rng(101)
    n = 24_000
    k = rng.integers(0, 400, n)
    k[: int(n * 0.4)] = 7
    return _two_sided_lake(tmp_path_factory.mktemp("skew_agg"),
                           {"k": k, "p": rng.uniform(0, 100, n)},
                           {"rk": np.arange(200), "w": rng.uniform(size=200)})


def _agg_query(M, session, root, kind: str):
    left = session.read.parquet(str(root / "l")).select("k", "p")
    right = session.read.parquet(str(root / "r")).select("rk", "w")
    joined = left.join(right, M.col("k") == M.col("rk"))
    if kind == "sum":
        return joined.group_by("k").agg(M.Sum(M.col("p") * M.col("w")).alias("s"),
                                        M.Count(M.lit(1)).alias("n"))
    return joined.group_by("k").agg(M.Count(M.lit(1)).alias("n"), M.Min(M.col("p")).alias("lo"),
                                    M.Max(M.col("p")).alias("hi"))


def _run_both(root, kind, conf=None, spy_paths=None):
    from hyperspace_tpu.telemetry.metrics import REGISTRY

    splits0 = REGISTRY.counter("pipeline.join.splits").value
    js = J.HyperspaceSession(str(root / "wj"), conf={JC.EXEC_TPU_ENABLED: True, **(conf or {})})
    want = _agg_query(JX, js.enable_hyperspace(), root, kind).to_pydict()
    jsplits = REGISTRY.counter("pipeline.join.splits").value - splits0
    ts = T.HyperspaceSession(str(root / "wt"), conf=conf, device="cpu").enable_hyperspace()
    got = _agg_query(TX, ts, root, kind).to_pydict()
    return want, got, jsplits, ts.device_stats


def _assert_agg_match(got, want):
    assert list(got) == list(want) and len(got["k"]) > 0
    for name in want:
        if name == "s":
            np.testing.assert_allclose(got[name], want[name], rtol=REL)
        else:
            assert got[name] == want[name], name


@pytest.fixture
def device_grant(monkeypatch):
    """Sets both packages' device ledgers to a grant (MiB; "0" turns the
    ledger and the strategy plan off), and the default ones back after."""
    from hyperspace_tpu.serve import budget as jbudget
    from hyperspace_tpu_torch.serve import budget as tbudget

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
@pytest.mark.parametrize("kind,split_rows", [("span", "1024"), ("span", "5000"),
                                             ("sum", "1024")])
def test_set_split_rows_splits_the_stacked_join_as_jax(skew_agg_lake, monkeypatch, device_grant,
                                                       kind, split_rows, grant):
    """A set HYPERSPACE_JOIN_SPLIT_ROWS overrides the plan's split row
    count in the fused join (and is the count without a plan, at a grant
    of 0): count/min/max buckets split as often as the JAX package splits
    them; a sum never splits."""
    device_grant(grant)
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", split_rows)
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    want, got, jsplits, stats = _run_both(skew_agg_lake, kind)
    _assert_agg_match(got, want)
    assert stats.join_paths == {"stacked_agg": 1} and not stats.declines
    assert stats.join_splits == jsplits
    assert (jsplits > 0) == (kind == "span")
    # the unsplit run gives the same bits
    monkeypatch.delenv("HYPERSPACE_JOIN_SPLIT_ROWS")
    _w, unsplit, _j, ustats = _run_both(skew_agg_lake, kind)
    assert ustats.join_splits == 0 and hex_rows(unsplit) == hex_rows(got)


@pytest.mark.parametrize("kind", ["span", "sum"])
def test_pipeline_modes_of_the_stacked_join_give_the_same_bits(skew_agg_lake, monkeypatch,
                                                               kind):
    monkeypatch.setenv("HYPERSPACE_JOIN_SPLIT_ROWS", "2048")
    out = {}
    for mode in ("serial", "1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        want, out[mode], _j, stats = _run_both(skew_agg_lake, kind)
        assert stats.join_paths == {"stacked_agg": 1}
        assert stats.join_waves == (1 if mode == "0" else stats.join_waves)
    _assert_agg_match(out["1"], want)
    assert hex_rows(out["serial"]) == hex_rows(out["1"]) == hex_rows(out["0"])


@pytest.mark.parametrize("settings,jax_path", [
    ({"HYPERSPACE_PIPELINE": "0"}, "per_bucket"),
    ({"HYPERSPACE_PIPELINE": "1", "HYPERSPACE_DEVICE_BUDGET_MB": "0"}, "per_bucket"),
    ({"HYPERSPACE_PIPELINE": "1"}, "stacked_agg"),
])
@pytest.mark.parametrize("kind", ["span", "sum"])
def test_over_memory_join_takes_the_jax_packages_path(skew_agg_lake, monkeypatch, settings,
                                                      jax_path, kind):
    """Index bytes above maxBytesInMemory: the per-bucket flow under
    HYPERSPACE_PIPELINE=0 or with the device ledger off (each occupied
    bucket's fused join+aggregate on the device), the stacked join when it
    can run memory-adaptively; the path the JAX package's _log_join_exec
    names."""
    from hyperspace_tpu.serve import budget as jbudget
    from hyperspace_tpu_torch.serve import budget as tbudget

    for k, v in settings.items():
        monkeypatch.setenv(k, v)
    jbudget.reset_device_budget()
    tbudget.reset_device_budget()
    paths = []
    orig = jbj._log_join_exec
    monkeypatch.setattr(jbj, "_log_join_exec",
                        lambda s, l, r, path: paths.append(path) or orig(s, l, r, path))
    try:
        want, got, _j, stats = _run_both(skew_agg_lake, kind,
                                         conf={JC.BUILD_MAX_BYTES_IN_MEMORY: 1000})
    finally:
        monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB", raising=False)
        jbudget.reset_device_budget()
        tbudget.reset_device_budget()
    assert paths == [jax_path]
    _assert_agg_match(got, want)
    if jax_path == "per_bucket":
        # the four buckets are occupied on both sides
        assert stats.join_paths == {"per_bucket": 1, "per_bucket_device": 4}
        assert stats.declines == {"join_over_memory": 1}
        assert stats.device_join_fragments == 0
    else:
        assert stats.join_paths == {"stacked_agg": 1} and not stats.declines


def test_empty_and_disjoint_buckets_of_the_stacked_join(tmp_path_factory, monkeypatch):
    """Right keys in two buckets only, and a second lake whose keys are
    disjoint: the groups (or no group) the JAX package gives, on the device."""
    rng = np.random.default_rng(5)
    n = 12_000
    left = {"k": rng.integers(0, 64, n), "p": rng.uniform(0, 10, n)}
    sparse = _two_sided_lake(tmp_path_factory.mktemp("sparse"), left,
                             {"rk": np.array([3, 11]), "w": np.array([1.5, 2.5])})
    disjoint = _two_sided_lake(tmp_path_factory.mktemp("disjoint"), left,
                               {"rk": np.arange(100, 140), "w": rng.uniform(size=40)})
    for mode in ("1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        for root, keys in ((sparse, [3, 11]), (disjoint, [])):
            for kind in ("span", "sum"):
                want, got, _j, stats = _run_both(root, kind)
                assert sorted(got["k"]) == keys
                assert got == want if kind == "span" else list(got) == list(want)
                assert stats.device_join_fragments == 1 and not stats.declines


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "residual", "dup"])
def test_cuda_per_bucket_body_matches_the_cpu(cuda_device, case):
    """The per-bucket body on the card: counts, min and max equal the CPU
    run's, sums within relative 1e-4, and two card runs the same bits."""
    res, dup, l_sorted, _dis = _PER_BUCKET_CASES[case]
    lk, rk, lcols, rcols = _body_inputs(7, 50_000, 900, dup)  # unique keys below 1000
    pad_l, pad_r = _pow2(len(lk)), _pow2(len(rk))
    right_names = [] if dup else ["rv"]
    left_names = ["disc", "price", "qty"]

    def dev_in(device):
        def up(a, pad, fill=0):
            out = np.full(pad, fill, dtype=a.dtype)
            out[:len(a)] = a
            return torch.from_numpy(out).to(device)
        d = {"lk": up(lk, pad_l), "rk": up(rk, pad_r, np.iinfo(np.int32).max),
             "mask": up(np.ones(len(lk), bool), pad_l, False), "n_r": len(rk), "sorted": l_sorted}
        d.update({"l_" + c: up(lcols[c], pad_l) for c in left_names})
        d.update({"r_" + c: up(rcols[c], pad_r) for c in right_names})
        return d

    body = tdj.per_bucket_join_body(_aggs(TX, dup), [res(TX)] if res else [], left_names,
                                    right_names, pad_r, dup)
    cpu = body(dev_in("cpu"))
    card, again = body(dev_in(cuda_device)), body(dev_in(cuda_device))
    assert torch.equal(card[0], again[0]) and torch.equal(cpu[0], card[0].cpu())
    for (kind, _c), a, b, c in zip(_aggs(TX, dup), cpu[1], card[1], again[1]):
        assert torch.equal(b, c)
        if kind in ("sum", "avg"):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=REL)
        else:
            assert torch.equal(a, b.cpu())
