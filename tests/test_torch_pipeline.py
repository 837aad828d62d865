"""The pipelined tier: the port's chunk streamer and streaming executor
against the JAX package on the same inputs.

- ``plan_chunk_groups`` on a table of file sizes, and ``iter_chunks``: the
  chunks come in file order and concatenate to ``read_parquet``'s batch,
  with and without a row-group selection, overlapped and serial, equal to
  the JAX package's chunks; a corrupt file raises ``ChunkReadError``.
- ``scan_streamable`` and ``_stream_route`` on case tables: the JAX
  package's decisions.
- A TPC-H lake (40,000 lineitem rows, seed 3; the JAX package's index set
  with z-order ranges of 64 KB, so every index scan spans several files)
  with ``HYPERSPACE_STREAM_CHUNK_MB`` at 1 KB (a chunk per file): every
  query of ``TPCH_QUERIES`` and q6_count, q6_sum, q1_sums, q6_span and
  q1_span equal the JAX package's results, both pipelined, take the JAX
  package's route (its ``pipeline.queries`` counter against the port's
  ``pipelined_queries``), and give identical bits in the port under
  ``HYPERSPACE_PIPELINE`` = 1, serial and 0; a warm repeat uploads 0
  bytes; bucket-pair read-ahead equals the load-all barrier pair for pair.
- Declines and aborts on small raw lakes (nullable chunk, dtype drift
  between files, an int64 value beyond 32 bits, the string predicate on
  the concat route, a Wide64 literal): counted by reason, the JAX
  package's counts, and the results of the monolithic path.
- The grouped partial route orders groups by their first passing row over
  the whole scan, groups first seen in later chunks included.
- On the card (``cuda``-marked, skipped here): a streamed q6_count
  launches filter_weighted_sum once and gives the monolithic bits.

Tolerances: counts, integers and min/max exact; f32 sums within relative
1e-4; the port's modes against each other bit for bit.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpch as jtpch
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.plan import executor as jexec
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import tpu_exec as jtpu
from hyperspace_tpu.telemetry.metrics import REGISTRY
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.columnar.table import ColumnBatch
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import bucket_join as tbj
from hyperspace_tpu_torch.plan import executor as texec
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import gpu_exec as tgpu
from hyperspace_tpu_torch.plan.nodes import Join

REL = 1e-4
ROWS = 40_000
MODES = ("1", "serial", "0")


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """Keep the JAX package's process-wide query ledger from filling up
    for the test files a worker runs after this one."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


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


def _pipeline_queries() -> int:
    return REGISTRY.counter("pipeline.queries").value


# ---------------------------------------------------------------------------
# the chunk streamer
# ---------------------------------------------------------------------------

def _files(root, sizes, seed=0, nulls=False) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    os.makedirs(os.path.join(root, "t"), exist_ok=True)
    for i, n in enumerate(sizes):
        x = rng.uniform(0, 100, n)
        p = os.path.join(root, "t", f"part-{i:03d}.parquet")
        pq.write_table(pa.table({
            "k": rng.integers(0, 40, n),
            "x": pa.array(x, mask=(rng.random(n) < 0.1) if nulls else None),
            "s": rng.choice(["A", "B", "C"], n),
            "d": rng.integers(8000, 10000, n).astype(np.int32),
        }), p, row_group_size=700)
        paths.append(p)
    return paths


@pytest.mark.parametrize("target", [1, 20_000, 60_000, 10**9])
def test_plan_chunk_groups_equals_the_jax_packages(tmp_path, target):
    paths = _files(str(tmp_path), [300, 4000, 100, 2500, 2500, 50, 6000])
    paths.insert(3, os.path.join(str(tmp_path), "missing.parquet"))
    got = tio.plan_chunk_groups(paths, target)
    assert got == jio.plan_chunk_groups(paths, target)
    assert [p for g in got for p in g] == paths
    assert tio.count_chunk_groups(paths, target) == len(got)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("selected", [False, True], ids=["whole", "row_groups"])
def test_iter_chunks_concatenate_to_the_read(tmp_path, monkeypatch, selected, threads):
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", threads)
    paths = _files(str(tmp_path), [1500, 3000, 800, 2200, 1700])
    row_groups = {paths[1]: [0, 2, 4], paths[3]: [1]} if selected else None
    cols = ["k", "x", "s"]
    whole = tio.read_parquet(paths, cols, row_groups=row_groups)
    runs = {}
    for overlap in (True, False):
        chunks = list(tio.iter_chunks(paths, cols, overlap=overlap, row_groups=row_groups))
        assert [c.index for c in chunks] == list(range(len(chunks)))
        assert len(chunks) >= 3
        assert [p for c in chunks for p in c.paths] == paths
        assert all(c.decode_s >= 0 and c.nbytes > 0 for c in chunks)
        runs[overlap] = _bits(ColumnBatch.concat([c.batch for c in chunks]).to_pydict())
    assert runs[True] == runs[False] == _bits(whole.to_pydict())
    jchunks = list(jio.iter_chunks(paths, cols, row_groups=row_groups))
    assert [c.paths for c in jchunks] == [c.paths for c in
                                          tio.iter_chunks(paths, cols, row_groups=row_groups)]
    jcat = J.columnar.table.ColumnBatch.concat([c.batch for c in jchunks])
    assert _bits(jcat.to_pydict()) == runs[True]


def test_iter_chunks_share_the_chunk_cache(tmp_path, monkeypatch):
    """A repeat gets the cached buffers, read on the caller's thread: with
    every group cached there is nothing to decode ahead."""
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.02")
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    paths = _files(str(tmp_path), [1500, 3000, 800])
    cache = tio.IndexChunkCache(1 << 30)
    first = [c.batch.column("x").data for c in tio.iter_chunks(paths, ["x"], cache=cache)]
    assert len(first) == 3

    def no_pool(*a, **k):
        raise AssertionError("a warm stream started an IO pool")

    monkeypatch.setattr(tio, "io_pool", no_pool)
    again = [c.batch.column("x").data for c in tio.iter_chunks(paths, ["x"], cache=cache)]
    assert len(again) == 3 and all(a is b for a, b in zip(first, again))


@pytest.mark.parametrize("overlap", [True, False])
def test_chunk_read_error(tmp_path, monkeypatch, overlap):
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.001")
    paths = _files(str(tmp_path), [500, 500, 500])
    with open(paths[1], "wb") as f:
        f.write(b"not parquet")
    with pytest.raises(tio.ChunkReadError):
        list(tio.iter_chunks(paths, ["k"], overlap=overlap))
    with pytest.raises(jio.ChunkReadError):
        list(jio.iter_chunks(paths, ["k"], overlap=overlap))
    assert issubclass(tio.ChunkReadError, T.exceptions.HyperspaceError)


def test_global_budget_ledger(monkeypatch):
    from hyperspace_tpu_torch.serve import budget

    monkeypatch.setenv("HYPERSPACE_IO_BUDGET_MB", "1")
    monkeypatch.delenv("HYPERSPACE_GLOBAL_BUDGET_MB", raising=False)
    acct = budget.reset_global_budget()
    try:
        assert acct.max_bytes == tio.io_byte_budget() == 1 << 20
        s = acct.stream("scan")
        assert s.try_reserve(3 << 20)  # a stream holding nothing is granted
        assert not s.try_reserve(1)
        other = acct.stream("join")
        assert other.try_reserve(5)  # so is another one's first reservation
        s.release(3 << 20)
        assert s.try_reserve(10)
        s.close()
        other.close()
        assert acct.held_bytes() == 0
        monkeypatch.setenv("HYPERSPACE_GLOBAL_BUDGET_MB", "2")
        assert budget.reset_global_budget().max_bytes == 2 << 20
    finally:
        monkeypatch.delenv("HYPERSPACE_IO_BUDGET_MB")
        monkeypatch.delenv("HYPERSPACE_GLOBAL_BUDGET_MB")
        budget.reset_global_budget()


def test_concurrent_streams_share_the_cache_and_the_ledger(tmp_path, monkeypatch):
    """Twelve threads stream the same files through one chunk cache under a
    1 MB ledger, with a short switch interval: every stream gets the same
    batches, and the ledger drains."""
    import sys
    import threading

    from hyperspace_tpu_torch.serve import budget

    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.01")
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    monkeypatch.setenv("HYPERSPACE_GLOBAL_BUDGET_MB", "1")
    paths = _files(str(tmp_path), [900, 1800, 700, 1300, 1100, 600])
    acct = budget.reset_global_budget()
    cache = tio.IndexChunkCache(1 << 30)
    want = _bits(tio.read_parquet(paths, ["k", "x"]).to_pydict())
    got, errors = [], []

    def stream():
        try:
            chunks = list(tio.iter_chunks(paths, ["k", "x"], cache=cache))
            got.append(_bits(ColumnBatch.concat([c.batch for c in chunks]).to_pydict()))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=stream) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        monkeypatch.delenv("HYPERSPACE_GLOBAL_BUDGET_MB")
        budget.reset_global_budget()
    assert not errors and got == [want] * 12
    assert acct.held_bytes() == 0


# ---------------------------------------------------------------------------
# route decisions
# ---------------------------------------------------------------------------

# name: (filter, aggregates, group keys)
ROUTE_CASES = {
    "count_only": (lambda X: X.col("d") > 9000, lambda X: [X.Count(X.lit(1)).alias("n")], []),
    "min_max": (lambda X: X.col("d") > 9000,
                lambda X: [X.Min(X.col("x")).alias("lo"), X.Max(X.col("d")).alias("hi")], []),
    "int_sum": (lambda X: X.col("d") > 9000, lambda X: [X.Sum(X.col("k")).alias("sk")], []),
    "int_avg": (None, lambda X: [X.Avg(X.col("k") * X.lit(2)).alias("a")], ["s"]),
    "float_sum": (lambda X: X.col("d") > 9000, lambda X: [X.Sum(X.col("x")).alias("sx"),
                                                          X.Count(X.lit(1)).alias("n")], []),
    "float_avg": (None, lambda X: [X.Avg(X.col("x")).alias("a")], ["k"]),
    "div_avg": (None, lambda X: [X.Avg(X.col("k") / X.lit(2)).alias("a")], []),
    "string_pred_sum": (lambda X: X.col("s") == "B", lambda X: [X.Sum(X.col("x")).alias("sx")],
                        []),
    "string_pred_count": (lambda X: X.col("s") == "B",
                          lambda X: [X.Count(X.lit(1)).alias("n")], ["k"]),
    "wide_literal": (lambda X: X.col("k") < 2**40, lambda X: [X.Count(X.lit(1)).alias("n")],
                     []),
}


def _df(X, session, src, case):
    filt, aggs, keys = ROUTE_CASES[case]
    df = session.read.parquet(src)
    if filt is not None:
        df = df.filter(filt(X))
    if keys:
        return df.group_by(*keys).agg(*aggs(X))
    return df.agg(*aggs(X))


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_stream_route_equals_the_jax_packages(tmp_path, case):
    _files(str(tmp_path), [400, 400, 400])
    src = os.path.join(str(tmp_path), "t")
    jplan = _df(JX, J.HyperspaceSession(str(tmp_path / "wj")), src, case).plan
    tplan = _df(TX, T.HyperspaceSession(str(tmp_path / "wt"), device="cpu"), src, case).plan
    jfrag, tfrag = jtpu._match_fragment(jplan), tgpu._match_fragment(tplan)
    assert tgpu._stream_route(tfrag, tplan) == jtpu._stream_route(jfrag, jplan)
    assert jexec.scan_streamable(jfrag.scan) and texec.scan_streamable(tfrag.scan)


def _scan_cases(tmp_path):
    """name: (the JAX scan, the port's scan)."""
    _files(str(tmp_path), [400, 400, 400])
    src = os.path.join(str(tmp_path), "t")
    one = os.path.join(str(tmp_path), "one")
    os.makedirs(one)
    os.link(os.path.join(src, "part-000.parquet"), os.path.join(one, "part-000.parquet"))
    out = {}
    for name, root, pkg, X in (("jax", src, J, JX), ("torch", src, T, TX)):
        kw = {} if pkg is J else {"device": "cpu"}
        s = pkg.HyperspaceSession(str(tmp_path / f"w{name}"), **kw)
        base = s.read.parquet(root).plan
        onefile = s.read.parquet(one).plan
        out[name] = {
            "plain": base,
            "pushed_filter": base.copy(pushed_filter=X.col("d") > 9000),
            "lineage_filter": base.copy(lineage_filter_ids=[1]),
            "one_file": onefile,
            "no_files": base.copy(files=[]),
        }
    return {k: (out["jax"][k], out["torch"][k]) for k in out["jax"]}


def test_scan_streamable_equals_the_jax_packages(tmp_path):
    cases = _scan_cases(tmp_path)
    got = {k: texec.scan_streamable(t) for k, (_j, t) in cases.items()}
    assert got == {k: jexec.scan_streamable(j) for k, (j, _t) in cases.items()}
    assert got == {"plain": True, "pushed_filter": False, "lineage_filter": False,
                   "one_file": False, "no_files": False}


def test_scan_streamable_refuses_verify_mode(tmp_path, monkeypatch):
    (_j, scan), = [v for k, v in _scan_cases(tmp_path).items() if k == "plain"]
    spec = type("Spec", (), {"active": True, "verify_files": [1]})()
    monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
    assert not texec.scan_streamable(scan.copy(prune_spec=spec))
    monkeypatch.setenv("HYPERSPACE_PRUNE", "1")
    assert texec.scan_streamable(scan.copy(prune_spec=spec))


# ---------------------------------------------------------------------------
# TPC-H end to end
# ---------------------------------------------------------------------------

def _port_only(X, tpch):
    """q6_count, q6_sum, q1_sums, q6_span and q1_span written with one
    package's operators (the JAX package has none of them)."""

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


JQ = {**jtpch.TPCH_QUERIES, **_port_only(JX, jtpch)}
TQ = {**ttpch.TPCH_QUERIES, **_port_only(TX, ttpch)}
# the routes the TPC-H queries take over the lake below: pipelined
# fragments per run (the grouped and filter-aggregate index scans span
# several files; the joins' sides are not fragments)
STREAMED = {"q1": 1, "q3": 0, "q6": 1, "q10": 0, "q17": 1, "q18": 1, "q6_count": 1,
            "q6_sum": 1, "q1_sums": 1, "q6_span": 1, "q1_span": 1}


@pytest.fixture(scope="module")
def tpch_lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipe"))
    lake = os.path.join(root, "lake")
    jtpch.generate_tpch(lake, rows_lineitem=ROWS, seed=3)
    wh = os.path.join(root, "wh")
    s = J.HyperspaceSession(wh, conf={JC.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION: 64 * 1024})
    jtpch.tpch_indexes(s, J.Hyperspace(s), lake)
    return lake, wh


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.001")


def _torch_run(wh, lake, q, mode, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
    s = T.HyperspaceSession(wh, device="cpu").enable_hyperspace()
    out = TQ[q](s, lake).collect().to_pydict()
    return out, s.device_stats


@pytest.mark.parametrize("q", sorted(STREAMED))
def test_tpch_query_matches_the_jax_package_on_its_route(tpch_lake, small_chunks,
                                                         monkeypatch, q):
    lake, wh = tpch_lake
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    js = J.HyperspaceSession(wh, conf={JC.EXEC_TPU_ENABLED: True}).enable_hyperspace()
    before = _pipeline_queries()
    want = JQ[q](js, lake).collect().to_pydict()
    jax_streamed = _pipeline_queries() - before
    runs = {mode: _torch_run(wh, lake, q, mode, monkeypatch) for mode in MODES}
    got, stats = runs["1"]
    assert stats.pipelined_queries == jax_streamed == STREAMED[q], q
    assert stats.pipelined_chunks >= 3 * STREAMED[q]
    assert not stats.pipeline_aborts and not stats.pipeline_declines
    _assert_close(got, want, q)
    assert runs["serial"][1].pipelined_queries == STREAMED[q]
    assert runs["0"][1].pipelined_queries == 0
    assert _bits(runs["serial"][0]) == _bits(got) == _bits(runs["0"][0]), q


def test_stream_routes_of_the_main_queries(tpch_lake, small_chunks, monkeypatch):
    """q6 forms and q1_sums concatenate, the span forms fold partials; the
    scan timing names the route and adds up the chunks' decode seconds."""
    lake, wh = tpch_lake
    for q, route in (("q6_count", "concat"), ("q1_sums", "concat"), ("q6_span", "partial"),
                     ("q1_span", "partial")):
        _out, stats = _torch_run(wh, lake, q, "1", monkeypatch)
        t = stats.last_scan
        assert (t.route, t.stream) == ("pipelined", route), q
        assert t.chunks >= 3 and t.decode_s > 0 and t.upload.copies > 0
        assert t.upload.seconds() >= 0
    _out, stats = _torch_run(wh, lake, "q6_count", "0", monkeypatch)
    assert (stats.last_scan.route, stats.last_scan.stream) == ("device", None)


@pytest.mark.parametrize("q", ["q1", "q1_span", "q1_sums", "q6", "q6_count", "q6_span"])
def test_warm_repeat_uploads_nothing(tpch_lake, small_chunks, monkeypatch, q):
    lake, wh = tpch_lake
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    s = T.HyperspaceSession(wh, device="cpu").enable_hyperspace()
    first = TQ[q](s, lake).collect().to_pydict()
    up = s.device_cache.uploaded_bytes
    assert up > 0
    again = TQ[q](s, lake).collect().to_pydict()
    assert s.device_cache.uploaded_bytes == up
    assert _bits(again) == _bits(first)
    assert s.device_stats.pipelined_queries == 2


@pytest.mark.parametrize("overlap", [True, False])
def test_bucket_pair_read_ahead_equals_the_barrier(tpch_lake, monkeypatch, overlap):
    lake, wh = tpch_lake
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "3")
    s = T.HyperspaceSession(wh, device="cpu").enable_hyperspace()
    plan = ttpch.q3_agg(s, lake).optimized_plan()
    join = next(n for n in plan.preorder() if isinstance(n, Join))
    left, right = tbj._decompose_side(join.left), tbj._decompose_side(join.right)
    appended = (None, None)
    barrier = tbj._load_all_bucket_pairs(left, right, appended, s, raw=True)
    streamed = list(tbj._iter_bucket_pairs(left, right, appended, s, raw=True,
                                           overlap=overlap))
    assert [p[0] for p in streamed] == list(range(len(barrier)))
    for (_b, lb, rb, ls, rs), (wlb, wrb, wls, wrs) in zip(streamed, barrier):
        assert (ls, rs) == (wls, wrs)
        for got, want in ((lb, wlb), (rb, wrb)):
            assert _bits(got.to_pydict()) == _bits(want.to_pydict())
    from hyperspace_tpu_torch.serve import budget

    assert budget.global_budget().held_bytes() == 0


# ---------------------------------------------------------------------------
# declines and aborts on small raw lakes
# ---------------------------------------------------------------------------

def _raw_lake(root, files: list) -> str:
    src = os.path.join(root, "t")
    os.makedirs(src, exist_ok=True)
    for i, table in enumerate(files):
        pq.write_table(table, os.path.join(src, f"part-{i:03d}.parquet"))
    return src


def _tables(kind: str, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        n = 600
        k = rng.integers(0, 1000, n)
        x = rng.uniform(0, 10, n)
        s = rng.choice(["A", "B", "C"], n)
        xa = pa.array(x)
        ka = pa.array(k)
        if kind == "nullable" and i == 2:
            xa = pa.array(x, mask=rng.random(n) < 0.2)
        if kind == "dtype_drift" and i == 1:
            ka = pa.array(k.astype(np.int32))
        if kind == "int64_range" and i == 3:
            ka = pa.array(k + (1 << 40))
        out.append(pa.table({"k": ka, "x": xa, "s": s, "g": rng.integers(0, 5, n)}))
    return out


# name: (lake, query, (port counter, reason), JAX counter)
ABORTS = {
    "nullable_partial": ("nullable", lambda X, df: df.filter(X.col("k") < 500).agg(
        X.Count(X.lit(1)).alias("n"), X.Max(X.col("x")).alias("mx")),
        ("pipeline_aborts", "nullable"), "pipeline.aborted"),
    "nullable_concat": ("nullable", lambda X, df: df.filter(X.col("k") < 500).agg(
        X.Sum(X.col("x")).alias("sx"), X.Count(X.lit(1)).alias("n")),
        ("pipeline_aborts", "nullable"), "pipeline.aborted"),
    "dtype_drift": ("dtype_drift", lambda X, df: df.filter(X.col("k") < 500).agg(
        X.Sum(X.col("x")).alias("sx"), X.Count(X.lit(1)).alias("n")),
        ("pipeline_aborts", "dtype_drift"), "pipeline.aborted"),
    "int64_range": ("int64_range", lambda X, df: df.filter(X.col("k") < 500).agg(
        X.Count(X.lit(1)).alias("n"), X.Min(X.col("g")).alias("mg")),
        ("pipeline_aborts", "int64_range"), "pipeline.aborted"),
    "string_concat": ("plain", lambda X, df: df.filter(X.col("s") == "B").agg(
        X.Sum(X.col("x")).alias("sx"), X.Count(X.lit(1)).alias("n")),
        ("pipeline_declines", "string_concat"), "pipeline.declined"),
    "wide64": ("plain", lambda X, df: df.filter(X.col("k") < 2**40).agg(
        X.Count(X.lit(1)).alias("n")),
        ("pipeline_declines", "wide64"), "pipeline.declined"),
}


@pytest.mark.parametrize("case", sorted(ABORTS))
def test_decline_and_abort_reasons(tmp_path, small_chunks, monkeypatch, case):
    lake_kind, build, (counter, reason), jcounter = ABORTS[case]
    src = _raw_lake(str(tmp_path), _tables(lake_kind))
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    js = J.HyperspaceSession(str(tmp_path / "wj"), conf={JC.EXEC_TPU_ENABLED: True})
    before = REGISTRY.counter(jcounter).value
    want = build(JX, js.read.parquet(src)).collect().to_pydict()
    assert REGISTRY.counter(jcounter).value - before == 1
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        ts = T.HyperspaceSession(str(tmp_path / f"wt{mode}"), device="cpu")
        out[mode] = (build(TX, ts.read.parquet(src)).collect().to_pydict(), ts.device_stats)
    got, stats = out["1"]
    assert getattr(stats, counter) == {reason: 1} and stats.pipelined_queries == 0
    assert _bits(got) == _bits(out["0"][0])
    _assert_close(got, want, case)
    host = T.HyperspaceSession(str(tmp_path / "wh"), conf={T.constants.EXEC_TPU_ENABLED: False})
    _assert_close(got, build(TX, host.read.parquet(src)).collect().to_pydict(), case)


def test_string_predicate_streams_on_the_partial_route(tmp_path, small_chunks, monkeypatch):
    """Each chunk's dictionary codes: no abort, the monolithic bits."""
    src = _raw_lake(str(tmp_path), _tables("plain"))
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        ts = T.HyperspaceSession(str(tmp_path / f"wt{mode}"), device="cpu")
        df = _df(TX, ts, src, "string_pred_count")
        out[mode] = (df.collect().to_pydict(), ts.device_stats)
    assert out["1"][1].pipelined_queries == 1 and not out["1"][1].pipeline_aborts
    assert _bits(out["1"][0]) == _bits(out["0"][0])


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_source_scan_concat_keeps_nothing_on_the_device(tmp_path, small_chunks,
                                                        monkeypatch, grouped):
    """A source scan's chunk buffers are new on every read: the concat
    route uploads them again each run and caches none of them."""
    src = _raw_lake(str(tmp_path), _tables("plain"))
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    ts = T.HyperspaceSession(str(tmp_path / "wt"), device="cpu")

    def run():
        df = ts.read.parquet(src).filter(TX.col("k") < 500)
        if grouped:
            df = df.group_by("s")
        return df.agg(TX.Sum(TX.col("x")).alias("sx"), TX.Count(TX.lit(1)).alias("n")) \
            .collect().to_pydict()

    first = run()
    up = ts.device_cache.uploaded_bytes
    again = run()
    assert ts.device_stats.pipelined_queries == 2 and ts.device_stats.last_scan.chunks == 4
    assert ts.device_cache.uploaded_bytes == 2 * up > 0
    assert ts.device_cache.resident_bytes == 0
    assert _bits(again) == _bits(first)


def test_grouped_partial_orders_late_groups_by_first_passing_row(tmp_path, monkeypatch):
    """Group "z" first appears in the last file; group "y" appears in the
    first file but passes the filter only in the third: the output follows
    the first passing rows, as the monolithic assembly orders it."""
    def table(groups, vals):
        return pa.table({"g": groups, "v": np.asarray(vals, dtype=np.int64)})

    files = [
        table(["a", "y", "b", "y"], [5, 0, 7, 1]),
        table(["b", "a", "b", "a"], [9, 3, 4, 8]),
        table(["y", "a", "y", "b"], [6, 2, 9, 1]),
        table(["z", "y", "z", "a"], [8, 7, 5, 9]),
    ]
    src = _raw_lake(str(tmp_path), files)
    monkeypatch.setenv("HYPERSPACE_STREAM_CHUNK_MB", "0.0001")

    def build(X, s):
        return s.read.parquet(src).filter(X.col("v") > 4).group_by("g").agg(
            X.Count(X.lit(1)).alias("n"), X.Min(X.col("v")).alias("lo"),
            X.Max(X.col("v")).alias("hi"), X.Sum(X.col("v")).alias("sv"))

    out = {}
    for mode in MODES:
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        ts = T.HyperspaceSession(str(tmp_path / f"wt{mode}"), device="cpu")
        out[mode] = (build(TX, ts).collect().to_pydict(), ts.device_stats)
    got, stats = out["1"]
    assert stats.pipelined_queries == 1 and stats.pipelined_chunks == 4
    assert got["g"] == ["a", "b", "y", "z"]
    assert got == {"g": ["a", "b", "y", "z"], "n": [3, 2, 3, 2], "lo": [5, 7, 6, 5],
                   "hi": [9, 9, 9, 8], "sv": [22, 16, 22, 13]}
    assert _bits(out["serial"][0]) == _bits(got) == _bits(out["0"][0])
    monkeypatch.setenv("HYPERSPACE_PIPELINE", "1")
    js = J.HyperspaceSession(str(tmp_path / "wj"), conf={JC.EXEC_TPU_ENABLED: True})
    assert build(JX, js).collect().to_pydict() == got


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_streamed_q6_count_launches_its_kernel_once(tpch_lake, small_chunks,
                                                         monkeypatch, cuda_device):
    lake, wh = tpch_lake
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("HYPERSPACE_PIPELINE", mode)
        s = T.HyperspaceSession(wh).enable_hyperspace()  # the card
        before = dict(K.LAUNCHES)
        got = TQ["q6_count"](s, lake).collect().to_pydict()
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] > before[k]}
        out[mode] = (got, launched, s.device_stats)
    assert out["1"][2].pipelined_queries == 1 and out["1"][2].last_scan.stream == "concat"
    assert out["1"][1] == out["0"][1] == {"filter_weighted_sum": 1}
    assert _bits(out["1"][0]) == _bits(out["0"][0])
