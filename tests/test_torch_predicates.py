"""The fragment executor's string and Wide64 predicates and the host
reader's arrow filter (hyperspace_tpu_torch/plan/gpu_exec.py, plan/passes.py),
held against the JAX package (hyperspace_tpu/plan/tpu_exec.py, passes.py)
on the same seeded inputs:

- ``_encode_string_predicates`` of both packages on a table of expressions
  (Eq and Ne either way round, IN, values absent from the dictionary, And,
  Or, Not, a string column compared with another column): the same
  rewritten expression, or None in both;
- global and grouped fragments whose filter compares string columns with
  string literals: the port's device tier (on the CPU) runs them, with no
  decline, through the kernel where the shape has one, and returns the
  JAX package's results;
- Wide64: the two-word compare of both packages against numpy's int64
  compares over random and boundary values and literals; fragments over a
  full-range int64 column run on the device tier and equal the JAX
  package's; a wide column that feeds an aggregate declines to the host;
- ``to_arrow_filter`` of both packages renders the same pyarrow
  expressions, and host reads of source files with it give the JAX
  package's results.

Tolerances: counts and keys exact; f32 sums within relative 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.columnar.table import Schema as JSchema
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import passes as jpasses
from hyperspace_tpu.plan import tpu_exec
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.columnar.table import Schema as TSchema
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import gpu_exec
from hyperspace_tpu_torch.plan import passes as tpasses

REL = 1e-4
PKGS = {"jax": (J, JC, JX), "torch": (T, TC, TX)}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """This module's JAX queries must not leave the JAX package's
    process-wide query ledger full for the modules run after it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _close(got, want):
    for g, w in zip(got, want):
        if w is None or g is None:
            assert g == w
        elif isinstance(w, float):
            assert abs(g - w) <= REL * abs(w), (g, w)
        else:
            assert g == w, (g, w)


def _same_results(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name])
        _close(got[name], want[name])


# ---------------------------------------------------------------------------
# string predicates
# ---------------------------------------------------------------------------

_DICT_S = ["aa", "bb", "cc"]
_DICT_T = ["x", "y"]


def _string_batches():
    rng = np.random.default_rng(5)
    codes_s = rng.integers(0, 3, 64).astype(np.int32)
    codes_t = rng.integers(0, 2, 64).astype(np.int32)
    ints = rng.integers(0, 100, 64)
    out = []
    for Col, Batch in ((JColumn, JBatch), (TColumn, TBatch)):
        out.append(Batch({"s": Col(codes_s, "string", None, list(_DICT_S)),
                          "t": Col(codes_t, "string", None, list(_DICT_T)),
                          "i": Col(ints, "int64")}))
    return out


ENCODE_CASES = {
    "eq": lambda X: X.col("s") == "bb",
    "eq_flipped": lambda X: X.Eq(X.lit("cc"), X.col("s")),
    "ne": lambda X: X.col("s") != "aa",
    "eq_absent": lambda X: X.col("s") == "zz",
    "ne_absent": lambda X: X.col("s") != "zz",
    "in": lambda X: X.col("s").isin(["aa", "zz", "cc"]),
    "in_absent": lambda X: X.col("s").isin(["zz", "qq"]),
    "and_int": lambda X: (X.col("s") == "aa") & (X.col("i") > 30),
    "or_two_cols": lambda X: (X.col("s") == "bb") | (X.col("t") != "y"),
    "not": lambda X: X.Not(X.col("t") == "x"),
    "column_vs_column": lambda X: X.col("s") == X.col("t"),
    "no_strings": lambda X: X.col("i") < 7,
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_string_predicates_equals_the_jax_rewrite(case):
    jb, tb = _string_batches()
    scols = {"s", "t"}
    want = tpu_exec._encode_string_predicates(ENCODE_CASES[case](JX), jb, scols)
    got = gpu_exec._encode_string_predicates(ENCODE_CASES[case](TX), tb, scols)
    assert repr(got) == repr(want)
    if case == "column_vs_column":
        assert got is None


def _write(columns: dict, path: str):
    """One parquet source file, written by the JAX package."""
    jio.write_parquet(JBatch.from_pydict(columns), path)


@pytest.fixture(scope="module")
def flags_lake(tmp_path_factory):
    """12,000 seeded rows in three files: string flag and status columns,
    a float price and discount, an int quantity."""
    root = str(tmp_path_factory.mktemp("flags"))
    rng = np.random.default_rng(17)
    for i in range(3):
        n = 4000
        _write({
            "flag": rng.choice(["A", "N", "R"], n).tolist(),
            "status": rng.choice(["F", "O"], n).tolist(),
            "price": rng.uniform(900.0, 105000.0, n).tolist(),
            "disc": np.round(rng.uniform(0.0, 0.1, n), 2).tolist(),
            "q": rng.integers(1, 51, n).tolist(),
        }, os.path.join(root, "t", f"part-{i}.parquet"))
    return root


STRING_QUERIES = {
    # filter_sum's shape
    "flag_sum": (lambda X, d: d.filter(X.col("flag") == "R").agg(
        X.Sum(X.col("price")).alias("s"), X.Count(X.lit(1)).alias("n")), "filter_sum"),
    # filter_weighted_sum's shape, Ne and an int conjunct
    "ne_weighted": (lambda X, d: d.filter((X.col("flag") != "N") & (X.col("q") < 30)).agg(
        X.Sum(X.col("price") * X.col("disc")).alias("s"),
        X.Count(X.lit(1)).alias("n")), "filter_weighted_sum"),
    # a value absent from the dictionary: no row matches
    "absent": (lambda X, d: d.filter(X.col("flag") == "Z").agg(
        X.Sum(X.col("price")).alias("s"), X.Count(X.lit(1)).alias("n")), "filter_sum"),
    # the generic body: min, max and avg
    "generic": (lambda X, d: d.filter(X.col("status").isin(["O"])).agg(
        X.Min(X.col("price")).alias("lo"), X.Max(X.col("q")).alias("hi"),
        X.Avg(X.col("disc")).alias("a")), None),
    # grouped on a string key, string IN in the filter: the grouped kernel
    "grouped": (lambda X, d: d.filter(X.col("flag").isin(["A", "R"]))
                .group_by("status").agg(X.Sum(X.col("price")).alias("s"),
                                        X.Count(X.lit(1)).alias("n")),
                "filter_grouped_multi_sum"),
    # grouped on the string column the predicate compares
    "grouped_same_col": (lambda X, d: d.filter((X.col("flag") != "A") & (X.col("q") > 10))
                         .group_by("flag").agg(X.Sum(X.col("disc")).alias("s"),
                                               X.Count(X.lit(1)).alias("n")),
                         "filter_grouped_multi_sum"),
}


def _jax_device_session(root):
    s = J.HyperspaceSession(os.path.join(root, "wh_j"))
    s.set_conf(JC.EXEC_TPU_ENABLED, True)
    return s


@pytest.mark.parametrize("q", sorted(STRING_QUERIES))
def test_string_predicate_fragments_run_on_the_device_as_jax(q, flags_lake):
    build, kernel = STRING_QUERIES[q]
    src = os.path.join(flags_lake, "t")
    js = _jax_device_session(flags_lake)
    want = build(JX, js.read.parquet(src)).collect().to_pydict()
    ts = T.HyperspaceSession(os.path.join(flags_lake, "wh_t"), device="cpu")
    before = dict(K.PLAIN_CALLS)
    got = build(TX, ts.read.parquet(src)).collect().to_pydict()
    assert ts.device_stats.device_fragments == 1 and not ts.device_stats.declines
    launched = {k for k in K.PLAIN_CALLS if K.PLAIN_CALLS[k] > before[k]}
    assert launched == ({kernel} if kernel else set())
    _same_results(got, want)


# ---------------------------------------------------------------------------
# Wide64
# ---------------------------------------------------------------------------

_SPECIALS = np.array([0, 1, -1, 2**31, -(2**31), 2**31 - 1, 2**32, -(2**32), 2**32 - 1,
                      2**62, -(2**62), 2**63 - 1, -(2**63)], dtype=np.int64)
_OPS = {"Eq": np.equal, "Ne": np.not_equal, "Lt": np.less, "Le": np.less_equal,
        "Gt": np.greater, "Ge": np.greater_equal}


def test_wide64_compares_as_numpy_and_jax():
    import jax.numpy as jnp
    from hyperspace_tpu.ops.hashing import split64_np

    rng = np.random.default_rng(12)
    vals = np.concatenate([rng.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64), _SPECIALS])
    lo, hi = split64_np(vals)
    jw = tpu_exec.Wide64(jnp.asarray(hi), jnp.asarray(lo.view(np.uint32)))
    thi, tlo = gpu_exec._wide_words(vals)
    tw = gpu_exec.Wide64(torch.from_numpy(thi), torch.from_numpy(tlo))
    lits = np.concatenate([rng.integers(-(2**63), 2**63 - 1, 24, dtype=np.int64), _SPECIALS])
    for lit in lits:
        for op, npop in _OPS.items():
            got = tw.compare(getattr(TX, op), int(lit)).numpy()
            np.testing.assert_array_equal(got, npop(vals, lit), err_msg=f"{op} {lit}")
            np.testing.assert_array_equal(got, np.asarray(jw.compare(getattr(JX, op), int(lit))))


@pytest.fixture(scope="module")
def wide_lake(tmp_path_factory):
    """tests/test_tpu_exec.py's Wide64 table: full-range int64 ``w`` with
    planted boundary values and a float ``x``, seed 6, 8,000 rows."""
    root = str(tmp_path_factory.mktemp("wide"))
    rng = np.random.default_rng(6)
    n = 8000
    wide = rng.integers(-(2**62), 2**62, n)
    wide[0], wide[1], wide[2] = 2**40 + 7, -(2**40) - 7, 2**31
    _write({"w": wide.tolist(), "x": rng.uniform(0, 10, n).tolist(),
               "g": rng.integers(0, 4, n).tolist()},
           os.path.join(root, "t", "p.parquet"))
    return root


WIDE_QUERIES = {
    "eq_count": (lambda X, d: d.filter(X.col("w") == 2**40 + 7).agg(
        X.Count(X.lit(1)).alias("n")), None),
    "gt_sum": (lambda X, d: d.filter(X.col("w") > 2**40).agg(
        X.Sum(X.col("x")).alias("s"), X.Count(X.lit(1)).alias("n")), "filter_sum"),
    "range": (lambda X, d: d.filter((X.col("w") >= -(2**40) - 7) & (X.col("w") <= 2**31)).agg(
        X.Count(X.lit(1)).alias("n")), None),
    "ne_flipped": (lambda X, d: d.filter(X.Ne(X.lit(2**31), X.col("w"))).agg(
        X.Count(X.lit(1)).alias("n")), None),
    "grouped": (lambda X, d: d.filter(X.col("w") < -(2**50)).group_by("g").agg(
        X.Sum(X.col("x")).alias("s"), X.Count(X.lit(1)).alias("n")),
        "filter_grouped_multi_sum"),
}


@pytest.mark.parametrize("q", sorted(WIDE_QUERIES))
def test_wide64_fragments_run_on_the_device_as_jax(q, wide_lake):
    build, kernel = WIDE_QUERIES[q]
    src = os.path.join(wide_lake, "t")
    want = build(JX, _jax_device_session(wide_lake).read.parquet(src)).collect().to_pydict()
    ts = T.HyperspaceSession(os.path.join(wide_lake, "wh_t"), device="cpu")
    before = dict(K.PLAIN_CALLS)
    got = build(TX, ts.read.parquet(src)).collect().to_pydict()
    assert ts.device_stats.device_fragments == 1 and not ts.device_stats.declines
    launched = {k for k in K.PLAIN_CALLS if K.PLAIN_CALLS[k] > before[k]}
    assert launched == ({kernel} if kernel else set())
    _same_results(got, want)


def test_a_wide_column_in_an_aggregate_declines_to_the_host(wide_lake):
    src = os.path.join(wide_lake, "t")

    def q(X, s):
        return s.read.parquet(src).filter(X.col("w") > 0).agg(
            X.Sum(X.col("w")).alias("s"), X.Count(X.lit(1)).alias("n"))

    want = q(JX, _jax_device_session(wide_lake)).collect().to_pydict()
    ts = T.HyperspaceSession(os.path.join(wide_lake, "wh_t"), device="cpu")
    got = q(TX, ts).collect().to_pydict()
    assert ts.device_stats.device_fragments == 0
    assert ts.device_stats.declines == {"nullable_or_out_of_range": 1}
    assert got == want  # the host's exact int64 sum


def test_wide_and_narrow_uploads_of_one_buffer_are_cached_apart():
    data = np.array([2**40, -5, 7], dtype=np.int64)
    ts = T.HyperspaceSession(".", device="cpu")
    batch = TBatch({"w": TColumn(data, "int64")})
    wide = gpu_exec._upload_columns(batch, {"w"}, 1024, ts, torch.device("cpu"),
                                    frozenset({"w"}))
    assert isinstance(wide["w"], tuple)
    narrow_batch = TBatch({"w": TColumn(data[1:], "int64")})
    narrow = gpu_exec._upload_columns(narrow_batch, {"w"}, 1024, ts, torch.device("cpu"),
                                      frozenset({"w"}))
    assert isinstance(narrow["w"], torch.Tensor)  # in range: narrowed
    from hyperspace_tpu_torch.plan.kernel_cache import dtype_signature

    assert dtype_signature(wide) != dtype_signature(narrow)


# ---------------------------------------------------------------------------
# the host reader's arrow filter
# ---------------------------------------------------------------------------

_ARROW_SCHEMA = [{"name": "d", "type": "date32"}, {"name": "i", "type": "int64"},
                 {"name": "f", "type": "float64"}, {"name": "s", "type": "string"}]

ARROW_CASES = {
    "range": lambda X: (X.col("i") >= 3) & (X.lit(10) > X.col("i")),
    "date": lambda X: (X.col("d") >= 8766) & (X.col("d") < 9131),
    "in": lambda X: X.col("s").isin(["a", "c"]),
    "date_in": lambda X: X.col("d").isin([8766, 9000]),
    "or": lambda X: (X.col("f") < 1.5) | (X.col("s") == "b"),
    "or_untranslatable": lambda X: (X.col("f") < 1.5) | (X.col("f") > X.col("i")),
    "not_null_and_ne": lambda X: X.col("s").is_not_null() & (X.col("i") != 4),
    "unknown_column": lambda X: X.col("zz") == 1,
}


@pytest.mark.parametrize("case", sorted(ARROW_CASES))
def test_to_arrow_filter_renders_as_jax(case):
    want = jpasses.to_arrow_filter(ARROW_CASES[case](JX), JSchema.from_list(_ARROW_SCHEMA))
    got = tpasses.to_arrow_filter(ARROW_CASES[case](TX), TSchema.from_list(_ARROW_SCHEMA))
    assert str(got) == str(want)


HOST_SCAN_QUERIES = {
    "date_range": lambda X, d: d.filter((X.col("l_shipdate") >= 8766)
                                        & (X.col("l_shipdate") < 8900))
    .select("l_orderkey", "l_shipdate", "l_tax"),
    "string_in_or": lambda X, d: d.filter(X.col("l_returnflag").isin(["R"])
                                          | (X.col("l_quantity") < 3))
    .select("l_orderkey", "l_returnflag", "l_quantity"),
    "agg": lambda X, d: d.filter((X.col("l_orderkey") > 1000) & (X.col("l_discount") >= 0.05))
    .agg(X.Sum(X.col("l_extendedprice")).alias("s"), X.Count(X.lit(1)).alias("n")),
}


@pytest.fixture(scope="module")
def tpch_lake(tmp_path_factory):
    from hyperspace_tpu.benchmark import tpch as jtpch

    root = str(tmp_path_factory.mktemp("tpch_pred"))
    jtpch.generate_tpch(root, rows_lineitem=6000, seed=3)
    return root


@pytest.mark.parametrize("q", sorted(HOST_SCAN_QUERIES))
def test_host_source_reads_with_the_arrow_filter_equal_jax(q, tpch_lake):
    """The device tier off on both sides: the host reads the source files
    through the pushed filter."""
    li = os.path.join(tpch_lake, "lineitem")
    out = {}
    for name, (pkg, C, X) in PKGS.items():
        kw = {} if pkg is J else {"device": "cpu"}
        s = pkg.HyperspaceSession(os.path.join(tpch_lake, f"wh_{name}"),
                                  conf={C.EXEC_TPU_ENABLED: False}, **kw)
        df = HOST_SCAN_QUERIES[q](X, s.read.parquet(li))
        scans = [n for n in df.optimized_plan().preorder() if n.kind == "FileScan"]
        assert scans[0].pushed_filter is not None
        out[name] = df.collect().to_pydict()
    _same_results(out["torch"], out["jax"])


# ---------------------------------------------------------------------------
# on the card: the string and Wide64 routes launch the CUDA kernels and
# equal the port's CPU run of the same fragments
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _card_and_cpu(root, build, src):
    """(results, launched kernels) of the fragment on the card and on the
    CPU."""
    out = {}
    for name, device in (("cpu", "cpu"), ("card", None)):  # None: the card
        ts = T.HyperspaceSession(os.path.join(root, f"wh_{name}"), device=device)
        before = dict(K.LAUNCHES)
        got = build(TX, ts.read.parquet(src)).collect().to_pydict()
        assert ts.device_stats.device_fragments == 1 and not ts.device_stats.declines
        out[name] = (got, {k for k in K.LAUNCHES if K.LAUNCHES[k] > before[k]})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("q", sorted(STRING_QUERIES))
def test_cuda_string_predicate_fragments_match_the_cpu(q, flags_lake, cuda_device):
    build, kernel = STRING_QUERIES[q]
    out = _card_and_cpu(flags_lake, build, os.path.join(flags_lake, "t"))
    assert out["card"][1] == ({kernel} if kernel else set())
    _same_results(out["card"][0], out["cpu"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("q", sorted(WIDE_QUERIES))
def test_cuda_wide64_fragments_match_the_cpu(q, wide_lake, cuda_device):
    build, kernel = WIDE_QUERIES[q]
    out = _card_and_cpu(wide_lake, build, os.path.join(wide_lake, "t"))
    assert out["card"][1] == ({kernel} if kernel else set())
    _same_results(out["card"][0], out["cpu"][0])
