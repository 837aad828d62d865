"""The port's native host kernels (hyperspace_tpu_torch/native) held against
the port's numpy forms and the JAX package's numpy forms on the same
numpy-seeded inputs.

- ``hash32`` and ``hash32_words`` against ``ops/hashing.hash32_plain`` and
  the JAX ``hash32_np`` with its native library switched off: exact, for
  int64, int32, float64, string words and several columns at once.
- ``bucket_partition`` against ``partition_plain`` and the JAX
  ``partition_batch`` (numpy form): the same rows in the same order.
- ``radix_argsort`` against numpy's stable argsort: exact, ties, negatives
  and extreme values included.
- ``join_i64`` against ``join_codes_plain`` and the JAX ``join_indices``
  (numpy form): the same pairs in numpy's order, NULL codes never matching.
- ``probe_agg_i64`` against ``np.bincount``: counts and sums exact.
- The call sites take the native kernels at the reference's sizes (1024
  rows for hashing and partitioning, 4096 for the radix sort and the host
  join) and the covering index files stay byte for byte the JAX package's;
  the host twin's native probe gives the numpy form's bits.
- The build: at first use into build/native/, a failed build raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import native as jnative
from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.ops import bucketize as jbucketize
from hyperspace_tpu.ops import hashing as jhashing
from hyperspace_tpu.plan import executor as jexecutor
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.exceptions import NativeError
from hyperspace_tpu_torch.ops import bucketize, hashing
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import executor
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan.nodes import Aggregate, InMemoryScan, Join

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_numpy_forms(monkeypatch):
    """The JAX package with its native library switched off: every entry
    point returns None, so its callers take their numpy forms."""
    for name in ("hash32", "hash32_words", "bucket_partition", "radix_argsort", "join_i64",
                 "probe_agg_i64"):
        monkeypatch.setattr(jnative, name, lambda *a, **k: None)


def _keys(seed: int, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    if n >= 4:
        a[:4] = [info.min, info.max, 0, -1]
    return a


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("n", [1024, 5000, 100_003])
def test_hash32_matches_the_numpy_forms(dtype, n, jax_numpy_forms):
    keys = _keys(n, n, dtype)
    got = native.hash32(keys)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, hashing.hash32_plain([keys]))
    np.testing.assert_array_equal(got, jhashing.hash32_np([keys]))
    np.testing.assert_array_equal(hashing.hash32_np([keys]), got)


def _word_columns(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    vocab = [f"v{i}" for i in range(37)]
    return [
        _keys(seed, n, np.int64),
        rng.normal(size=n),
        hashing.string_key_words(rng.integers(0, len(vocab), n), vocab),
        rng.integers(-300, 300, n).astype(np.int16),
        rng.integers(0, 2, n).astype(bool),
        rng.normal(size=n).astype(np.float32),
    ]


@pytest.mark.parametrize("cols", [(1,), (2,), (0, 1), (0, 2, 3), (4, 5, 0)])
def test_hash32_words_matches_the_numpy_forms(cols, jax_numpy_forms):
    columns = [_word_columns(7, 20_000)[i] for i in cols]
    words = [w for c in columns for w in hashing._words_np(c)]
    got = native.hash32_words(words)
    np.testing.assert_array_equal(got, hashing.hash32_plain(columns))
    np.testing.assert_array_equal(got, jhashing.hash32_np(columns))
    np.testing.assert_array_equal(hashing.hash32_np(columns), got)


@pytest.mark.parametrize("num_buckets", [1, 8, 200])
@pytest.mark.parametrize("n", [1024, 50_000])
def test_bucket_partition_matches_the_numpy_forms(num_buckets, n, jax_numpy_forms):
    keys = _keys(num_buckets + n, n, np.int64)
    hashes = hashing.hash32_plain([keys])
    ids, order, offsets = native.bucket_partition(hashes, num_buckets)
    np.testing.assert_array_equal(ids, (hashes % np.uint32(num_buckets)).astype(np.int32))
    got = [(b, order[offsets[b]:offsets[b + 1]]) for b in range(num_buckets)
           if offsets[b + 1] > offsets[b]]
    batch_t = TBatch({"k": TColumn(keys, "int64")})
    batch_j = JBatch({"k": JColumn(keys, "int64")})
    for other in (bucketize.partition_plain(hashes, num_buckets),
                  jbucketize.partition_batch(batch_j, ["k"], num_buckets),
                  bucketize.partition_batch(batch_t, ["k"], num_buckets)):
        assert [b for b, _ in other] == [b for b, _ in got]
        for (_b, want), (_b2, rows) in zip(other, got):
            np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("case", ["i64", "i64_ties", "i32", "i32_neg", "sorted", "equal"])
def test_radix_argsort_is_numpys_stable_order(case):
    rng = np.random.default_rng(3)
    n = 40_000
    keys = {
        "i64": _keys(1, n, np.int64),
        "i64_ties": rng.integers(0, 50, n).astype(np.int64) * (2**40),
        "i32": _keys(2, n, np.int32),
        "i32_neg": rng.integers(-1000, 1000, n).astype(np.int32),
        "sorted": np.arange(n, dtype=np.int64),
        "equal": np.full(n, 7, dtype=np.int32),
    }[case]
    got = native.radix_argsort(keys)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(bucketize.stable_argsort(keys), got)


@pytest.mark.parametrize("seed,n_l,n_r,hi", [(1, 5000, 300, 200), (2, 20_000, 20_000, 5000),
                                             (3, 4096, 1, 3), (4, 6000, 0, 10)])
def test_join_matches_numpy_pair_order(seed, n_l, n_r, hi, jax_numpy_forms):
    rng = np.random.default_rng(seed)
    lcodes = rng.integers(0, hi, n_l).astype(np.int64)
    rcodes = rng.integers(0, hi, n_r).astype(np.int64)
    lcodes[::97] = -1  # NULL codes never match, each other included
    rcodes[::89] = -2
    li, ri = native.join_i64(lcodes, rcodes)
    pl, pr = executor.join_codes_plain(lcodes, rcodes)
    np.testing.assert_array_equal(li, pl)
    np.testing.assert_array_equal(ri, pr)
    # the executor's join_indices, native in the port, numpy in the JAX package
    lb = {"k": lcodes.astype(np.float64)}
    rb = {"k": rcodes.astype(np.float64)}
    tout = executor.join_indices(TBatch({n: TColumn(a, "float64") for n, a in lb.items()}),
                                 TBatch({n: TColumn(a, "float64") for n, a in rb.items()}),
                                 ["k"], ["k"])
    jout = jexecutor.join_indices(JBatch({n: JColumn(a, "float64") for n, a in lb.items()}),
                                  JBatch({n: JColumn(a, "float64") for n, a in rb.items()}),
                                  ["k"], ["k"])
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)


def test_join_grows_its_pair_buffer():
    """More pairs than either side has rows: the first call reports the
    total, the retry returns every pair."""
    lcodes = np.zeros(3000, np.int64)
    rcodes = np.zeros(2000, np.int64)
    li, ri = native.join_i64(lcodes, rcodes)
    assert len(li) == 6_000_000
    np.testing.assert_array_equal(li[:2001], np.repeat([0, 1], [2000, 1]))
    np.testing.assert_array_equal(ri[:2001], np.r_[np.arange(2000), 0])


@pytest.mark.parametrize("w", [0, 1, 3])
def test_probe_agg_matches_bincount(w):
    rng = np.random.default_rng(w)
    rk = np.unique(rng.integers(-500, 5000, 900)).astype(np.int64)
    lk = rng.integers(-600, 5200, 30_000).astype(np.int64)
    weights = [rng.normal(size=len(lk)) * 1e3 for _ in range(w)]
    counts, sums = native.probe_agg_i64(lk, rk, weights)
    pos = np.clip(np.searchsorted(rk, lk), 0, len(rk) - 1)
    found = rk[pos] == lk
    np.testing.assert_array_equal(counts, np.bincount(pos[found], minlength=len(rk)))
    assert len(sums) == w
    for s, x in zip(sums, weights):
        np.testing.assert_array_equal(s, np.bincount(pos[found], weights=x[found],
                                                     minlength=len(rk)))


def test_call_sites_take_the_native_kernels_at_the_reference_sizes():
    native.reset_counts()
    small = _keys(5, 1023, np.int64)
    hashing.hash32_np([small])
    bucketize.stable_argsort(_keys(5, 4095, np.int64))
    bucketize.partition_batch(TBatch({"k": TColumn(small, "int64")}), ["k"], 8)
    assert not any(native.CALLS.values())
    big = _keys(6, 4096, np.int64)
    hashing.hash32_np([big])
    hashing.hash32_np([big, big.astype(np.float64)])
    bucketize.stable_argsort(big)
    bucketize.partition_batch(TBatch({"k": TColumn(big, "int64")}), ["k"], 8)
    lb = TBatch({"k": TColumn(big % 100, "int64")})
    executor.join_indices(lb, lb.take(np.arange(50)), ["k"], ["k"])
    assert native.CALLS == {"hash32": 2, "hash32_words": 1, "bucket_partition": 1,
                            "radix_argsort": 1, "join_i64": 1, "probe_agg_i64": 0}


def test_covering_index_files_stay_the_jax_packages(tmp_path, jax_numpy_forms):
    """A covering index built by the port (native partition and radix sort)
    and by the JAX package (numpy forms) from the same source: the same
    bucket files, byte for byte."""
    from hyperspace_tpu_torch.columnar import io as cio

    rng = np.random.default_rng(9)
    n = 30_000
    cio.write_parquet(TBatch({
        "k": TColumn(rng.integers(-10**12, 10**12, n), "int64"),
        "d": TColumn(rng.integers(0, 900, n).astype(np.int32), "int32"),
        "v": TColumn(rng.normal(size=n), "float64"),
    }), str(tmp_path / "src" / "p.parquet"))
    native.reset_counts()
    files = {}
    for pkg, name, kw in ((J, "jax", {}), (T, "torch", {"device": "cpu"})):
        session = pkg.HyperspaceSession(str(tmp_path / name), **kw)
        hs = pkg.Hyperspace(session)
        df = session.read.parquet(str(tmp_path / "src"))
        hs.create_index(df, pkg.CoveringIndexConfig("by_k", ["k"], ["v"]))
        hs.create_index(df, pkg.CoveringIndexConfig("by_d", ["d"], ["k"]))
        files[name] = {
            idx: {os.path.basename(f): open(f, "rb").read()
                  for f in hs.get_index(idx).content.files()}
            for idx in ("by_k", "by_d")
        }
    assert native.CALLS["bucket_partition"] >= 2 and native.CALLS["radix_argsort"] >= 2
    assert files["torch"] == files["jax"]
    assert all(len(v) > 1 for v in files["torch"].values())


@pytest.mark.parametrize("aggs", ["sum_count", "avg", "int_sum"])
def test_host_twin_native_probe_matches_its_numpy_form(aggs, tmp_path, monkeypatch):
    rng = np.random.default_rng(12)
    n_l, n_r = 20_000, 3000
    lb = TBatch({"k": TColumn(rng.integers(0, 4000, n_l), "int64"),
                 "v": TColumn(rng.uniform(0, 100, n_l), "float64"),
                 "q": TColumn(rng.integers(1, 50, n_l), "int64")})
    rk = np.sort(rng.permutation(4000)[:n_r]).astype(np.int64)
    rb = TBatch({"rk": TColumn(rk, "int64"), "d": TColumn(rng.integers(0, 9, n_r), "int64")})
    agg_exprs = {
        "sum_count": [TX.Sum(TX.col("v")).alias("s"), TX.Count(TX.lit(1)).alias("n")],
        "avg": [TX.Avg(TX.col("v") * TX.lit(2.0)).alias("a")],
        "int_sum": [TX.Sum(TX.col("q")).alias("s"), TX.Count(TX.lit(1)).alias("n")],
    }[aggs]
    agg = Aggregate([TX.col("k"), TX.col("d")], agg_exprs,
                    Join(InMemoryScan(lb), InMemoryScan(rb), TX.col("k") == TX.col("rk")))
    session = T.HyperspaceSession(str(tmp_path), device="cpu")
    native.reset_counts()
    got = tdj.try_host_join_agg(agg, lb, rb, ["k"], ["rk"], [], session, True).to_pydict()
    assert native.CALLS["probe_agg_i64"] == 1
    monkeypatch.setattr(tdj, "_native_probe_agg", lambda *a, **k: None)
    want = tdj.try_host_join_agg(agg, lb, rb, ["k"], ["rk"], [], session, True).to_pydict()
    assert list(got) == list(want) and len(got["k"]) > 100
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


def test_build_goes_to_build_native_and_a_failure_raises(tmp_path, monkeypatch):
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == __import__("pathlib").Path(REPO) / "build" / "native"
    assert path.exists()
    # a compiler that fails: NativeError with its output, and no library
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", [])
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(NativeError, match="failed"):
        native.hash32(np.arange(10, dtype=np.int64))
    assert not list((tmp_path / "b").glob("*.so"))
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-compiler"))
    with pytest.raises(NativeError, match="cannot run"):
        native.build()


def test_concurrent_builds_race_safely(tmp_path):
    """Processes that build the library at once into an empty directory
    each load a whole library and agree on the hash."""
    code = (
        "import sys, pathlib, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from hyperspace_tpu_torch import native\n"
        f"native.BUILD_DIR = pathlib.Path({str(tmp_path / 'race')!r})\n"
        "print(int(native.hash32(np.arange(5000, dtype=np.int64)).sum()))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want = str(int(hashing.hash32_plain([np.arange(5000, dtype=np.int64)]).sum()))
    assert outs == [want] * 3
    assert len(list((tmp_path / "race").glob("*.so"))) == 1
    assert not list((tmp_path / "race").glob("*.tmp"))


def test_bindings_reject_inputs_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        native.bucket_partition(np.zeros(10, np.uint32), 0)
    with pytest.raises(ValueError):
        native.hash32_words([np.zeros(10, np.uint32), np.zeros(9, np.uint32)])
    with pytest.raises(ValueError):
        native.probe_agg_i64(np.zeros(10, np.int64), np.arange(3), [np.zeros(9)])
    with pytest.raises(TypeError):
        native.radix_argsort(np.zeros(10, np.float64))
    with pytest.raises(TypeError):
        native.hash32(np.zeros(10, np.int16))
