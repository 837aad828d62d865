"""Bucket placement of the port (hyperspace_tpu_torch/ops/hashing.py,
ops/bucketize.py) is bit-identical to the JAX package's: the bucket layout
is part of the on-disk index contract shared by both packages."""

import numpy as np
import pytest

from hyperspace_tpu.columnar.table import Column as JColumn, ColumnBatch as JBatch
from hyperspace_tpu.ops import bucketize as jbucketize
from hyperspace_tpu.ops import hashing as jhashing
from hyperspace_tpu_torch.columnar.table import Column as TColumn, ColumnBatch as TBatch
from hyperspace_tpu_torch.ops import bucketize as tbucketize
from hyperspace_tpu_torch.ops import hashing as thashing


def _keys(kind: str, n: int, rng) -> np.ndarray:
    if kind == "int32":
        return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    if kind == "int64":
        return rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    if kind == "float64":
        return rng.normal(0, 1e6, n)
    raise ValueError(kind)


# sizes below and above 1024: the JAX package hashes large inputs in its
# native C++ kernel when that is built, small ones in numpy
@pytest.mark.parametrize("n", [7, 5000])
@pytest.mark.parametrize("kind", ["int32", "int64", "float64"])
def test_hash32_matches_reference(kind, n):
    keys = _keys(kind, n, np.random.default_rng(n))
    np.testing.assert_array_equal(thashing.hash32_np([keys]), jhashing.hash32_np([keys]))
    for buckets in (1, 8, 200):
        np.testing.assert_array_equal(
            thashing.bucket_ids_np([keys], buckets), jhashing.bucket_ids_np([keys], buckets)
        )


def test_multi_column_hash_matches_reference():
    rng = np.random.default_rng(3)
    cols = [_keys("int32", 3000, rng), _keys("float64", 3000, rng), _keys("int64", 3000, rng)]
    np.testing.assert_array_equal(thashing.hash32_np(cols), jhashing.hash32_np(cols))


@pytest.mark.parametrize("n", [5, 4096])
def test_string_and_mixed_key_buckets_match_reference(n):
    rng = np.random.default_rng(n)
    vocab = ["A", "N", "R", "Brand#12", "ünïcode", ""]
    strings = [vocab[i] for i in rng.integers(0, len(vocab), n)]
    dates = rng.integers(8035, 10590, n).astype(np.int32)
    t_batch = TBatch({"s": TColumn.from_values(strings), "d": TColumn(dates, "date32")})
    j_batch = JBatch({"s": JColumn.from_values(strings), "d": JColumn(dates, "date32")})
    for keys in (["s"], ["s", "d"], ["d", "s"]):
        np.testing.assert_array_equal(
            tbucketize.bucket_ids_for_batch(t_batch, keys, 8),
            jbucketize.bucket_ids_for_batch(j_batch, keys, 8),
        )


def test_partition_rows_match_reference():
    """Same rows in the same order per bucket: the index files of both
    packages hold the same data."""
    keys = np.random.default_rng(11).integers(8035, 10590, 50_000).astype(np.int32)
    t_parts = tbucketize.partition_batch(TBatch({"k": TColumn(keys, "int32")}), ["k"], 8)
    j_parts = jbucketize.partition_batch(JBatch({"k": JColumn(keys, "int32")}), ["k"], 8)
    assert [b for b, _ in t_parts] == [b for b, _ in j_parts]
    for (_, t_rows), (_, j_rows) in zip(t_parts, j_parts):
        np.testing.assert_array_equal(t_rows, j_rows)
