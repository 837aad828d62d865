"""Bucketize: hash rows to buckets (counterpart of
hyperspace_tpu/ops/bucketize.py, host path).

From 1024 rows up the partition is the native library's counting sort
(native/hs_native.cpp); ``stable_argsort`` sorts one int key within a
bucket by the native radix argsort from 4096 keys up. Below those sizes,
and as the plain versions the tests hold the kernels against, the numpy
forms run: they give the same rows in the same order.
"""

from __future__ import annotations

import numpy as np

from .hashing import bucket_ids_np, hash32_np, string_key_words
from ..columnar.table import Column, ColumnBatch, STRING

_NATIVE_PARTITION_MIN_ROWS = 1024
_NATIVE_SORT_MIN_ROWS = 4096  # numpy's argsort is quicker at small sizes


def key_hash_words(col: Column) -> np.ndarray:
    """Hash-input words for a column; strings hash by value (not code)."""
    if col.dtype == STRING:
        return string_key_words(col.data, col.dictionary)
    return col.data


def bucket_ids_for_batch(
    batch: ColumnBatch, bucket_columns: list[str], num_buckets: int
) -> np.ndarray:
    return bucket_ids_np(
        [key_hash_words(batch.column(c)) for c in bucket_columns], num_buckets
    )


def partition_batch(
    batch: ColumnBatch, bucket_columns: list[str], num_buckets: int
) -> list[tuple[int, np.ndarray]]:
    """Row indices per non-empty bucket, ordered by bucket id; rows keep
    their source order within a bucket."""
    from .. import native

    hashes = hash32_np([key_hash_words(batch.column(c)) for c in bucket_columns])
    if batch.num_rows < _NATIVE_PARTITION_MIN_ROWS:
        return partition_plain(hashes, num_buckets)
    _ids, order, offsets = native.bucket_partition(hashes, num_buckets)
    return [(b, order[offsets[b]: offsets[b + 1]])
            for b in range(num_buckets) if offsets[b + 1] > offsets[b]]


def partition_plain(hashes: np.ndarray, num_buckets: int) -> list[tuple[int, np.ndarray]]:
    """The numpy form of ``partition_batch`` over the rows' hashes: a stable
    argsort of the bucket ids."""
    ids = (hashes % np.uint32(num_buckets)).astype(np.int32)
    order = np.argsort(ids, kind="stable")
    boundaries = np.searchsorted(ids[order], np.arange(num_buckets + 1))
    return [
        (b, order[boundaries[b]: boundaries[b + 1]])
        for b in range(num_buckets)
        if boundaries[b + 1] > boundaries[b]
    ]


def stable_argsort(key: np.ndarray) -> np.ndarray:
    """Stable argsort of one sort key: the native radix argsort for int64
    and int32 keys from 4096 up, numpy's otherwise (the same order)."""
    from .. import native

    if key.dtype in (np.int64, np.int32) and len(key) >= _NATIVE_SORT_MIN_ROWS:
        return native.radix_argsort(key)
    return np.argsort(key, kind="stable")
