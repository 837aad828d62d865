"""Bucketize: hash rows to buckets (counterpart of
hyperspace_tpu/ops/bucketize.py, host path)."""

from __future__ import annotations

import numpy as np

from .hashing import bucket_ids_np, string_key_words
from ..columnar.table import Column, ColumnBatch, STRING


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
    ids = bucket_ids_for_batch(batch, bucket_columns, num_buckets)
    order = np.argsort(ids, kind="stable")
    boundaries = np.searchsorted(ids[order], np.arange(num_buckets + 1))
    return [
        (b, order[boundaries[b]: boundaries[b + 1]])
        for b in range(num_buckets)
        if boundaries[b + 1] > boundaries[b]
    ]
