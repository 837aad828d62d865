"""Join building blocks for the co-partitioned, shuffle-free path
(counterpart of hyperspace_tpu/ops/join.py).

Both sides of a JoinIndexRule rewrite arrive hash-bucketed on the join keys
with the same bucket count, so bucket b joins only bucket b; within a
bucket, rows are sorted by key, and the match structure comes from two
searchsorted passes. The host helpers are numpy; the device primitives are
torch over tensors of any device.
"""

from __future__ import annotations

import numpy as np
import torch


def exact_key32(a: np.ndarray):
    """Exact 32-bit device representation of a key column that decides a
    result's structure (join matches, sort order), or None: int64 within the
    int32 range casts, narrower ints widen, f32 passes unless it holds a
    NaN, and f64 always declines (a lossy downcast could collapse distinct
    keys)."""
    if a.dtype == np.int64:
        if len(a) and (a.min() < -(2**31) or a.max() >= 2**31):
            return None
        return a.astype(np.int32)
    if a.dtype in (np.int32, np.int16, np.int8):
        return a.astype(np.int32)
    if a.dtype == np.float32:
        return None if np.isnan(a).any() else a
    return None


def merge_match_counts(left_keys_sorted: torch.Tensor, right_keys_sorted: torch.Tensor):
    """For each left row: (first match position, number of right matches).
    Both inputs sorted ascending."""
    lo = torch.searchsorted(right_keys_sorted, left_keys_sorted, side="left")
    hi = torch.searchsorted(right_keys_sorted, left_keys_sorted, side="right")
    return lo, hi - lo


def segment_sum_by_sorted_key(keys_sorted: torch.Tensor, values: torch.Tensor,
                              unique_keys: torch.Tensor) -> torch.Tensor:
    """Sum ``values`` per key of a sorted key column, aligned with the
    sorted ``unique_keys`` (a prefix-sum difference)."""
    starts = torch.searchsorted(keys_sorted, unique_keys, side="left")
    ends = torch.searchsorted(keys_sorted, unique_keys, side="right")
    csum = torch.cat([torch.zeros(1, dtype=values.dtype, device=values.device),
                      torch.cumsum(values, 0, dtype=values.dtype)])
    return csum[ends] - csum[starts]


def lookup_sorted(table_keys_sorted: torch.Tensor, table_values: torch.Tensor,
                  queries: torch.Tensor, default):
    """Exact-match gather: for each query key, the table value of its first
    match, or ``default``; also the found mask."""
    pos = torch.searchsorted(table_keys_sorted, queries, side="left")
    pos_c = torch.clamp(pos, 0, table_keys_sorted.shape[0] - 1)
    found = table_keys_sorted[pos_c] == queries
    return torch.where(found, table_values[pos_c], default), found


def expand_runs(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Expand [start_i, start_i + count_i) runs into one index array."""
    total = int(counts.sum())
    cum = (
        np.concatenate([[0], np.cumsum(counts)[:-1]])
        if len(counts)
        else np.empty(0, np.int64)
    )
    within = np.arange(total, dtype=np.int64) - np.repeat(cum, counts)
    return np.repeat(starts, counts) + within


def host_merge_join_indices(left_sorted: np.ndarray, right_sorted: np.ndarray):
    """Host merge join on sorted keys -> (left_idx, right_idx)."""
    starts = np.searchsorted(right_sorted, left_sorted, side="left")
    ends = np.searchsorted(right_sorted, left_sorted, side="right")
    counts = ends - starts
    li = np.repeat(np.arange(len(left_sorted)), counts)
    return li, expand_runs(starts, counts)
