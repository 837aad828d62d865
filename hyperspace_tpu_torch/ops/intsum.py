"""Exact integer summation on 32-bit device columns (counterpart of
hyperspace_tpu/ops/intsum.py).

Device columns are at most 32 bits wide (int64 is narrowed to int32 after a
range check), so an integer sum accumulated in int32 would wrap. Instead
v = b3*2^24 + b2*2^16 + b1*2^8 + b0 with b0..b2 in [0,256) and b3 in
[-128,128): each chunk's sum stays within int32 for up to 2^23 rows, and
the host recombines the chunks into int64 exactly. Fragments above the row
cap decline to the host, exactly where the JAX package declines.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_SUM_ROW_CAP = 1 << 23


def int_chunk_sums(v: torch.Tensor, seg: torch.Tensor | None = None, num_segments: int = 0):
    """Per-chunk int32 sums of an int32 vector: global (seg=None) or per
    segment. Integer sums are exact in any order, so the CUDA atomics
    behind ``index_add_`` are deterministic here."""
    v = v.to(torch.int32)
    chunks = (v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v >> 24)
    if seg is None:
        return tuple(c.sum(dtype=torch.int32) for c in chunks)
    return tuple(
        torch.zeros(num_segments, dtype=torch.int32, device=v.device).index_add_(0, seg, c)
        for c in chunks
    )


def combine_int_chunks(parts) -> np.ndarray:
    """Host-side exact recombination of chunk sums into int64."""
    total = np.zeros(np.asarray(parts[0]).shape, dtype=np.int64)
    for k, p in enumerate(parts):
        total += np.asarray(p).astype(np.int64) << (8 * k)
    return total
