"""The bucket exchange of mesh-partitioned index builds (counterpart of
hyperspace_tpu/parallel/exchange.py).

Every shard holds a block of rows, computes each row's destination shard
from the shared hash (ops/hashing.py), and the exchange moves each row to
its destination: shard s's slot for destination d is copied to d's device
and concatenated there in source order, the reference's ``all_to_all``.

The reference's static-capacity contract is kept: each shard sends at most
``capacity`` rows to each destination, padded with a validity mask, and
the exchange also returns the true per-(source, destination) maximum, so
the host detects an overflow and runs again with the capacity grown to
the next power of two (``exchange_with_retry``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .mesh import SHARD_AXIS, Mesh, fold, shard_devices


def _exchange_body(n_dest: int, capacity: int, cols: dict, dest: torch.Tensor):
    """One shard's send side: cols maps names to [N] tensors, dest is [N]
    int32 in [0, n_dest). Returns ({name: [n_dest, capacity]}, valid
    [n_dest, capacity], the largest per-destination count)."""
    n = dest.shape[0]
    dev = dest.device
    # stable: rows keep their source order within a destination
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest[order].long(), minlength=n_dest)
    offsets = torch.cumsum(counts, 0) - counts
    max_count = counts.max()
    # slot (d, m) <- sorted row offsets[d] + m while m < counts[d]
    d_idx = torch.arange(n_dest, device=dev)[:, None]
    m_idx = torch.arange(capacity, device=dev)[None, :]
    valid = m_idx < counts[d_idx]
    src_pos = torch.clamp(offsets[d_idx] + m_idx, 0, n - 1)
    send = {name: col[order][src_pos] for name, col in cols.items()}
    return send, valid, max_count


def bucket_exchange(mesh: Mesh, cols: dict, dest: list, capacity: int,
                    axis: str = SHARD_AXIS):
    """Exchange rows so that every row with dest == d lands on shard d.

    cols maps names to per-shard tensors (one per shard, on its device);
    dest is the per-shard int32 destinations. Returns (cols_out, valid,
    overflow): each shard's cols_out and valid hold ``num_shards *
    capacity`` slots (valid marks real rows, source-major), and overflow is
    the true largest per-(source, destination) count as a 0-d tensor on the
    mesh's first device; above ``capacity`` the result is truncated and the
    caller must run again with a larger capacity."""
    devices = shard_devices(mesh, axis)
    n = len(devices)
    sends, valids, maxes = [], [], []
    for i in range(n):
        send, valid, mx = _exchange_body(n, capacity, {k: v[i] for k, v in cols.items()},
                                         dest[i])
        sends.append(send)
        valids.append(valid)
        maxes.append(mx)
    out: dict = {name: [] for name in cols}
    valid_out = []
    for d, dev in enumerate(devices):
        for name in cols:
            out[name].append(torch.cat([sends[s][name][d].to(dev.device) for s in range(n)]))
        valid_out.append(torch.cat([valids[s][d].to(dev.device) for s in range(n)]))
    return out, valid_out, fold(mesh, maxes, "max")


def exchange_with_retry(mesh: Mesh, cols: dict, dest: list, rows_per_shard: int,
                        axis: str = SHARD_AXIS):
    """Start from a balanced capacity guess and grow it to the next power
    of two on overflow (skewed buckets)."""
    from ..telemetry import trace
    from ..utils.rpc_meter import METER

    n = mesh.shape[axis]
    capacity = max(64, int(2 ** np.ceil(np.log2(max(1, 2 * rows_per_shard // n)))))
    while True:
        with trace.span("kernel:bucket_exchange", capacity=capacity):
            METER.record_dispatch()
            out, valid, overflow = bucket_exchange(mesh, cols, dest, capacity, axis)
            overflow = int(overflow)  # the blocking read, inside the span
        if overflow <= capacity:
            return out, valid
        capacity = int(2 ** np.ceil(np.log2(overflow)))


def _host(parts: list) -> np.ndarray:
    return np.concatenate([p.cpu().numpy() for p in parts])


def partition_batch_mesh(batch, bucket_columns, num_buckets: int, mesh: Mesh,
                         axis: str = SHARD_AXIS) -> Any:
    """The bucket partition of an index build, computed on the mesh: the
    key words shard across the devices, the bucket hash runs on each device
    with the host path's arithmetic, and the exchange moves (bucket, row
    id) pairs so shard s owns every bucket that is s modulo the shard count.

    Returns what ops.bucketize.partition_batch returns (per-bucket row
    indices in source order, so the sort and the write give the host
    path's layout byte for byte), or None when the batch cannot shard: a
    hierarchical mesh (rows never cross slices; the caller partitions per
    slice), fewer rows than shards, or rows lost in the exchange. Each None
    is logged; the caller counts it."""
    from ..ops.bucketize import key_hash_words
    from ..ops.hashing import _words_np, bucket_ids_torch
    from ..telemetry import trace
    from ..utils.rpc_meter import METER
    from .mesh import _log, is_hierarchical, shard_rows

    def decline(reason: str) -> None:
        _log.info("mesh partition declined (%s): the host partitions", reason)
        return None

    if is_hierarchical(mesh):
        return decline("hierarchical mesh")
    D = mesh.shape[axis]
    n = batch.num_rows
    if n < D:
        return decline("fewer rows than shards")
    padded = -(-n // D) * D

    def pad32(a: np.ndarray) -> np.ndarray:
        out = np.zeros(padded, np.int32)
        out[:n] = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
        return out

    # the host hash's words (int64 and float64 keys split in two, strings
    # hash by value), shipped as int32
    words: list[np.ndarray] = []
    for c in bucket_columns:
        for w in _words_np(np.asarray(key_hash_words(batch.column(c)))):
            words.append(pad32(w))
    row_id = np.full(padded, -1, np.int32)
    row_id[:n] = np.arange(n, dtype=np.int32)

    with trace.span("kernel:mesh_partition", rows=n, buckets=num_buckets):
        METER.record_upload(sum(w.nbytes for w in words) + row_id.nbytes, n=len(words) + 1)
        words_d = [shard_rows(mesh, w, axis) for w in words]
        row_d = shard_rows(mesh, row_id, axis)
        # each shipped word is one single-word hash column, in hash32_np's
        # word order, so the buckets are the host path's
        bucket_d = [bucket_ids_torch([w[i] for w in words_d], num_buckets)
                    for i in range(D)]
        dest_d = [b % D for b in bucket_d]
        out, valid = exchange_with_retry(mesh, {"b": bucket_d, "r": row_d}, dest_d,
                                         padded // D, axis)

    b_np, r_np = _host(out["b"]), _host(out["r"])
    sel = _host(valid) & (r_np >= 0)
    if int(sel.sum()) != n:
        return decline("rows lost in the exchange")  # a partial index is never written
    b_sel, r_sel = b_np[sel], r_np[sel]
    # stable by bucket: rows arrive shard-major and source-major, which is
    # their source order within each bucket
    order = np.argsort(b_sel, kind="stable")
    b_sorted, r_sorted = b_sel[order], r_sel[order].astype(np.int64)
    bounds = np.searchsorted(b_sorted, np.arange(num_buckets + 1))
    return [
        (b, r_sorted[bounds[b]: bounds[b + 1]])
        for b in range(num_buckets)
        if bounds[b + 1] > bounds[b]
    ]
