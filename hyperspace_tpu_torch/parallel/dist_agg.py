"""Distributed filter-aggregate over a device mesh (counterpart of
hyperspace_tpu/parallel/dist_agg.py).

The columns live sharded across the mesh, one row block per shard; each
shard runs the filter and the aggregate on its own device, and the
partials fold on the mesh's first device (parallel/mesh.fold: within each
slice first on a hierarchical mesh). Only group-sized vectors cross
between devices, never rows.

Within a shard the grouped body is the single-device one's
(plan/gpu_exec.py): ``_segment_sum`` for float sums, ``_first_masked_rows``
for each group's first passing row, integer sums exact as 8-bit chunk sums
(ops/intsum.py). First rows are global row indices, the shard's index
times the shard length plus the local row, so the assembly orders groups
as the host tier does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh import Mesh, fold, mesh_row_axes, num_shards, shard_devices, shard_rows
from ..ops.intsum import int_chunk_sums

_BIG = 2**31 - 1  # a group's first row when no row passed


def _row_axis(mesh: Mesh, axis):
    """The data axis: explicit, or every axis of the mesh."""
    return axis if axis is not None else mesh_row_axes(mesh)


def distributed_filter_aggregate(
    mesh: Mesh,
    cols: dict,
    mask: list,
    pred_fn: Callable,
    agg_fns: dict,
    axis=None,
) -> dict:
    """pred_fn and per-shard reductions on every shard, summed over shards.

    cols maps names to per-shard tensors, mask is the per-shard valid-row
    masks; pred_fn(cols) -> bool tensor; agg_fns maps a name to
    fn(cols, final_mask) -> a 0-d partial. Returns {name: the folded 0-d
    tensor} on the mesh's first device."""
    from ..telemetry import trace
    from ..utils.rpc_meter import METER

    axis = _row_axis(mesh, axis)
    n = len(shard_devices(mesh, axis))
    with trace.span("kernel:dist_filter_agg", aggs=len(agg_fns)):
        METER.record_dispatch()
        partials: dict = {name: [] for name in agg_fns}
        for i in range(n):
            shard = {k: v[i] for k, v in cols.items()}
            m = mask[i] & pred_fn(shard)
            for name, fn in agg_fns.items():
                partials[name].append(fn(shard, m))
        return {name: fold(mesh, parts, "sum") for name, parts in partials.items()}


def _fold_out(mesh: Mesh, kind: str, parts: list):
    if isinstance(parts[0], tuple):  # exact int chunk sums, chunk by chunk
        return tuple(fold(mesh, [p[k] for p in parts], "sum") for k in range(len(parts[0])))
    return fold(mesh, parts, {"min": "min", "max": "max"}.get(kind, "sum"))


def build_distributed_grouped_kernel(
    mesh: Mesh,
    pred_fn: Callable | None,
    agg_list: list,
    seg_pad: int,
    axis=None,
):
    """The mesh kernel of a grouped aggregate (callers cache it): every
    shard segment-reduces its rows (group ids are global, factorized on
    the host), then the per-group partials fold over the shards. A global
    aggregate is the one-group case.

    agg_list: (kind, value_fn(cols) -> vals) with kind in
    sum/count/min/max/avg. The kernel takes per-shard lists (cols as
    {name: [tensor per shard]}, gids, mask) and returns (counts,
    first_masked, tuple(outputs)) on the mesh's first device; first_masked
    is each group's first passing row as a global row index."""
    from ..plan.gpu_exec import (_as_column, _extreme, _first_masked_rows, _is_int,
                                 _segment_sum)

    axis = _row_axis(mesh, axis)
    n_shards = len(shard_devices(mesh, axis))

    def body(shard_idx: int, cols, gids, mask):
        m = mask
        if pred_fn is not None:
            m = m & pred_fn(cols)
        g = torch.where(m, gids, seg_pad - 1)
        seg = g.long()
        counts = torch.bincount(seg, minlength=seg_pad).to(torch.int32)
        local = _first_masked_rows(m, g, seg_pad)
        # global row index = shard index * shard length + local row
        first = torch.where(local == _BIG, local, local + shard_idx * g.shape[0])
        out = []
        for kind, fn in agg_list:
            if kind == "count":
                out.append(None)
                continue
            vals = _as_column(fn(cols), m)
            if kind in ("sum", "avg") and _is_int(vals):
                # exact: 8-bit chunk sums, each within int32 under the
                # caller's 2^23-row cap, recombined into int64 on the host
                out.append(int_chunk_sums(vals, seg, seg_pad))
            elif kind in ("sum", "avg"):
                out.append(_segment_sum(vals, g, seg_pad))
            else:
                init = torch.full((seg_pad,), _extreme(vals.dtype, kind == "min"),
                                  dtype=vals.dtype, device=vals.device)
                out.append(init.scatter_reduce(0, seg, vals,
                                               "amin" if kind == "min" else "amax"))
        return counts, first, out

    def kernel(cols: dict, gids: list, mask: list):
        parts = [body(i, {k: v[i] for k, v in cols.items()}, gids[i], mask[i])
                 for i in range(n_shards)]
        counts = fold(mesh, [p[0] for p in parts], "sum")
        first = fold(mesh, [p[1] for p in parts], "min")
        out = []
        for j, (kind, _fn) in enumerate(agg_list):
            if kind == "count":
                out.append(counts)
                continue
            v = _fold_out(mesh, kind, [p[2][j] for p in parts])
            if kind == "avg" and not isinstance(v, tuple):
                v = v / torch.clamp(counts, min=1)
            out.append(v)
        return counts, first, tuple(out)

    return kernel


def shard_columns(mesh: Mesh, cols: dict, axis=None) -> tuple:
    """Pad to a multiple of the shard count and place each column's row
    blocks on their shards. Returns (cols, mask), both per-shard lists."""
    from ..utils.rpc_meter import METER

    axis = _row_axis(mesh, axis)
    n = len(next(iter(cols.values())))
    d = num_shards(mesh, axis)
    padded = -(-n // d) * d
    out = {}
    nbytes = 0
    for name, arr in cols.items():
        a = np.asarray(arr)
        out[name] = shard_rows(mesh, a, axis)
        nbytes += a.itemsize * padded
    mask = shard_rows(mesh, np.arange(padded) < n, axis)
    METER.record_upload(nbytes + padded, n=len(out) + 1)
    return out, mask
