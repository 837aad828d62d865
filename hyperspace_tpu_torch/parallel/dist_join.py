"""Distributed co-partitioned probe over a device mesh (counterpart of
hyperspace_tpu/parallel/dist_join.py).

Both sides are bucketed on the join key, so each shard probes its own
bucket's left keys against its own bucket's sorted right keys, with no
traffic between devices: the bucketing already is the shuffle. One call
serves a wave of as many buckets as the mesh has shards. The probe (each
left row's lower bound and match count over the sorted right keys) runs on
the devices; the expansion into row pairs stays on the host, as in the
single-device plain join, so the rows equal the host merge join's.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import SHARD_AXIS, Mesh, shard_devices
from ..plan.kernel_cache import MESH_CACHE, mesh_probe_fingerprint

# the name the JAX package's tests and tools use for the probe cache
_PROBE_CACHE = MESH_CACHE


def _build_probe(mesh: Mesh, axis: str):
    """The per-shard probe: (lower bounds, match counts) of one bucket's
    sorted left keys over its sorted right keys, clamped to the real right
    rows (pads carry the dtype's maximum)."""

    def probe(lk: list, rk: list, n_r: list):
        lo_out, cnt_out = [], []
        for lk_s, rk_s, n_s in zip(lk, rk, n_r):
            lo = torch.minimum(torch.searchsorted(rk_s, lk_s, out_int32=True), n_s)
            hi = torch.minimum(torch.searchsorted(rk_s, lk_s, right=True, out_int32=True), n_s)
            lo_out.append(lo)
            cnt_out.append(hi - lo)
        return lo_out, cnt_out

    return probe


def mesh_join_probe(
    mesh: Mesh,
    lk_stack: np.ndarray,
    rk_stack: np.ndarray,
    n_r: np.ndarray,
    axis: str = SHARD_AXIS,
) -> tuple:
    """Probe a wave of co-partitioned buckets, one per shard.

    lk_stack: [S, padL] sorted left keys per bucket (padded with the dtype's
    maximum); rk_stack: [S, padR] sorted right keys; n_r: [S] real right
    row counts. Returns host (starts [S, padL], counts [S, padL]) int64."""
    from ..telemetry import trace
    from ..utils.rpc_meter import METER, device_get

    devices = shard_devices(mesh, axis)
    key = mesh_probe_fingerprint(id(mesh), axis, lk_stack.shape, rk_stack.shape,
                                 str(lk_stack.dtype))
    fn = MESH_CACHE.get_or_build(key, lambda: _build_probe(mesh, axis), "mesh_probe")
    with trace.span("kernel:mesh_join_probe", buckets=int(lk_stack.shape[0])):
        METER.record_upload(lk_stack.nbytes + rk_stack.nbytes + n_r.nbytes, n=3)
        METER.record_dispatch()
        n32 = n_r.astype(np.int32)
        lk = [torch.from_numpy(lk_stack[i].copy()).to(d.device)
              for i, d in enumerate(devices)]
        rk = [torch.from_numpy(rk_stack[i].copy()).to(d.device)
              for i, d in enumerate(devices)]
        nr = [torch.tensor(int(n32[i]), dtype=torch.int32, device=d.device)
              for i, d in enumerate(devices)]
        lo, cnt = device_get(fn(lk, rk, nr))
    return np.stack(lo).astype(np.int64), np.stack(cnt).astype(np.int64)
