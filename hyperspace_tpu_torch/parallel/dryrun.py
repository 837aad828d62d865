"""``dryrun_multigpu(n)``: the multi-device tier's dry run (counterpart of
``__graft_entry__.dryrun_multichip``), in five steps:

1. a distributed index build: keys hash to shards on the devices, the
   bucket exchange moves them, and every shard sorts what it received;
2. a co-partitioned join and aggregate with no exchange: each shard joins
   its rows to the dimension keys it holds, and the partials fold;
3. a grouped query through the session's mesh route (meshDevices = n),
   float and exact integer sums and averages;
4. the mesh plain join of two covering indexes bucketed on the key;
5. the grouped integer query over a (2, n/2) hierarchical mesh.

It runs over ``n`` real devices when that many exist, else over
``virtual_devices(n, device)`` (one card, or the CPU), as the reference's
dry run runs over the host devices XLA fakes.

    python -m hyperspace_tpu_torch.parallel.dryrun [n] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import tempfile

import numpy as np
import torch


def dryrun_multigpu(n_devices: int, device=None) -> dict:
    """Run the five steps over ``n_devices`` devices and check each; the
    returned dict names the devices and what each step saw. ``device`` is
    the torch device of a virtual mesh (default: the card when there is
    one, else the CPU)."""
    from .mesh import visible_devices, virtual_devices

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    real = len(visible_devices()) >= n_devices
    ctx = contextlib.nullcontext() if real else virtual_devices(n_devices, device)
    with ctx:
        return _run(n_devices, device, real)


def _run(n_devices: int, device, real: bool) -> dict:
    from .dist_join import _PROBE_CACHE
    from .exchange import bucket_exchange
    from .mesh import Mesh, SHARD_AXIS, fold, shard_rows, visible_devices
    from ..ops.hashing import bucket_ids_torch
    from ..ops.join import lookup_sorted, segment_sum_by_sorted_key

    devices = visible_devices()[:n_devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    mesh = Mesh(grid, (SHARD_AXIS,))
    D = len(devices)
    rows, capacity = D * 64, 64
    report: dict = {"devices": [repr(d) for d in devices], "real": real}

    # ---- step 1: distributed index build (hash, exchange, sort per shard)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1000, rows).astype(np.int32)
    payload = rng.uniform(size=rows).astype(np.float32)
    keys_d = shard_rows(mesh, keys)
    pay_d = shard_rows(mesh, payload)
    dest = [bucket_ids_torch([k], D) for k in keys_d]
    out, valid, _ovf = bucket_exchange(mesh, {"k": keys_d, "p": pay_d}, dest, capacity)
    sorted_shards = []
    for k, p, v in zip(out["k"], out["p"], valid):
        order = torch.argsort(torch.where(v, k, 2**31 - 1), stable=True)
        sorted_shards.append((k[order], p[order], v[order]))
    got_rows = sum(int(v.sum()) for v in valid)
    assert got_rows == rows, f"the exchange lost rows: {got_rows} of {rows}"
    report["build_rows"] = got_rows

    # ---- step 2: co-partitioned join + aggregate, no exchange
    dim_keys = np.arange(D * capacity, dtype=np.int32).reshape(D, capacity)
    dim_vals = (dim_keys * 2).astype(np.float32)
    partials = []
    for i, (k, p, v) in enumerate(sorted_shards):
        dk = torch.from_numpy(dim_keys[i]).to(devices[i].device)
        dv = torch.from_numpy(dim_vals[i]).to(devices[i].device)
        sums = segment_sum_by_sorted_key(k, torch.where(v, p, 0.0), dk)
        joined, found = lookup_sorted(dk, dv, dk, 0.0)
        partials.append(torch.where(found, sums * joined, 0.0).sum())
    total = float(fold(mesh, partials, "sum"))
    assert np.isfinite(total)
    report["join_total"] = total

    ws = tempfile.mkdtemp(prefix="hs_dryrun_")
    try:
        report.update(_session_steps(ws, D, device if not real else None, _PROBE_CACHE))
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    return report


def _session_steps(ws: str, D: int, device, probe_cache) -> dict:
    from .. import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from .. import constants as C
    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch
    from ..plan.expr import Avg, Count, Sum, col, lit
    from .mesh import active_mesh

    report: dict = {}
    # ---- step 3: the production mesh-query path
    cio.write_parquet(ColumnBatch.from_pydict({
        "g": [i % 3 for i in range(256)],
        "x": [float(i) for i in range(256)],
        # above 2^24: the grouped int SUM must take the exact chunk sums
        "q": [16_777_216 + i for i in range(256)],
    }), ws + "/t/p.parquet")
    session = HyperspaceSession(ws, device=device)
    session.set_conf(C.EXEC_MESH_DEVICES, D)
    out = (session.read.parquet(ws + "/t").filter(col("x") >= 0.0).select("g", "x")
           .group_by("g").agg(Sum(col("x")).alias("s"), Count(lit(1)).alias("n"))
           .to_pydict())
    assert sum(out["n"]) == 256 and abs(sum(out["s"]) - sum(range(256))) < 1e-3, out
    expect: dict = {}
    for i in range(256):
        expect.setdefault(i % 3, []).append(16_777_216 + i)

    def int_query() -> dict:
        return (session.read.parquet(ws + "/t").filter(col("x") >= 0.0).select("g", "q")
                .group_by("g").agg(Sum(col("q")).alias("s"), Avg(col("q")).alias("a"))
                .to_pydict())

    out_int = int_query()
    got = dict(zip(out_int["g"], out_int["s"]))
    got_avg = dict(zip(out_int["g"], out_int["a"]))
    for g, vals in expect.items():
        assert got[g] == sum(vals), (g, got[g], sum(vals))
        assert got_avg[g] == sum(vals) / len(vals), (g, got_avg[g])
    report["mesh_fragments"] = session.device_stats.mesh_fragments
    assert report["mesh_fragments"] == 2, report

    # ---- step 4: the mesh co-partitioned plain join
    n_rows, n_keys = 40_000, 200
    rng = np.random.default_rng(7)
    cio.write_parquet(ColumnBatch.from_pydict({
        "k": rng.integers(0, n_keys, n_rows).tolist(),
        "price": rng.uniform(0, 100, n_rows).tolist(),
    }), ws + "/jl/p.parquet")
    cio.write_parquet(ColumnBatch.from_pydict({
        "rk": list(range(n_keys)), "rv": [float(i) * 3 for i in range(n_keys)],
    }), ws + "/jr/p.parquet")
    session.set_conf(C.INDEX_NUM_BUCKETS, D)
    hs = Hyperspace(session)
    hs.create_index(session.read.parquet(ws + "/jl"), CoveringIndexConfig("djl", ["k"], ["price"]))
    hs.create_index(session.read.parquet(ws + "/jr"), CoveringIndexConfig("djr", ["rk"], ["rv"]))
    session.enable_hyperspace()
    probe_cache.clear()
    joined = (session.read.parquet(ws + "/jl").select("k", "price")
              .join(session.read.parquet(ws + "/jr").select("rk", "rv"), col("k") == col("rk"))
              .select("k", "price", "rv").to_pydict())
    assert len(probe_cache._d) > 0, "the mesh join probe did not run"
    assert len(joined["k"]) == n_rows  # the right side is unique: every row joins once
    report["mesh_joins"] = session.device_stats.mesh_joins

    # ---- step 5: a hierarchical (multi-slice) mesh
    if D % 2 == 0 and D >= 4:
        session.disable_hyperspace()
        session.set_conf(C.EXEC_MESH_SLICES, 2)
        hier = active_mesh(session)
        assert hier is not None and tuple(hier.axis_names) == ("dcn", "ici")
        got_h = dict(zip(*(lambda d: (d["g"], d["s"]))(int_query())))
        for g, vals in expect.items():
            assert got_h[g] == sum(vals), (g, got_h[g], sum(vals))
        session.set_conf(C.EXEC_MESH_SLICES, 1)
        report["hierarchical"] = dict(hier.shape)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description="the multi-device tier's dry run")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="a virtual mesh's torch device")
    args = ap.parse_args()
    print(dryrun_multigpu(args.n, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
