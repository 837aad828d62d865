#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (hyperspace_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py [--rows N]

Phases, each of which raises (and so exits non-zero) on any failed check:

1. device facts: the card's name, and its name and power limit from
   nvidia-smi;
2. kernel build: nvcc compiles every CUDA source of hyperspace_tpu_torch/ops/
   csrc/ into build/kernels/, in parallel;
3. kernel phase: each CUDA kernel against its plain PyTorch version on the
   card, over several sizes, group counts (1, 6, 16) and measure counts (0,
   1, 3, 4, 5; five run as two passes), on aligned inputs and on offset
   views (pred, gids and each measure offset by different rows, which the
   kernels take through their scalar loops), with gids that are negative,
   in [G, 16) and >= 16: counts exact, sums within relative 1e-4, min and
   max exact (NaN, all-invalid and empty inputs included), two launches
   bit-identical; then each kernel's time at the main path's padded size:
   per call with the wrapper included (CUDA events around one call, median
   of 25) and on the device (CUDA events around 50 back-to-back launches,
   over 50), beside its bound and the plain version's per-call time. With
   --profile, a torch.profiler pass per kernel splits a call into its CUDA
   kernels (chiprun_out/profile_kernel_<name>.txt);
4. end-to-end phase: TPC-H lineitem at SF10 (60M rows, seed 42), orders
   (15M rows) and part (2M rows) written as parquet, the reference's index
   set built over them (tpch_indexes: the z-order index li_shipdate_z, the
   covering indexes li_orderkey, li_partkey, li_flagstatus, od_orderkey and
   pt_partkey), then
   - the filter-aggregate queries q6, q6_count, q6_sum, q1 and q1_sums run
     through the normal API with Hyperspace enabled. The q6 forms must read
     li_shipdate_z and the q1 forms li_flagstatus (through
     AggregateIndexRule); each must run on the device tier, launch its
     kernel where it has one, match the host executor over the raw source
     with Hyperspace and the device tier off, and upload nothing on a warm
     run;
   - the lookups on li_orderkey's key: lookup_count (a present key),
     lookup_absent (a key no row holds) and range_sum. Each plan must show
     the pruning the CPU tests pin (tpch.LOOKUP_PRUNING), and the kept
     files and row groups are printed; lookup_count and range_sum launch
     their kernels, lookup_absent is pruned to nothing and declines to the
     host, as in the JAX package; each matches the host executor and
     uploads nothing on a warm run;
   - the join queries q3_agg and q3 (TPC-H Q3 through JoinIndexRule). Each
     must read li_orderkey and od_orderkey, run the fused device join on
     every run with no decline, upload nothing and repeat bit for bit on
     warm runs, and match the host executor;
   - q10, q17 and q18, the rest of the reference's TPC-H queries. Each must
     read the reference's indexes (q17's and q18's aggregates through
     AggregateIndexRule), take the reference's device routes (q10 and q17
     the batched plain join with two fetches per join, q17 and q18 the
     grouped fragment), repeat bit for bit on warm runs, and match the host
     executor; their warm upload bytes are printed (a filtered side of the
     plain join is a new buffer on every run, as in the reference).
   masked_min_max is on no path of the system (the JAX package calls it
   from its tests only), so it launches no time in this phase;
5. order phase: the device top-k and sort against the host on one
   2^26-row batch of lineitem columns (the generator's distributions):
   l_shipdate (int32, heavy ties) ascending and l_extendedprice as f32
   descending, k in {10, 100, 4096}; (l_extendedprice f64, l_orderkey
   int64) ascending and descending. The rows must be the host's stable
   lexsort's, row for row; a top-k's keys must also equal the host top-k's
   (which orders ties by its partition, not by row). Each call is timed
   beside the host's, and the device bodies alone (CUDA events), with the
   plain join's probe and expansion at Q17's wave shape.

The last lines are the kernels line, the card's name and power limit, and
the result. Details go to chiprun_out/chip_smoke.json. The data lives in
build/chip_smoke/ and is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

SF10_ROWS = 60_000_000  # TPC-H SF10: 6M lineitem rows per scale factor
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published HBM3 rate
F32_OPS_PER_S = 67e12  # H100 SXM, published f32 rate outside the tensor cores
REL_TOL = 1e-4  # f32 sums, as tests/test_pallas_and_dist.py holds the reference
SEED = 42  # bench.py's TPC-H seed
WARM_RUNS = 3
KERNEL_REPS = 25
DEVICE_LAUNCHES = 50  # back-to-back launches per device-time reading
GROUP_COUNTS = (1, 6, 16)
MEASURE_COUNTS = (0, 1, 3, 4, 5)
# row offsets of (pred, gids, measures) views: aligned, then misaligned by
# different amounts, which the vector loads cannot take
OFFSETS = ((0, 0, 0), (1, 2, 3), (3, 1, 2))
GID_RANGE = (-2, 18)  # negative, [G, 16) and >= 16 gids count nowhere

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
DATA_DIR = os.path.join(ROOT, "build", "chip_smoke")

# which kernel each query's fragment must launch on the main path (where
# the JAX package's route has one)
EXPECTED_KERNEL = {
    "q6": None,
    "q6_count": "filter_weighted_sum",
    "q6_sum": "filter_sum",
    "q1": None,
    "q1_sums": "filter_grouped_multi_sum",
    "lookup_count": "filter_weighted_sum",
    # pruned to nothing: the device tier declines the empty scan, as the
    # JAX package's does, and the host answers
    "lookup_absent": None,
    "range_sum": "filter_sum",
    # the fused join+aggregate body is torch code (the reference's is XLA)
    "q3_agg": None,
    "q3": None,
    # the plain join, the top-k and the sort are torch code too
    "q10": None,
    "q17": None,
    "q18": None,
}
# the reference's TPC-H queries beyond Q1, Q3 and Q6: (indexes the plan
# must read, batched plain joins per run, grouped fragments per run,
# leading sort key for the tie rule of the comparison)
PLAIN_QUERIES = {
    "q10": (["li_orderkey", "od_orderkey"], 1, 0, "revenue"),
    "q17": (["li_partkey", "pt_partkey", "li_partkey"], 1, 1, None),
    "q18": (["li_orderkey"], 0, 1, "sum_qty"),
}
ORDER_ROWS = 1 << 26
TOPK_KS = (10, 100, 4096)
KERNEL_ROWS = {
    "filter_weighted_sum": ("hyperspace_tpu_torch/ops/csrc/filter_reduce.cu",
                            "hyperspace_tpu/ops/pallas_kernels.py:83"),
    "filter_sum": ("hyperspace_tpu_torch/ops/csrc/filter_reduce.cu",
                   "hyperspace_tpu/ops/pallas_kernels.py:119"),
    "filter_grouped_multi_sum": ("hyperspace_tpu_torch/ops/csrc/grouped_sum.cu",
                                 "hyperspace_tpu/ops/pallas_kernels.py:198"),
    "masked_min_max": ("hyperspace_tpu_torch/ops/csrc/minmax.cu",
                       "hyperspace_tpu/ops/pallas_kernels.py:236"),
}
ON_PATH = {"filter_weighted_sum", "filter_sum", "filter_grouped_multi_sum"}
MINMAX_CASES = ("random", "all_invalid", "nan_valid", "nan_invalid", "int")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_err(got: float, want: float) -> float:
    return 0.0 if got == want else abs(got - want) / max(abs(want), 1e-30)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(torch, fn, reps: int = KERNEL_REPS, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time_ms(torch, fn, launches: int = DEVICE_LAUNCHES, warmup: int = 3) -> float:
    """CUDA-event time of `launches` back-to-back calls, over `launches`: the
    card's time per call once the host runs ahead of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def profile_kernel(torch, fn, name: str, calls: int = 10) -> None:
    """A torch.profiler pass over `calls` calls: the CUDA kernels (first
    pass, fold, any fill) of one wrapper call, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with open(os.path.join(OUT_DIR, f"profile_kernel_{name}.txt"), "w") as f:
        f.write(f"{calls} calls\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(torch, K, R, sizes: list[int], timed_n: int, card: str,
                 profile: bool = False) -> tuple[dict, dict]:
    """The checks and times of every kernel; returns the results and, when
    `profile`, each kernel's call at the timed size (for profile_kernel once
    the end-to-end phase has profiled its queries)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    results = {name: {"max_abs_err": 0.0, "checks": 0} for name in KERNEL_ROWS}

    def inputs(n: int, k: int, seed: int, offsets=(0, 0, 0), gid_range=(0, K.MAX_GROUPS)):
        """pred, k measures and gids of n rows; each a contiguous view that
        starts `offsets` (pred, gids, measures) rows into its storage."""
        gen.manual_seed(seed)
        po, go, xo = offsets

        def view(t, r):
            return t[r:r + n]

        pred = view(torch.rand(n + po, generator=gen, device=dev) < 0.3, po)
        xs = [view(torch.rand(n + xo, generator=gen, device=dev) * 1000, xo)
              for _ in range(k)]
        gids = view(torch.randint(*gid_range, (n + go,), generator=gen, device=dev,
                                  dtype=torch.int32), go)
        return pred, xs, gids

    def compare(name, got, again, want, what):
        (gs, gc), (as_, ac), (ws, wc) = got, again, want
        for a, b in zip(gs, as_):
            require(torch.equal(a, b), f"{name} {what}: repeat launch differs")
        require(torch.equal(gc, ac), f"{name} {what}: repeat launch counts differ")
        require(torch.equal(gc.cpu(), wc.cpu()), f"{name} {what}: counts differ from plain")
        for a, b in zip(gs, ws):
            for x, y in zip(a.reshape(-1).tolist(), b.reshape(-1).tolist()):
                require(math.isfinite(x), f"{name} {what}: non-finite sum")
                require(rel_err(x, y) <= REL_TOL,
                        f"{name} {what}: sum {x} vs plain {y}")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], abs(x - y))
        results[name]["checks"] += 1

    def minmax_inputs(n: int, case: str, seed: int):
        gen.manual_seed(seed)
        x = (torch.rand(n, generator=gen, device=dev) - 0.5) * 2000
        valid = torch.rand(n, generator=gen, device=dev) < 0.5
        if case == "all_invalid":
            valid[:] = False
        elif case == "int":
            x = torch.randint(-(2**20), 2**20, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        elif case in ("nan_valid", "nan_invalid") and n:
            x[n // 2] = float("nan")
            valid[n // 2] = case == "nan_valid"
        return x, valid

    def check_minmax(got, again, want, what):
        name = "masked_min_max"
        for g, a, w, side in zip(got, again, want, ("min", "max")):
            require(torch.equal(g.view(torch.int32), a.view(torch.int32)),
                    f"{name} {what}: repeat launch differs ({side})")
            gv, wv = float(g), float(w)
            same = (math.isnan(gv) and math.isnan(wv)) or gv == wv
            require(same, f"{name} {what}: {side} {gv} vs plain {wv}")
        if what.endswith("nan_valid") and not what.startswith("n=0 "):
            require(all(math.isnan(float(v)) for v in got), f"{name} {what}: NaN dropped")
        r = results[name]
        r["checks"] += 1

    for n in sizes:
        for off in OFFSETS:
            pred, (x, y), _g = inputs(n, 2, n, off)
            for name, args in (("filter_weighted_sum", (pred, x, y)),
                               ("filter_sum", (pred, x))):
                got = getattr(K, name)(*args)
                again = getattr(K, name)(*args)
                want = getattr(R, name)(*args)
                compare(name, ((got[0],), got[1]), ((again[0],), again[1]),
                        ((want[0],), want[1]), f"n={n} offsets={off}")
            for groups in GROUP_COUNTS:
                for k in MEASURE_COUNTS:
                    pred, xs, gids = inputs(n, k, 1000 * n + 10 * groups + k, off, GID_RANGE)
                    got = K.filter_grouped_multi_sum(pred, gids, xs, groups)
                    again = K.filter_grouped_multi_sum(pred, gids, xs, groups)
                    want = R.filter_grouped_multi_sum(pred, gids, xs, groups)
                    compare("filter_grouped_multi_sum", got, again, want,
                            f"n={n} G={groups} k={k} offsets={off}")
        for case in MINMAX_CASES:
            x, valid = minmax_inputs(n, case, 7 * n + len(case))
            got = K.masked_min_max(x, valid)
            again = K.masked_min_max(x, valid)
            want = R.masked_min_max(x, valid)
            check_minmax(got, again, want, f"n={n} {case}")
    torch.cuda.synchronize()

    # times at the main path's padded size; the grouped kernel at q1_sums'
    # shape (3 float sums over 16 group slots)
    n = timed_n
    pred, xs, gids = inputs(n, 3, 7)
    cases = {
        "filter_weighted_sum": (lambda: K.filter_weighted_sum(pred, xs[0], xs[1]),
                                lambda: R.filter_weighted_sum(pred, xs[0], xs[1]),
                                n * (1 + 4 + 4), 3 * n),
        "filter_sum": (lambda: K.filter_sum(pred, xs[0]),
                       lambda: R.filter_sum(pred, xs[0]),
                       n * (1 + 4), 2 * n),
        "filter_grouped_multi_sum": (
            lambda: K.filter_grouped_multi_sum(pred, gids, xs, 16),
            lambda: R.filter_grouped_multi_sum(pred, gids, xs, 16),
            n * (1 + 4 + 4 * 3), n * 16 * (1 + 3)),
    }
    mm_x, mm_valid = minmax_inputs(n, "random", 11)
    cases["masked_min_max"] = (lambda: K.masked_min_max(mm_x, mm_valid),
                               lambda: R.masked_min_max(mm_x, mm_valid),
                               n * (4 + 1), 2 * n)
    for name, (kern, plain, nbytes, ops) in cases.items():
        r = results[name]
        r["ms"] = time_ms(torch, kern)  # per call, wrapper included
        r["device_ms"] = device_time_ms(torch, kern)
        r["plain_ms"] = time_ms(torch, plain)
        r["bytes"] = nbytes
        r["ops"] = ops
        r["timed_n"] = n
        # the larger of: inputs read once over the HBM rate, and the f32
        # operations (multiplies, selects, adds) over the f32 peak
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        # no single PyTorch call computes (masked sum, count) from (pred, x),
        # nor (masked min, masked max) from (x, valid)
        r["library_ms"] = None
        r["library_note"] = ("no single PyTorch call computes a masked min and max"
                             if name == "masked_min_max" else
                             "no single PyTorch call computes a masked sum and count")
        log({"kernel": name, "card": card, "n": n, "per_call_ms": r["ms"],
             "device_ms": r["device_ms"], "library_ms": None, "library_note": r["library_note"],
             "plain_ms": r["plain_ms"], "plain": f"hyperspace_tpu_torch/ops/reference.py:{name}",
             "bytes": nbytes, "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "checks": r["checks"], "max_abs_err": r["max_abs_err"]})
    timed = {name: case[0] for name, case in cases.items()} if profile else {}
    return results, timed


# ---------------------------------------------------------------------------
# end-to-end phase
# ---------------------------------------------------------------------------

def compare_batches(q: str, got: dict, want: dict) -> None:
    require(list(got) == list(want), f"{q}: columns {list(got)} vs {list(want)}")
    for name in want:
        g, w = list(got[name]), list(want[name])
        require(len(g) == len(w), f"{q}.{name}: {len(g)} rows vs {len(w)}")
        for a, b in zip(g, w):
            if isinstance(b, float):
                require(a is not None and math.isfinite(a), f"{q}.{name}: {a}")
                require(rel_err(float(a), b) <= REL_TOL, f"{q}.{name}: {a} vs {b}")
            else:  # counts and group keys: exact, in the same row order
                require(a == b, f"{q}.{name}: {a!r} vs {b!r}")


def _floats(d: dict) -> dict:
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in d.items()}


def profile_warm_run(torch, run, label: str) -> dict:
    """One warm run under torch.profiler: wall time, the card's kernel time,
    and their ratio (the device's busy share of the query); then the host's
    Python functions over another warm run (cProfile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity (kernels, copies, memsets) on the one stream the
    # device tier uses, so the intervals do not overlap
    device_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    # where the host's share goes: Python functions of another warm run
    import cProfile
    import pstats

    host_prof = cProfile.Profile()
    host_prof.runcall(run)
    torch.cuda.synchronize()
    with open(os.path.join(OUT_DIR, f"hostprofile_{label}.txt"), "w") as f:
        pstats.Stats(host_prof, stream=f).sort_stats("tottime").print_stats(25)
    return {"wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "device_busy_share": (device_us / 1e3) / wall_ms if device_us else None}


def compare_join(q: str, got: dict, want: dict) -> None:
    """q3_agg: the same (l_orderkey, o_orderdate) groups, revenue within
    REL_TOL (row order differs between the bucketed and the host path, so
    both sort by key). q3: the top revenues within REL_TOL in order, and the
    keys equal except where the host's neighbouring revenues tie within
    REL_TOL."""
    import numpy as np

    require(list(got) == list(want), f"{q}: columns {list(got)} vs {list(want)}")
    keys = ("l_orderkey", "o_orderdate")
    n = len(want["revenue"])
    require(len(got["revenue"]) == n and n > 0, f"{q}: {len(got['revenue'])} rows vs {n}")
    if q == "q3_agg":
        g_order = np.lexsort([got[k] for k in reversed(keys)])
        w_order = np.lexsort([want[k] for k in reversed(keys)])
        got = {k: np.asarray(v)[g_order] for k, v in got.items()}
        want = {k: np.asarray(v)[w_order] for k, v in want.items()}
    g_rev = np.asarray(got["revenue"], dtype=np.float64)
    w_rev = np.asarray(want["revenue"], dtype=np.float64)
    require(bool(np.isfinite(g_rev).all()), f"{q}: non-finite revenue")
    err = np.abs(g_rev - w_rev) / np.maximum(np.abs(w_rev), 1e-30)
    require(float(err.max()) <= REL_TOL, f"{q}: revenue off by relative {float(err.max())}")
    tied = np.zeros(n, dtype=bool)
    if q == "q3":
        near = np.abs(np.diff(w_rev)) <= REL_TOL * np.abs(w_rev[1:])
        tied[1:] |= near
        tied[:-1] |= near
    for k in keys:
        same = np.asarray(got[k]) == np.asarray(want[k])
        require(bool((same | tied).all()), f"{q}: {k} differs from the host")


def compare_ordered(q: str, got: dict, want: dict, lead) -> None:
    """Every column equal, floats within REL_TOL, and the `lead` sort key
    within REL_TOL on every row. The other columns of a row may differ from
    the host's only where the host's neighbouring `lead` values differ but
    lie within REL_TOL (both order the same values, summed in other orders);
    exact ties are broken by the query's next sort key, so they are held."""
    import numpy as np

    require(list(got) == list(want), f"{q}: columns {list(got)} vs {list(want)}")
    n = len(next(iter(want.values())))
    require(n > 0 and all(len(v) == n for v in got.values()), f"{q}: row counts differ")
    near = np.zeros(n, dtype=bool)
    if lead is not None:
        w = np.asarray(want[lead], dtype=np.float64)
        d = np.abs(np.diff(w))
        pair = (d > 0) & (d <= REL_TOL * np.abs(w[1:]))
        near[1:] |= pair
        near[:-1] |= pair
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        held = np.ones(n, dtype=bool) if name == lead else ~near
        if w.dtype.kind == "f":
            require(bool(np.isfinite(g).all()), f"{q}.{name}: non-finite values")
            err = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
            require(float(err[held].max(initial=0)) <= REL_TOL,
                    f"{q}.{name}: off by relative {float(err[held].max(initial=0))}")
        else:
            require(bool((g == w)[held].all()), f"{q}.{name}: differs from the host")


def _columns(batch) -> dict:
    """A result batch as numpy arrays by column (no Python lists: q3_agg
    returns millions of groups at SF10)."""
    return {n: c.decode() for n, c in batch.columns.items()}


def end_to_end_phase(torch, K, rows: int, card: str, profile: bool = False) -> dict:
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.plan.executor import resolve_scan_pruning
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    lake = os.path.join(DATA_DIR, "lake")
    warehouse = os.path.join(DATA_DIR, "warehouse")
    out: dict = {"rows": rows}

    t0 = time.perf_counter()
    out["source_bytes"] = tpch.generate_tpch(lake, rows_lineitem=rows, seed=SEED)
    out["generate_s"] = time.perf_counter() - t0

    session = HyperspaceSession(warehouse)  # device=None: the card
    hs = Hyperspace(session)
    out["index_build_s"] = {}
    for table, zordered, spec in tpch.TPCH_INDEXES:  # tpch.tpch_indexes, timed
        t0 = time.perf_counter()
        tpch.build_index(session, hs, lake, table, zordered, spec)
        out["index_build_s"][spec[0]] = time.perf_counter() - t0
    log({"phase": "data", "card": card, "rows": rows, "generate_s": out["generate_s"],
         "source_bytes": out["source_bytes"], "index_build_s": out["index_build_s"]})

    # the plain end-to-end reference: the host executor over the raw source
    host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
    all_queries = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES,
                   **{q: tpch.TPCH_QUERIES[q] for q in PLAIN_QUERIES}}

    def result(q: str, df) -> dict:
        if q in tpch.JOIN_QUERIES or q in PLAIN_QUERIES:
            return _columns(df.collect())
        return _floats(df.to_pydict())

    def same_bits(a: dict, b: dict) -> bool:
        import numpy as np

        return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)

    want = {}
    for q, fn in all_queries.items():
        t0 = time.perf_counter()
        want[q] = result(q, fn(host, lake))
        out.setdefault("host_s", {})[q] = time.perf_counter() - t0
    del host

    session.enable_hyperspace()
    queries = {}
    expected_indexes = {q: [tpch.LI_SHIPDATE_Z[0] if q.startswith("q6")
                            else tpch.LI_FLAGSTATUS[0]] for q in tpch.QUERIES}
    expected_indexes.update({q: [tpch.LI_ORDERKEY[0]] for q in tpch.LOOKUP_QUERIES})
    expected_indexes.update({q: [tpch.LI_ORDERKEY[0], tpch.OD_ORDERKEY[0]]
                             for q in tpch.JOIN_QUERIES})
    expected_indexes.update({q: spec[0] for q, spec in PLAIN_QUERIES.items()})
    K.reset_counts()  # the main path's launches start here
    for q, fn in all_queries.items():
        join = q in tpch.JOIN_QUERIES
        plain = q in PLAIN_QUERIES
        plan = fn(session, lake).optimized_plan()
        used = [n.index_info.index_name for n in plan.preorder()
                if getattr(n, "index_info", None) is not None]
        require(used == expected_indexes[q],
                f"{q}: plan reads {used}, expected {expected_indexes[q]}")
        pruned = [n for n in plan.preorder()
                  if getattr(n, "prune_spec", None) is not None and n.prune_spec.active]
        require([n.prune_spec.describe() for n in pruned]
                == ([tpch.LOOKUP_PRUNING[q]] if q in tpch.LOOKUP_PRUNING else []),
                f"{q}: pruning {[n.prune_spec.describe() for n in pruned]}")
        for n in pruned:  # the files and row groups the scan reads
            row_groups, kept = resolve_scan_pruning(n)
            log({"query": q, "card": card, "index": n.index_info.index_name,
                 "pruned": n.prune_spec.describe(), "files_in_plan": len(n.files),
                 "kept_files": [os.path.basename(f.name) for f in kept],
                 "row_groups": {os.path.basename(p): list(g)
                                for p, g in (row_groups or {}).items()}})
        session.device_stats = DeviceTierStats()
        before = dict(K.LAUNCHES)
        up0 = session.device_cache.uploaded_bytes
        t0 = time.perf_counter()
        got = result(q, fn(session, lake))
        cold_s = time.perf_counter() - t0
        up1 = session.device_cache.uploaded_bytes
        warm = []
        uploads_warm = []
        for _ in range(WARM_RUNS):
            u = session.device_cache.uploaded_bytes
            t0 = time.perf_counter()
            again = result(q, fn(session, lake))
            warm.append(time.perf_counter() - t0)
            uploads_warm.append(session.device_cache.uploaded_bytes - u)
            if join or plain:  # deterministic device paths: the same bits
                require(same_bits(again, got), f"{q}: a warm run differs from the first run")
            else:
                compare_batches(q, again, got)
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        stats = session.device_stats
        runs = 1 + WARM_RUNS
        if plain:
            _idx, joins, frags, _lead = PLAIN_QUERIES[q]
            require(stats.join_paths == ({"batched": joins * runs} if joins else {})
                    and stats.plain_join_fetches == 2 * joins * runs
                    and stats.device_plain_probes == 0
                    and stats.device_fragments == frags * runs and not stats.declines,
                    f"{q}: join paths {stats.join_paths}, fetches "
                    f"{stats.plain_join_fetches}, per-bucket probes "
                    f"{stats.device_plain_probes}, fragments {stats.device_fragments}, "
                    f"declines {stats.declines}")
        elif q == "lookup_absent":  # every run's scan is empty
            require(stats.device_fragments == 0 and stats.declines == {"empty": runs},
                    f"{q}: device fragments {stats.device_fragments}, "
                    f"declines {stats.declines}")
        else:
            ran = stats.device_join_fragments if join else stats.device_fragments
            require(ran == runs and not stats.declines,
                    f"{q}: device fragments {stats.device_fragments}, join fragments "
                    f"{stats.device_join_fragments}, declines {stats.declines}")
        expected = EXPECTED_KERNEL[q]
        for k, c in launched.items():
            if k == expected:  # once per run
                require(c == 1 + WARM_RUNS, f"{q}: {k} launched {c} times")
            else:
                require(c == 0, f"{q}: unexpected launches of {k}")
        if not plain:
            require(all(u == 0 for u in uploads_warm),
                    f"{q}: warm runs uploaded {uploads_warm}")
        if join:
            compare_join(q, got, want[q])
        elif plain:
            compare_ordered(q, got, want[q], PLAIN_QUERIES[q][3])
        else:
            compare_batches(q, got, want[q])
        queries[q] = {"first_run_s": cold_s, "warm_median_s": statistics.median(warm),
                      "upload_bytes_first": up1 - up0, "upload_bytes_second": uploads_warm[0],
                      "launches": launched, "host_reference_s": out["host_s"][q],
                      "rows_out": len(next(iter(got.values()))), "matches_host": True}
        if join:
            queries[q]["device_join_fragments"] = stats.device_join_fragments
        if plain:
            queries[q].update({
                "upload_bytes_warm": uploads_warm, "join_paths": stats.join_paths,
                "plain_join_fetches": stats.plain_join_fetches,
                "device_plain_probes": stats.device_plain_probes,
                "join_spills": stats.join_spills, "device_fragments": stats.device_fragments,
                "device_topk": stats.device_topk, "device_sort": stats.device_sort,
                "order_declines": stats.order_declines})
        log({"query": q, "card": card, **queries[q]})
    out["main_path_launches"] = dict(K.LAUNCHES)
    require(not any(K.PLAIN_CALLS.values()),
            f"plain versions ran on the main path: {K.PLAIN_CALLS}")
    out["queries"] = queries
    if profile:
        for q, fn in all_queries.items():
            queries[q]["profile"] = profile_warm_run(
                torch, lambda: fn(session, lake).collect(), q
            )
            log({"query": q, "card": card, "profile": queries[q]["profile"]})
    out["device_resident_bytes"] = session.device_cache.resident_bytes
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# order phase
# ---------------------------------------------------------------------------

def order_phase(torch, n: int, card: str) -> dict:
    """The device top-k and sort against the host chain on one batch of n
    lineitem rows (the generator's distributions, seed 42), permutations
    equal row for row; each call timed beside the host's, and the device
    bodies alone. Then the plain join's probe and expansion bodies at Q17's
    wave shape at SF10 (8 left chunks of 262144 sorted keys against 50,000
    unique right keys, a fifth of them matching)."""
    import numpy as np

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.columnar.table import Column, ColumnBatch
    from hyperspace_tpu_torch.ops.join import exact_key32
    from hyperspace_tpu_torch.plan import device_join as dj
    from hyperspace_tpu_torch.plan import executor as ex
    from hyperspace_tpu_torch.plan import gpu_exec as gx
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.plan.nodes import InMemoryScan, Sort

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    price = rng.uniform(900, 105_000, n)
    cols = {
        "row": np.arange(n, dtype=np.int64),
        "l_shipdate": rng.integers(8035, 10590, n).astype(np.int32),
        "l_extendedprice": price,
        "l_price32": price.astype(np.float32),
        "l_orderkey": rng.integers(0, SF10_ROWS // 4, n),
    }
    batch = ColumnBatch({k: Column(a, str(a.dtype)) for k, a in cols.items()})
    scan = InMemoryScan(batch)
    session = HyperspaceSession(os.path.join(DATA_DIR, "order"))  # device=None: the card
    out: dict = {"rows": n, "topk": [], "sort": []}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    for key, asc in (("l_shipdate", True), ("l_price32", False)):
        plan = Sort([(col(key), asc)], scan)
        x = torch.from_numpy(exact_key32(cols[key])).to(dev)
        # the host's stable order (ties keep their row order), sorted once:
        # the host chain falls back to this same sort for every k
        t0 = time.perf_counter()
        full = ex._exec_sort(plan, batch)
        sort_ms = (time.perf_counter() - t0) * 1e3
        for k in TOPK_KS:
            got, ms = timed(lambda: gx.try_device_topk(plan, k, batch, session))
            require(got is not None, f"top-k {key} k={k}: the device declined")
            require(np.array_equal(got.column("row").data, full.column("row").data[:k]),
                    f"top-k {key} k={k}: rows differ from the host's stable sort")
            # the host chain: its top-k, else the full sort (timed above)
            t0 = time.perf_counter()
            want = ex._try_topk_batch(plan, k, batch)
            host_ms = (time.perf_counter() - t0) * 1e3
            if want is None:
                want = full.take(np.arange(k))
                host_ms += sort_ms
            # the host top-k orders ties by its candidates' partition order,
            # so only its keys are held to the device's order
            require(np.array_equal(got.column(key).data, want.column(key).data),
                    f"top-k {key} k={k}: keys differ from the host top-k")
            body = gx._build_topk_kernel(k, asc)
            r = {"key": key, "asc": asc, "k": k, "ms": ms, "host_ms": host_ms,
                 "host_full_sort_ms": sort_ms,
                 "device_ms": device_time_ms(torch, lambda: body(x, n), launches=10),
                 "matches_host": True}
            out["topk"].append(r)
            log({"order": "topk", "card": card, **r})

    for asc in (True, False):
        plan = Sort([(col("l_extendedprice"), asc), (col("l_orderkey"), asc)], scan)
        got, ms = timed(lambda: gx.try_device_sort(plan, batch, session))
        require(got is not None, f"sort asc={asc}: the device declined")
        t0 = time.perf_counter()
        want = ex._exec_sort(plan, batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(got.column("row").data, want.column("row").data),
                f"sort asc={asc}: rows differ from the host")
        # where the call's time goes, step by step as try_device_sort takes
        # them: the host encoding, the upload, the device body, the fetch
        # of the permutation, the host gather of the sorted rows
        t0 = time.perf_counter()
        words = []
        for name in ("l_extendedprice", "l_orderkey"):
            words += gx._encode_sort_words(batch.column(name), asc)
        encode_ms = (time.perf_counter() - t0) * 1e3
        ops, upload_ms = timed(lambda: [torch.from_numpy(w.view(np.int32)).to(dev)
                                        for w in words])
        body = gx._build_sort_kernel(len(words))
        perm_d, body_ms = timed(lambda: body(*ops))
        (pinned,), fetch_ms = timed(lambda: dj._fetch_all([perm_d]))
        t0 = time.perf_counter()
        perm = pinned.copy()
        copy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch.take(perm)
        take_ms = (time.perf_counter() - t0) * 1e3
        r = {"keys": ["l_extendedprice f64", "l_orderkey int64"], "asc": asc,
             "n_words": len(words), "ms": ms, "host_ms": host_ms,
             "encode_ms": encode_ms, "upload_ms": upload_ms, "body_ms": body_ms,
             "fetch_ms": fetch_ms, "copy_ms": copy_ms, "take_ms": take_ms,
             "device_ms": device_time_ms(torch, lambda: body(*ops), launches=5, warmup=1),
             "matches_host": True}
        if asc:
            # the same gather reading its index array from the pinned buffer
            t0 = time.perf_counter()
            batch.take(pinned)
            r["take_from_pinned_ms"] = (time.perf_counter() - t0) * 1e3
        out["sort"].append(r)
        log({"order": "sort", "card": card, **r})
        del ops, got, want, perm, perm_d, pinned
    stats = session.device_stats
    require(stats.device_topk == 2 * len(TOPK_KS) and stats.device_sort == 2
            and not stats.order_declines, f"order phase routes: {stats}")

    # the plain join's bodies at Q17's wave shape
    w, pad_l, n_r = 8, 1 << 18, 50_000
    lk = np.sort(rng.integers(0, 250_000, (w, pad_l)), axis=1).astype(np.int32)
    rk = np.full((w, dj._pow2(n_r)), np.iinfo(np.int32).max, np.int32)
    for i in range(w):
        rk[i, :n_r] = np.sort(rng.permutation(250_000)[:n_r])
    lk_d, rk_d = torch.from_numpy(lk).to(dev), torch.from_numpy(rk).to(dev)
    n_l_d = torch.full((w,), pad_l, dtype=torch.int32, device=dev)
    n_r_d = torch.full((w,), n_r, dtype=torch.int32, device=dev)
    probe = dj._build_stacked_probe_kernel()
    lo, offs, totals, ok = probe(lk_d, rk_d, n_r_d, n_l_d)
    require(bool(ok.all()), "probe body: overflow flagged")
    out_pad = dj._pow2(int(totals.max()))
    expand = dj._build_stacked_expand_kernel(out_pad)
    li, ri = expand(lo, offs, totals)
    i = int(totals.argmax())
    t = int(totals[i])
    from hyperspace_tpu_torch.ops.join import host_merge_join_indices

    hli, hri = host_merge_join_indices(lk[i], rk[i, :n_r])
    require(np.array_equal(li[i, :t].cpu().numpy(), hli)
            and np.array_equal(ri[i, :t].cpu().numpy(), hri),
            "expansion body: pairs differ from the host merge join")
    out["plain_join_bodies"] = {
        "items": w, "pad_l": pad_l, "n_r": n_r, "out_pad": out_pad,
        "pairs": int(totals.sum()),
        "probe_device_ms": device_time_ms(torch, lambda: probe(lk_d, rk_d, n_r_d, n_l_d)),
        "expand_device_ms": device_time_ms(torch, lambda: expand(lo, offs, totals)),
    }
    log({"order": "plain_join_bodies", "card": card, **out["plain_join_bodies"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=SF10_ROWS,
                    help="lineitem rows (default: TPC-H SF10)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm run of each query (device busy share)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs the card",
              file=sys.stderr)
        return 1
    from hyperspace_tpu_torch.ops import cuda_kernels as K
    from hyperspace_tpu_torch.ops import reference as R
    from hyperspace_tpu_torch.plan.gpu_exec import _pad_pow2

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log({"phase": "device", "kind": kind, "nvidia_smi": smi, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda})

    build_s = K.build_kernels()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for src, text in K.BUILD_LOG.items():
            f.write(f"== {src}\n{text}\n")
    log({"phase": "build", "card": smi, "seconds": build_s, "sources": list(K.SOURCES)})

    timed_n = _pad_pow2(args.rows)
    sizes = sorted({0, 1, 1023, 1025, 1_000_003, 1 << 26, timed_n})
    kernels, timed = kernel_phase(torch, K, R, sizes, timed_n, smi, args.profile)
    e2e = end_to_end_phase(torch, K, args.rows, smi, args.profile)
    order = order_phase(torch, ORDER_ROWS if args.rows == SF10_ROWS else _pad_pow2(args.rows),
                        smi)
    # after the queries' profiles: a profiler session before them lost
    # their short runs' device events
    for name, call in timed.items():
        profile_kernel(torch, call, name)

    line = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        r = kernels[name]
        by_query = {q: v["launches"][name] for q, v in e2e["queries"].items()
                    if v["launches"][name]}
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": e2e["main_path_launches"][name],
            "launches_by_query": by_query, "runs_per_query": 1 + WARM_RUNS,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "on_path": name in ON_PATH,
            "status": f"built, {r['checks']} checks against the plain version passed",
        })
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": {"kind": kind, "nvidia_smi": smi}, "build_s": build_s,
                   "kernels": kernels, "end_to_end": e2e, "order": order,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    log({"phase": "done", "card": smi, "total_s": time.perf_counter() - t_start})
    log({"kernels": line})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
