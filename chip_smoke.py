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
   pt_partkey, the data-skipping index li_shipdate_mm; each build timed),
   then
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
5. lifecycle phase: a second lake whose lineitem and orders hard-link the
   SF10 files, with its own warehouse, lineage on, and three indexes over
   it: lc_shipdate_z (li_shipdate_z's config), lc_orderkey (li_orderkey's)
   and od_orderkey. Stages, each running q6_count, q6_sum, lookup_count,
   range_sum and q3_agg through the normal API (first run and warm runs,
   each compared with the host executor over the lake's current files):
   1. build;
   2. 6 of the 120 lineitem files deleted, hybrid scan off: no lc_ index
      may serve lineitem;
   3. hybrid scan on: the lineitem scans drop the deleted files' rows by
      lineage, filter_weighted_sum and filter_sum launch on them and the
      join runs on the card; then refresh_index(mode="incremental") of
      both indexes takes the deletes in (each bucket rewritten);
   4. 12 files appended (generate_tpch's lineitem at 6M rows, seed 43,
      renamed): the filter queries read a Union on the host, as in the
      reference, and q3_agg a BucketUnion through the fused join on the
      card;
   5. refresh_index(mode="incremental") of both: the appended rows become
      a second run in every bucket, and the queries run on the card with
      no hybrid scan (lookups read pruned buckets of two runs);
   6. optimize_index (quick) of lc_orderkey compacts them to one file per
      bucket (files per bucket printed before and after), queries on the
      card;
   7. vacuum_outdated_index of both, then delete_index and restore_index
      of lc_shipdate_z, each followed by a plan check, and a final
      delete_index and vacuum_index of every index.
   The plan's index and hybrid form, files per bucket, warm ms, first-run
   and warm upload bytes, kernel launches and each action's seconds are
   printed. Any mismatch, a kernel of the stage's path launched no time,
   or a plain-version call fails the run;
6. skipping phase: each query held to the host executor over the raw
   files of its lake, its files, row groups and rows kept, first-run and
   warm times and upload bytes printed; every kernel-shaped one must launch
   filter_sum once per run with no decline:
   (a) BASELINE config 3: q6_tax_sum (Q6's ship-date range, sum(l_tax),
       count) over the SF10 lineitem, which only li_shipdate_mm can serve;
       the rule must be consulted ("0 of 120 files pruned": the generator
       draws l_shipdate uniformly in every file);
   (b) BASELINE config 5: bench.py's store_sales lake (16M rows in 256
       files of file-local item keys, seed 11): the bloom point query raw
       and through ss_bloom, a four-file key range through ss_minmax, then
       2 files deleted and 2 appended (seed 12), an incremental and a full
       refresh of both, each followed by the point, range and an appended
       key's query;
   (c) the sidecar sketch stage: bench.py's events_sk lake (4M rows, 16
       files, seed 23) and the covering index ev_sk_idx built with
       HYPERSPACE_SKETCHES=1; its eq and in queries in three legs (raw,
       sketches off, on) must agree, and the sketch stage must keep fewer
       row groups than the index scan's footer stage; ev_point_sum (the eq
       with sum(ev_v) and count) runs on the card over the kept groups;
   (d) the predicate routes: flag_sum (l_returnflag = 'R') over
       li_flagstatus through the dictionary-code rewrite, and wide64_sum
       (w > 2^40 over a full-range int64 column, 2^22 rows) through Wide64
       word pairs. No plain version may run. With --profile, each
       kernel-shaped query is profiled once more after its counts are read
       (chiprun_out/profile_skipping_<q>.txt);
7. order phase: the device top-k and sort against the host on one
   2^25-row batch of lineitem columns (the generator's distributions):
   l_shipdate (int32, heavy ties) ascending and l_extendedprice as f32
   descending, k in {10, 100, 4096}; (l_extendedprice f64, l_orderkey
   int64) ascending and descending. The rows must be the host's stable
   lexsort's, row for row; a top-k's keys must also equal the host top-k's
   (which orders ties by its partition, not by row). Each call is timed
   beside the host's, and the device bodies alone (CUDA events), with the
   plain join's probe and expansion at Q17's wave shape.

The last lines are the kernels line, the card's name and power limit, and
the result. Details go to chiprun_out/chip_smoke.json. The data lives in
build/chip_smoke/ and is removed at the end. The kernels line's launches
add up the end-to-end, lifecycle and skipping phases' counts, each read on
its own (``launches_by_phase``).
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
WARM_RUNS = 2
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
# host references read off another query's host result by the host
# executor's own code, instead of a second pass over the 60M-row source:
# q3 is q3_agg's groups through Limit(Sort), q1_sums is q1 less avg_qty
DERIVED_REFERENCES = {"q3": "q3_agg", "q1_sums": "q1"}
ORDER_ROWS = 1 << 25
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
# the lifecycle phase's queries, their kernel, and its indexes (the
# reference's configs under other names, so the main phase's indexes are
# never candidates over the second lake)
LIFECYCLE_QUERIES = {"q6_count": "filter_weighted_sum", "q6_sum": "filter_sum",
                     "lookup_count": "filter_weighted_sum", "range_sum": "filter_sum",
                     "q3_agg": None}
LC_FILTER_QUERIES = ("q6_count", "q6_sum", "lookup_count", "range_sum")
LIFECYCLE_WARM_RUNS = 1
APPEND_SEED = 43
# the skipping phase: bench.py's store_sales lake (BASELINE config 5) at
# SF10's row count, capped as bench.py caps it; its events_sk lake; the
# Wide64 table of tests/test_tpu_exec.py at 2^22 rows
SS_ROWS = 16_000_000
SS_FILES = 256
SS_SEED = 11
SS_APPEND_SEED = 12
EV_ROWS = 4_000_000
EV_FILES = 16
EV_SEED = 23
WIDE_ROWS = 1 << 22
WIDE_SEED = 6
SKIP_WARM_RUNS = 1
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


def derived_reference(q: str, batch):
    """The host executor's result of ``q`` from the host result of the
    query DERIVED_REFERENCES names: q3's top 10 by revenue over q3_agg's
    groups (the same Limit(Sort) the executor runs over the same
    Aggregate output), q1_sums as q1's columns less avg_qty."""
    from hyperspace_tpu_torch.plan.executor import execute_plan
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.plan.nodes import InMemoryScan, Limit, Sort

    if q == "q3":
        return execute_plan(Limit(10, Sort([(col("revenue"), False)], InMemoryScan(batch))))
    if q == "q1_sums":
        return batch.select([n for n in batch.schema.names if n != "avg_qty"])
    raise ValueError(q)


def end_to_end_phase(torch, K, rows: int, card: str, profile: bool = False) -> dict:
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.columnar.table import ColumnBatch
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
    for table, kind, spec in tpch.TPCH_INDEXES:  # tpch.tpch_indexes, timed
        t0 = time.perf_counter()
        tpch.build_index(session, hs, lake, table, kind, spec)
        out["index_build_s"][spec[0]] = time.perf_counter() - t0
    log({"phase": "data", "card": card, "rows": rows, "generate_s": out["generate_s"],
         "source_bytes": out["source_bytes"], "index_build_s": out["index_build_s"]})

    # the plain end-to-end reference: the host executor over the raw source
    host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
    all_queries = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES,
                   **{q: tpch.TPCH_QUERIES[q] for q in PLAIN_QUERIES}}

    def result(q: str, df) -> dict:
        """A query's result (a DataFrame, or a host batch) as comparable
        columns."""
        batch = df if isinstance(df, ColumnBatch) else df.collect()
        if q in tpch.JOIN_QUERIES or q in PLAIN_QUERIES:
            return _columns(batch)
        return _floats(batch.to_pydict())

    def same_bits(a: dict, b: dict) -> bool:
        import numpy as np

        return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)

    want, batches = {}, {}
    for q, fn in all_queries.items():
        if q in DERIVED_REFERENCES:
            continue
        t0 = time.perf_counter()
        batches[q] = fn(host, lake).collect()
        want[q] = result(q, batches[q])
        out.setdefault("host_s", {})[q] = time.perf_counter() - t0
    for q, src in DERIVED_REFERENCES.items():
        want[q] = result(q, derived_reference(q, batches[src]))
    del host, batches

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
                      "launches": launched, "host_reference_s": out["host_s"].get(q),
                      "host_reference_from": DERIVED_REFERENCES.get(q),
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
    # the lifecycle and skipping phases reuse the lake (and the skipping
    # phase the warehouse), the lifecycle phase these references
    out["lake"] = lake
    out["warehouse"] = warehouse
    out["want"] = {q: want[q] for q in LIFECYCLE_QUERIES}
    return out


# ---------------------------------------------------------------------------
# lifecycle phase
# ---------------------------------------------------------------------------

def _plan_form(plan) -> dict:
    """What a plan reads: its index scans (name, files, lineage ids) and
    whether it unions appended files (Union, BucketUnion)."""
    scans = [n for n in plan.preorder() if getattr(n, "index_info", None) is not None]
    kinds = {n.kind for n in plan.preorder()}
    return {"indexes": [n.index_info.index_name for n in scans],
            "lineage_ids": [n.lineage_filter_ids for n in scans],
            "files": [len(n.files) for n in scans],
            "union": "Union" in kinds, "bucket_union": "BucketUnion" in kinds}


def _files_per_bucket(hs, name: str) -> dict:
    from hyperspace_tpu_torch.models.covering import bucket_id_from_filename

    per: dict = {}
    for f in hs.get_index(name).content.files():
        b = bucket_id_from_filename(f)
        per[b] = per.get(b, 0) + 1
    return {"files": sum(per.values()), "min": min(per.values()), "max": max(per.values())}


def _hard_link_tree(src: str, dst: str) -> None:
    os.makedirs(dst)
    for f in sorted(os.listdir(src)):
        os.link(os.path.join(src, f), os.path.join(dst, f))


def lifecycle_phase(torch, K, e2e: dict, rows: int, card: str, profile: bool = False) -> dict:
    """The index lifecycle and hybrid scan over a second lake (the module
    docstring lists the stages). Returns what each stage measured; with
    ``profile``, each query of stages 3-6 is profiled once more."""
    from hyperspace_tpu_torch import (CoveringIndexConfig, Hyperspace, HyperspaceSession,
                                      ZOrderCoveringIndexConfig)
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats

    t_phase = time.perf_counter()
    lake = os.path.join(DATA_DIR, "lake2")
    warehouse = os.path.join(DATA_DIR, "warehouse2")
    for table in ("lineitem", "orders"):
        _hard_link_tree(os.path.join(e2e["lake"], table), os.path.join(lake, table))
    n_files = len(os.listdir(os.path.join(lake, "lineitem")))
    n_deleted = n_files // 20  # 5% of the files (6 of 120 at SF10)
    require(n_deleted >= 1, f"lifecycle: {n_files} lineitem files, too few to delete 5%")
    deleted = [f"part-{10 + 20 * i:04d}.parquet" for i in range(n_deleted)]
    indexes = {"lc_shipdate_z": ("lineitem", ZOrderCoveringIndexConfig,
                                 tpch.LI_SHIPDATE_Z[1:]),
               "lc_orderkey": ("lineitem", CoveringIndexConfig, tpch.LI_ORDERKEY[1:]),
               "od_orderkey": ("orders", CoveringIndexConfig, tpch.OD_ORDERKEY[1:])}
    expected = {"q6_count": ["lc_shipdate_z"], "q6_sum": ["lc_shipdate_z"],
                "lookup_count": ["lc_orderkey"], "range_sum": ["lc_orderkey"],
                "q3_agg": ["lc_orderkey", "od_orderkey"]}
    queries = {q: ({**tpch.LOOKUP_QUERIES, **tpch.QUERIES, **tpch.JOIN_QUERIES})[q]
               for q in LIFECYCLE_QUERIES}
    session = HyperspaceSession(warehouse, conf={C.INDEX_LINEAGE_ENABLED: True})
    hs = Hyperspace(session)
    out: dict = {"deleted_files": deleted, "actions_s": {}, "stages": {}}

    def action(label: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        out["actions_s"][label] = time.perf_counter() - t0
        log({"lifecycle_action": label, "card": card, "seconds": out["actions_s"][label]})

    for name, (table, config, spec) in indexes.items():
        action(f"create {name}", lambda: hs.create_index(
            session.read.parquet(os.path.join(lake, table)), config(name, *spec)))
    session.enable_hyperspace()

    def result(q: str, df) -> dict:
        return _columns(df.collect()) if q == "q3_agg" else _floats(df.to_pydict())

    def host_reference() -> dict:
        host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
        t0 = time.perf_counter()
        want = {q: result(q, fn(host, lake)) for q, fn in queries.items()}
        out.setdefault("host_reference_s", []).append(time.perf_counter() - t0)
        return want

    def check(q: str, got: dict, want: dict) -> None:
        if q == "q3_agg":
            compare_join(q, got, want)
        else:
            compare_batches(q, got, want)

    def stage(label: str, want: dict, hybrid: bool, on_card: set, indexed: bool = True,
              bucket_union: bool = False, lineage: bool = False,
              warm_runs: int = LIFECYCLE_WARM_RUNS, plan_only: frozenset = frozenset()) -> None:
        """Run every query (first run, then warm runs), hold each to the
        host reference, check its plan and its route: ``on_card`` are the
        queries whose fragment or join must run on the device; of the
        ``plan_only`` ones only the plan is checked."""
        session.set_conf(C.HYBRID_SCAN_ENABLED, hybrid)
        rec: dict = {"hybrid": hybrid, "queries": {},
                     "lc_orderkey": _files_per_bucket(hs, "lc_orderkey")}
        K.reset_counts()  # this stage's launches start here
        for q, fn in queries.items():
            form = _plan_form(fn(session, lake).optimized_plan())
            if indexed:
                require(form["indexes"] == expected[q],
                        f"{label} {q}: plan reads {form['indexes']}, expected {expected[q]}")
            else:
                require(not any(i.startswith("lc_") for i in form["indexes"]),
                        f"{label} {q}: plan reads {form['indexes']} over a changed lake")
            li_lineage = [ids for i, ids in zip(form["indexes"], form["lineage_ids"])
                          if i.startswith("lc_")]
            require(all((ids is not None and len(ids) == n_deleted) == lineage
                        for ids in li_lineage), f"{label} {q}: lineage filters {li_lineage}")
            union = form["bucket_union"] if q == "q3_agg" else form["union"]
            require(union == (bucket_union and indexed),
                    f"{label} {q}: union form {form}")
            if q in plan_only:
                rec["queries"][q] = form
                continue
            session.device_stats = DeviceTierStats()
            before = dict(K.LAUNCHES)
            up0 = session.device_cache.uploaded_bytes
            t0 = time.perf_counter()
            got = result(q, fn(session, lake))
            first_s = time.perf_counter() - t0
            up1 = session.device_cache.uploaded_bytes
            check(q, got, want[q])
            warm, warm_up = [], []
            for _ in range(warm_runs):
                u = session.device_cache.uploaded_bytes
                t0 = time.perf_counter()
                again = result(q, fn(session, lake))
                warm.append(time.perf_counter() - t0)
                warm_up.append(session.device_cache.uploaded_bytes - u)
                check(q, again, want[q])
            runs = 1 + warm_runs
            launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
            stats = session.device_stats
            kernel = LIFECYCLE_QUERIES[q]
            if q == "q3_agg":
                want_paths = {"stacked_agg": runs} if q in on_card else stats.join_paths
                require(stats.join_paths == want_paths and stats.device_join_fragments
                        == (runs if q in on_card else 0),
                        f"{label} {q}: join paths {stats.join_paths}, declines "
                        f"{stats.declines}")
            else:
                ran = q in on_card
                require(stats.device_fragments == (runs if ran else 0),
                        f"{label} {q}: device fragments {stats.device_fragments}, "
                        f"declines {stats.declines}")
                require(launched[kernel] == (runs if ran else 0),
                        f"{label} {q}: {kernel} launched {launched[kernel]} times")
            require(all(c == 0 for k, c in launched.items() if k != kernel),
                    f"{label} {q}: unexpected launches {launched}")
            rec["queries"][q] = {
                **form, "first_run_s": first_s,
                "upload_bytes_first": up1 - up0, "upload_bytes_warm": warm_up,
                "warm_median_s": statistics.median(warm) if warm else None,
                "launches": launched, "join_paths": stats.join_paths,
                "device_fragments": stats.device_fragments, "matches_host": True}
            log({"lifecycle": label, "query": q, "card": card, **rec["queries"][q]})
        require(not any(K.PLAIN_CALLS.values()),
                f"{label}: plain versions ran on the card's path: {K.PLAIN_CALLS}")
        rec["launches"] = dict(K.LAUNCHES)
        for k in {LIFECYCLE_QUERIES[q] for q in on_card} - {None}:
            require(rec["launches"][k] > 0, f"{label}: {k} never launched")
        out["stages"][label] = rec
        log({"lifecycle_stage": label, "card": card, "launches": rec["launches"],
             "lc_orderkey_files_per_bucket": rec["lc_orderkey"]})
        if profile and label[0] in "3456":  # after the stage's counts are read
            for q, fn in queries.items():
                rec["queries"][q]["profile"] = profile_warm_run(
                    torch, lambda: fn(session, lake).collect(), f"lifecycle{label[0]}_{q}")
                log({"lifecycle": label, "query": q, "card": card,
                     "profile": rec["queries"][q]["profile"]})

    every = set(LIFECYCLE_QUERIES)
    # 1. build: the lake's data is the main phase's, so are the references
    stage("1_build", e2e["want"], hybrid=False, on_card=every)
    # 2. delete 5% of the lineitem files, hybrid scan off
    for f in deleted:
        os.unlink(os.path.join(lake, "lineitem", f))
    want = host_reference()
    # the raw scans still run on the device tier, as in the reference; q3_agg
    # over raw files is the host join the reference just ran, so only its
    # plan is checked, and the raw filter queries run once
    stage("2_deleted", want, hybrid=False, on_card=every - {"q3_agg"}, indexed=False,
          warm_runs=0, plan_only=frozenset({"q3_agg"}))
    # 3. hybrid scan on: lineage-filtered index scans
    stage("3_hybrid_deleted", want, hybrid=True, on_card=every, lineage=True)
    for name in ("lc_shipdate_z", "lc_orderkey"):
        action(f"refresh incremental (deletes) {name}",
               lambda: hs.refresh_index(name, C.REFRESH_MODE_INCREMENTAL))
    # 4. append 12 files (6M rows at SF10) of another seed, renamed
    extra = os.path.join(DATA_DIR, "extra")
    t0 = time.perf_counter()
    tpch.generate_tpch(extra, rows_lineitem=rows // 10, seed=APPEND_SEED)
    appended = sorted(os.listdir(os.path.join(extra, "lineitem")))
    for i, f in enumerate(appended):
        os.rename(os.path.join(extra, "lineitem", f),
                  os.path.join(lake, "lineitem", f"part-{9000 + i:04d}.parquet"))
    shutil.rmtree(extra)
    out["appended_files"] = len(appended)
    out["append_generate_s"] = time.perf_counter() - t0
    want = host_reference()
    stage("4_hybrid_appended", want, hybrid=True, on_card={"q3_agg"}, bucket_union=True)
    # 5. incremental refresh of the appends: a second run in every bucket
    for name in ("lc_shipdate_z", "lc_orderkey"):
        action(f"refresh incremental (appends) {name}",
               lambda: hs.refresh_index(name, C.REFRESH_MODE_INCREMENTAL))
    stage("5_refreshed", want, hybrid=False, on_card=every)
    require(out["stages"]["5_refreshed"]["lc_orderkey"]["min"] == 2,
            f"refresh: {out['stages']['5_refreshed']['lc_orderkey']}")
    # 6. optimize (quick): one file per bucket again
    action("optimize quick lc_orderkey", lambda: hs.optimize_index("lc_orderkey"))
    stage("6_optimized", want, hybrid=False, on_card=every)
    out["files_per_bucket_optimize"] = {
        "before": out["stages"]["5_refreshed"]["lc_orderkey"],
        "after": out["stages"]["6_optimized"]["lc_orderkey"]}
    require(out["files_per_bucket_optimize"]["after"]["max"] == 1,
            f"optimize: {out['files_per_bucket_optimize']}")
    log({"lifecycle": "files per bucket of lc_orderkey", "card": card,
         **out["files_per_bucket_optimize"]})

    # 7. vacuum-outdated, delete, restore, each with a plan check; then
    # delete and vacuum every index
    def reads(q: str) -> list:
        return _plan_form(queries[q](session, lake).optimized_plan())["indexes"]

    for name in ("lc_shipdate_z", "lc_orderkey"):
        action(f"vacuum outdated {name}", lambda: hs.vacuum_outdated_index(name))
    index_dirs = {n: sorted(d for d in os.listdir(os.path.join(warehouse, "indexes", n))
                            if d.startswith("v__=")) for n in indexes}
    require(index_dirs["lc_orderkey"] == ["v__=3"], f"vacuum outdated: {index_dirs}")
    require(all(reads(q) == expected[q] for q in queries), "plans after vacuum outdated")
    action("delete lc_shipdate_z", lambda: hs.delete_index("lc_shipdate_z"))
    require(reads("q6_count") == [], f"after delete: {reads('q6_count')}")
    action("restore lc_shipdate_z", lambda: hs.restore_index("lc_shipdate_z"))
    require(reads("q6_count") == ["lc_shipdate_z"], "after restore")
    compare_batches("q6_count after restore",
                    result("q6_count", queries["q6_count"](session, lake)), want["q6_count"])
    for name in indexes:
        action(f"delete {name}", lambda: hs.delete_index(name))
        action(f"vacuum {name}", lambda: hs.vacuum_index(name))
    left = {n: sorted(os.listdir(os.path.join(warehouse, "indexes", n))) for n in indexes}
    require(all(v == ["_hyperspace_log"] for v in left.values()), f"after vacuum: {left}")
    require(all(reads(q) == [] for q in queries), "plans after vacuum")
    out["index_dirs_after_vacuum_outdated"] = index_dirs
    out["launches"] = {k: sum(st["launches"][k] for st in out["stages"].values())
                       for k in K.LAUNCHES}
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "lifecycle", "card": card, "seconds": out["seconds"],
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# skipping phase
# ---------------------------------------------------------------------------

def _write_columns(path: str, columns: dict) -> None:
    """One parquet source file from numpy columns."""
    from hyperspace_tpu_torch.columnar import io as cio
    from hyperspace_tpu_torch.columnar.table import Column, ColumnBatch

    cio.write_parquet(ColumnBatch({k: Column(a, str(a.dtype)) for k, a in columns.items()}),
                      path)


def _store_sales_file(rng, i: int, per: int) -> dict:
    """bench.py's store_sales file i: item keys from the file-local range
    [100,000 i, 100,000 (i + 1)), ss_net_paid uniform in [1, 300)."""
    return {"ss_item_sk": rng.integers(i * 100_000, (i + 1) * 100_000, per),
            "ss_net_paid": rng.uniform(1, 300, per)}


def pq_column(path: str, name: str):
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=[name]).column(name).to_numpy()


def _scan_of(plan):
    return [n for n in plan.preorder() if n.kind == "FileScan"][0]


def _kept(scan) -> dict:
    """What a scan reads: its files, and the row groups and rows of them.
    An index scan reads its pruning's selection; a source scan reads the
    groups whose footer statistics can hold a match of the pushed filter's
    min-max-convertible conjuncts, which is what the parquet reader's
    filter skips by."""
    from dataclasses import replace

    from hyperspace_tpu_torch.columnar import io as cio
    from hyperspace_tpu_torch.plan import pruning
    from hyperspace_tpu_torch.plan.executor import resolve_scan_pruning
    from hyperspace_tpu_torch.plan.expr import split_conjunction

    if scan.index_info is None or scan.index_info.index_kind_abbr == "DS":
        cols = tuple(sorted(scan.pushed_filter.references())) if scan.pushed_filter else ()
        spec = pruning.PruneSpec("source", 1, (), cols)
        conjs = (pruning._rowgroup_conjuncts(split_conjunction(scan.pushed_filter), spec)
                 if cols else ())
        scan = scan.copy(prune_spec=replace(spec, rowgroup_conjuncts=conjs))
    row_groups, files = resolve_scan_pruning(scan)
    groups = rows = 0
    for f in files:
        stats = cio.read_rowgroup_stats(f.name, [])
        sel = (row_groups or {}).get(f.name, range(len(stats)))
        groups += len(sel)
        rows += sum(stats[g]["num_rows"] for g in sel)
    out = {"files_in_plan": len(scan.files), "files_kept": len(files),
           "row_groups_kept": groups, "rows_kept": rows}
    if scan.prune_spec is not None and scan.prune_spec.sketch_conjuncts:
        # the same scan with its footer (min-max) stage alone
        footer = _kept(scan.copy(prune_spec=replace(scan.prune_spec, sketch_conjuncts=())))
        out["row_groups_footer_stage"] = footer["row_groups_kept"]
        out["rows_footer_stage"] = footer["rows_kept"]
        # the planner's NDV-model prediction of the sketch stage's kept share
        out["sketch_fraction_predicted"] = scan.prune_spec.sketch_fraction
    return out


def skipping_phase(torch, K, e2e: dict, rows: int, card: str, profile: bool = False) -> dict:
    """Data skipping, the sidecar sketch stage and the string and Wide64
    predicate routes (the module docstring lists the parts). Every query
    is held to the host executor over the raw files of its lake; every
    kernel-shaped query must launch filter_sum on the card, once per run,
    with no decline. With ``profile``, each kernel-shaped query is
    profiled once more (its launches are left out of the phase's)."""
    import numpy as np

    from hyperspace_tpu_torch import (BloomFilterSketch, CoveringIndexConfig,
                                      DataSkippingIndexConfig, Hyperspace, HyperspaceSession,
                                      MinMaxSketch)
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.plan.expr import Count, Sum, col, lit
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats

    t_phase = time.perf_counter()
    out: dict = {"queries": {}, "actions_s": {}, "sidecar": {}}
    K.reset_counts()  # the phase's launches start here
    profiled = dict.fromkeys(K.LAUNCHES, 0)  # launches of the profiled runs

    def action(label: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        out["actions_s"][label] = time.perf_counter() - t0
        log({"skipping_action": label, "card": card, "seconds": out["actions_s"][label]})

    def host_result(label: str, warehouse: str, make) -> dict:
        """The host executor over the raw files (no index, no device)."""
        host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
        t0 = time.perf_counter()
        want = _floats(make(host).to_pydict())
        out.setdefault("host_reference_s", {})[label] = time.perf_counter() - t0
        return want

    def run(label: str, session, make, want: dict, index, files_in_plan=None) -> dict:
        """A kernel-shaped query on the card: its plan reads ``index`` (None:
        the source files) over ``files_in_plan`` files where given, and the
        first run and each warm run equal ``want`` and launch filter_sum
        once, with no decline."""
        scan = _scan_of(make(session).optimized_plan())
        name = None if scan.index_info is None else scan.index_info.index_name
        require(name == index, f"{label}: plan reads {name}, expected {index}")
        rec = {"index": name, **_kept(scan)}
        require(files_in_plan is None or rec["files_in_plan"] == files_in_plan,
                f"{label}: the plan reads {rec['files_in_plan']} files, "
                f"expected {files_in_plan}")
        session.device_stats = DeviceTierStats()
        before = dict(K.LAUNCHES)
        up0 = session.device_cache.uploaded_bytes
        t0 = time.perf_counter()
        got = _floats(make(session).to_pydict())
        rec["first_run_s"] = time.perf_counter() - t0
        rec["upload_bytes_first"] = session.device_cache.uploaded_bytes - up0
        compare_batches(label, got, want)
        warm, warm_up = [], []
        for _ in range(SKIP_WARM_RUNS):
            u = session.device_cache.uploaded_bytes
            t0 = time.perf_counter()
            compare_batches(label, _floats(make(session).to_pydict()), want)
            warm.append(time.perf_counter() - t0)
            warm_up.append(session.device_cache.uploaded_bytes - u)
        runs = 1 + SKIP_WARM_RUNS
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        stats = session.device_stats
        require(stats.device_fragments == runs and not stats.declines,
                f"{label}: device fragments {stats.device_fragments}, "
                f"declines {stats.declines}")
        require(launched == {k: (runs if k == "filter_sum" else 0) for k in K.LAUNCHES},
                f"{label}: launches {launched}")
        rec.update({"warm_s": warm, "upload_bytes_warm": warm_up, "launches": launched,
                    "rows_out": got.get("n", got.get("count")), "matches_host": True})
        if profile:  # after the run's counts are read
            before = dict(K.LAUNCHES)
            rec["profile"] = profile_warm_run(torch, lambda: make(session).collect(),
                                              f"skipping_{label}")
            for k in K.LAUNCHES:
                profiled[k] += K.LAUNCHES[k] - before[k]
        out["queries"][label] = rec
        log({"skipping": label, "card": card, **rec})
        return rec

    # (a) BASELINE config 3: li_shipdate_mm over the main phase's lake
    lake, warehouse = e2e["lake"], e2e["warehouse"]
    session = HyperspaceSession(warehouse).enable_hyperspace()  # device=None: the card
    make = lambda s: tpch.q6_tax_sum(s, lake)
    want = host_result("q6_tax_sum", warehouse, make)
    run("q6_tax_sum", session, make, want, index=None)
    last = session.dataskipping_stats.last
    require(last.get("index") == tpch.LI_SHIPDATE_MM[0] and last.get("files_pruned") == 0
            and last.get("files_total") == len(os.listdir(os.path.join(lake, "lineitem"))),
            f"q6_tax_sum: the data-skipping rule was not consulted as expected: {last}")
    out["queries"]["q6_tax_sum"]["dataskipping"] = last["message"]
    log({"skipping": "q6_tax_sum", "card": card, "rule": last["message"]})

    # (d) the string route over li_flagstatus
    make = lambda s: tpch._lineitem(s, lake).filter(col("l_returnflag") == "R").agg(
        Sum(col("l_extendedprice")).alias("sum_price"), Count(lit(1)).alias("count"))
    run("flag_sum", session, make, host_result("flag_sum", warehouse, make),
        index=tpch.LI_FLAGSTATUS[0])
    del session

    # (b) BASELINE config 5: bloom skipping over store_sales
    n_ss = max(2_000_000, min(rows, SS_ROWS))
    per = n_ss // SS_FILES
    ss_root = os.path.join(DATA_DIR, "store_sales_lake")
    ss = os.path.join(ss_root, "store_sales")
    os.makedirs(ss)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SS_SEED)
    for i in range(SS_FILES):
        _write_columns(os.path.join(ss, f"part-{i:02d}.parquet"), _store_sales_file(rng, i, per))
    key = int(rng.integers(3 * 100_000, 4 * 100_000))  # bench.py's draw
    out["store_sales"] = {"rows": n_ss, "files": SS_FILES, "rows_per_file": per,
                          "generate_s": time.perf_counter() - t0, "key": key}
    if not (pq_column(os.path.join(ss, "part-03.parquet"), "ss_item_sk") == key).any():
        # present at SF10's 62,500 rows a file; at a smaller --rows the draw
        # may miss, and a pruned-to-nothing scan runs no kernel
        key = int(pq_column(os.path.join(ss, "part-03.parquet"), "ss_item_sk")[0])
        out["store_sales"]["key_present_instead"] = key
    ss_wh = os.path.join(ss_root, "warehouse")
    session = HyperspaceSession(ss_wh)
    hs = Hyperspace(session)
    action("create ss_bloom", lambda: hs.create_index(session.read.parquet(ss),
           DataSkippingIndexConfig("ss_bloom", [BloomFilterSketch("ss_item_sk", per, 0.01)])))

    def point(k):
        return lambda s: s.read.parquet(ss).filter(col("ss_item_sk") == k).agg(
            Sum(col("ss_net_paid")).alias("s"), Count(lit(1)).alias("n"))

    lo = 100 * 100_000
    ranged = lambda s: s.read.parquet(ss).filter(
        (col("ss_item_sk") >= lo) & (col("ss_item_sk") < lo + 4 * 100_000)).agg(
        Sum(col("ss_net_paid")).alias("s"), Count(lit(1)).alias("n"))
    want = host_result("ss_point", ss_wh, point(key))
    run("ss_point_raw", session, point(key), want, index=None, files_in_plan=SS_FILES)
    session.enable_hyperspace()
    rec = run("ss_point_bloom", session, point(key), want, index="ss_bloom")
    require(0 < rec["files_in_plan"] < SS_FILES, f"ss_point_bloom: {rec}")
    action("create ss_minmax", lambda: hs.create_index(session.read.parquet(ss),
           DataSkippingIndexConfig("ss_minmax", [MinMaxSketch("ss_item_sk")])))
    run("ss_range_minmax", session, ranged, host_result("ss_range", ss_wh, ranged),
        index="ss_minmax", files_in_plan=4)
    # the kind's lifecycle: 2 files deleted, 2 appended, then refreshes
    for f in ("part-101.parquet", "part-200.parquet"):
        os.unlink(os.path.join(ss, f))
    rng = np.random.default_rng(SS_APPEND_SEED)
    for i in (SS_FILES, SS_FILES + 1):
        appended = _store_sales_file(rng, i, per)
        _write_columns(os.path.join(ss, f"part-{i:02d}.parquet"), appended)
    new_key = int(appended["ss_item_sk"][0])  # a key of the last appended file
    # (query, the files its plan reads): the point lookups one file, the
    # range its four files less the deleted part-101
    changed = {"ss_point": (point(key), 1), "ss_range": (ranged, 3),
               "ss_point_appended": (point(new_key), 1)}
    want = {q: host_result(q, ss_wh, m) for q, (m, _n) in changed.items()}
    for mode in ("incremental", "full"):
        for name in ("ss_bloom", "ss_minmax"):
            action(f"refresh {mode} {name}", lambda: hs.refresh_index(name, mode))
        for q, (m, n_files) in changed.items():
            # both indexes bound Eq: the ranker takes the greater name
            run(f"{q}_{mode}", session, m, want[q], index="ss_minmax", files_in_plan=n_files)
    # the reference's dataskipping.* counters, as the session keeps them
    out["store_sales"]["dataskipping_stats"] = dict(vars(session.dataskipping_stats))
    log({"skipping": "store_sales dataskipping_stats", "card": card,
         **out["store_sales"]["dataskipping_stats"]})
    del session, hs
    shutil.rmtree(ss_root)

    # (c) the sidecar sketch stage: bench.py's events_sk lake
    n_ev = max(400_000, min(rows, EV_ROWS))
    per = n_ev // EV_FILES
    ev_root = os.path.join(DATA_DIR, "events_lake")
    ev = os.path.join(ev_root, "events_sk")
    os.makedirs(ev)
    rng = np.random.default_rng(EV_SEED)
    cat_div = max(1, n_ev // 64)
    t0 = time.perf_counter()
    for i in range(EV_FILES):
        k = np.arange(per, dtype=np.int64) + i * per
        _write_columns(os.path.join(ev, f"part-{i:02d}.parquet"), {
            "ev_k": k, "ev_id": k + 10_000_000, "ev_cat": k // cat_div,
            "ev_v": rng.uniform(0, 100, per)})
    out["events"] = {"rows": n_ev, "files": EV_FILES, "generate_s": time.perf_counter() - t0}
    ev_wh = os.path.join(ev_root, "warehouse")
    session = HyperspaceSession(ev_wh)
    hs = Hyperspace(session)
    prev = os.environ.get("HYPERSPACE_SKETCHES")
    os.environ["HYPERSPACE_SKETCHES"] = "1"
    try:
        action("create ev_sk_idx (sketches on)", lambda: hs.create_index(
            session.read.parquet(ev),
            CoveringIndexConfig("ev_sk_idx", ["ev_k"], ["ev_id", "ev_cat", "ev_v"])))
        ev_key = int(10_000_000 + n_ev * 5 // 8 + 17)
        cats = [3, int((n_ev - 1) // cat_div) - 1]
        sidecar_queries = {
            "eq": lambda s: s.read.parquet(ev).filter(col("ev_id") == ev_key)
            .select("ev_k", "ev_id", "ev_cat").sort("ev_k"),
            "in": lambda s: s.read.parquet(ev).filter(col("ev_cat").isin(cats))
            .select("ev_k", "ev_cat").sort("ev_k"),
        }
        for q, make in sidecar_queries.items():
            legs = {}
            for leg, (on, sketches) in {"raw": (False, "0"), "minmax_only": (True, "0"),
                                        "sketches": (True, "1")}.items():
                os.environ["HYPERSPACE_SKETCHES"] = sketches
                if on:
                    session.enable_hyperspace()
                else:
                    session.disable_hyperspace()
                scan = _scan_of(make(session).optimized_plan())
                kept = _kept(scan)
                t0 = time.perf_counter()
                got = make(session).to_pydict()
                first_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                again = make(session).to_pydict()
                legs[leg] = {"index": None if scan.index_info is None
                             else scan.index_info.index_name, **kept, "first_run_s": first_s,
                             "warm_s": time.perf_counter() - t0,
                             "rows_out": len(got["ev_k"])}
                require(again == got, f"sidecar {q} {leg}: a warm run differs")
                legs[leg]["result"] = got
            results = [legs[leg].pop("result") for leg in legs]
            require(results[0] == results[1] == results[2] and results[0]["ev_k"],
                    f"sidecar {q}: the three legs differ")
            # the minmax-only legs read the source files (the index does not
            # qualify without sketches: its first column is not filtered);
            # the sketch stage is held against the index scan's footer
            # (min-max) stage, which cannot bound a non-sort column
            sk = legs["sketches"]
            require(sk["index"] == "ev_sk_idx"
                    and sk["row_groups_kept"] < sk["row_groups_footer_stage"],
                    f"sidecar {q}: the sketch stage skipped nothing: {legs}")
            out["sidecar"][q] = legs
            log({"sidecar": q, "card": card, **legs})
        os.environ["HYPERSPACE_SKETCHES"] = "1"
        session.enable_hyperspace()
        make = lambda s: s.read.parquet(ev).filter(col("ev_id") == ev_key).agg(
            Sum(col("ev_v")).alias("s"), Count(lit(1)).alias("n"))
        rec = run("ev_point_sum", session, make, host_result("ev_point_sum", ev_wh, make),
                  index="ev_sk_idx")
        require(rec["row_groups_kept"] < rec["row_groups_footer_stage"],
                f"ev_point_sum: the sketch stage skipped nothing: {rec}")
    finally:
        if prev is None:
            os.environ.pop("HYPERSPACE_SKETCHES", None)
        else:
            os.environ["HYPERSPACE_SKETCHES"] = prev
    del session, hs
    shutil.rmtree(ev_root)

    # (d) the Wide64 route: a full-range int64 column compared on the card
    wide_root = os.path.join(DATA_DIR, "wide_lake")
    wide = os.path.join(wide_root, "wide")
    os.makedirs(wide)
    rng = np.random.default_rng(WIDE_SEED)
    w = rng.integers(-(2**62), 2**62, WIDE_ROWS)
    w[0], w[1], w[2] = 2**40 + 7, -(2**40) - 7, 2**31  # tests/test_tpu_exec.py's plants
    x = rng.uniform(0, 10, WIDE_ROWS)
    for i, part in enumerate(np.array_split(np.arange(WIDE_ROWS), 4)):
        _write_columns(os.path.join(wide, f"part-{i}.parquet"), {"w": w[part], "x": x[part]})
    make = lambda s: s.read.parquet(wide).filter(col("w") > 2**40).agg(
        Sum(col("x")).alias("s"), Count(lit(1)).alias("n"))
    wide_wh = os.path.join(wide_root, "warehouse")
    run("wide64_sum", HyperspaceSession(wide_wh), make,
        host_result("wide64_sum", wide_wh, make), index=None, files_in_plan=4)
    shutil.rmtree(wide_root)

    out["launches"] = {k: K.LAUNCHES[k] - profiled[k] for k in K.LAUNCHES}
    require(out["launches"]["filter_sum"] > 0, "skipping: filter_sum never launched")
    require(not any(K.PLAIN_CALLS.values()),
            f"skipping: plain versions ran on the card's path: {K.PLAIN_CALLS}")
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "skipping", "card": card, "seconds": out["seconds"],
         "launches": out["launches"]})
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
    torch.cuda.empty_cache()
    lifecycle = lifecycle_phase(torch, K, e2e, args.rows, smi, args.profile)
    del e2e["want"]
    torch.cuda.empty_cache()
    skipping = skipping_phase(torch, K, e2e, args.rows, smi, args.profile)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    order = order_phase(torch, ORDER_ROWS if args.rows == SF10_ROWS else _pad_pow2(args.rows),
                        smi)
    # after the queries' profiles: a profiler session before them lost
    # their short runs' device events
    for name, call in timed.items():
        profile_kernel(torch, call, name)

    line = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        r = kernels[name]
        by_query = {q: v["launches"][name]
                    for q, v in {**e2e["queries"], **skipping["queries"]}.items()
                    if v["launches"][name]}
        by_phase = {"end_to_end": e2e["main_path_launches"][name],
                    "lifecycle": lifecycle["launches"][name],
                    "skipping": skipping["launches"][name]}
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
            "launches_by_query": by_query, "runs_per_query": 1 + WARM_RUNS,
            "runs_per_skipping_query": 1 + SKIP_WARM_RUNS,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "on_path": name in ON_PATH,
            "status": f"built, {r['checks']} checks against the plain version passed",
        })
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": {"kind": kind, "nvidia_smi": smi}, "build_s": build_s,
                   "kernels": kernels, "end_to_end": e2e, "lifecycle": lifecycle,
                   "skipping": skipping, "order": order,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    log({"phase": "done", "card": smi, "total_s": time.perf_counter() - t_start})
    log({"kernels": line})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
