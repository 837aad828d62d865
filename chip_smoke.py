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
   max exact (NaN, all-invalid, all-valid and empty inputs included, and
   masked_min_max also at its tile edges, 511-4097 rows), two launches
   bit-identical; then each kernel's time at the main path's padded size:
   per call with the wrapper included (CUDA events around one call, median
   of 25) and on the device (CUDA events around 50 back-to-back launches,
   over 50), beside its bound and the plain version's per-call time, and
   beside the fastest of two compositions of PyTorch calls that compute the
   same function (device time as above; kernel_compositions names them;
   no single library call computes any of the four), each held to the plain
   version first. With
   --profile, a torch.profiler pass per kernel splits a call into its CUDA
   kernels (chiprun_out/profile_kernel_<name>.txt);
4. end-to-end phase: TPC-H lineitem at SF10 (60M rows, seed 42), orders
   (15M rows) and part (2M rows) written as parquet, the reference's index
   set built over them (tpch_indexes: the z-order index li_shipdate_z, the
   covering indexes li_orderkey, li_partkey, li_flagstatus, od_orderkey and
   pt_partkey, the data-skipping index li_shipdate_mm; each build timed),
   then
   - the filter-aggregate queries q6, q6_count, q6_sum, q1 and q1_sums, and
     the partial route's forms q6_span and q1_span (count, min and max of
     l_shipdate), run through the normal API with Hyperspace enabled. The
     q6 forms must read li_shipdate_z and the q1 forms li_flagstatus
     (through AggregateIndexRule); each must run on the device tier, launch
     its kernel where it has one, match the host executor over the raw
     source with Hyperspace and the device tier off, and upload nothing on
     a warm run. Each filter-aggregate query's first run prints its route:
     an index scan of several files streams ("pipelined"; at SF10 every q6
     and q1 form), the q6 and q1 forms and range_sum on the concat route,
     which still launches their kernel once per run, the span forms on the
     partial route; a scan of one file takes the monolithic "device" route.
     Beside it, its chunks, host decode seconds (the chunks' sum) and
     upload seconds (CUDA events around each copy, read after the query);
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
   from its tests only), so it launches no time in this phase. The card's
   first-run results of q6, q1 and q3 are also held to the pandas answers
   of benchmark/external.py (PANDAS_TPCH) over the same lake, an engine
   the port does not share: keys and counts exact, sums within relative
   1e-4, q3's top 10 as against the host;
5. lifecycle phase: a second lake whose lineitem hard-links the first
   20 of the SF10 lake's 120 files (10M rows, a sixth: the phase's depth,
   cut to keep the whole run well inside its time limit) and whose orders
   hard-links the SF10 orders, with its own warehouse, lineage on, and
   three indexes over it: lc_shipdate_z (li_shipdate_z's config), lc_orderkey (li_orderkey's)
   and od_orderkey. Stages, each running q6_count, q6_sum, lookup_count,
   range_sum and q3_agg through the normal API (first run and warm runs,
   each compared with the host executor over the lake's current files):
   1. build;
   2. 1 of the 20 lineitem files deleted, hybrid scan off: no lc_ index
      may serve lineitem;
   3. hybrid scan on: the lineitem scans drop the deleted files' rows by
      lineage, filter_weighted_sum and filter_sum launch on them and the
      join runs on the card; then refresh_index(mode="incremental") of
      both indexes takes the deletes in (each bucket rewritten);
   4. files appended (generate_tpch's lineitem at a tenth of the
      lake's rows, 1M, seed 43, renamed): the filter queries read a Union on the host, as in the
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
       with sum(ev_v) and count) runs on the card over the kept groups.
       The build's pruning.sketch.sidecars_written and sketches_built
       must count the sidecar files it wrote and the sketches in them, and
       ev_point_sum run once more under HYPERSPACE_PRUNE=verify must equal
       the host and count pruning.verified once, as the JAX package does;
   (d) the predicate routes: flag_sum (l_returnflag = 'R') over
       li_flagstatus through the dictionary-code rewrite, and wide64_sum
       (w > 2^40 over a full-range int64 column, 2^22 rows) through Wide64
       word pairs;
   (e) the z-order conf keys: a seeded 2^22-row table (four 8-byte
       columns, 8 files, seed 29) z-ordered on (za, zb) into two
       warehouses, once with min-max fields and once with
       hyperspace.index.zorder.quantile.enabled=true, each with
       hyperspace.index.zorder.targetSourceBytesPerPartition at an eighth of
       the index data's bytes, so that each build writes several files (its
       seconds and file count printed); a count and a weighted sum over a
       box on (za, zb) through each index launches filter_weighted_sum once
       per run and equals the host executor over the raw files. The
       sidecar legs of (c) must count cache.sketch hits or misses (the
       counters printed), and the knob registry's size is printed. No
       plain version may run. With --profile, each kernel-shaped query is
       profiled once more after its counts are read
       (chiprun_out/profile_skipping_<q>.txt);
7. pipeline phase over the SF10 lake:
   (a) the first runs of q6_count, q6_sum, q1_sums and q6_tax_sum, each on
       a fresh session under HYPERSPACE_PIPELINE 0, serial and 1: results
       equal bit for bit across the modes, the concat route under serial
       and 1, the kernel launched once; wall, decode and upload seconds
       printed per mode;
   (b) q3_agg and q3 under 0 (the load-all barrier) and 1 (bucket-pair
       read-ahead): the same bits;
   (c) a third warehouse over hard links to the first 20 of the lake's
       120 lineitem files (10M rows: the lifecycle phase's cut, made to
       keep the whole run well inside its time limit), with
       hyperspace.tpu.build.maxBytesInMemory at a quarter of their bytes
       (at most 256 MiB) and lineage on:
       st_orderkey (li_orderkey's config) and st_shipdate_z
       (li_shipdate_z's) must build out of core, one run per file group in
       every bucket or range (st_shipdate_z has one range over 20M rows,
       two over 60M), with the rows of their source files (sorted
       row hashes equal); q6_count, q6_span, lookup_count and range_sum
       through them held to the host and launching their kernels; then 2
       source files deleted, an incremental refresh of st_orderkey that
       must stream (each old file rewritten alone), a quick optimize to one
       file per bucket, and the queries again (q6's forms over the source,
       st_shipdate_z being stale). Each build's seconds print beside the
       lifecycle phase's in-memory build of the same config over the same
       files;
8. join phase over the SF10 lake (its bucketed joins' routes):
   (a) at the default device grant, q3, q3_agg, q3_span (port-only: Q3's
       join and groups with count, min and max of l_quantity, which may
       split), q10, q17 and q18 on one new session: each bucketed join's
       strategy plan (broadcast, banded and split buckets, the derived
       split rows), band waves, splits, spills and parks printed; no
       spill and no decline; results the main phase's bits, q3_span's
       groups equal to an arrow join and aggregate over the raw files;
       q18 has no bucketed join, so no plan;
   (b) at HYPERSPACE_DEVICE_BUDGET_MB=256, then with
       HYPERSPACE_JOIN_SPLIT_ROWS=262144 too (65536 before part (f) of
       the gates phase came): q3 (a sum, which never
       splits) and q3_span (which must split) through the stacked fused
       join, each parking or spilling, with (a)'s bits;
   (c) q3_agg under HYPERSPACE_PIPELINE=0 with maxBytesInMemory (1 MiB)
       below its indexes' bytes: the per-bucket route, the fused
       join+aggregate on the card once per occupied bucket (8), held to
       the host executor and to the stacked route's result; first-run and
       warm seconds beside the stacked route's;
   (d) q3 and q10 under HYPERSPACE_PIPELINE 1 (pairs streamed) and 0
       (the barrier), a first run each on a fresh session, then warm runs
       in turns (1, 0; 1, 0, 0, 1 before the gates phase): the same bits;
       wall and pair-load (decode) seconds;
   (e) the native host kernels (hyperspace_tpu_torch/native) over the
       lake's first 2^23 l_orderkey values (and 2^21 o_orderkey values;
       all 60M and 15M at first, 2^24 and 2^22 before the gates phase,
       cut to keep the whole run inside its time limit) against their
       numpy forms, outputs
       equal, both timed: hash32, bucket_partition into 8 buckets,
       radix_argsort, and join_i64 of l_orderkey against o_orderkey; the
       main phase's index build seconds are printed with them;
9. sources phase (the source providers and the readers), each query held
    to the host executor over its raw source, its indexes, route and
    kernel launches checked, then its lakes removed:
    (a) the first 12 lineitem files (6M rows, cut to keep the whole run
        inside its time limit) written hive-partitioned by
        l_returnflag/l_linestatus (the two columns only in the paths; the
        generator draws them independently, so six directories): raw q1 on
        the card (the scan attaches each partition's values), a partition
        filter on the host that must read only the R directories (its rows
        held to arrow over the source files), the covering index
        pt_flagstatus (li_flagstatus's config) that q1_sums reads through
        filter_grouped_multi_sum, and the data-skipping pt_shipdate_mm with
        its automatic PartitionSketches, consulted by q6_count on the raw
        lake (filter_weighted_sum);
    (b) SF10's orders as 16 CSV files with a header (read back and held to
        the parquet orders), the covering index csv_od_orderkey over them in
        the main warehouse: q3_agg with li_orderkey through the fused join,
        held to the main phase's host result and device result, and a key
        range's count and date span over the CSV index; then the index is
        deleted and vacuumed;
    (c) a snapshot (Delta-style) lineitem of the same 6M rows committed in
        four versions of 1.5M: a lineage-enabled z-order index at v1, v2 and
        v3 committed and an incremental refresh; q6_count and q6_sum at v3,
        q6_count at v1 by time travel (the log version recorded for v1);
        v0's file deleted (v4), q6_count by hybrid scan (lineage ids), an
        incremental refresh, q6_count again;
    (d) an Iceberg-style orders of three 5M-row snapshots (ids from a
        seeded generator): an index at s0, a full refresh at s2, the key
        range's span by snapshot id and by time; the log version each
        reads follows the ancestry chain (s1 reads the source: its nearest
        recorded ancestor was built over other files);
10. reference-cache check: a first and a warm run of q6_count and q1_sums
    in a fresh session at the JAX package's cache budgets (the smoke runs
    at 16 GiB of index chunks, 16 GiB of device columns and 2 GiB of
    host-derived arrays, set through the same HYPERSPACE_*_CACHE_MB knobs
    and printed at the start), with ms and upload bytes;
11. analysis phase (the analysis views and the telemetry core) over the
    SF10 lake and the main phase's indexes, in a fresh session on the card:
    (a) explain(verbose) of q6, q1, q3, q10, q17 and q18, each listing the
        indexes its optimized plan reads; (b) whyNot of q3 (extended) and
        q18; (c) EXPLAIN ANALYZE of q6_count, q1_sums, range_sum,
        lookup_count, q3_agg and q10, warm: each kernel's launches and the
        device tier's route record equal a plain warm run's, the analyzed
        run has the plain run's bits (q3_agg's and q10's the main phase's
        device result, the others held to its host result), the root
        node's rows are the result's and the notes hold the route taken;
        (d) profile of q6_count and q3_agg: the span tree holds query ->
        plan -> rule:* and exec:* -> kernel:* (q3_agg: join:band), with a
        dispatch and no upload on the warm run, each span's ms printed;
        (e) warm q6_count and q1_sums untraced and traced, five runs each
        in turns, the same bits, both medians printed; (f) the min/max
        layout comparison of l_shipdate over the raw lineitem against
        li_shipdate_z, printed. The phase launches filter_weighted_sum,
        filter_sum and filter_grouped_multi_sum, and no plain version;
12. serve phase (the serving plane and the rest of telemetry) over the
    SF10 lake and tpch_indexes in the analysis phase's session: a
    QueryScheduler of four workers, the tenants of the HYPERSPACE_TENANTS
    spec "dash:weight=3;batch:weight=1,max_active=2", the workload journal
    in a scratch directory and the exporter on an ephemeral port of
    127.0.0.1. 48 submissions of the warm mix (q6_count, q6_sum, q1_sums,
    lookup_count and range_sum under dash; q3_agg and q1 under batch) each
    equal, bit for bit, the same query's direct warm result of this
    session and of the end-to-end phase; then a running q18 is cancelled
    mid-stream (a read-ahead or device-ledger stream of its own open): it
    resolves "cancelled", the read-ahead and device ledgers hold 0 bytes
    and no snapshot pin is left. Over the window, the per-query (and
    per-tenant) sums of every io., cache., rpc., pipeline., pruning. and
    serve.budget. counter equal the global deltas; /metrics, /snapshot
    and /healthz answer once (/healthz 200 "ok"); the journal holds one
    record per served query; index_report counts each served query
    against li_shipdate_z, li_flagstatus or li_orderkey, the first and the
    last with a benefit above 0 (li_flagstatus's queries decode more bytes
    than the raw files hold, which the reference's benefit clamps to 0).
    Printed: the served wall beside
    the sum of the direct warm medians, queue-wait p50 and p99 per tenant,
    the cancel-to-resolution seconds and each kernel's launches; kernels
    1-3 launch in the window and no plain version runs;
13. staticcheck phase (the static checks) over the SF10 lake and
    tpch_indexes in the serve phase's session (staticcheck_phase's
    docstring has each check): 16 submissions of the warm mix (q6_count,
    q6_sum, q1_sums, lookup_count, range_sum, q3_agg) served under the
    lock-order and lifecycle audits, each bit for bit the end-to-end
    phase's, a running q18 cancelled mid-stream, then check_quiescent();
    every TPCH_QUERIES plan and the kernel-shaped forms verified under
    HYPERSPACE_VERIFY_PLAN=1 (and in the approx phase, q3_revenue's
    sampled plans over the twins); the kernel cache cleared and the mix
    run once under HYPERSPACE_KERNEL_AUDIT=1, bit for bit; warm q6_count
    and q1_sums with the audits off and on, in turns. Printed: lock
    acquisitions, edges and violations, lifecycle acquires, releases and
    leaks, plan runs, nodes and violations, hazards by kind and code,
    retrace storms and the warm milliseconds (`{"staticcheck": ...}`
    lines); a lock-order violation, a leak, a plan violation or a result
    that differs fails the run;
14. approx phase (the approximate tier, the adaptive executor and the
    Arrow IPC index format; approx_phase's docstring has each check):
    run before the ingest phase, whose appends leave the lineitem indexes
    but li_orderkey stale:
    (a) a fresh warehouse with HYPERSPACE_APPROX=1 and fractions 0.01 and
        0.1: li_orderkey and od_orderkey over the SF10 lake with their
        sample twins (twins per fraction, kept rows against f·rows, build
        seconds beside the end-to-end phase's build without twins);
        q3_revenue (port-only: q3_agg's join and filter with sum(revenue)
        and count, no groups) exact, then sampled at 0.1 and 0.01, first
        run and warm, each interval covering the exact answer, one verify
        pass, q3_agg declined as group-on-key with its exact bits, and a
        served degrade (engaged) beside an allow_approx=False rejection;
    (b) the warm mix (q6_count, q6_sum, q1_sums, lookup_count, range_sum,
        q3_agg) in the serve phase's session under
        HYPERSPACE_ADAPTIVE=verify, bit for bit mode 0, and
        tools/adapt_smoke.py's three planted mis-estimates on seeded tables
        (the phase's one cut: 2M rows, and the join's fixed 150k-row
        geometry), each switch with the static bits;
    (c) li_orderkey as Arrow IPC files over the SF10 lake's first 40
        lineitem files: lookup_count and range_sum equal the parquet
        index's bits and launch the same kernel;
15. mesh phase (the multi-device tier, mesh_phase's docstring has each
    check), in the approx phase's session over the SF10 index set, under
    virtual_devices(4, the card): four mesh ordinals over the one card,
    the counterpart of the JAX package's forced host device count, each
    with its own device ledger (HYPERSPACE_DEVICE_BUDGET_MB=8192 each, 32
    GiB of the card's 80):
    (a) placement (HYPERSPACE_MESH=1): q3_agg, q3, q10 and q18 in the
        warm session with their band waves spread over the ordinals (one
        run each: the phase's cut in depth), and first runs of
        q6_count, q1_count and q6_span on a fresh session (the partial
        route's chunks placed; q1_count launches filter_grouped_multi_sum
        on each chunk's ordinal), each bit for bit the mesh-off result,
        every ledger back to 0;
    (b) the mesh route (meshDevices=4): warm q6_count, q6_sum, q1_sums
        and q1 sharded over the ordinals, counts exact and f32 sums within
        relative 1e-4 of the one-device results;
    (c) the mesh join: q10's plain join probed one bucket per ordinal,
        bit for bit the one-device rows;
    (d) a mesh-partitioned covering build over the lifecycle phase's
        20-file cut of the lineitem, byte for byte the host-partitioned
        build's files;
    (e) a (2, 2) hierarchical mesh: (b)'s queries, and (d)'s build as
        per-slice runs whose rows, per bucket, are the host build's;
    (f) dryrun_multigpu(4);
    every part's mesh:* and kernel:mesh_* spans are counted and printed;
16. ingest phase (the ingest plane, the result cache and view
    maintenance) over the SF10 lake's lineitem and li_orderkey, with
    HYPERSPACE_RESULT_CACHE=1: lookup_count (a key in the base run and in
    every delta run), range_sum and range_stats (count, min, max and sum
    of l_orderkey over range_sum's range, every output foldable) over
    order keys [0, 200000): first runs miss, warm runs hit with no
    dispatch or upload; four batches of generate_tpch's lineitem (1M rows
    each at SF10, seeds 44-47) appended, three through Hyperspace.append
    and one through ingest.append_batch, each followed by the background
    refresh that folds range_stats by a scan of the new runs on the card
    (held to a cache-off run bit for bit, which at SF10 takes the host as
    the JAX package's integer-sum cap does, and to a numpy reference over
    one in-memory read of the columns) and
    by lookup_count and range_sum over the multi-run buckets on the card
    (filter_weighted_sum and filter_sum); a pin scope held across
    compact_index and vacuum_outdated_index (the pinned versions deferred,
    the held plan's result unchanged), a second vacuum that retires them,
    the three recomputed, and one pass under
    HYPERSPACE_RESULT_CACHE=verify. Append, fold, hit, recompute and
    compaction seconds are printed;
17. tpcds phase (TPC-DS q1, the JAX package's plan-stability query):
    generate_tpcds at 2,880,000 store_returns rows (TPC-DS SF10's
    2,875,432, rounded to 8 equal files; seed 0) and tpcds_indexes
    (sr_datekey, dd_datekey, sr_cust_bloom), then q1_customer_total_return
    and q1_store_avg once cold and twice warm with Hyperspace on: each
    plan reads sr_datekey and dd_datekey (printed), each run takes the
    batched plain join on the card with the first run's bits, and the
    result equals the host executor over the raw source (keys exact, sums
    within relative 1e-4); each run's ms printed. Then the device forms of
    ops/sketch.py and ops/zorder.py (segment_min_max_torch,
    bloom_build_bits_torch, bloom_probe_bits_torch, interleave_bits_torch)
    on the card over the store_returns columns, bit for bit their numpy
    forms, each timed beside its numpy form;
18. order phase: the device top-k and sort against the host on one
   2^22-row batch (cut from 2^25 in PR 10 and from 2^23 in PR 16 to keep
   the whole run well inside its time limit) of lineitem columns (the generator's distributions):
   l_shipdate (int32, heavy ties) ascending and l_extendedprice as f32
   descending, k in {10, 100, 4096}; (l_extendedprice f64, l_orderkey
   int64) ascending and descending. The rows must be the host's stable
   lexsort's, row for row; a top-k's keys must also equal the host top-k's
   (which orders ties by its partition, not by row). Each call is timed
   beside the host's, and the device bodies alone (CUDA events), with the
   plain join's probe and expansion at Q17's wave shape.

19. gates phase (the port's correctness gates, hyperspace_tpu_torch/
    tools/ and examples/), after the order phase:
    (a) the differential soak's world and loop (tools/differential_soak)
        over seeds 0-149 (0-599 until part (f) came): random filter,
        join, aggregate, top-k, sort and union plans over covering,
        z-order and data-skipping indexes, each seed on the host, the
        device tier or the mesh route over virtual_devices(8, the card)
        (2 slices on odd mesh seeds), hybrid scan on every fifth; each seed's rows with Hyperspace on equal its
        rows with it off within 1e-6 relative, and no seed raises;
    (b) the kernel-shaped leg: the world's fact schema (and a float y) at
        2^22 rows in 16 files with ci_k and z_d built on the card, and 8
        seeds of each of three shapes (16 until part (f) came) over the reference's random
        predicates (ungrouped sum(x) + count, sum(x*y) + count, and sums
        and a count grouped by the 3-valued cat): counts exact and sums
        within relative 1e-4 of the host executor, and filter_sum,
        filter_weighted_sum and filter_grouped_multi_sum each launched;
    (c) tools/chaos_stress's query sweep (11 fault specs over the TPC-H
        queries at 30,000 lineitem rows): every run bit for bit the clean
        run or a typed error, each device and compile spec fired;
    (d) tools/race_stress at its defaults (8 threads x 2 repeats at 60,000
        rows, the lock-order audit on): bit for bit serial, no lock-order
        violation, every cache consistent;
    (e) the five examples (examples/), called in-process on the card;
    (f) the six serving-plane gates (tools/serve_smoke, qos_smoke,
        plan_stats_smoke, workload_smoke, result_cache_smoke,
        ingest_smoke), each run() in-process on the card at the
        reference's defaults (serve_smoke's clients submitting the mix
        once, not twice, and qos_smoke over a fairness window of 180
        results, not 60: FEATURE_GATES), each ok: served results bit for
        bit the serial ones, pinned results bit for bit their snapshot's,
        the fairness ratio within 1.8, the typed rejections, hits and
        folds, conservation, quiescence and the audits; in serve_smoke
        and qos_smoke every run of q6_count, q6_sum and q1_sums launched
        its kernel on the scheduler worker that served it, each kernel
        from at least two workers, and no plain version runs.

The last lines are the kernels line, the card's name and power limit, and
the result. Details go to chiprun_out/chip_smoke.json. The data lives in
build/chip_smoke/ and is removed at the end. The kernels line's launches
add up the end-to-end, lifecycle, skipping, pipeline, join, sources,
analysis, serve, staticcheck, approx, mesh, ingest, tpcds and gates phases' counts,
each read on its own (``launches_by_phase``).
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
COMPOSITION_TOL = 1e-3  # the timed PyTorch compositions' sums against the plain version
SEED = 42  # bench.py's TPC-H seed
WARM_RUNS = 1  # the end-to-end phase's warm runs
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
    # count, min and max fold exactly: the pipelined partial route, whose
    # per-chunk bodies are torch code
    "q6_span": None,
    "q1_span": None,
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
# the pipelined tier's route of each filter-aggregate query of the main
# phase over an index scan of several files (a scan of one file takes the
# monolithic "device" route); at SF10 the q6 and q1 forms span several
PIPELINE_STREAM = {"q6": "concat", "q6_count": "concat", "q6_sum": "concat", "q1": "concat",
                   "q1_sums": "concat", "q6_span": "partial", "q1_span": "partial",
                   "lookup_count": "concat", "range_sum": "concat"}
# the pipeline phase: the first runs of these under each HYPERSPACE_PIPELINE
# mode, the joins under 0 and 1, and the out-of-core builds' limit
PIPELINE_MODES = ("0", "serial", "1")
PIPELINE_QUERIES = ("q6_count", "q6_sum", "q1_sums", "q6_tax_sum")
PIPELINE_JOINS = ("q3_agg", "q3")
STREAM_BUILD_LIMIT = 256 * 1024 * 1024
# the two source files deleted before the streamed refresh, by position
STREAM_DELETED_AT = lambda n: (1 + n // 24, n * 2 // 3)  # noqa: E731
STREAM_QUERIES = {"q6_count": "filter_weighted_sum", "q6_span": None,
                  "lookup_count": "filter_weighted_sum", "range_sum": "filter_sum"}
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
# the queries whose reference is arrow's filters, joins and aggregates over
# the raw lake (arrow_reference) instead of the port's host executor, whose
# numpy joins and group-bys over 60M rows took 188 s of a 1029 s smoke (my
# chip run, PR 11); the cheap filter-aggregate references stay the host
# executor's
ARROW_REFERENCES = ("q1", "q1_span", "q3_agg", "q10", "q17", "q18")
# the join phase: the bucketed joins whose strategy plans it prints (q18's
# join is not a bucketed one, so it plans none), its small grant and split
# override, and the per-bucket route's build limit
JOIN_PHASE_QUERIES = ("q3", "q3_agg", "q3_span", "q10", "q17", "q18")
JOIN_SMALL_GRANT_MB = "256"
# 65536 until the serving-plane gates came (912 splits of q3_span at SF10;
# this gives about a quarter of them, and the check is the same)
JOIN_SPLIT_OVERRIDE = "262144"
JOIN_PER_BUCKET_WARM_RUNS = 2
JOIN_MODE_TURNS = ("1", "0")  # (d)'s warm runs, in turns
ORDER_ROWS = 1 << 22
# the join phase's native host kernels: the first keys of the lake's
# l_orderkey and o_orderkey (the whole columns cost 53 s of the run)
NATIVE_LEFT_KEYS = 1 << 23
NATIVE_RIGHT_KEYS = 1 << 21
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
# lineitem files of the lifecycle lake: the first 20 of SF10's 120 (also
# the pipeline and mesh phases' cut)
LIFECYCLE_FILES = 20
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
# the skipping phase's z-order leg: a seeded table of four 8-byte columns in
# ZORDER_FILES files, z-ordered on (za, zb) twice, with min-max and with
# percentile fields, each build cut into about ZORDER_PARTS files by
# hyperspace.index.zorder.targetSourceBytesPerPartition
ZORDER_ROWS = 1 << 22
ZORDER_FILES = 8
ZORDER_PARTS = 8
ZORDER_SEED = 29
ZORDER_BUILDS = {"zo_minmax": False, "zo_quantile": True}
SKIP_WARM_RUNS = 1
MINMAX_CASES = ("random", "all_invalid", "all_valid", "nan_valid", "nan_invalid", "nan_tail",
                "int")
# masked_min_max's tile edges (a warp folds 512 rows a tile, a thread two
# tiles at once), checked beside the sizes every kernel runs
MINMAX_TILE_SIZES = (511, 512, 513, 1024 + 3, 2 * 512 * 4 + 1)
# the sources phase: the lineitem files its partitioned and snapshot lakes
# take (the first 12 of SF10's 120), the CSV
# orders' file count, the snapshot versions and Iceberg snapshots, the
# deleted share hybrid scan must accept (one of four versions' files), and
# the key range of its range queries
SOURCES_FILES = 12
SOURCES_CSV_FILES = 16
SNAPSHOT_VERSIONS = 4
ICEBERG_SNAPSHOTS = 3
SNAPSHOT_DELETED_RATIO = 0.3
SOURCES_KEY_RANGE = 200_000
SOURCES_WARM_RUNS = 1
# the cache budgets (MB) the smoke runs at, set through the JAX package's
# knobs: an SF10 index slice is about 2 GB decoded on the host and 1.3 GB
# padded on the card, more than the reference's 1 GiB index-chunk default;
# the build and footer-statistics caches keep the reference's defaults
H100_CACHE_MB = {"HYPERSPACE_INDEX_CACHE_MB": "16384", "HYPERSPACE_DEVICE_CACHE_MB": "16384",
                 "HYPERSPACE_HOST_DERIVED_CACHE_MB": "2048"}
CACHE_KNOBS = ("HYPERSPACE_INDEX_CACHE_MB", "HYPERSPACE_DEVICE_CACHE_MB",
               "HYPERSPACE_HOST_DERIVED_CACHE_MB", "HYPERSPACE_BUILD_CACHE_MB",
               "HYPERSPACE_STATS_CACHE_MB")


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

    def minmax_inputs(n: int, case: str, seed: int, offsets=(0, 0)):
        """x and valid of n rows, each a view that starts `offsets` (x,
        valid) rows into its storage."""
        gen.manual_seed(seed)
        xo, vo = offsets
        x = ((torch.rand(n + xo, generator=gen, device=dev) - 0.5) * 2000)[xo:]
        valid = (torch.rand(n + vo, generator=gen, device=dev) < 0.5)[vo:]
        if case == "all_invalid":
            valid[:] = False
        elif case == "all_valid":
            valid[:] = True
        elif case == "int":
            x = torch.randint(-(2**20), 2**20, (n + xo,), generator=gen, device=dev,
                              dtype=torch.int32)[xo:]
        elif case in ("nan_valid", "nan_invalid", "nan_tail") and n:
            i = n - 1 if case == "nan_tail" else n // 2
            x[i] = float("nan")
            valid[i] = case != "nan_invalid"
        return x, valid

    def check_minmax(got, again, want, n, case, what):
        name = "masked_min_max"
        for g, a, w, side in zip(got, again, want, ("min", "max")):
            require(torch.equal(g.view(torch.int32), a.view(torch.int32)),
                    f"{name} {what}: repeat launch differs ({side})")
            gv, wv = float(g), float(w)
            same = (math.isnan(gv) and math.isnan(wv)) or gv == wv
            require(same, f"{name} {what}: {side} {gv} vs plain {wv}")
        if case in ("nan_valid", "nan_tail") and n:
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
    # masked_min_max at every size and its tile edges, with x and valid
    # offset as the measures and pred are above
    for n in sorted({*sizes, *MINMAX_TILE_SIZES}):
        for po, _go, xo in OFFSETS:
            for case in MINMAX_CASES:
                x, valid = minmax_inputs(n, case, 7 * n + len(case) + xo, (xo, po))
                got = K.masked_min_max(x, valid)
                again = K.masked_min_max(x, valid)
                want = R.masked_min_max(x, valid)
                check_minmax(got, again, want, n, case,
                             f"n={n} {case} offsets=(x {xo}, valid {po})")
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
    compositions = kernel_compositions(torch, pred, xs, gids, mm_x, mm_valid)
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
        # the fastest composition of PyTorch calls that computes the same
        # function (device time, as device_ms), each held to the plain version
        want = plain()
        composed = {}
        for label, fn in compositions[name].items():
            check_composition(torch, name, label, fn(), want)
            composed[label] = device_time_ms(torch, fn)
        r["composition"] = min(composed, key=composed.get)
        r["composition_ms"] = composed[r["composition"]]
        log({"kernel": name, "card": card, "n": n, "per_call_ms": r["ms"],
             "device_ms": r["device_ms"], "library_ms": None, "library_note": r["library_note"],
             "composition_ms": r["composition_ms"], "composition": r["composition"],
             "compositions_ms": composed,
             "plain_ms": r["plain_ms"], "plain": f"hyperspace_tpu_torch/ops/reference.py:{name}",
             "bytes": nbytes, "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "checks": r["checks"], "max_abs_err": r["max_abs_err"]})
    timed = {name: case[0] for name, case in cases.items()} if profile else {}
    return results, timed


def kernel_compositions(torch, pred, xs, gids, mm_x, mm_valid) -> dict:
    """For each kernel, compositions of PyTorch calls (not one library
    call) that compute its function on the timed inputs, by label; each
    returns the plain version's structure. The grouped ones take gids in
    [0, 16), as the timed inputs hold."""
    x, y = xs[0], xs[1]
    groups = 16

    def slots():  # rows that count nowhere go to slot 16
        return torch.where(pred & (gids >= 0) & (gids < groups), gids, groups).long()

    def grouped_index_add():
        g = slots()
        sums = torch.zeros(groups + 1, len(xs), device=pred.device).index_add_(
            0, g, torch.stack(xs, 1))[:groups]
        return tuple(sums.T), torch.bincount(g, minlength=groups + 1)[:groups]

    def grouped_bincount():
        g = slots()
        return (tuple(torch.bincount(g, weights=m, minlength=groups + 1)[:groups] for m in xs),
                torch.bincount(g, minlength=groups + 1)[:groups])

    inf = float("inf")
    return {
        "filter_weighted_sum": {
            "torch.where(pred, x*y, 0).sum(), pred.sum()":
                lambda: (torch.where(pred, x * y, 0.0).sum(), pred.sum()),
            "torch.dot(torch.where(pred, x, 0), y), pred.sum()":
                lambda: (torch.dot(torch.where(pred, x, 0.0), y), pred.sum()),
        },
        "filter_sum": {
            "torch.where(pred, x, 0).sum(), pred.sum()":
                lambda: (torch.where(pred, x, 0.0).sum(), pred.sum()),
            "torch.dot(pred.float(), x), pred.sum()":
                lambda: (torch.dot(pred.float(), x), pred.sum()),
        },
        "filter_grouped_multi_sum": {
            "index_add_ of the stacked measures by masked gid, bincount": grouped_index_add,
            "bincount(masked gid, weights=x) per measure, bincount": grouped_bincount,
        },
        "masked_min_max": {
            "torch.where(valid, x, inf).amin(), torch.where(valid, x, -inf).amax()":
                lambda: (torch.where(mm_valid, mm_x, inf).amin(),
                         torch.where(mm_valid, mm_x, -inf).amax()),
            "x[valid].aminmax()": lambda: tuple(mm_x[mm_valid].aminmax()),
        },
    }


def check_composition(torch, name: str, label: str, got, want) -> None:
    """A composition's result against the plain version's: counts exact,
    min and max exact, sums within COMPOSITION_TOL (the compositions'
    atomic accumulations add about 1.3M f32 values per group in launch
    order)."""
    if name == "masked_min_max":
        for g, w in zip(got, want):
            require(float(g) == float(w), f"{name} composition {label!r}: {g} vs {w}")
        return
    if name == "filter_grouped_multi_sum":
        (gs, gc), (ws, wc) = got, want
    else:
        (gs, gc), (ws, wc) = ((got[0],), got[1]), ((want[0],), want[1])
    require(torch.equal(gc.cpu().long(), wc.cpu().long()),
            f"{name} composition {label!r}: counts differ from plain")
    for a, b in zip(gs, ws):
        for u, v in zip(a.reshape(-1).tolist(), b.reshape(-1).tolist()):
            require(rel_err(u, v) <= COMPOSITION_TOL,
                    f"{name} composition {label!r}: {u} vs {v}")


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


def _align_groups(got: dict, want: dict, keys: tuple) -> tuple:
    """``got`` and ``want`` with their rows in one order, matched on the
    group keys. Where ``want``'s first key is a non-negative integer unique
    to each row (q3_agg's l_orderkey: orders have one row per key), a dense
    position table matches them in linear time, and ``got``'s first keys
    must map one to one onto ``want``'s; otherwise both sort by the keys."""
    import numpy as np

    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    wk, gk = want[keys[0]], got[keys[0]]
    n = len(wk)
    if wk.dtype.kind in "iu" and gk.dtype.kind in "iu" and int(wk.min()) >= 0:
        pos = np.full(int(wk.max()) + 1, -1, dtype=np.int64)
        pos[wk] = np.arange(n)
        if int(np.count_nonzero(pos >= 0)) == n:  # unique: one row per key
            inside = (gk >= 0) & (gk < len(pos))
            require(bool(inside.all()), f"{keys[0]}: keys the host has no group for")
            idx = pos[gk]
            require(bool((idx >= 0).all())
                    and bool((np.bincount(idx, minlength=n) == 1).all()),
                    f"{keys[0]}: the groups differ from the host's")
            return got, {k: v[idx] for k, v in want.items()}
    g_order = np.lexsort([got[k] for k in reversed(keys)])
    w_order = np.lexsort([want[k] for k in reversed(keys)])
    return ({k: v[g_order] for k, v in got.items()},
            {k: v[w_order] for k, v in want.items()})


def compare_join(q: str, got: dict, want: dict) -> None:
    """q3_agg: the same (l_orderkey, o_orderdate) groups, revenue within
    REL_TOL (row order differs between the bucketed and the host path, so
    _align_groups matches the rows by key first). q3: the top revenues
    within REL_TOL in order, and the keys equal except where the host's
    neighbouring revenues tie within REL_TOL."""
    import numpy as np

    require(list(got) == list(want), f"{q}: columns {list(got)} vs {list(want)}")
    keys = ("l_orderkey", "o_orderdate")
    n = len(want["revenue"])
    require(len(got["revenue"]) == n and n > 0, f"{q}: {len(got['revenue'])} rows vs {n}")
    if q == "q3_agg":
        got, want = _align_groups(got, want, keys)
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


def same_bits(a: dict, b: dict) -> bool:
    import numpy as np

    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def scan_route(timing) -> dict:
    """A fragment's scan as the device tier recorded it (the last one the
    session ran): its route, the stream route and chunks, the host decode
    seconds and the upload seconds (CUDA events, read here, once)."""
    if timing is None:
        return {"route": None, "stream": None}
    return {"route": timing.route, "stream": timing.stream, "chunks": timing.chunks,
            "decode_s": timing.decode_s, "upload_s": timing.upload.seconds(),
            "copies": timing.upload.copies}


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


def arrow_reference(q: str, lake: str):
    """The result of ``q`` by arrow's own filters, hash joins, hash
    aggregates and sorts over the raw lake (code the port does not share),
    as a ColumnBatch with the query's columns in its order: the reference
    of the queries whose host-executor run over 60M rows is the phase's
    largest cost (ARROW_REFERENCES)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.columnar import io as cio

    def read(table: str, cols: list):
        return pq.read_table(os.path.join(lake, table), columns=cols)

    def revenue(t):
        return pc.multiply(t["l_extendedprice"], pc.subtract(1.0, t["l_discount"]))

    if q in ("q1", "q1_span"):
        li = read("lineitem", ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                               "l_discount", "l_shipdate"])
        li = li.filter(pc.less_equal(li["l_shipdate"], 10470))
        keys = ["l_returnflag", "l_linestatus"]
        if q == "q1":
            li = li.append_column("disc_price", revenue(li))
            g = li.group_by(keys).aggregate([
                ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("disc_price", "sum"),
                ("l_quantity", "mean"), ("l_quantity", "count")])
            names = {"l_quantity_sum": "sum_qty", "l_extendedprice_sum": "sum_base_price",
                     "disc_price_sum": "sum_disc_price", "l_quantity_mean": "avg_qty",
                     "l_quantity_count": "count_order"}
        else:
            g = li.group_by(keys).aggregate([("l_shipdate", "count"), ("l_shipdate", "min"),
                                             ("l_shipdate", "max")])
            names = {"l_shipdate_count": "count_order", "l_shipdate_min": "first_ship",
                     "l_shipdate_max": "last_ship"}
        g = g.sort_by([(k, "ascending") for k in keys])
        out = pa.table({**{k: g[k] for k in keys}, **{n: g[a] for a, n in names.items()}})
    elif q == "q3_agg":
        li = read("lineitem", ["l_orderkey", "l_extendedprice", "l_discount"])
        od = read("orders", ["o_orderkey", "o_orderdate"])
        od = od.filter(pc.less(od["o_orderdate"], 9500))
        j = li.join(od, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        j = j.append_column("revenue", revenue(j))
        g = j.group_by(["l_orderkey", "o_orderdate"]).aggregate([("revenue", "sum")])
        out = pa.table({"l_orderkey": g["l_orderkey"], "o_orderdate": g["o_orderdate"],
                        "revenue": g["revenue_sum"]})
    elif q == "q10":
        li = read("lineitem", ["l_orderkey", "l_extendedprice", "l_discount", "l_returnflag"])
        li = li.filter(pc.equal(li["l_returnflag"], "R"))
        od = read("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
        od = od.filter(pc.and_(pc.greater_equal(od["o_orderdate"], 8766),
                               pc.less(od["o_orderdate"], 8856)))
        j = li.join(od, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        j = j.append_column("revenue", revenue(j))
        g = j.group_by(["o_custkey"]).aggregate([("revenue", "sum")])
        g = g.sort_by([("revenue_sum", "descending"), ("o_custkey", "ascending")]).slice(0, 20)
        out = pa.table({"o_custkey": g["o_custkey"], "revenue": g["revenue_sum"]})
    elif q == "q17":
        li = read("lineitem", ["l_partkey", "l_quantity", "l_extendedprice"])
        pt = read("part", ["p_partkey", "p_brand"])
        pt = pt.filter(pc.equal(pt["p_brand"], "Brand#3")).select(["p_partkey"])
        avg = li.group_by(["l_partkey"]).aggregate([("l_quantity", "mean")])
        j = li.join(pt, keys="l_partkey", right_keys="p_partkey", join_type="inner")
        j = j.join(avg, keys="l_partkey", join_type="inner")
        j = j.filter(pc.less(j["l_quantity"], pc.multiply(0.2, j["l_quantity_mean"])))
        total = pc.sum(j["l_extendedprice"]).as_py() or 0.0
        out = pa.table({"avg_yearly": pa.array([total / 7.0], pa.float64())})
    elif q == "q18":
        li = read("lineitem", ["l_orderkey", "l_quantity"])
        big = li.group_by(["l_orderkey"]).aggregate([("l_quantity", "sum")])
        big = big.filter(pc.greater(big["l_quantity_sum"], 300))
        od = read("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
        j = big.join(od, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
        j = j.sort_by([("l_quantity_sum", "descending"), ("l_orderkey", "ascending")])
        j = j.slice(0, 100)
        out = pa.table({"o_custkey": j["o_custkey"], "l_orderkey": j["l_orderkey"],
                        "o_orderdate": j["o_orderdate"], "sum_qty": j["l_quantity_sum"]})
    else:
        raise ValueError(q)
    return cio.table_to_batch(out)


PANDAS_CHECKED = ("q6", "q1", "q3")  # held to benchmark/external.PANDAS_TPCH too


def pandas_check(lake: str, results: dict, card: str) -> dict:
    """The card's first-run results of PANDAS_CHECKED against the pandas
    answers of benchmark/external.py over the same lake (an engine the port
    does not share): q6's revenue and q1's sums within REL_TOL, q1's keys
    and counts exact, q3's top 10 as compare_join holds it. Returns each
    pandas answer's seconds (parquet read included)."""
    from hyperspace_tpu_torch.benchmark.external import PANDAS_TPCH, answer_columns

    seconds = {}
    for q in PANDAS_CHECKED:
        got = results[q]
        t0 = time.perf_counter()
        want = answer_columns(PANDAS_TPCH[q](lake), list(got))
        seconds[q] = time.perf_counter() - t0
        if q == "q3":
            compare_join(q, got, want)
        else:
            compare_batches(q, got, _floats(want))
    log({"pandas": "matches", "card": card, "queries": list(PANDAS_CHECKED),
         "pandas_s": seconds})
    return seconds


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
    all_queries = {**tpch.QUERIES, **tpch.SPAN_QUERIES, **tpch.LOOKUP_QUERIES,
                   **tpch.JOIN_QUERIES, **{q: tpch.TPCH_QUERIES[q] for q in PLAIN_QUERIES}}

    def result(q: str, df) -> dict:
        """A query's result (a DataFrame, or a host batch) as comparable
        columns."""
        batch = df if isinstance(df, ColumnBatch) else df.collect()
        if q in tpch.JOIN_QUERIES or q in PLAIN_QUERIES:
            return _columns(batch)
        return _floats(batch.to_pydict())

    want, batches = {}, {}
    for q, fn in all_queries.items():
        if q in DERIVED_REFERENCES:
            continue
        t0 = time.perf_counter()
        batches[q] = (arrow_reference(q, lake) if q in ARROW_REFERENCES
                      else fn(host, lake).collect())
        want[q] = result(q, batches[q])
        out.setdefault("host_s", {})[q] = time.perf_counter() - t0
    for q, src in DERIVED_REFERENCES.items():
        want[q] = result(q, derived_reference(q, batches[src]))
    del host, batches

    session.enable_hyperspace()
    queries = {}
    expected_indexes = {q: [tpch.LI_SHIPDATE_Z[0] if q.startswith("q6")
                            else tpch.LI_FLAGSTATUS[0]]
                        for q in {**tpch.QUERIES, **tpch.SPAN_QUERIES}}
    expected_indexes.update({q: [tpch.LI_ORDERKEY[0]] for q in tpch.LOOKUP_QUERIES})
    expected_indexes.update({q: [tpch.LI_ORDERKEY[0], tpch.OD_ORDERKEY[0]]
                             for q in tpch.JOIN_QUERIES})
    expected_indexes.update({q: spec[0] for q, spec in PLAIN_QUERIES.items()})
    K.reset_counts()  # the main path's launches start here
    pandas_got = {}
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
        route = None
        if q in PIPELINE_STREAM:  # the first run's scan: route, decode, upload
            route = scan_route(session.device_stats.last_scan)
            index_scans = [n for n in plan.preorder()
                           if getattr(n, "index_info", None) is not None]
            streams = len(index_scans[0].files) >= 2
            want_route = ("pipelined", PIPELINE_STREAM[q]) if streams else ("device", None)
            require((route["route"], route["stream"]) == want_route,
                    f"{q}: route {route}, expected {want_route}")
            require(rows < SF10_ROWS or not q.startswith(("q6", "q1")) or streams,
                    f"{q}: at SF10 the index scan should span several files")
            log({"query": q, "card": card, "first_run": route})
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
        if q in JOIN_PHASE_QUERIES:
            out.setdefault("device_results", {})[q] = got
        if q in SERVE_QUERIES:  # the serve phase holds its served results to these
            out.setdefault("warm_results", {})[q] = again
        if q in PANDAS_CHECKED:
            pandas_got[q] = got
        queries[q] = {"first_run_s": cold_s, "first_run_route": route,
                      "warm_median_s": statistics.median(warm), "warm_s": warm,
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
    out["pandas_s"] = pandas_check(lake, pandas_got, card)
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
    out["want"] = {q: want[q] for q in {*LIFECYCLE_QUERIES, *PIPELINE_QUERIES,
                                        *PIPELINE_JOINS, *STREAM_QUERIES,
                                        *JOIN_PHASE_QUERIES} if q in want}
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


def _hard_link_tree(src: str, dst: str, limit: int | None = None) -> None:
    """Hard-link the first ``limit`` files of ``src`` (all by default)
    into a new directory ``dst``."""
    os.makedirs(dst)
    for f in sorted(os.listdir(src))[:limit]:
        os.link(os.path.join(src, f), os.path.join(dst, f))


def lifecycle_phase(torch, K, e2e: dict, rows: int, card: str, profile: bool = False) -> dict:
    """The index lifecycle and hybrid scan over a second lake (the module
    docstring lists the stages). Returns what each stage measured; with
    ``profile``, each query of stages 3-6 is profiled once more."""
    from hyperspace_tpu_torch import (CoveringIndexConfig, Hyperspace, HyperspaceSession,
                                      ZOrderCoveringIndexConfig)
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.columnar.table import ColumnBatch
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats

    t_phase = time.perf_counter()
    lake = os.path.join(DATA_DIR, "lake2")
    warehouse = os.path.join(DATA_DIR, "warehouse2")
    for table, limit in (("lineitem", LIFECYCLE_FILES), ("orders", None)):
        _hard_link_tree(os.path.join(e2e["lake"], table), os.path.join(lake, table), limit)
    n_files = len(os.listdir(os.path.join(lake, "lineitem")))
    whole = n_files == len(os.listdir(os.path.join(e2e["lake"], "lineitem")))
    lc_rows = rows * n_files // len(os.listdir(os.path.join(e2e["lake"], "lineitem")))
    n_deleted = n_files // 20  # one file in 20 (6 of 120 at SF10)
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
    out: dict = {"lineitem_files": n_files, "rows": lc_rows, "deleted_files": deleted,
                 "actions_s": {}, "stages": {}}

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
        """A query's result (a DataFrame, or a reference batch) as
        comparable columns."""
        batch = df if isinstance(df, ColumnBatch) else df.collect()
        return _columns(batch) if q == "q3_agg" else _floats(batch.to_pydict())

    def host_reference() -> dict:
        host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
        t0 = time.perf_counter()
        want = {q: result(q, arrow_reference(q, lake) if q in ARROW_REFERENCES
                          else fn(host, lake)) for q, fn in queries.items()}
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
    # 1. build: over the whole main lake the main phase's references hold
    stage("1_build", e2e["want"] if whole else host_reference(), hybrid=False, on_card=every)
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
    # 4. append a tenth of the lake's rows (1M rows at SF10's 20-file cut) of
    # another seed, renamed
    extra = os.path.join(DATA_DIR, "extra")
    t0 = time.perf_counter()
    tpch.generate_tpch(extra, rows_lineitem=lc_rows // 10, seed=APPEND_SEED)
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


def zorder_leg(K, card: str, rows: int = ZORDER_ROWS) -> dict:
    """The skipping phase's (e): ``rows`` seeded rows z-ordered twice through
    the conf keys (module docstring), each build's files counted, and a
    kernel-shaped box query per index held to the host executor, launching
    filter_weighted_sum once per run with no decline."""
    import numpy as np

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ZOrderCoveringIndexConfig
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.plan.expr import Count, Sum, col, lit
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.utils import env as hs_env

    t_leg = time.perf_counter()
    root = os.path.join(DATA_DIR, "zorder_lake")
    src = os.path.join(root, "zsrc")
    os.makedirs(src)
    rng = np.random.default_rng(ZORDER_SEED)
    t0 = time.perf_counter()
    za = rng.integers(0, 1_000_000, rows)
    zb = rng.lognormal(0.0, 2.0, rows)  # skewed: percentile fields split it evenly
    zp = rng.uniform(1.0, 100.0, rows)
    zd = rng.uniform(0.0, 0.1, rows)
    for i, part in enumerate(np.array_split(np.arange(rows), ZORDER_FILES)):
        _write_columns(os.path.join(src, f"part-{i:02d}.parquet"),
                       {"za": za[part], "zb": zb[part], "zp": zp[part], "zd": zd[part]})
    target = rows * 4 * 8 // ZORDER_PARTS  # the index data's bytes over ZORDER_PARTS
    out: dict = {"rows": rows, "files": ZORDER_FILES, "target_bytes": target,
                 "generate_s": time.perf_counter() - t0, "builds": {}, "queries": {},
                 "knobs": len(hs_env.all_knobs())}
    lo, hi, zb_max = 250_000, 750_000, float(np.quantile(zb, 0.3))

    def make(s):
        return s.read.parquet(src).filter(
            (col("za") >= lo) & (col("za") < hi) & (col("zb") < zb_max)).agg(
            Sum(col("zp") * col("zd")).alias("revenue"), Count(lit(1)).alias("n"))

    host = HyperspaceSession(os.path.join(root, "host_wh"), conf={C.EXEC_TPU_ENABLED: False})
    t0 = time.perf_counter()
    want = _floats(make(host).to_pydict())
    out["host_reference_s"] = time.perf_counter() - t0
    require(want["n"][0] > 0, f"zorder: the box holds no row: {want}")
    for name, quantile in ZORDER_BUILDS.items():
        session = HyperspaceSession(os.path.join(root, f"wh_{name}"), conf={
            C.ZORDER_QUANTILE_ENABLED: quantile,
            C.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION: target})
        hs = Hyperspace(session)
        t0 = time.perf_counter()
        hs.create_index(session.read.parquet(src),
                        ZOrderCoveringIndexConfig(name, ["za", "zb"], ["zp", "zd"]))
        build_s = time.perf_counter() - t0
        entry = hs.get_index(name)
        fields = {f.to_dict()["kind"] for f in entry.derived_dataset.fields}
        n_files = len(entry.content.files())
        require(fields == {"percentile" if quantile else "minmax"},
                f"zorder {name}: fields {fields}, quantile.enabled={quantile}")
        require(n_files > 1, f"zorder {name}: {n_files} file(s); the target asks for several")
        out["builds"][name] = {"quantile": quantile, "seconds": build_s, "files": n_files}
        log({"zorder_build": name, "card": card, **out["builds"][name]})

        session.enable_hyperspace()
        scan = _scan_of(make(session).optimized_plan())
        read = None if scan.index_info is None else scan.index_info.index_name
        require(read == name, f"zorder_{name}: plan reads {read}, expected {name}")
        rec = {"index": read, **_kept(scan)}
        session.device_stats = DeviceTierStats()
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        compare_batches(f"zorder_{name}", _floats(make(session).to_pydict()), want)
        rec["first_run_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compare_batches(f"zorder_{name}", _floats(make(session).to_pydict()), want)
        rec["warm_s"] = [time.perf_counter() - t0]
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        stats = session.device_stats
        require(stats.device_fragments == 2 and not stats.declines,
                f"zorder_{name}: device fragments {stats.device_fragments}, "
                f"declines {stats.declines}")
        require(launched == {k: (2 if k == "filter_weighted_sum" else 0) for k in K.LAUNCHES},
                f"zorder_{name}: launches {launched}")
        rec.update({"launches": launched, "rows_out": want["n"][0], "matches_host": True})
        out["queries"][f"zorder_{name}"] = rec
        log({"skipping": f"zorder_{name}", "card": card, **rec})
        del session, hs
    shutil.rmtree(root)
    out["seconds"] = time.perf_counter() - t_leg
    log({"zorder": "leg", "card": card, "seconds": out["seconds"], "knobs": out["knobs"],
         "builds": out["builds"]})
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
    sketch_before = _counters("cache.sketch.")
    try:
        build_before = _counters("pruning.sketch.")
        action("create ev_sk_idx (sketches on)", lambda: hs.create_index(
            session.read.parquet(ev),
            CoveringIndexConfig("ev_sk_idx", ["ev_k"], ["ev_id", "ev_cat", "ev_v"])))
        out["sidecar"]["writer"] = sidecar_writer_check(
            _delta(build_before, "pruning.sketch."), os.path.join(ev_wh, "indexes", "ev_sk_idx"),
            card)
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
        want_point = host_result("ev_point_sum", ev_wh, make)
        rec = run("ev_point_sum", session, make, want_point, index="ev_sk_idx")
        require(rec["row_groups_kept"] < rec["row_groups_footer_stage"],
                f"ev_point_sum: the sketch stage skipped nothing: {rec}")
        out["sidecar"]["verify"] = prune_verify_check(
            "ev_point_sum", lambda: _floats(make(session).to_pydict()), want_point, card)
        # the sidecar cache's counters (cache.sketch.*), as the JAX package's
        sketch_cache = _delta(sketch_before, "cache.sketch.")
        out["sidecar"]["cache_sketch"] = sketch_cache
        log({"sidecar": "cache.sketch", "card": card, **sketch_cache})
        require(sketch_cache.get("hits", 0) + sketch_cache.get("misses", 0) > 0,
                f"sidecar legs: no cache.sketch hit or miss counted: {sketch_cache}")
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

    # (e) the z-order conf keys
    out["zorder"] = zorder_leg(K, card)
    out["queries"].update(out["zorder"].pop("queries"))

    out["launches"] = {k: K.LAUNCHES[k] - profiled[k] for k in K.LAUNCHES}
    require(out["launches"]["filter_sum"] > 0, "skipping: filter_sum never launched")
    require(not any(K.PLAIN_CALLS.values()),
            f"skipping: plain versions ran on the card's path: {K.PLAIN_CALLS}")
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "skipping", "card": card, "seconds": out["seconds"],
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# pipeline phase
# ---------------------------------------------------------------------------

def _row_fingerprint(paths: list, columns: list) -> tuple:
    """An order-free fingerprint of the multiset of rows of ``paths`` over
    ``columns``: the row count and two sums (mod 2^64) of independent
    64-bit row hashes. Strings hash by value, so files with other
    dictionaries fingerprint alike; a row lost, added or changed moves
    both sums. Files are read on a thread pool."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    mults = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F))

    def one(p):
        t = pq.read_table(p, columns=columns)
        hs = [np.full(t.num_rows, i + 1, dtype=np.uint64) for i in range(2)]
        for c in columns:
            a = t.column(c).combine_chunks()
            if pa.types.is_dictionary(a.type) or pa.types.is_string(a.type):
                d = a if pa.types.is_dictionary(a.type) else a.dictionary_encode()
                lut = np.array([zlib.crc32(str(v).encode()) for v in d.dictionary.to_pylist()],
                               dtype=np.uint64)
                v = lut[np.asarray(d.indices)]
            else:
                x = np.asarray(a)
                v = (x.astype(np.int64) if x.dtype.itemsize < 8 else x).view(np.uint64)
            for h, m in zip(hs, mults):
                h ^= v
                h *= m
                h ^= h >> np.uint64(29)
        return t.num_rows, [int(h.sum(dtype=np.uint64)) for h in hs]

    with ThreadPoolExecutor(max_workers=8) as pool:
        parts = list(pool.map(one, paths))
    return (sum(n for n, _ in parts),
            *(sum(s[i] for _, s in parts) % 2**64 for i in range(2)))


def _runs_per_range(files: list) -> dict:
    """Runs per z-order range of a streamed z-order index
    (``part-0-z<range>-<group>``)."""
    per: dict = {}
    for f in files:
        rng = os.path.basename(f).split("-")[2]
        per[rng] = per.get(rng, 0) + 1
    return {"files": sum(per.values()), "ranges": len(per), "min": min(per.values()),
            "max": max(per.values())}


def pipeline_phase(torch, K, e2e: dict, lifecycle: dict, rows: int, card: str) -> dict:
    """The pipelined tier over the SF10 lake (the module docstring lists
    the parts): first runs under each HYPERSPACE_PIPELINE mode, split into
    decode and upload seconds and held bit for bit across the modes; the
    joins under 0 and 1; then out-of-core builds and a streamed refresh
    in a third warehouse at a quarter of the lifecycle lake's bytes as the
    build limit, over that lake's files, their rows held to the source's
    and their queries to the host."""
    from hyperspace_tpu_torch import (CoveringIndexConfig, Hyperspace, HyperspaceSession,
                                      ZOrderCoveringIndexConfig)
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.models.covering import _file_groups

    t_phase = time.perf_counter()
    lake, warehouse = e2e["lake"], e2e["warehouse"]
    want = e2e["want"]
    out: dict = {"modes": {}, "joins": {}, "actions_s": {}, "stream_queries": {}}
    K.reset_counts()  # the phase's launches start here
    queries = {**tpch.QUERIES, **tpch.SPAN_QUERIES, **tpch.LOOKUP_QUERIES,
               **tpch.JOIN_QUERIES, "q6_tax_sum": tpch.q6_tax_sum}
    saved = os.environ.get("HYPERSPACE_PIPELINE")

    def first_run(q: str, mode: str):
        """``q``'s first run on a fresh session under ``mode``: (result,
        wall seconds, the scan's route record, launches)."""
        os.environ["HYPERSPACE_PIPELINE"] = mode
        session = HyperspaceSession(warehouse).enable_hyperspace()  # the card
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        batch = queries[q](session, lake).collect()
        wall = time.perf_counter() - t0
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] > before[k]}
        got = _columns(batch) if q in tpch.JOIN_QUERIES else _floats(batch.to_pydict())
        return got, wall, scan_route(session.device_stats.last_scan), launched, session

    try:
        # (a) the first run split into decode and upload, per mode
        for q in PIPELINE_QUERIES:
            runs = {}
            os.environ["HYPERSPACE_PIPELINE"] = "1"
            plan = queries[q](HyperspaceSession(warehouse).enable_hyperspace(),
                              lake).optimized_plan()
            streams = len(_scan_of(plan).files) >= 2  # a scan of one file does not
            require(rows < SF10_ROWS or streams, f"pipeline {q}: one file at SF10")
            for mode in PIPELINE_MODES:
                got, wall, route, launched, _s = first_run(q, mode)
                want_route = (("pipelined", "concat") if mode != "0" and streams
                              else ("device", None))
                require((route["route"], route["stream"]) == want_route,
                        f"pipeline {q} under {mode}: route {route}")
                require(launched == {EXPECTED_KERNEL.get(q, "filter_sum"): 1},
                        f"pipeline {q} under {mode}: launches {launched}")
                runs[mode] = got
                rec = {"wall_s": wall, **route}
                out["modes"].setdefault(q, {})[mode] = rec
                log({"pipeline": q, "mode": mode, "card": card, **rec})
            require(all(runs[m] == runs["0"] for m in PIPELINE_MODES),
                    f"pipeline {q}: the modes' results differ")
            if q in want:
                compare_batches(q, runs["1"], want[q])
        # (b) the joins: bucket-pair read-ahead against the barrier
        for q in PIPELINE_JOINS:
            runs = {}
            for mode in ("0", "1"):
                got, wall, _route, _l, session = first_run(q, mode)
                require(session.device_stats.device_join_fragments == 1,
                        f"pipeline {q} under {mode}: not the fused device join")
                runs[mode] = got
                out["joins"].setdefault(q, {})[mode] = {"wall_s": wall}
                log({"pipeline": q, "mode": mode, "card": card, "wall_s": wall})
            require(same_bits(runs["1"], runs["0"]), f"pipeline {q}: read-ahead differs")
            compare_join(q, runs["1"], want[q])
    finally:
        if saved is None:
            os.environ.pop("HYPERSPACE_PIPELINE", None)
        else:
            os.environ["HYPERSPACE_PIPELINE"] = saved

    # (c) out-of-core builds in a third warehouse, over
    # the lifecycle lake's cut (its first LIFECYCLE_FILES lineitem files),
    # whose in-memory builds of the same configs the lifecycle phase timed
    st_lake = os.path.join(DATA_DIR, "lake3")
    _hard_link_tree(os.path.join(lake, "lineitem"), os.path.join(st_lake, "lineitem"),
                    LIFECYCLE_FILES)
    st_wh = os.path.join(DATA_DIR, "warehouse3")
    li = os.path.join(st_lake, "lineitem")
    src_files = sorted(os.path.join(li, f) for f in os.listdir(li))
    # a quarter of the source (at most 256 MiB), so the builds stream in
    # several groups and the refresh's old index bytes pass the limit
    limit = min(STREAM_BUILD_LIMIT, sum(os.path.getsize(f) for f in src_files) // 4)
    session = HyperspaceSession(st_wh, conf={C.BUILD_MAX_BYTES_IN_MEMORY: limit,
                                             C.INDEX_LINEAGE_ENABLED: True})
    hs = Hyperspace(session)
    source = session.read.parquet(li)
    groups = len(_file_groups(_scan_of(source.plan).files, limit))
    out.update({"lineitem_files": len(src_files), "build_limit_bytes": limit,
                "groups": groups})
    in_memory = {tpch.LI_ORDERKEY[0]: lifecycle["actions_s"]["create lc_orderkey"],
                 tpch.LI_SHIPDATE_Z[0]: lifecycle["actions_s"]["create lc_shipdate_z"]}

    def action(label: str, fn, in_memory_s=None) -> None:
        t0 = time.perf_counter()
        fn()
        out["actions_s"][label] = time.perf_counter() - t0
        log({"pipeline_action": label, "card": card, "seconds": out["actions_s"][label],
             "in_memory_build_s": in_memory_s})

    specs = {"st_orderkey": (CoveringIndexConfig, tpch.LI_ORDERKEY),
             "st_shipdate_z": (ZOrderCoveringIndexConfig, tpch.LI_SHIPDATE_Z)}
    for name, (config, spec) in specs.items():
        action(f"create {name}", lambda: hs.create_index(source, config(name, *spec[1:])),
               in_memory.get(spec[0]))
        files = hs.get_index(name).content.files()
        layout = (_files_per_bucket(hs, name) if config is CoveringIndexConfig
                  else _runs_per_range(files))
        require(groups > 1 and layout["max"] == groups
                and all(os.path.basename(f).count("-") == 3 for f in files),
                f"{name}: not streamed in {groups} groups: {layout}")
        columns = spec[1] + spec[2]
        fingerprint = _row_fingerprint(files, columns)
        require(fingerprint == _row_fingerprint(src_files, columns),
                f"{name}: its rows differ from the source's")
        out[name] = {"layout": layout, "rows_equal": "source", "rows": fingerprint[0]}
        log({"pipeline_build": name, "card": card, "groups": groups, **layout,
             "rows_equal_to": "source"})
    session.enable_hyperspace()
    expected = {"q6_count": ["st_shipdate_z"], "q6_span": ["st_shipdate_z"],
                "lookup_count": ["st_orderkey"], "range_sum": ["st_orderkey"]}

    def stream_queries(label: str, want_now: dict, used: dict) -> None:
        for q, kernel in STREAM_QUERIES.items():
            plan = queries[q](session, st_lake).optimized_plan()
            names = [n.index_info.index_name for n in plan.preorder()
                     if getattr(n, "index_info", None) is not None]
            require(names == used[q], f"{label} {q}: plan reads {names}, expected {used[q]}")
            fragments = session.device_stats.device_fragments
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            got = _floats(queries[q](session, st_lake).to_pydict())
            wall = time.perf_counter() - t0
            route = scan_route(session.device_stats.last_scan)
            launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                        if K.LAUNCHES[k] > before[k]}
            require(session.device_stats.device_fragments == fragments + 1
                    and launched == ({kernel: 1} if kernel else {}),
                    f"{label} {q}: launches {launched}")
            compare_batches(f"{label} {q}", got, want_now[q])
            rec = {"first_run_s": wall, "indexes": names, **route}
            out["stream_queries"].setdefault(label, {})[q] = rec
            log({"pipeline_query": q, "stage": label, "card": card, **rec})

    host = HyperspaceSession(st_wh, conf={C.EXEC_TPU_ENABLED: False})
    t0 = time.perf_counter()
    want_built = {q: _floats(queries[q](host, st_lake).to_pydict()) for q in STREAM_QUERIES}
    out["host_reference_s"] = [time.perf_counter() - t0]
    stream_queries("built", want_built, expected)
    # two source files deleted, st_orderkey refreshed incrementally (each
    # old file rewritten alone, a run each), then quick optimize
    names = sorted(os.listdir(li))
    deleted = [names[i] for i in STREAM_DELETED_AT(len(names))]
    for f in deleted:
        os.unlink(os.path.join(li, f))
    out["deleted_files"] = deleted
    n_before = len(hs.get_index("st_orderkey").content.files())
    action("refresh incremental st_orderkey",
           lambda: hs.refresh_index("st_orderkey", "incremental"))
    files = hs.get_index("st_orderkey").content.files()
    # streamed: runs only (an in-memory refresh writes one unsuffixed file
    # per bucket), at most one per old file
    require(len(files) <= n_before and all(os.path.basename(f).count("-") == 3 for f in files),
            f"st_orderkey refresh: {len(files)} files after, {n_before} before")
    out["refreshed_layout"] = _files_per_bucket(hs, "st_orderkey")
    action("optimize quick st_orderkey", lambda: hs.optimize_index("st_orderkey", "quick"))
    out["optimized_layout"] = _files_per_bucket(hs, "st_orderkey")
    require(out["optimized_layout"]["max"] == 1, f"optimize: {out['optimized_layout']}")
    log({"pipeline_layout": "st_orderkey", "card": card, "refreshed": out["refreshed_layout"],
         "optimized": out["optimized_layout"]})
    t0 = time.perf_counter()
    want_now = {q: _floats(queries[q](host, st_lake).to_pydict()) for q in STREAM_QUERIES}
    out["host_reference_s"].append(time.perf_counter() - t0)
    # st_shipdate_z is stale now (no hybrid scan): q6's forms read the source
    stream_queries("refreshed", want_now, {**expected, "q6_count": [], "q6_span": []})
    out["launches"] = dict(K.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "pipeline", "card": card, "seconds": out["phase_s"],
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# join phase
# ---------------------------------------------------------------------------

def read_join_tables(lake: str) -> tuple:
    """The raw lake's (l_orderkey, l_quantity) and (o_orderkey,
    o_orderdate) as arrow tables."""
    import pyarrow.parquet as pq

    return (pq.read_table(os.path.join(lake, "lineitem"), columns=["l_orderkey", "l_quantity"]),
            pq.read_table(os.path.join(lake, "orders"), columns=["o_orderkey", "o_orderdate"]))


def q3_span_reference(li, od) -> dict:
    """q3_span's groups by arrow's own hash join and hash aggregate over the
    raw lake's columns (code the port does not share): the orders dated
    before 9500 joined to lineitem on the order key, count, min and max of
    l_quantity per (l_orderkey, o_orderdate), by l_orderkey."""
    import pyarrow.compute as pc

    od = od.filter(pc.less(od["o_orderdate"], 9500))
    g = (li.join(od, keys="l_orderkey", right_keys="o_orderkey", join_type="inner")
         .group_by(["l_orderkey", "o_orderdate"])
         .aggregate([("l_quantity", "count"), ("l_quantity", "min"), ("l_quantity", "max")])
         .sort_by("l_orderkey"))
    return {"l_orderkey": g["l_orderkey"].to_numpy(), "o_orderdate": g["o_orderdate"].to_numpy(),
            "lines": g["l_quantity_count"].to_numpy(), "min_qty": g["l_quantity_min"].to_numpy(),
            "max_qty": g["l_quantity_max"].to_numpy()}


def compare_span(q: str, got: dict, want: dict) -> None:
    """q3_span against its arrow reference: the same groups, counts, mins
    and maxes exactly (l_quantity is integral, so f32 holds it)."""
    import numpy as np

    order = np.argsort(np.asarray(got["l_orderkey"]), kind="stable")
    require(len(order) == len(want["l_orderkey"]) > 0,
            f"{q}: {len(order)} groups vs {len(want['l_orderkey'])}")
    for k in want:
        require(bool(np.array_equal(np.asarray(got[k])[order], want[k])),
                f"{q}.{k}: differs from the arrow reference")


def _join_stats(stats) -> dict:
    return {"join_paths": dict(stats.join_paths), "plans": list(stats.join_plans),
            "strategies": dict(stats.join_strategies), "waves": stats.join_waves,
            "splits": stats.join_splits, "spills": stats.join_spills,
            "parks": stats.join_parks, "declines": dict(stats.declines),
            "device_join_fragments": stats.device_join_fragments}


def join_phase(torch, K, e2e: dict, rows: int, card: str) -> dict:
    """The bucketed join's routes over the SF10 lake (the module docstring
    lists the parts): strategy plans at the default grant, a small grant
    and a split override, the per-bucket route of an over-limit join, the
    streamed plain join against the barrier, and the native host kernels
    against their numpy forms."""
    import numpy as np

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.ops import bucketize, hashing
    from hyperspace_tpu_torch.plan import bucket_join, executor
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.serve import budget

    t_phase = time.perf_counter()
    lake, warehouse, want = e2e["lake"], e2e["warehouse"], e2e["want"]
    main_results = e2e["device_results"]
    queries = {**tpch.JOIN_QUERIES, **tpch.SPLIT_JOIN_QUERIES, **tpch.TPCH_QUERIES}
    out: dict = {"default": {}, "small_grant": {}, "per_bucket": {}, "modes": {}, "native": {}}
    K.reset_counts()
    saved = {k: os.environ.get(k) for k in ("HYPERSPACE_PIPELINE", "HYPERSPACE_DEVICE_BUDGET_MB",
                                            "HYPERSPACE_JOIN_SPLIT_ROWS")}
    loads: list = []  # seconds of each bucket pair's load in the last run
    orig_load = bucket_join._load_pair

    def timed_load(*a, **kw):  # the join's pair decode, on any thread
        t0 = time.perf_counter()
        try:
            return orig_load(*a, **kw)
        finally:
            loads.append(time.perf_counter() - t0)

    def run(q: str, conf=None, session=None) -> tuple:
        """``q``'s result, wall seconds and session: on ``session`` with its
        counts zeroed, else on a fresh session on the card."""
        if session is None:
            session = HyperspaceSession(warehouse, conf=conf).enable_hyperspace()
        session.device_stats = DeviceTierStats()
        loads.clear()
        t0 = time.perf_counter()
        got = _columns(queries[q](session, lake).collect())
        return got, time.perf_counter() - t0, session

    def setenv(**kw) -> None:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        budget.reset_device_budget()

    parts = out["parts_s"] = {}
    t_part = [time.perf_counter()]

    def part_done(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    li_table, od_table = read_join_tables(lake)
    span_want = q3_span_reference(li_table, od_table)
    part_done("reference")
    bucket_join._load_pair = timed_load
    try:
        # (a) the default grant: each join's strategy mix and split rows
        setenv(HYPERSPACE_PIPELINE="1", HYPERSPACE_DEVICE_BUDGET_MB=None,
               HYPERSPACE_JOIN_SPLIT_ROWS=None)
        default = {}
        shared = HyperspaceSession(warehouse).enable_hyperspace()  # one session: (a)'s reads
        for q in JOIN_PHASE_QUERIES:
            got, wall, session = run(q, session=shared)
            st = _join_stats(session.device_stats)
            require(not st["declines"] and st["spills"] == 0,
                    f"join {q} at the default grant: {st}")
            if q == "q3_span":
                compare_span(q, got, span_want)
                require(st["join_paths"] == {"stacked_agg": 1}, f"join {q}: {st}")
            else:
                require(same_bits(got, main_results[q]),
                        f"join {q}: differs from the main phase's result")
            require((q == "q18") == (not st["plans"]), f"join {q}: plans {st['plans']}")
            default[q] = got
            out["default"][q] = {"wall_s": wall, **st}
            log({"join": q, "grant": "default", "card": card, "wall_s": wall, **st})
        part_done("a")
        # (b) a 256 MiB grant, then with the split override too: q3 (a sum,
        # which never splits) and q3_span (count/min/max, which splits)
        # 256 MiB and 262144 rows at SF10; scaled with the rows at a smaller
        # --rows, so the waves still park and the buckets still split there
        grant_mb, split_rows = JOIN_SMALL_GRANT_MB, JOIN_SPLIT_OVERRIDE
        if rows < SF10_ROWS:
            grant_mb = str(max(0.25, float(JOIN_SMALL_GRANT_MB) * rows / SF10_ROWS))
            split_rows = str(max(1024, int(JOIN_SPLIT_OVERRIDE) * rows // SF10_ROWS))
        out.update({"small_grant_mb": float(grant_mb), "split_override": int(split_rows)})
        for label, override in (("small", None), ("small+split", split_rows)):
            setenv(HYPERSPACE_DEVICE_BUDGET_MB=grant_mb, HYPERSPACE_JOIN_SPLIT_ROWS=override)
            for q in ("q3", "q3_span"):
                got, wall, session = run(q)
                st = _join_stats(session.device_stats)
                require(same_bits(got, default[q]), f"join {q} at {label}: bits differ")
                require(st["join_paths"] == {"stacked_agg": 1} and not st["declines"],
                        f"join {q} at {label}: {st}")
                require(st["parks"] + st["spills"] > 0, f"join {q} at {label}: never parked")
                require((st["splits"] > 0) == (q == "q3_span"),
                        f"join {q} at {label}: splits {st['splits']}")
                out["small_grant"].setdefault(label, {})[q] = {"wall_s": wall, **st}
                log({"join": q, "grant": label, "card": card, "wall_s": wall, **st})
        part_done("b")
        # (c) over the build limit under HYPERSPACE_PIPELINE=0: per bucket
        setenv(HYPERSPACE_PIPELINE="0", HYPERSPACE_DEVICE_BUDGET_MB=None,
               HYPERSPACE_JOIN_SPLIT_ROWS=None)
        limit = 1 << 20
        hs = Hyperspace(HyperspaceSession(warehouse))
        idx_bytes = sum(os.path.getsize(f) for n in (tpch.LI_ORDERKEY[0], tpch.OD_ORDERKEY[0])
                        for f in hs.get_index(n).content.files())
        require(idx_bytes > limit, f"index bytes {idx_bytes} under the limit")
        conf = {C.BUILD_MAX_BYTES_IN_MEMORY: limit}
        got, first, session = run("q3_agg", conf)
        st = _join_stats(session.device_stats)
        require(st["join_paths"] == {"per_bucket": 1, "per_bucket_device": 8}
                and st["declines"] == {"join_over_memory": 1},
                f"join q3_agg per bucket: {st}")
        compare_join("q3_agg", got, want["q3_agg"])  # the host executor's
        # the stacked route's, row for row: both emit buckets in order, each
        # bucket's groups in right-key order
        compare_ordered("q3_agg", got, main_results["q3_agg"], None)
        warm = []
        for _ in range(JOIN_PER_BUCKET_WARM_RUNS):
            again, wall, _s = run("q3_agg", conf)
            require(same_bits(again, got), "join q3_agg per bucket: a repeat differs")
            warm.append(wall)
        stacked = e2e["queries"]["q3_agg"]
        out["per_bucket"] = {"first_run_s": first, "warm_s": warm, "index_bytes": idx_bytes,
                             "limit_bytes": limit, "stacked_warm_s": stacked["warm_s"],
                             "stacked_first_run_s": stacked["first_run_s"], **st}
        log({"join": "q3_agg", "route": "per_bucket", "card": card, **out["per_bucket"]})
        part_done("c")
        # (d) on fresh sessions, streamed pairs against the barrier: q3 (raw
        # pairs, side filters in the body) and q10 (the plain join, filtered
        # on the host as its pairs load); a first run per mode, then warm
        # runs in turns (JOIN_MODE_TURNS), each mode on its own session
        for q in ("q3", "q10"):
            runs, sessions = {}, {}
            for mode in ("1", "0"):
                setenv(HYPERSPACE_PIPELINE=mode)
                runs[mode], wall, sessions[mode] = run(q)
                out["modes"].setdefault(q, {})[mode] = {
                    "wall_s": wall, "decode_s": sum(loads), "pairs": len(loads),
                    "warm_s": [], "warm_decode_s": []}
            for mode in JOIN_MODE_TURNS:
                setenv(HYPERSPACE_PIPELINE=mode)
                again, warm, session = run(q, session=sessions[mode])
                require(same_bits(again, runs[mode]), f"join {q} under {mode}: a repeat differs")
                rec = out["modes"][q][mode]
                rec["warm_s"].append(warm)
                rec["warm_decode_s"].append(sum(loads))
                rec.update(_join_stats(session.device_stats))
            for mode in ("1", "0"):
                log({"join": q, "mode": mode, "card": card, **out["modes"][q][mode]})
            require(same_bits(runs["1"], runs["0"]), f"join {q}: the modes' bits differ")
        part_done("d")
    finally:
        bucket_join._load_pair = orig_load
        setenv(**saved)

    # (e) the native host kernels over the lake's own keys
    lk = li_table["l_orderkey"].to_numpy()[:NATIVE_LEFT_KEYS]
    ok = od_table["o_orderkey"].to_numpy()[:NATIVE_RIGHT_KEYS]
    del li_table, od_table
    native.build()

    def pair(name, fast, plain, same):
        t0 = time.perf_counter()
        a = fast()
        t1 = time.perf_counter()
        b = plain()
        t2 = time.perf_counter()
        require(same(a, b), f"native {name}: differs from its numpy form")
        out["native"][name] = {"native_s": t1 - t0, "numpy_s": t2 - t1, "rows": len(lk)}
        log({"native": name, "card": card, **out["native"][name]})
        return a

    hashes = pair("hash32", lambda: native.hash32(lk), lambda: hashing.hash32_plain([lk]),
                  np.array_equal)
    pair("bucket_partition", lambda: native.bucket_partition(hashes, 8)[1:],
         lambda: bucketize.partition_plain(hashes, 8),
         lambda a, b: all(np.array_equal(a[0][a[1][i]:a[1][i + 1]], r) for i, r in b))
    pair("radix_argsort", lambda: native.radix_argsort(lk),
         lambda: np.argsort(lk, kind="stable"), np.array_equal)
    pair("join_i64", lambda: native.join_i64(lk, ok),
         lambda: executor.join_codes_plain(lk, ok),
         lambda a, b: np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
    part_done("e")
    out["index_build_s"] = e2e["index_build_s"]
    out["launches"] = dict(K.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "join", "card": card, "seconds": out["phase_s"], "parts_s": parts,
         "index_build_s": out["index_build_s"], "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# sources phase
# ---------------------------------------------------------------------------

def _write_partitioned(src_files: list, dst: str) -> dict:
    """Each lineitem file split by (l_returnflag, l_linestatus) into hive
    directories, the two columns living only in the paths; returns the
    count and the l_extendedprice sum of the l_returnflag = 'R' rows, read
    off the source files by arrow."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    def one(i_path):
        i, path = i_path
        t = pq.read_table(path)
        flag, status = t.column("l_returnflag"), t.column("l_linestatus")
        rest = t.drop_columns(["l_returnflag", "l_linestatus"])
        for rf in pc.unique(flag).to_pylist():
            for ls in pc.unique(status).to_pylist():
                mask = pc.and_(pc.equal(flag, rf), pc.equal(status, ls))
                d = os.path.join(dst, f"l_returnflag={rf}", f"l_linestatus={ls}")
                os.makedirs(d, exist_ok=True)
                pq.write_table(rest.filter(mask), os.path.join(d, f"part-{i:04d}.parquet"))
        r = pc.equal(flag, "R")
        return (int(pc.sum(r.cast("int64")).as_py()),
                float(pc.sum(pc.filter(t.column("l_extendedprice"), r)).as_py()))

    with ThreadPoolExecutor(max_workers=8) as pool:
        parts = list(pool.map(one, enumerate(src_files)))
    return {"count": sum(p[0] for p in parts), "sum_price": sum(p[1] for p in parts)}


def _write_csv_orders(src: str, dst: str, files: int) -> dict:
    """The orders table as ``files`` CSV files with a header row; returns
    its row count and the sums of o_orderkey and o_orderdate."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.compute as pc
    import pyarrow.csv as pacsv
    import pyarrow.parquet as pq

    t = pq.read_table(src)
    os.makedirs(dst)
    per = -(-t.num_rows // files)

    def one(i):
        pacsv.write_csv(t.slice(i * per, per), os.path.join(dst, f"part-{i:04d}.csv"))

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(files)))
    return {"rows": t.num_rows, "o_orderkey_sum": int(pc.sum(t.column("o_orderkey")).as_py()),
            "o_orderdate_sum": int(pc.sum(t.column("o_orderdate")).as_py())}


def sources_phase(torch, K, e2e: dict, rows: int, card: str) -> dict:
    """Partitioned, CSV, snapshot (Delta-style) and Iceberg-style lakes
    (the module docstring lists the parts). Every query is held to the
    host executor over its raw source (or, for q3_agg over the CSV orders,
    to the main phase's host result over the same rows); each query's
    indexes, route and kernel launches are checked."""
    import random

    import numpy as np

    from hyperspace_tpu_torch import (CoveringIndexConfig, DataSkippingIndexConfig, Hyperspace,
                                      HyperspaceSession, IcebergStyleTable, MinMaxSketch,
                                      SnapshotTable, ZOrderCoveringIndexConfig)
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.columnar import io as cio
    from hyperspace_tpu_torch.plan.expr import Count, Max, Min, col, lit
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.sources import iceberg as ice

    t_phase = time.perf_counter()
    root = os.path.join(DATA_DIR, "sources")
    warehouse = os.path.join(root, "warehouse")
    lake = e2e["lake"]
    li_files = sorted(os.path.join(lake, "lineitem", f)
                      for f in os.listdir(os.path.join(lake, "lineitem")))
    n_files = min(SOURCES_FILES, len(li_files))
    require(n_files >= SNAPSHOT_VERSIONS, f"sources: {n_files} lineitem files, too few")
    src_files = li_files[:n_files]
    out: dict = {"lineitem_files": n_files, "queries": {}, "actions_s": {}, "writes_s": {}}
    K.reset_counts()  # the phase's launches start here

    def timed(kind: str, label: str, fn):
        t0 = time.perf_counter()
        r = fn()
        out[kind][label] = time.perf_counter() - t0
        log({"sources_" + kind: label, "card": card, "seconds": out[kind][label]})
        return r

    def host(label: str, make, joined: bool = False) -> dict:
        """The host executor over the raw source: no index, no device."""
        h = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
        t0 = time.perf_counter()
        batch = make(h).collect()
        out.setdefault("host_reference_s", {})[label] = time.perf_counter() - t0
        return batch

    def run(label: str, session, make, want, indexes: list, kernel, route=None,
            log_versions=None, join: bool = False, warm_runs: int = SOURCES_WARM_RUNS) -> dict:
        """A query on the card: the indexes (and log versions) its plan
        reads, its route ("device", "pipelined" or "join"), ``kernel``
        launched once per run (no other), no decline, and every run equal
        to ``want``."""
        plan = make(session).optimized_plan()
        scans = [n for n in plan.preorder() if getattr(n, "index_info", None) is not None]
        used = [n.index_info.index_name for n in scans]
        require(used == indexes, f"sources {label}: plan reads {used}, expected {indexes}")
        versions = [n.index_info.log_version for n in scans]
        require(log_versions is None or versions == log_versions,
                f"sources {label}: log versions {versions}, expected {log_versions}")
        rec: dict = {"indexes": used, "log_versions": versions,
                     "lineage_ids": [n.lineage_filter_ids for n in scans]}
        session.device_stats = DeviceTierStats()
        before = dict(K.LAUNCHES)
        result = (lambda: _columns(make(session).collect())) if join else \
            (lambda: _floats(make(session).to_pydict()))
        check = (lambda got: compare_join("q3_agg", got, want)) if join else \
            (lambda got: compare_batches(label, got, want))
        up0 = session.device_cache.uploaded_bytes
        t0 = time.perf_counter()
        got = result()
        rec["first_run_s"] = time.perf_counter() - t0
        rec["upload_bytes_first"] = session.device_cache.uploaded_bytes - up0
        rec["first_run_route"] = scan_route(session.device_stats.last_scan)
        check(got)
        warm, warm_up = [], []
        for _ in range(warm_runs):
            u = session.device_cache.uploaded_bytes
            t0 = time.perf_counter()
            again = result()
            warm.append(time.perf_counter() - t0)
            warm_up.append(session.device_cache.uploaded_bytes - u)
            check(again)
        runs = 1 + warm_runs
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        stats = session.device_stats
        if join:
            require(stats.device_join_fragments == runs and not stats.declines,
                    f"sources {label}: join fragments {stats.device_join_fragments}, "
                    f"declines {stats.declines}")
        else:
            require(stats.device_fragments == runs and not stats.declines,
                    f"sources {label}: device fragments {stats.device_fragments}, "
                    f"declines {stats.declines}")
            got_route = rec["first_run_route"]["route"]
            require(route is None or got_route == route,
                    f"sources {label}: route {rec['first_run_route']}, expected {route}")
        require(launched == {k: (runs if k == kernel else 0) for k in K.LAUNCHES},
                f"sources {label}: launches {launched}, expected {kernel} x {runs}")
        rec.update({"warm_s": warm, "upload_bytes_warm": warm_up, "launches": launched,
                    "join_paths": stats.join_paths, "matches_host": True})
        out["queries"][label] = rec
        log({"sources": label, "card": card, **rec})
        return got

    # (a) a hive-partitioned lineitem
    part = os.path.join(root, "part_lineitem")
    r_ref = timed("writes_s", "partitioned lineitem",
                  lambda: _write_partitioned(src_files, part))
    dirs = sorted(os.path.relpath(d, part) for d, _s, fs in os.walk(part) if fs)
    out["partitions"] = dirs
    log({"sources": "partitions", "card": card, "directories": dirs,
         "files": sum(len(fs) for _d, _s, fs in os.walk(part))})
    session = HyperspaceSession(warehouse, conf={
        C.HYBRID_SCAN_MAX_DELETED_RATIO: SNAPSHOT_DELETED_RATIO})
    hs = Hyperspace(session)
    read_part = lambda s: s.read.parquet(part)  # noqa: E731
    schema = read_part(session).schema.names
    require(schema[-2:] == ["l_returnflag", "l_linestatus"] and len(schema) == 10,
            f"sources: partitioned schema {schema}")
    q1_host = host("q1_partitioned", lambda s: tpch.q1_of(read_part(s)))
    run("q1_partitioned", session, lambda s: tpch.q1_of(read_part(s)),
        _floats(q1_host.to_pydict()), [], None, route="device")
    # a partition filter on the host path: only the R directories are read
    reads: list = []
    real_read = cio.read_parquet
    cio.read_parquet = lambda paths, *a, **kw: reads.extend(paths) or real_read(paths, *a, **kw)
    try:
        t0 = time.perf_counter()
        flagged = read_part(session).filter(col("l_returnflag") == "R").select(
            "l_orderkey", "l_extendedprice").collect()
        r_s = time.perf_counter() - t0
    finally:
        cio.read_parquet = real_read
    r_files = sum(1 for d in dirs if d.startswith("l_returnflag=R")) * n_files
    require(len(reads) == r_files and all("/l_returnflag=R/" in p for p in reads),
            f"sources: the R filter read {len(reads)} files, expected the {r_files} under R")
    require(flagged.num_rows == r_ref["count"], f"sources: {flagged.num_rows} R rows "
            f"vs {r_ref['count']}")
    got_sum = float(flagged.column("l_extendedprice").data.sum())
    require(rel_err(got_sum, r_ref["sum_price"]) <= REL_TOL,
            f"sources: R sum {got_sum} vs {r_ref['sum_price']}")
    out["partition_filter"] = {"files_read": len(reads), "files_total": len(dirs) * n_files,
                               "rows": flagged.num_rows, "seconds": r_s}
    log({"sources": "partition_filter", "card": card, **out["partition_filter"]})
    del flagged
    timed("actions_s", "create pt_flagstatus", lambda: hs.create_index(
        read_part(session), CoveringIndexConfig("pt_flagstatus", *tpch.LI_FLAGSTATUS[1:])))
    timed("actions_s", "create pt_shipdate_mm", lambda: hs.create_index(
        read_part(session), DataSkippingIndexConfig("pt_shipdate_mm",
                                                    [MinMaxSketch("l_shipdate")])))
    kinds = [type(s).__name__ for s in hs.get_index("pt_shipdate_mm").derived_dataset.sketches]
    require(kinds == ["MinMaxSketch", "PartitionSketch", "PartitionSketch"],
            f"sources: pt_shipdate_mm sketches {kinds}")
    session.enable_hyperspace()
    run("q1_sums_partitioned", session, lambda s: tpch.q1_sums_of(read_part(s)),
        _floats(derived_reference("q1_sums", q1_host).to_pydict()), ["pt_flagstatus"],
        "filter_grouped_multi_sum")
    del q1_host
    make = lambda s: tpch.q6_count_of(read_part(s))  # noqa: E731
    run("q6_count_partitioned", session, make, _floats(host("q6_count_partitioned",
                                                            make).to_pydict()),
        [], "filter_weighted_sum", route="device")
    last = session.dataskipping_stats.last
    require(last.get("index") == "pt_shipdate_mm"
            and last.get("files_total") == len(dirs) * n_files,
            f"sources: the data-skipping index was not consulted: {last}")
    out["queries"]["q6_count_partitioned"]["dataskipping"] = last["message"]

    # (b) the orders as CSV files
    csv_dir = os.path.join(root, "orders_csv")
    od = timed("writes_s", "csv orders", lambda: _write_csv_orders(
        os.path.join(lake, "orders", "part-0.parquet"), csv_dir, SOURCES_CSV_FILES))
    csv_files = sorted(os.path.join(csv_dir, f) for f in os.listdir(csv_dir))
    raw = timed("writes_s", "csv read back", lambda: cio.read_csv(csv_files))
    require(raw.num_rows == od["rows"]
            and int(raw.column("o_orderkey").data.sum()) == od["o_orderkey_sum"]
            and int(raw.column("o_orderdate").data.sum()) == od["o_orderdate_sum"],
            "sources: the CSV orders read back differ from the parquet orders")
    del raw
    main = HyperspaceSession(e2e["warehouse"])  # the main phase's li_orderkey
    main_hs = Hyperspace(main)
    timed("actions_s", "create csv_od_orderkey", lambda: main_hs.create_index(
        main.read.csv(csv_dir), CoveringIndexConfig("csv_od_orderkey", *tpch.OD_ORDERKEY[1:])))
    main.enable_hyperspace()
    got = run("q3_agg_csv", main, lambda s: tpch.q3_agg_of(tpch._lineitem(s, lake),
                                                           s.read.csv(csv_dir)),
              e2e["want"]["q3_agg"], [tpch.LI_ORDERKEY[0], "csv_od_orderkey"], None, join=True,
              warm_runs=2)
    compare_join("q3_agg", got, e2e["device_results"]["q3_agg"])  # the parquet orders' run
    del got
    key0 = tpch.first_orderkey(lake)

    def key_span(df, start):
        return df.filter((col("o_orderkey") >= start)
                         & (col("o_orderkey") < start + SOURCES_KEY_RANGE)).agg(
            Count(lit(1)).alias("count"), Min(col("o_orderdate")).alias("first_date"),
            Max(col("o_orderdate")).alias("last_date"))

    make = lambda s: key_span(s.read.csv(csv_dir), key0)  # noqa: E731
    run("range_span_csv", main, make, _floats(host("range_span_csv", make).to_pydict()),
        ["csv_od_orderkey"], None)
    timed("actions_s", "delete+vacuum csv_od_orderkey",
          lambda: (main_hs.delete_index("csv_od_orderkey"),
                   main_hs.vacuum_index("csv_od_orderkey")))
    del main, main_hs

    # (c) a snapshot (Delta-style) lineitem: 4 versions of a quarter each
    table = SnapshotTable(os.path.join(root, "snap_lineitem"))
    per = n_files // SNAPSHOT_VERSIONS

    def commit(v: int) -> None:
        timed("writes_s", f"snapshot v{v}", lambda: table.commit(
            cio.read_parquet(src_files[v * per:(v + 1) * per])))

    commit(0)
    commit(1)
    session.set_conf(C.INDEX_LINEAGE_ENABLED, True)  # the deletes of v4 need it
    z_spec = tpch.LI_SHIPDATE_Z[1:]
    timed("actions_s", "create snap_shipdate_z (v1)", lambda: hs.create_index(
        table.scan(session), ZOrderCoveringIndexConfig("snap_shipdate_z", *z_spec)))
    created = hs.get_index("snap_shipdate_z").id
    commit(2)
    commit(3)
    timed("actions_s", "refresh incremental snap_shipdate_z (v3)",
          lambda: hs.refresh_index("snap_shipdate_z", C.REFRESH_MODE_INCREMENTAL))
    refreshed = hs.get_index("snap_shipdate_z")
    history = refreshed.properties.get("snapshotVersionHistory")
    require(history == f"{created}:1,{refreshed.id}:3", f"sources: history {history}")
    for label, version, q, kernel in (("q6_count_v3", None, tpch.q6_count_of,
                                       "filter_weighted_sum"),
                                      ("q6_sum_v3", None, tpch.q6_sum_of, "filter_sum"),
                                      ("q6_count_v1", 1, tpch.q6_count_of,
                                       "filter_weighted_sum")):
        make = lambda s, v=version, q=q: q(table.scan(s, version=v))  # noqa: E731
        run(label, session, make, _floats(host(label, make).to_pydict()), ["snap_shipdate_z"],
            kernel, log_versions=[created if version == 1 else refreshed.id])
    deleted = table.snapshot_files(0)
    table.delete_files(deleted)  # v4
    session.set_conf(C.HYBRID_SCAN_ENABLED, True)
    make = lambda s: tpch.q6_count_of(table.scan(s))  # noqa: E731
    want = _floats(host("q6_count_v4", make).to_pydict())
    run("q6_count_v4_hybrid", session, make, want, ["snap_shipdate_z"], "filter_weighted_sum",
        route="device", log_versions=[refreshed.id])
    require(len(out["queries"]["q6_count_v4_hybrid"]["lineage_ids"][0] or []) == len(deleted),
            f"sources: hybrid lineage ids {out['queries']['q6_count_v4_hybrid']}")
    timed("actions_s", "refresh incremental snap_shipdate_z (v4 deletes)",
          lambda: hs.refresh_index("snap_shipdate_z", C.REFRESH_MODE_INCREMENTAL))
    session.set_conf(C.HYBRID_SCAN_ENABLED, False)
    last_id = hs.get_index("snap_shipdate_z").id
    run("q6_count_v4_refreshed", session, make, want, ["snap_shipdate_z"],
        "filter_weighted_sum", log_versions=[last_id])
    out["snapshot"] = {"created": created, "refreshed": refreshed.id, "after_deletes": last_id,
                       "history": hs.get_index("snap_shipdate_z").properties[
                           "snapshotVersionHistory"]}

    # (d) an Iceberg-style orders: three snapshots of a third each
    itable = IcebergStyleTable(os.path.join(root, "ice_orders"), rng=random.Random(SEED))
    orders = cio.read_parquet([os.path.join(lake, "orders", "part-0.parquet")])
    third = -(-orders.num_rows // ICEBERG_SNAPSHOTS)
    sids = []

    def icommit(i: int) -> None:
        sids.append(timed("writes_s", f"iceberg s{i}", lambda: itable.commit(
            orders.slice(i * third, min(orders.num_rows, (i + 1) * third)))))

    icommit(0)
    timed("actions_s", "create ice_od_orderkey (s0)", lambda: hs.create_index(
        itable.scan(session), CoveringIndexConfig("ice_od_orderkey", *tpch.OD_ORDERKEY[1:])))
    first = hs.get_index("ice_od_orderkey").id
    icommit(1)
    icommit(2)
    del orders
    timed("actions_s", "refresh full ice_od_orderkey (s2)",
          lambda: hs.refresh_index("ice_od_orderkey", C.REFRESH_MODE_FULL))
    entry = hs.get_index("ice_od_orderkey")
    chain = {f"s{i}": ice.closest_index_version_by_ancestry(itable, entry.properties, sid)
             for i, sid in enumerate(sids)}
    require(chain == {"s0": first, "s1": first, "s2": entry.id}, f"sources: ancestry {chain}")
    stamp = {s["snapshot-id"]: s["timestamp-ms"] for s in itable.snapshots()}
    start = int(key0 % third)  # a key range inside the first snapshot
    for label, kw, indexes, versions in (
            ("range_span_s0", {"snapshot_id": sids[0]}, ["ice_od_orderkey"], [first]),
            ("range_span_as_of_s0", {"as_of_ms": stamp[sids[0]]}, ["ice_od_orderkey"], [first]),
            # s1's nearest recorded ancestor is s0, built over other files:
            # the signature check refuses it and the scan reads the source
            ("range_span_s1", {"snapshot_id": sids[1]}, [], []),
            ("range_span_s2", {}, ["ice_od_orderkey"], [entry.id])):
        make = lambda s, kw=kw: key_span(itable.scan(s, **kw), start)  # noqa: E731
        run(label, session, make, _floats(host(label, make).to_pydict()), indexes, None,
            log_versions=versions)
    out["iceberg"] = {"snapshots": sids, "created": first, "refreshed": entry.id,
                      "ancestry": chain}
    require(not any(K.PLAIN_CALLS.values()),
            f"sources: plain versions ran on the card's path: {K.PLAIN_CALLS}")
    out["launches"] = dict(K.LAUNCHES)
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"sources: {k} never launched")
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "sources", "card": card, "seconds": out["seconds"],
         "launches": out["launches"]})
    return out


def reference_cache_check(e2e: dict, card: str) -> dict:
    """A warm run each of q6_count and q1_sums in a fresh session at the
    JAX package's cache budgets (the knobs unset), then the H100 sizing
    back: ms and upload bytes of the first and the warm run, each result
    held to the main phase's host reference."""
    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.columnar import io as cio

    saved = {k: os.environ.pop(k, None) for k in CACHE_KNOBS}
    try:
        session = HyperspaceSession(e2e["warehouse"]).enable_hyperspace()
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        cio.configure_caches()
    out: dict = {"budgets_mb": {"index": session.index_chunk_cache.max_bytes >> 20,
                                "device": session.device_cache.budget_bytes >> 20,
                                "host_derived": session.host_derived_cache.budget_bytes >> 20}}
    for q in ("q6_count", "q1_sums"):
        rec = {}
        for run in ("first", "warm"):
            u = session.device_cache.uploaded_bytes
            t0 = time.perf_counter()
            got = _floats(getattr(tpch, q)(session, e2e["lake"]).to_pydict())
            rec[f"{run}_ms"] = (time.perf_counter() - t0) * 1e3
            rec[f"{run}_upload_bytes"] = session.device_cache.uploaded_bytes - u
            compare_batches(f"{q} at the reference's cache budgets", got, e2e["want"][q])
        out[q] = rec
        log({"reference_cache_budgets": q, "card": card, **out["budgets_mb"], **rec})
    return out


# ---------------------------------------------------------------------------
# analysis phase
# ---------------------------------------------------------------------------

ANALYSIS_EXPLAIN = ("q6", "q1", "q3", "q10", "q17", "q18")
ANALYZE_QUERIES = ("q6_count", "q1_sums", "range_sum", "lookup_count", "q3_agg", "q10")
PROFILE_QUERIES = ("q6_count", "q3_agg")
TRACE_COST_QUERIES = ("q6_count", "q1_sums")
TRACE_COST_TURNS = 5
_ROUTE_FIELDS = ("device_fragments", "device_join_fragments", "declines", "join_paths",
                 "plain_join_fetches", "join_spills", "join_waves", "join_splits",
                 "device_plain_probes", "pipelined_queries", "pipelined_chunks",
                 "pipeline_declines", "pipeline_aborts")


def _route_record(stats) -> dict:
    """What the device tier recorded for one run: its counts by route and
    the last scan's route."""
    rec = {f: getattr(stats, f) for f in _ROUTE_FIELDS}
    last = stats.last_scan
    rec["scan"] = None if last is None else (last.route, last.stream)
    return rec


def _span_tree(span, depth: int = 0) -> list:
    """(depth, name, ms) of a span and its descendants, in preorder."""
    out = [(depth, span.name, span.duration_s * 1e3)]
    for c in span.children:
        out += _span_tree(c, depth + 1)
    return out


def analysis_phase(torch, K, e2e: dict, rows: int, card: str) -> dict:
    """The analysis views and the telemetry core over the main phase's lake
    and tpch_indexes, through the user's entry points:
    (a) explain(verbose) of q6, q1, q3, q10, q17 and q18 lists the indexes
        the optimized plan reads;
    (b) whyNot of q3 (extended) and q18 render;
    (c) EXPLAIN ANALYZE of q6_count, q1_sums, range_sum, lookup_count,
        q3_agg and q10, warm: each kernel's launches and the device tier's
        route record equal a plain warm run's; the analyzed run (the same
        collector, installed again to read its batch) has the plain run's
        bits, its root node's rows are the result's rows, and its notes
        hold the route the device tier took;
    (d) profile of q6_count and q3_agg: the span tree holds query -> plan
        -> rule:* and exec:* -> kernel:* (q6_count) or join:band (q3_agg),
        the root's meter delta holds a dispatch and no upload (warm); each
        span's name and ms print;
    (e) the cost of tracing: warm q6_count and q1_sums untraced and traced
        in turns, five runs each, the same bits, both medians printed (no
        threshold);
    (f) the min/max layout comparison of l_shipdate over the raw lineitem
        against li_shipdate_z, printed."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.analysis import minmax_analysis
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.telemetry import plan_stats, trace

    lake, warehouse = e2e["lake"], e2e["warehouse"]
    session = HyperspaceSession(warehouse).enable_hyperspace()  # device=None: the card
    hs = Hyperspace(session)
    fns = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES, **tpch.TPCH_QUERIES}
    out: dict = {"explain": {}, "analyze": {}, "profile": {}, "trace_cost": {}}
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)

    # (a) explain
    for q in ANALYSIS_EXPLAIN:
        text = hs.explain(fns[q](session, lake), verbose=True)
        listed = text.split("Indexes used:")[1].split("=" * 65)[1].strip().splitlines()
        listed = sorted(line.split(" (Type:")[0] for line in listed if "(Type:" in line)
        plan = fns[q](session, lake).optimized_plan()
        used = sorted({n.index_info.index_name for n in plan.preorder()
                       if getattr(n, "index_info", None) is not None})
        require(listed == used, f"explain {q}: lists {listed}, the plan reads {used}")
        require("Physical operator stats:" in text and "Applicable indexes:" in text,
                f"explain {q}: verbose sections missing")
        out["explain"][q] = listed
        log({"explain": q, "card": card, "indexes": listed, "chars": len(text)})

    # (b) whyNot
    for q, extended in (("q3", True), ("q18", False)):
        text = hs.why_not(fns[q](session, lake), extended=extended)
        for part in ("Plan with Hyperspace & Summary:", "Applied indexes:",
                     "Plan without Hyperspace:", "Index reasons:"):
            require(part in text, f"whyNot {q}: {part!r} missing")
        log({"why_not": q, "card": card, "extended": extended, "chars": len(text)})

    # (c) EXPLAIN ANALYZE
    for q in ANALYZE_QUERIES:
        fn = fns[q]
        fn(session, lake).collect()  # warm: every cache filled
        runs = {}
        for mode in ("plain", "explain_analyze", "collector"):
            session.device_stats = DeviceTierStats()
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            if mode == "plain":
                batch = fn(session, lake).collect()
            elif mode == "explain_analyze":
                report = hs.explain_analyze(fn(session, lake))
            else:
                with plan_stats.collect_scope() as col:
                    batch_a = fn(session, lake).collect()
            ms = (time.perf_counter() - t0) * 1e3
            runs[mode] = {"launches": {k: K.LAUNCHES[k] - before[k] for k in before},
                          "route": _route_record(session.device_stats), "ms": ms}
        for mode in ("explain_analyze", "collector"):
            require(runs[mode]["launches"] == runs["plain"]["launches"],
                    f"{q}: {mode} launches {runs[mode]['launches']} vs "
                    f"{runs['plain']['launches']}")
            require(runs[mode]["route"] == runs["plain"]["route"],
                    f"{q}: {mode} route {runs[mode]['route']} vs {runs['plain']['route']}")
        got = _columns(batch_a)
        require(same_bits(got, _columns(batch)), f"{q}: the analyzed run's bits differ")
        if q in e2e["device_results"]:
            require(same_bits(got, e2e["device_results"][q]),
                    f"{q}: the analyzed run differs from the main phase's device result")
        elif q in e2e["want"]:
            compare_batches(q, _floats(batch_a.to_pydict()), e2e["want"][q])
        root = col.nodes.get(col.plan.plan_id)
        require(root is not None and root.rows_out == batch_a.num_rows,
                f"{q}: root rows {None if root is None else root.rows_out} vs "
                f"{batch_a.num_rows}")
        routes = dict(col.summary()["routes"])
        scan = runs["plain"]["route"]["scan"]
        if scan is not None:  # a fragment: its Aggregate notes the scan's route
            require(routes.get(scan[0], 0) >= 1, f"{q}: notes {routes}, scan route {scan}")
        else:  # a bucketed join
            require(routes.get("bucketed", 0) >= 1, f"{q}: notes {routes}")
        for part in ("Plan statistics (EXPLAIN ANALYZE):", "rows=", "wall=", "routes:",
                     f"result: {batch_a.num_rows} row(s)"):
            require(part in report, f"{q}: EXPLAIN ANALYZE lacks {part!r}")
        out["analyze"][q] = {"routes": routes, "scan_route": scan,
                             "join_paths": runs["plain"]["route"]["join_paths"],
                             "rows": batch_a.num_rows,
                             "launches": runs["plain"]["launches"],
                             "ms": {m: r["ms"] for m, r in runs.items()}}
        log({"explain_analyze": q, "card": card, **out["analyze"][q]})

    # (d) profile
    for q in PROFILE_QUERIES:
        fn = fns[q]
        text = hs.profile(fn(session, lake))
        require("Query profile (spans + metrics):" in text and "metrics:" in text,
                f"profile {q}: report sections missing")
        with trace.capture() as cap:
            fn(session, lake).collect()
        (query,) = [r for r in cap.roots if r.name == "query"]
        tree = _span_tree(query)
        names = [n for _d, n, _ms in tree]
        kids = {c.name.split(":")[0] for c in query.children}
        require({"plan", "exec"} <= kids, f"profile {q}: the query's children {kids}")
        (plan,) = [c for c in query.children if c.name == "plan"]
        require(any(n.startswith("rule:") for _d, n, _ms in _span_tree(plan)),
                f"profile {q}: no rule span under plan")
        leaf = "kernel:" if q == "q6_count" else "join:band"
        execs = [c for c in query.children if c.name.startswith("exec:")]
        require(any(n.startswith(leaf) for e in execs for _d, n, _ms in _span_tree(e)),
                f"profile {q}: no {leaf} span under exec:*")
        require(query.rpc["dispatches"] >= 1 and query.rpc["upload_bytes"] == 0,
                f"profile {q}: warm meter delta {query.rpc}")
        out["profile"][q] = {"rpc": query.rpc, "spans": len(names)}
        log({"profile": q, "card": card, "rpc": query.rpc,
             "spans": [["  " * d + n, round(ms, 3)] for d, n, ms in tree]})

    # (e) the cost of tracing
    for q in TRACE_COST_QUERIES:
        fn = fns[q]
        fn(session, lake).collect()
        times = {"untraced": [], "traced": []}
        bits = {}
        for _turn in range(TRACE_COST_TURNS):
            for mode in ("untraced", "traced"):
                t0 = time.perf_counter()
                if mode == "traced":
                    with trace.capture():
                        batch = fn(session, lake).collect()
                else:
                    batch = fn(session, lake).collect()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                got = _columns(batch)
                require(same_bits(got, bits.setdefault(mode, got))
                        and same_bits(got, bits.setdefault("untraced", got)),
                        f"{q}: a traced run's bits differ")
        trace.drain_roots()
        out["trace_cost"][q] = {"untraced_median_ms": statistics.median(times["untraced"]),
                                "traced_median_ms": statistics.median(times["traced"]),
                                "untraced_ms": times["untraced"], "traced_ms": times["traced"]}
        log({"trace_cost": q, "card": card, **out["trace_cost"][q]})

    # (f) the min/max layout comparison
    t0 = time.perf_counter()
    z_files = hs.get_index(tpch.LI_SHIPDATE_Z[0]).content.files()
    report = minmax_analysis.analyze_comparison(
        session.read.parquet(os.path.join(lake, "lineitem")), session.read.parquet(z_files),
        ["l_shipdate"])
    require("l_shipdate — before" in report and "l_shipdate — after" in report,
            "the min/max comparison did not render")
    out["minmax_s"] = time.perf_counter() - t0
    log({"minmax_comparison": "l_shipdate", "card": card, "seconds": out["minmax_s"],
         "z_files": len(z_files)})
    print(report, flush=True)

    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the analysis phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"the analysis phase launched {k} no time")
    out["session"] = session  # the serve phase serves from its warm caches
    return out


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

SERVE_TENANTS = "dash:weight=3;batch:weight=1,max_active=2"
SERVE_MIX = (("dash", "q6_count"), ("dash", "q6_sum"), ("dash", "q1_sums"),
             ("dash", "lookup_count"), ("dash", "range_sum"), ("batch", "q3_agg"),
             ("batch", "q1"))
SERVE_QUERIES = tuple(q for _t, q in SERVE_MIX)
SERVE_SUBMISSIONS = 48
SERVE_WORKERS = 4
SERVE_WARM_RUNS = 3
SERVE_CANCEL_QUERY = "q18"
SERVE_CONSERVED = ("io.", "cache.", "rpc.", "pipeline.", "pruning.", "serve.budget.")
SERVE_KNOBS = ("HYPERSPACE_TENANTS", "HYPERSPACE_WORKLOAD_DIR", "HYPERSPACE_METRICS_PORT")
SERVE_SETTLE_S = 10.0  # straggler read-ahead tasks of a cancelled query


def _result_form(q: str, batch) -> dict:
    """A query's result as the end-to-end phase keeps it: numpy columns for
    the joins and the plain-join queries, Python values otherwise (exact:
    a float converts without rounding, so == compares bits)."""
    from hyperspace_tpu_torch.benchmark import tpch

    if q in tpch.JOIN_QUERIES or q in PLAIN_QUERIES:
        return _columns(batch)
    return _floats(batch.to_pydict())


def _same_result(q: str, a: dict, b: dict) -> bool:
    from hyperspace_tpu_torch.benchmark import tpch

    if q in tpch.JOIN_QUERIES or q in PLAIN_QUERIES:
        return same_bits(a, b)
    return a == b


def _percentile(xs: list, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else 0.0


def _http_get(url: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def serve_phase(K, e2e: dict, session, card: str) -> dict:
    """The serving plane over the main phase's lake and tpch_indexes, in
    ``session`` (the analysis phase's, its caches warm):
    (a) each query of SERVE_MIX run directly, SERVE_WARM_RUNS warm runs
        timed after one run that warms it; the last equals the end-to-end
        phase's warm result bit for bit;
    (b) the window: the tenants of SERVE_TENANTS, the workload journal in
        a scratch directory and the exporter on an ephemeral port (the
        scheduler starts it from HYPERSPACE_METRICS_PORT=0);
        SERVE_SUBMISSIONS submissions of SERVE_MIX, in turn, through one
        QueryScheduler of SERVE_WORKERS workers: every result equals (a)'s
        bit for bit; then SERVE_CANCEL_QUERY submitted and cancelled once
        a read-ahead or device-ledger stream of its own is open: it
        resolves "cancelled", both ledgers hold 0 bytes and no pin is left;
    (c) conservation over the window: per-query and per-tenant sums of the
        SERVE_CONSERVED counters equal the global deltas;
    (d) /metrics, /snapshot and /healthz fetched once (/healthz 200 ok);
        the journal holds one record per served query; index_report counts
        each served query against the index it read (li_shipdate_z,
        li_flagstatus, li_orderkey), li_shipdate_z's and li_orderkey's
        benefit above 0;
    (e) kernels 1-3 launch in the window, no plain version runs.
    The knobs it sets are restored afterwards."""
    import json as _json
    import tempfile

    from hyperspace_tpu_torch import Hyperspace, serve
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.ingest import REGISTRY as PINS
    from hyperspace_tpu_torch.serve import tenant as tenant_mod
    from hyperspace_tpu_torch.telemetry import attribution, exporter, workload
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY

    t_phase = time.perf_counter()
    lake = e2e["lake"]
    fns = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES, **tpch.TPCH_QUERIES}
    hs = Hyperspace(session)
    out: dict = {"direct": {}, "tenants": {}}
    plain0 = dict(K.PLAIN_CALLS)

    # (a) the direct warm runs
    direct = {}
    for q in SERVE_QUERIES:
        fns[q](session, lake).collect()
        warm = []
        for _ in range(SERVE_WARM_RUNS):
            t0 = time.perf_counter()
            batch = fns[q](session, lake).collect()
            warm.append(time.perf_counter() - t0)
        direct[q] = _result_form(q, batch)
        require(_same_result(q, direct[q], e2e["warm_results"][q]),
                f"serve {q}: the direct warm result differs from the end-to-end phase's")
        out["direct"][q] = {"warm_s": warm, "warm_median_s": statistics.median(warm)}
    del batch
    log({"serve": "direct", "card": card,
         "warm_median_s": {q: v["warm_median_s"] for q, v in out["direct"].items()}})

    saved = {k: os.environ.get(k) for k in SERVE_KNOBS}
    journal_dir = tempfile.mkdtemp(prefix="serve_workload_", dir=DATA_DIR)
    os.environ.update({"HYPERSPACE_TENANTS": SERVE_TENANTS,
                       "HYPERSPACE_WORKLOAD_DIR": journal_dir,
                       "HYPERSPACE_METRICS_PORT": "0"})
    tenant_mod.TENANTS.reset_for_testing()  # the spec above, bootstrapped
    workload.reset_for_testing()
    attribution.LEDGER.reset_for_testing()
    serve.reset_global_budget()

    def conserved() -> dict:
        return {n: v for n, kind, v in REGISTRY.export()
                if kind == "counter" and n.startswith(SERVE_CONSERVED)}

    sched = None
    try:
        # (b) the window
        g0 = conserved()
        launches0 = dict(K.LAUNCHES)
        sched = serve.QueryScheduler(max_concurrent=SERVE_WORKERS, queue_depth=64)
        exp = exporter.get_exporter()
        require(exp is not None and exp.host == "127.0.0.1",
                "the scheduler did not start the exporter from HYPERSPACE_METRICS_PORT")
        t0 = time.perf_counter()
        handles = []
        for i in range(SERVE_SUBMISSIONS):
            tenant, q = SERVE_MIX[i % len(SERVE_MIX)]
            handles.append((tenant, q, sched.submit_query(fns[q](session, lake), label=q,
                                                          tenant=tenant)))
        require(sched.drain(600), "the served mix did not drain")
        served_wall = time.perf_counter() - t0
        for _tenant, q, h in handles:
            require(h.status == "done", f"serve {q}: status {h.status} ({h._error!r})")
            require(_same_result(q, _result_form(q, h.result(0)), direct[q]),
                    f"serve {q} (query {h.query_id}): the served result differs from the "
                    f"direct warm result")
        serial = sum(out["direct"][q]["warm_median_s"] for _t, q, _h in handles)
        waits: dict = {}
        for tenant, _q, h in handles:
            waits.setdefault(tenant, []).append(h.queue_wait_s)
        for tenant, ws in sorted(waits.items()):
            out["tenants"][tenant] = {"queries": len(ws),
                                      "queue_wait_p50_s": _percentile(ws, 0.5),
                                      "queue_wait_p99_s": _percentile(ws, 0.99)}
        out.update({"served_wall_s": served_wall, "serial_warm_sum_s": serial,
                    "speedup": serial / served_wall if served_wall else None})
        log({"serve": "mix", "card": card, "submissions": SERVE_SUBMISSIONS,
             "workers": SERVE_WORKERS, "served_wall_s": served_wall,
             "serial_warm_sum_s": serial, "speedup": out["speedup"],
             "tenants": out["tenants"], "qos": sched.state()["tenants"]})

        # the cancel of a running query, mid-stream
        victim = sched.submit_query(fns[SERVE_CANCEL_QUERY](session, lake),
                                    label=SERVE_CANCEL_QUERY, tenant="batch")
        qid, mid_stream, deadline = victim.query_id, None, time.perf_counter() + 60
        while mid_stream is None and time.perf_counter() < deadline and not victim.done():
            for ledger, name in ((serve.global_budget(), "read-ahead"),
                                 (serve.device_budget(), "device")):
                if any(st["query"] == qid for st in ledger.state()["streams"]):
                    mid_stream = name
            if mid_stream is None:
                time.sleep(0.001)
        t_cancel = time.perf_counter()
        victim.cancel()
        try:
            victim.result(120)
            outcome = "done"
        except serve.QueryCancelledError:
            outcome = "cancelled"
        cancel_s = time.perf_counter() - t_cancel
        require(mid_stream is not None, f"{SERVE_CANCEL_QUERY} opened no stream before it "
                                        f"finished ({victim.status})")
        require(outcome == "cancelled" and victim.status == "cancelled",
                f"{SERVE_CANCEL_QUERY}: resolved {outcome} / {victim.status}")
        require(sched.drain(120), "the scheduler did not drain after the cancel")
        held = {"read_ahead": serve.global_budget().held_bytes(),
                "device": serve.device_budget().held_bytes(), "pins": PINS.active_pins()}
        require(held == {"read_ahead": 0, "device": 0, "pins": 0},
                f"the cancelled {SERVE_CANCEL_QUERY} left {held}")
        require(serve.global_budget().check_consistency()
                and serve.device_budget().check_consistency(), "a byte ledger is inconsistent")
        out["cancel"] = {"query": SERVE_CANCEL_QUERY, "stream_open": mid_stream,
                         "cancel_to_resolution_s": cancel_s, "held_after": held}
        log({"serve": "cancel", "card": card, **out["cancel"]})
        out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}

        # (c) conservation over the window
        def mismatches(by_tenant: bool) -> dict:
            g1 = conserved()
            deltas = {k: g1.get(k, 0) - g0.get(k, 0) for k in set(g0) | set(g1)}
            if by_tenant:
                lsum: dict = {}
                for counters in attribution.LEDGER.aggregate_counters_by_tenant().values():
                    for k, v in counters.items():
                        lsum[k] = lsum.get(k, 0) + v
            else:
                lsum = attribution.LEDGER.aggregate_counters()
            lsum = {k: v for k, v in lsum.items() if k.startswith(SERVE_CONSERVED)}
            return {k: (deltas.get(k, 0), lsum.get(k, 0)) for k in set(deltas) | set(lsum)
                    if deltas.get(k, 0) != lsum.get(k, 0)}

        for by_tenant in (False, True):
            settle = time.perf_counter() + SERVE_SETTLE_S
            m = mismatches(by_tenant)
            while m and time.perf_counter() < settle:
                time.sleep(0.1)  # straggler read-ahead tasks of the cancelled query
                m = mismatches(by_tenant)
            require(m == {}, f"conservation (by tenant: {by_tenant}): (global, ledger) {m}")
        records = attribution.LEDGER.recent_records()
        out["conserved_counters"] = len({k for r in records for k in r["counters"]
                                         if k.startswith(SERVE_CONSERVED)})
        phases = {p: sum(r["phases_ms"][p] for r in records) for p in attribution.PHASES}
        log({"serve": "conservation", "card": card, "records": len(records),
             "counters_checked": out["conserved_counters"], "phases_ms_sum": phases})

        # (d) the exporter, the journal, index_report
        scrapes = {}
        for path in ("/metrics", "/snapshot", "/healthz"):
            code, body = _http_get(exp.url + path)
            require(code == 200, f"{path}: HTTP {code}: {body[:200]}")
            scrapes[path] = len(body)
            if path == "/metrics":
                require("hyperspace_serve_tenant_queries{tenant=\"dash\"}" in body
                        and "breaker" not in body, "/metrics: tenant series missing")
            elif path == "/snapshot":
                snap = _json.loads(body)
                require(len(snap["queries"]["recent"]) > 0 and "breaker" not in snap,
                        "/snapshot: no query records")
            else:
                health = _json.loads(body)
                require(health["status"] == "ok", f"/healthz: {health}")
        workload.JOURNAL.flush(60)
        journal = workload.JOURNAL.load()
        served_ids = sorted([h.query_id for _t, _q, h in handles] + [qid])
        require(sorted(r["query_id"] for r in journal) == served_ids,
                f"the journal holds {len(journal)} records for {len(served_ids)} served "
                f"queries")
        report = hs.index_report()
        rows_by_name = {r["name"]: r for r in workload.INDEX_LEDGER.report()}
        # every served query settles, the cancelled q18 (li_orderkey) too
        served_by_index = {tpch.LI_SHIPDATE_Z[0]: ("q6_count", "q6_sum"),
                           tpch.LI_FLAGSTATUS[0]: ("q1_sums", "q1"),
                           tpch.LI_ORDERKEY[0]: ("lookup_count", "range_sum", "q3_agg",
                                                 SERVE_CANCEL_QUERY)}
        served_labels = [q for _t, q, _h in handles] + [SERVE_CANCEL_QUERY]
        for name, qs in served_by_index.items():
            row = rows_by_name.get(name, {})
            require(name in report and row.get("queries", 0)
                    == sum(q in qs for q in served_labels),
                    f"index_report: {name} missing or with {row.get('queries')} queries")
        # the benefit is the JAX package's counterfactual: the raw files'
        # (compressed) bytes the rewrite replaced less the bytes the query
        # decoded, plus what pruning skipped. li_flagstatus's queries decode
        # seven of lineitem's sixteen columns, more bytes than the raw
        # files hold, so its benefit is 0 by that formula; the pruned
        # lookups and the four-column q6 scans credit theirs
        for name in (tpch.LI_SHIPDATE_Z[0], tpch.LI_ORDERKEY[0]):
            require(rows_by_name[name]["benefit_s"] > 0, f"index_report: {name}'s benefit "
                    f"is {rows_by_name[name]['benefit_s']} s")
        out["index_report"] = {n: {k: r[k] for k in ("queries", "benefit_bytes",
                                                     "bytes_skipped", "benefit_s",
                                                     "net_utility_s")}
                               for n, r in rows_by_name.items()}
        out.update({"scrape_bytes": scrapes, "journal_records": len(journal),
                    "health": health["status"]})
        log({"serve": "telemetry", "card": card, "scrape_bytes": scrapes,
             "journal_records": len(journal), "index_report": out["index_report"]})
        print(report, flush=True)
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
        exporter.stop_exporter()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        workload.reset_for_testing()
        tenant_mod.TENANTS.reset_for_testing()
        shutil.rmtree(journal_dir, ignore_errors=True)

    # (e) the kernels
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the serve phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"the serve phase launched {k} no time")
    log({"serve": "launches", "card": card, **out["launches"]})
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# staticcheck phase
# ---------------------------------------------------------------------------

STATICCHECK_MIX = ("q6_count", "q6_sum", "q1_sums", "lookup_count", "range_sum", "q3_agg")
STATICCHECK_SUBMISSIONS = 16
STATICCHECK_WORKERS = 4
STATICCHECK_CANCEL_QUERY = "q18"
STATICCHECK_TIMED = ("q6_count", "q1_sums")
STATICCHECK_TURNS = (False, True, True, False)  # audits off/on, in turns
STATICCHECK_KNOBS = ("HYPERSPACE_VERIFY_PLAN", "HYPERSPACE_KERNEL_AUDIT")


def _counters(prefix: str) -> dict:
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY

    return {n: v for n, kind, v in REGISTRY.export()
            if kind == "counter" and n.startswith(prefix)}


def _delta(before: dict, prefix: str) -> dict:
    after = _counters(prefix)
    return {k[len(prefix):]: after[k] - before.get(k, 0) for k in sorted(after)
            if after[k] != before.get(k, 0)}


def sidecar_writer_check(counted: dict, index_dir: str, card: str) -> dict:
    """The sidecar writer's counters of a build (``counted``: its
    ``pruning.sketch.`` deltas) against what it left in ``index_dir``:
    ``sidecars_written`` is the number of sidecar files and
    ``sketches_built`` the sketches in them, as the JAX package counts."""
    import glob

    t0 = time.perf_counter()
    paths = glob.glob(os.path.join(index_dir, "**", "_sketch.*.json"), recursive=True)
    sketches = 0
    for path in paths:
        with open(path, encoding="utf-8") as f:
            sketches += len(json.load(f)["sketches"])
    rec = {"sidecars_written": counted.get("sidecars_written", 0),
           "sketches_built": counted.get("sketches_built", 0),
           "sidecar_files": len(paths), "sketches_in_files": sketches}
    require(rec["sidecars_written"] == len(paths) > 0 and rec["sketches_built"] == sketches,
            f"sidecar writer: counters {counted}, files {len(paths)}, sketches {sketches}")
    rec["seconds"] = time.perf_counter() - t0
    log({"sidecar": "writer counters", "card": card, **rec})
    return rec


def prune_verify_check(label: str, collect, want: dict, card: str) -> dict:
    """A pruned query run once more under ``HYPERSPACE_PRUNE=verify``: the
    pruned read is held to the full one, the result to ``want``, and
    ``pruning.verified`` must count 1, as in the JAX package."""
    prev = os.environ.get("HYPERSPACE_PRUNE")
    before = _counters("pruning.")
    os.environ["HYPERSPACE_PRUNE"] = "verify"
    t0 = time.perf_counter()
    try:
        got = collect()
    finally:
        if prev is None:
            os.environ.pop("HYPERSPACE_PRUNE", None)
        else:
            os.environ["HYPERSPACE_PRUNE"] = prev
    rec = {"seconds": time.perf_counter() - t0, **_delta(before, "pruning.")}
    compare_batches(f"{label} (prune verify)", got, want)
    require(rec.get("verified") == 1, f"{label}: pruning.verified counted {rec}")
    log({"prune_verify": label, "card": card, **rec})
    return rec


def staticcheck_phase(K, e2e: dict, session, card: str) -> dict:
    """The static checks over the main phase's lake and tpch_indexes, in
    ``session`` (the serve phase's, its caches warm; nothing re-uploads):
    (a) with the lock-order and lifecycle audits armed (set_audit),
        STATICCHECK_SUBMISSIONS submissions of STATICCHECK_MIX through one
        QueryScheduler of STATICCHECK_WORKERS workers, each bit for bit
        the end-to-end phase's warm result, then a running q18 (on a new
        session, its chunk caches cold) cancelled mid-stream; once every
        handle has drained, check_quiescent()
        (a LockOrderError or a ResourceLeakError fails the run);
    (b) with HYPERSPACE_VERIFY_PLAN=1, the optimized plan of every
        TPCH_QUERIES query and of the kernel-shaped forms (tpch.QUERIES,
        LOOKUP_QUERIES, JOIN_QUERIES) verified (a PlanInvariantError fails
        the run; the sampled q3_revenue plan is verified in the approx
        phase, whose warehouse holds the twins);
    (c) the session's kernel cache cleared (its device cache kept) and the
        mix run once under HYPERSPACE_KERNEL_AUDIT=1: each built closure's
        first call audited, each result bit for bit the end-to-end
        phase's; hazards by kind and code and retrace storms printed;
    (d) warm q6_count and q1_sums with every audit off and on, in turns.
    Kernels 1-3 launch and no plain version runs. The knobs and audit
    switches are restored afterwards."""
    from hyperspace_tpu_torch import serve
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.staticcheck import concurrency, kernel_audit, lifecycle

    t_phase = time.perf_counter()
    lake = e2e["lake"]
    fns = {**tpch.QUERIES, **tpch.LOOKUP_QUERIES, **tpch.JOIN_QUERIES, **tpch.TPCH_QUERIES}
    want = e2e["warm_results"]
    out: dict = {}
    parts: dict = {}
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    saved = {k: os.environ.get(k) for k in STATICCHECK_KNOBS}
    prev_lock, prev_life = concurrency.audit_enabled(), lifecycle.audit_enabled()
    sched = None

    def arm(on: bool) -> None:
        concurrency.set_audit(on)
        lifecycle.set_audit(on)
        if on:
            os.environ["HYPERSPACE_VERIFY_PLAN"] = "1"
        else:
            os.environ.pop("HYPERSPACE_VERIFY_PLAN", None)

    try:
        # (a) the served mix under the lock-order and lifecycle audits
        t0 = time.perf_counter()
        lock0, life0 = _counters("staticcheck.lock."), _counters("staticcheck.lifecycle.")
        arm(True)
        sched = serve.QueryScheduler(max_concurrent=STATICCHECK_WORKERS, queue_depth=64)
        handles = []
        for i in range(STATICCHECK_SUBMISSIONS):
            q = STATICCHECK_MIX[i % len(STATICCHECK_MIX)]
            handles.append((q, sched.submit_query(fns[q](session, lake), label=q)))
        require(sched.drain(600), "staticcheck: the served mix did not drain")
        for q, h in handles:
            require(h.status == "done", f"staticcheck {q}: status {h.status} ({h._error!r})")
            require(_same_result(q, _result_form(q, h.result(0)), want[q]),
                    f"staticcheck {q} (query {h.query_id}): the served result under the "
                    f"audits differs from the end-to-end phase's")
        # on a new session, whose chunk caches are cold, so that its scan
        # streams (the warm session may hold every chunk q18 reads)
        from hyperspace_tpu_torch import HyperspaceSession

        cold = HyperspaceSession(e2e["warehouse"]).enable_hyperspace()
        victim = sched.submit_query(fns[STATICCHECK_CANCEL_QUERY](cold, lake),
                                    label=STATICCHECK_CANCEL_QUERY)
        qid, mid_stream, deadline = victim.query_id, None, time.perf_counter() + 60
        while mid_stream is None and time.perf_counter() < deadline and not victim.done():
            for ledger, name in ((serve.global_budget(), "read-ahead"),
                                 (serve.device_budget(), "device")):
                if any(st["query"] == qid for st in ledger.state()["streams"]):
                    mid_stream = name
            if mid_stream is None:
                time.sleep(0.001)
        victim.cancel()
        try:
            victim.result(120)
            outcome = "done"
        except serve.QueryCancelledError:
            outcome = "cancelled"
        require(mid_stream is not None and outcome == "cancelled",
                f"staticcheck: {STATICCHECK_CANCEL_QUERY} resolved {outcome} "
                f"(stream open: {mid_stream})")
        require(sched.drain(120), "staticcheck: the scheduler did not drain after the cancel")
        sched.shutdown(wait=True, cancel=True)
        sched = None
        # straggler read-ahead tasks of the cancelled query release their
        # attribution scopes when they end
        settle = time.perf_counter() + SERVE_SETTLE_S
        while lifecycle.live_handles() and time.perf_counter() < settle:
            time.sleep(0.05)
        lifecycle.check_quiescent()
        lock_report = concurrency.report()
        out["locks"] = {**_delta(lock0, "staticcheck.lock."), "edges_seen": len(
            lock_report["edges"]), "registered": len(lock_report["locks"])}
        out["lifecycle"] = _delta(life0, "staticcheck.lifecycle.")
        for k in ("acquisitions", "edges", "violations"):
            out["locks"].setdefault(k, 0)
        for k in ("acquires", "releases", "leaks"):
            out["lifecycle"].setdefault(k, 0)
        require(out["locks"]["violations"] == 0 and out["lifecycle"]["leaks"] == 0,
                f"staticcheck: {out['locks']} {out['lifecycle']}")
        require(out["lifecycle"]["acquires"] == out["lifecycle"]["releases"] > 0,
                f"staticcheck: lifecycle acquires and releases differ: {out['lifecycle']}")
        out["served"] = {"submissions": len(handles), "cancelled": STATICCHECK_CANCEL_QUERY,
                         "stream_open": mid_stream}
        parts["served"] = time.perf_counter() - t0
        log({"staticcheck": "served", "card": card, **out["served"],
             "locks": out["locks"], "lifecycle": out["lifecycle"]})

        # (b) every optimized plan through the verifier
        t0 = time.perf_counter()
        plan0 = _counters("staticcheck.plan.")
        verified = []
        for q in sorted(set(tpch.TPCH_QUERIES) | set(tpch.QUERIES) | set(tpch.LOOKUP_QUERIES)
                        | set(tpch.JOIN_QUERIES)):
            fns[q](session, lake).optimized_plan()  # raises PlanInvariantError
            verified.append(q)
        out["plans"] = {**_delta(plan0, "staticcheck.plan."), "queries": verified}
        out["plans"].setdefault("violations", 0)
        require(out["plans"].get("runs", 0) >= len(verified)
                and out["plans"]["violations"] == 0,
                f"staticcheck: plan verifier {out['plans']}")
        parts["plans"] = time.perf_counter() - t0
        log({"staticcheck": "plans", "card": card, **out["plans"]})

        # (d) the audits' cost on warm queries: off, on, on, off
        t0 = time.perf_counter()
        timed: dict = {q: {"off": [], "on": []} for q in STATICCHECK_TIMED}
        for on in STATICCHECK_TURNS:
            arm(on)
            for q in STATICCHECK_TIMED:
                t1 = time.perf_counter()
                batch = fns[q](session, lake).collect()
                timed[q]["on" if on else "off"].append((time.perf_counter() - t1) * 1000)
                require(_same_result(q, _result_form(q, batch), want[q]),
                        f"staticcheck {q}: the warm result (audits {on}) differs")
        arm(False)
        out["warm_ms"] = {q: {k: {"runs": v, "median": statistics.median(v)}
                              for k, v in d.items()} for q, d in timed.items()}
        parts["warm_cost"] = time.perf_counter() - t0
        log({"staticcheck": "warm_ms", "card": card, **out["warm_ms"]})

        # (c) the kernel hazard audit over rebuilt closures
        t0 = time.perf_counter()
        kern0 = _counters("staticcheck.kernel.")
        kernel_audit.reset_hazards()
        session.kernel_cache.clear()
        os.environ["HYPERSPACE_KERNEL_AUDIT"] = "1"
        for q in STATICCHECK_MIX:
            batch = fns[q](session, lake).collect()
            require(_same_result(q, _result_form(q, batch), want[q]),
                    f"staticcheck {q}: the result under the kernel audit differs")
        os.environ.pop("HYPERSPACE_KERNEL_AUDIT", None)
        by: dict = {}
        for h in kernel_audit.hazards_found():
            key = f"{h.kind}:{h.code}:{h.primitive}"
            by[key] = by.get(key, 0) + 1
        out["kernels"] = {**_delta(kern0, "staticcheck.kernel."), "hazards_by": by,
                          "retrace_storms_in_run": kernel_audit.report()["retrace_storms"]}
        require(out["kernels"].get("audited", 0) > 0, "staticcheck: no closure was audited")
        parts["kernel_audit"] = time.perf_counter() - t0
        log({"staticcheck": "kernels", "card": card, **out["kernels"]})
    finally:
        if sched is not None:
            sched.shutdown(wait=True, cancel=True)
        concurrency.set_audit(prev_lock)
        lifecycle.set_audit(prev_life)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the staticcheck phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"the staticcheck phase launched {k} no time")
    out["parts_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "staticcheck", "card": card, "seconds": out["phase_s"], "parts_s": parts,
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# mesh phase
# ---------------------------------------------------------------------------

MESH_DEVICES = 4
MESH_SLICES = 2  # (e): a (2, 2) hierarchical mesh
MESH_DEVICE_BUDGET_MB = "8192"  # per ordinal: four ledgers, 32 GiB of the card
MESH_PLACED = ("q3_agg", "q3", "q10", "q18")  # warm, HYPERSPACE_MESH=1
MESH_STREAMED = ("q6_count", "q1_count", "q6_span")  # first runs, HYPERSPACE_MESH=1
MESH_ROUTE = ("q6_count", "q6_sum", "q1_sums", "q1")  # meshDevices=4
MESH_JOIN = "q10"
MESH_BUILD_INDEX = ("mesh_orderkey", ["l_orderkey"], ["l_extendedprice"])
MESH_KNOBS = ("HYPERSPACE_MESH", "HYPERSPACE_MESH_DEVICES", "HYPERSPACE_DEVICE_BUDGET_MB")
MESH_SPANS = ("mesh:", "kernel:mesh_", "kernel:bucket_exchange", "kernel:dist_filter_agg")


def q1_count(session, root: str):
    """Q1's predicate and groups with count(1) only: the partial route's
    grouped kernel shape (filter_grouped_multi_sum with no measure), so
    each chunk placed on a mesh ordinal launches the kernel there."""
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.plan.expr import Count, col, lit

    return (tpch._lineitem(session, root).filter(col("l_shipdate") <= 10470)
            .group_by("l_returnflag", "l_linestatus")
            .agg(Count(lit(1)).alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def _mesh_spans(cap) -> dict:
    """Counts of the mesh tier's spans among a capture's spans."""
    names: dict = {}
    for sp in cap.sink.spans:
        if sp.name.startswith(MESH_SPANS):
            names[sp.name] = names.get(sp.name, 0) + 1
    return names


def _part_files(wh: str) -> dict:
    """relative path -> absolute path of every index data file under ``wh``."""
    out = {}
    for dirpath, _dirs, names in os.walk(wh):
        for fn in names:
            if fn.startswith("part-"):
                out[os.path.relpath(os.path.join(dirpath, fn), wh)] = os.path.join(dirpath, fn)
    return out


def mesh_phase(torch, K, e2e: dict, session, card: str) -> dict:
    """The multi-device tier over the SF10 index set, in ``session`` (warm;
    the approx phase's), under ``virtual_devices(MESH_DEVICES, card)``:
    MESH_DEVICES mesh ordinals over the one card, each with its own device
    ledger (HYPERSPACE_DEVICE_BUDGET_MB = MESH_DEVICE_BUDGET_MB each, so
    the ledgers together fit the card).
    (a) placement, HYPERSPACE_MESH=1: one run of each of MESH_PLACED in
        the warm session (band waves placed on the ordinals:
        ``device_stats.placed_waves`` spans at least two; the run uploads
        under the ordinals' new cache keys; the phase's one cut in depth:
        no repeat), and first runs of MESH_STREAMED on a fresh session (partial-route
        chunks placed: ``placed_chunks`` spans at least two ordinals, and
        q1_count launches filter_grouped_multi_sum once per placed chunk);
        each bit for bit the mesh-off result (the end-to-end phase's device
        result where it kept one); mesh.placement.* counted;
        every ordinal's ledger back to 0 reserved;
    (b) the mesh route, meshDevices = MESH_DEVICES: MESH_ROUTE's first
        mesh run and a warm one (``mesh_fragments`` counts both), counts
        and integers exact and f32 within REL_TOL of the one-device result;
    (c) the mesh join: MESH_JOIN through ``_mesh_join_work`` (join path
        "mesh"), bit for bit the one-device rows;
    (d) MESH_BUILD_INDEX over the first LIFECYCLE_FILES of the SF10
        lineitem files (hard links), built with the host partition and with
        the mesh's: the same files, byte for byte, and no declined mesh
        partition;
    (e) a (MESH_SLICES, MESH_DEVICES / MESH_SLICES) hierarchical mesh:
        MESH_ROUTE again (folds within each slice, then across), and (d)'s
        build as one run per slice per bucket (``-0s<slice>``) whose rows,
        stably sorted by key, are the host build's bucket;
    (f) ``dryrun_multigpu(MESH_DEVICES)`` over virtual ordinals of the card.
    Each part's seconds and its mesh:* / kernel:mesh_* span counts print.
    The knobs, the session's mesh conf keys and the device ledgers are
    restored afterwards."""
    import numpy as np
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.serve import budget as serve_budget
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.parallel.dryrun import dryrun_multigpu
    from hyperspace_tpu_torch.parallel.mesh import virtual_devices
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.telemetry import trace
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY

    t_phase = time.perf_counter()
    lake, wh = e2e["lake"], e2e["warehouse"]
    fns = {**tpch.QUERIES, **tpch.SPAN_QUERIES, **tpch.JOIN_QUERIES, **tpch.TPCH_QUERIES,
           "q1_count": q1_count}
    card_dev = session.device
    out: dict = {}
    parts: dict = {}
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    saved = {k: os.environ.get(k) for k in MESH_KNOBS}
    saved_conf = {k: session.get_conf(k) for k in (C.EXEC_MESH_DEVICES, C.EXEC_MESH_SLICES)}
    root = os.path.join(DATA_DIR, "mesh")

    def ledgers_drained(what: str) -> None:
        held = {o: a.held_bytes() for o, a in serve_budget.device_budgets().items()}
        require(all(v == 0 for v in held.values()), f"mesh {what}: ledgers hold {held}")

    def route_run(q: str, sess) -> dict:
        return _floats(fns[q](sess, lake).collect().to_pydict())

    try:
        os.environ["HYPERSPACE_DEVICE_BUDGET_MB"] = MESH_DEVICE_BUDGET_MB
        serve_budget.reset_device_budget()
        os.environ["HYPERSPACE_MESH"] = "0"
        # the one-device references: the end-to-end phase's device results
        # where it kept them, else a run in this session
        known = e2e.get("device_results", {})
        off = {q: known[q] if q in known else _result_form(q, fns[q](session, lake).collect())
               for q in MESH_PLACED + MESH_STREAMED}
        single = {q: route_run(q, session) for q in MESH_ROUTE}
        with virtual_devices(MESH_DEVICES, card_dev) as devices:
            require(len(devices) == MESH_DEVICES, f"mesh: {devices}")
            # (a) placement
            t0 = time.perf_counter()
            os.environ["HYPERSPACE_MESH"] = "1"
            buckets0 = REGISTRY.counter("mesh.placement.buckets").value
            session.device_stats = DeviceTierStats()
            placed_ms: dict = {}
            with trace.capture() as cap:
                for q in MESH_PLACED:
                    # warm host caches; the ordinals' cache keys are new, so
                    # this run uploads each wave's columns to its ordinal
                    t1 = time.perf_counter()
                    got = _result_form(q, fns[q](session, lake).collect())
                    placed_ms[q] = (time.perf_counter() - t1) * 1000
                    require(_same_result(q, got, off[q]),
                            f"mesh (a) {q}: the placed result differs from the mesh-off bits")
            waves = dict(session.device_stats.placed_waves)
            require(len(waves) >= 2, f"mesh (a): band waves placed on {waves}")
            ledgers_drained("(a) joins")
            fresh = HyperspaceSession(wh).enable_hyperspace()
            first_ms: dict = {}
            chunks_by_query: dict = {}
            grouped: dict = {}
            with trace.capture() as cap_s:
                for q in MESH_STREAMED:
                    c0 = sum(fresh.device_stats.placed_chunks.values())
                    g0 = K.LAUNCHES["filter_grouped_multi_sum"]
                    t1 = time.perf_counter()
                    got = _result_form(q, fns[q](fresh, lake).collect())
                    first_ms[q] = (time.perf_counter() - t1) * 1000
                    chunks_by_query[q] = sum(fresh.device_stats.placed_chunks.values()) - c0
                    grouped[q] = K.LAUNCHES["filter_grouped_multi_sum"] - g0
                    require(_same_result(q, got, off[q]),
                            f"mesh (a) {q}: the placed first run differs from the mesh-off bits")
            chunks = dict(fresh.device_stats.placed_chunks)
            # q1_count's partial route launches the grouped kernel once per
            # chunk, each on the ordinal its chunk was placed on
            require(len(chunks) >= 2 and chunks_by_query["q1_count"] > 1
                    and grouped["q1_count"] == chunks_by_query["q1_count"],
                    f"mesh (a): chunks placed {chunks_by_query} on {chunks}, grouped kernel "
                    f"launches {grouped}")
            ledgers_drained("(a)")
            out["placement"] = {
                "placed_ms": placed_ms, "first_run_ms": first_ms, "placed_waves": waves,
                "placed_chunks": chunks, "placed_chunks_by_query": chunks_by_query,
                "grouped_kernel_launches": grouped,
                "placed_buckets": REGISTRY.counter("mesh.placement.buckets").value - buckets0,
                "devices_used": REGISTRY.gauge("mesh.placement.devices_used").value,
                "imbalance": REGISTRY.gauge("mesh.placement.bytes_imbalance_ratio").value,
                "spans": {**_mesh_spans(cap), **{f"stream {k}": v
                                                 for k, v in _mesh_spans(cap_s).items()}},
            }
            require(out["placement"]["placed_buckets"] > 0, "mesh (a): no bucket placed")
            del fresh
            parts["placement"] = time.perf_counter() - t0
            log({"mesh": "placement", "card": card, **out["placement"]})
            os.environ["HYPERSPACE_MESH"] = "0"

            # (b) the mesh route, (c) the mesh join, (e) the same on a (2, 2) mesh
            for slices in (1, MESH_SLICES):
                t0 = time.perf_counter()
                session.set_conf(C.EXEC_MESH_DEVICES, MESH_DEVICES)
                session.set_conf(C.EXEC_MESH_SLICES, slices)
                session.device_stats = DeviceTierStats()
                route_ms: dict = {}
                with trace.capture() as cap:
                    for q in MESH_ROUTE:
                        compare_batches(f"mesh route {q}", route_run(q, session), single[q])
                        t1 = time.perf_counter()
                        got = route_run(q, session)
                        route_ms[q] = (time.perf_counter() - t1) * 1000
                        compare_batches(f"mesh route {q} (warm)", got, single[q])
                stats = session.device_stats
                require(stats.mesh_fragments == 2 * len(MESH_ROUTE),
                        f"mesh route ({slices} slices): {stats.mesh_fragments} mesh fragments, "
                        f"declines {stats.declines}")
                key = "route" if slices == 1 else "hierarchical_route"
                out[key] = {"warm_ms": route_ms, "mesh_fragments": stats.mesh_fragments,
                            "spans": _mesh_spans(cap)}
                parts[key] = time.perf_counter() - t0
                log({"mesh": key, "card": card, **out[key]})
                if slices == 1:
                    t0 = time.perf_counter()
                    session.device_stats = DeviceTierStats()
                    with trace.capture() as cap:
                        fns[MESH_JOIN](session, lake).collect()
                        t1 = time.perf_counter()
                        got = _result_form(MESH_JOIN, fns[MESH_JOIN](session, lake).collect())
                        join_ms = (time.perf_counter() - t1) * 1000
                    require(_same_result(MESH_JOIN, got, off[MESH_JOIN]),
                            f"mesh join {MESH_JOIN}: the rows differ from the one-device rows")
                    stats = session.device_stats
                    require(stats.mesh_joins == 2 and stats.join_paths.get("mesh") == 2,
                            f"mesh join: {stats.mesh_joins} mesh joins, paths {stats.join_paths}")
                    ledgers_drained("(c)")
                    out["join"] = {"warm_ms": join_ms, "mesh_joins": stats.mesh_joins,
                                   "spans": _mesh_spans(cap)}
                    parts["join"] = time.perf_counter() - t0
                    log({"mesh": "join", "card": card, **out["join"]})

            # (d) the mesh-partitioned build, (e) per slice
            t0 = time.perf_counter()
            mlake = os.path.join(root, "lake")
            _hard_link_tree(os.path.join(lake, "lineitem"), os.path.join(mlake, "lineitem"),
                            LIFECYCLE_FILES)
            builds: dict = {}
            for name, devices_conf, slices in (("host", 0, 1), ("mesh", MESH_DEVICES, 1),
                                               ("hierarchical", MESH_DEVICES, MESH_SLICES)):
                bwh = os.path.join(root, f"wh_{name}")
                bs = HyperspaceSession(bwh, conf={C.EXEC_MESH_DEVICES: devices_conf,
                                                  C.EXEC_MESH_SLICES: slices})
                t1 = time.perf_counter()
                with trace.capture() as cap:
                    Hyperspace(bs).create_index(
                        bs.read.parquet(os.path.join(mlake, "lineitem")),
                        CoveringIndexConfig(*MESH_BUILD_INDEX))
                require(not bs.device_stats.declines.get("mesh_partition"),
                        f"mesh build {name}: the mesh partition declined")
                builds[name] = {"seconds": time.perf_counter() - t1,
                                "files": _part_files(bwh), "spans": _mesh_spans(cap)}
            host, mesh_b, hier = (builds[k]["files"] for k in ("host", "mesh", "hierarchical"))
            require(sorted(host) == sorted(mesh_b) and host,
                    f"mesh build: file names differ ({len(host)} vs {len(mesh_b)})")
            import filecmp

            for rel in host:
                require(filecmp.cmp(host[rel], mesh_b[rel], shallow=False),
                        f"mesh build: {rel} differs from the host-partitioned file")
            runs = {}
            for rel, path in hier.items():
                stem = os.path.basename(rel).rsplit(".", 1)[0]  # part-0-b00003-0s1
                bucket, run = stem.split("-")[2], stem.split("-")[3]
                runs.setdefault(bucket, {})[run] = path
            key = MESH_BUILD_INDEX[1][0]
            for rel, path in host.items():
                bucket = os.path.basename(rel).rsplit(".", 1)[0].split("-")[2]
                tabs = [pq.read_table(runs[bucket][r]) for r in sorted(runs.get(bucket, {}))]
                require(sorted(runs.get(bucket, {})) in (["0s0", "0s1"], ["0s0"], ["0s1"]),
                        f"mesh build (e): bucket {bucket} runs {sorted(runs.get(bucket, {}))}")
                cat = {c: np.concatenate([t.column(c).to_numpy() for t in tabs])
                       for c in tabs[0].column_names}
                order = np.argsort(cat[key], kind="stable")
                want = pq.read_table(path)
                for c in want.column_names:
                    require(np.array_equal(cat[c][order], want.column(c).to_numpy()),
                            f"mesh build (e): bucket {bucket} column {c} differs")
            out["build"] = {k: {"seconds": v["seconds"], "files": len(v["files"]),
                                "spans": v["spans"]} for k, v in builds.items()}
            require(out["build"]["mesh"]["spans"].get("kernel:mesh_partition", 0) >= 1
                    and out["build"]["hierarchical"]["spans"].get("kernel:mesh_partition", 0)
                    >= MESH_SLICES, f"mesh build: spans {out['build']}")
            parts["build"] = time.perf_counter() - t0
            log({"mesh": "build", "card": card, **out["build"]})
        # (f) the dry run, over virtual ordinals of the card
        t0 = time.perf_counter()
        out["dryrun"] = dryrun_multigpu(MESH_DEVICES, card_dev)
        require(not out["dryrun"]["real"] and out["dryrun"]["mesh_joins"] >= 1,
                f"mesh dry run: {out['dryrun']}")
        parts["dryrun"] = time.perf_counter() - t0
        log({"mesh": "dryrun", "card": card, **out["dryrun"]})
        ledgers_drained("phase")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k, v in saved_conf.items():
            if v is None:
                session.unset_conf(k)
            else:
                session.set_conf(k, v)
        serve_budget.reset_device_budget()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the mesh phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"the mesh phase launched {k} no time")
    out["parts_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "mesh", "card": card, "seconds": out["phase_s"], "parts_s": parts,
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# ingest phase
# ---------------------------------------------------------------------------

INGEST_BATCHES = (44, 45, 46, 47)  # generate_tpch seeds of the appended batches
INGEST_BATCH_ROWS = 1_000_000
INGEST_BATCH_API = ("append", "append", "append", "append_batch")
INGEST_RANGE = (0, 200_000)  # range_sum's and range_stats's key range
INGEST_COLUMNS = ("l_orderkey", "l_extendedprice", "l_discount")
INGEST_REFRESH_WAIT_S = 120.0


def range_stats(session, root: str, start: int = INGEST_RANGE[0],
                width: int = INGEST_RANGE[1]):
    """range_sum's l_orderkey range with count(1), min, max and sum of
    l_orderkey: every output folds exactly (tests/test_torch_result_cache.py
    writes it the same way for both packages)."""
    from hyperspace_tpu_torch.plan.expr import Count, Max, Min, Sum, col, lit

    return session.read.parquet(os.path.join(root, "lineitem")).filter(
        (col("l_orderkey") >= start) & (col("l_orderkey") < start + width)
    ).agg(Count(lit(1)).alias("count"), Min(col("l_orderkey")).alias("min_key"),
          Max(col("l_orderkey")).alias("max_key"), Sum(col("l_orderkey")).alias("sum_key"))


def _ingest_host_reference(cols: dict, key: int) -> dict:
    """The three forms over the in-memory columns of the lake's current
    lineitem files: numpy, float64, no device."""
    import numpy as np

    ok, price, disc = (cols[c] for c in INGEST_COLUMNS)
    at = ok == key
    lo, hi = INGEST_RANGE[0], INGEST_RANGE[0] + INGEST_RANGE[1]
    inr = (ok >= lo) & (ok < hi)
    keys = ok[inr]
    return {
        "lookup_count": {"revenue": [float((price[at] * disc[at]).sum())],
                         "count": [int(at.sum())]},
        "range_sum": {"sum_price": [float(price[inr].sum())], "count": [int(inr.sum())]},
        "range_stats": {"count": [int(keys.size)], "min_key": [int(keys.min())],
                        "max_key": [int(keys.max())], "sum_key": [int(keys.sum())]},
    }


def ingest_phase(torch, K, e2e: dict, rows: int, card: str) -> dict:
    """The ingest plane, the result cache and view maintenance over the
    main lake's lineitem and li_orderkey, through the user's entry points,
    with HYPERSPACE_RESULT_CACHE=1 (restored afterwards):
    (1) lookup_count (a key in the base run and in every delta), range_sum
        and range_stats over INGEST_RANGE: first runs miss, warm runs hit
        with no dispatch and no upload, bit for bit;
    (2) four batches of generate_tpch's lineitem (seeds 44-47, 1M rows each
        at SF10) renamed into the lake, three through Hyperspace.append and
        one through ingest.append_batch; after each, the background refresh
        folds range_stats (cache.result.folds +1; its delta scan of the new
        runs is one device fragment) and the query is served from the folded
        entry, bit for bit a run with the cache off and the host reference
        (an integer sum over more than 2^23 rows takes the host, as in the
        JAX package, so at SF10 the cache-off recompute runs there while
        the fold's delta scan runs on the card); lookup_count and range_sum miss,
        run on the card over the multi-run buckets (filter_weighted_sum and
        filter_sum once each) and match the host reference;
    (3) a query's pin scope held across compact_index (one file per bucket)
        and vacuum_outdated_index: the pinned versions are deferred and the
        held plan's result is its pre-compaction result; after the scope, a
        vacuum retires them, and the three forms recompute (no fold over a
        rewritten layout) and match;
    (4) one pass under HYPERSPACE_RESULT_CACHE=verify, with no divergence."""
    import numpy as np
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, ingest
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.cache import view_maintenance
    from hyperspace_tpu_torch.cache.result_cache import RESULT_CACHE
    from hyperspace_tpu_torch.plan.executor import execute_plan
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats
    from hyperspace_tpu_torch.telemetry import plan_stats
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY
    from hyperspace_tpu_torch.utils.rpc_meter import METER

    lake, warehouse = e2e["lake"], e2e["warehouse"]
    li_dir = os.path.join(lake, "lineitem")
    name = tpch.LI_ORDERKEY[0]
    batch_rows = min(INGEST_BATCH_ROWS, max(20_000, rows // 10))
    saved_mode = os.environ.get("HYPERSPACE_RESULT_CACHE")
    os.environ["HYPERSPACE_RESULT_CACHE"] = "1"
    RESULT_CACHE.clear()
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    out: dict = {"batch_rows": batch_rows, "appends": []}

    def val(n: str) -> int:
        m = REGISTRY.get(n)
        return 0 if m is None else int(m.value)

    names = ("cache.result.hits", "cache.result.misses", "cache.result.folds",
             "cache.result.refreshes", "cache.result.verified", "ingest.vacuum.deferred",
             "ingest.vacuum.versions_removed", "ingest.appends", "ingest.rows_appended")

    def counters() -> dict:
        return {n: val(n) for n in names}

    def moved(before: dict) -> dict:
        return {n: val(n) - before[n] for n in names}

    try:
        t0 = time.perf_counter()
        cols = {c: [] for c in INGEST_COLUMNS}
        for f in sorted(os.listdir(li_dir)):
            t = pq.read_table(os.path.join(li_dir, f), columns=list(INGEST_COLUMNS))
            for c in INGEST_COLUMNS:
                cols[c].append(t.column(c).to_numpy())
        host = {c: np.concatenate(v) for c, v in cols.items()}
        out["host_read_s"] = time.perf_counter() - t0

        # the batches, generated up front; the lookup key is the first key of
        # the first batch that the base holds, so it is in every run
        staged = []
        for seed in INGEST_BATCHES:
            root = os.path.join(DATA_DIR, f"ingest_{seed}")
            tpch.generate_tpch(root, rows_lineitem=batch_rows, seed=seed)
            files = sorted(os.listdir(os.path.join(root, "lineitem")))
            staged.append((seed, root, files))
        first = pq.read_table(os.path.join(staged[0][1], "lineitem", staged[0][2][0]),
                              columns=["l_orderkey"]).column(0).to_numpy()
        present = np.isin(first[:1000], host["l_orderkey"])
        require(bool(present.any()), "ingest: no key of the first batch is in the base")
        key = int(first[:1000][present][0])
        out["lookup_key"] = key

        session = HyperspaceSession(warehouse).enable_hyperspace()  # device=None: the card
        hs = Hyperspace(session)
        forms = {"lookup_count": lambda: tpch.lookup_count(session, lake, key=key),
                 "range_sum": lambda: tpch.range_sum(session, lake, start=INGEST_RANGE[0],
                                                     width=INGEST_RANGE[1]),
                 "range_stats": lambda: range_stats(session, lake)}

        def run(q: str):
            """One collect of ``q``: its columns, seconds, launches, meter
            delta, device fragments and the root's route note."""
            session.device_stats = DeviceTierStats()
            before = dict(K.LAUNCHES)
            with plan_stats.collect_scope() as col, METER.measure() as m:
                t = time.perf_counter()
                batch = forms[q]().collect()
                secs = time.perf_counter() - t
            root = col.nodes.get(col.plan.plan_id)
            return {"got": _columns(batch), "floats": _floats(batch.to_pydict()), "s": secs,
                    "launches": {k: K.LAUNCHES[k] - before[k] for k in before},
                    "rpc": m.delta, "fragments": session.device_stats.device_fragments,
                    "declines": dict(session.device_stats.declines),
                    "route": None if root is None else root.route}

        def on_card_or_capped(r: dict) -> bool:
            """range_stats's integer sum: the card, or, over more rows than
            the exact integer route takes (ops/intsum.py, 2^23), the host,
            as the JAX package declines it (its _INT_SUM_ROW_CAP)."""
            return (r["fragments"], r["declines"]) in ((1, {}), (0, {"int_sum_row_cap": 1}))

        def cache_off(q: str) -> dict:
            os.environ["HYPERSPACE_RESULT_CACHE"] = "0"
            try:
                return run(q)
            finally:
                os.environ["HYPERSPACE_RESULT_CACHE"] = "1"

        def check_on_card(q: str, r: dict, want: dict, stage: str) -> None:
            kernel = EXPECTED_KERNEL[q]
            require(r["fragments"] == 1 and r["launches"][kernel] == 1,
                    f"ingest {stage}: {q} fragments {r['fragments']}, launches "
                    f"{r['launches']}")
            compare_batches(q, r["floats"], want[q])

        # (1) populate: first runs miss, warm runs hit
        want = _ingest_host_reference(host, key)
        first_runs, hits = {}, {}
        for q in forms:
            c0 = counters()
            first_runs[q] = run(q)
            warm = run(q)
            d = moved(c0)
            require(d["cache.result.misses"] == 1 and d["cache.result.hits"] == 1,
                    f"ingest populate: {q} counters {d}")
            require(warm["rpc"]["dispatches"] == 0 and warm["rpc"]["uploads"] == 0
                    and warm["rpc"]["fetches"] == 0 and warm["route"] == "cached",
                    f"ingest populate: {q} warm hit ran {warm['rpc']}, route {warm['route']}")
            require(same_bits(warm["got"], first_runs[q]["got"]),
                    f"ingest populate: {q} hit differs from its first run")
            if q != "range_stats":
                check_on_card(q, first_runs[q], want, "populate")
            else:  # the generic body, no hand-written kernel
                require(on_card_or_capped(first_runs[q]),
                        f"ingest populate: range_stats fragments "
                        f"{first_runs[q]['fragments']}, declines {first_runs[q]['declines']}")
                compare_batches(q, first_runs[q]["floats"], want[q])
            # a hit plans the query before its key exists: the planning
            # alone, timed apart (outside a pin scope nothing is pinned)
            t0 = time.perf_counter()
            forms[q]().optimized_plan()
            plan_s = time.perf_counter() - t0
            hits[q] = {"first_run_s": first_runs[q]["s"], "hit_s": warm["s"], "plan_s": plan_s}
            log({"ingest": "populate", "card": card, "query": q,
                 "first_run_s": first_runs[q]["s"], "hit_ms": warm["s"] * 1e3,
                 "plan_ms": plan_s * 1e3, "launches": first_runs[q]["launches"]})
        out["populate"] = hits

        # (2) appends
        last = {}
        for i, (seed, root, files) in enumerate(staged):
            moved_to = []
            for f in files:
                dst = os.path.join(li_dir, f"part-ingest-{seed}-{f}")
                os.rename(os.path.join(root, "lineitem", f), dst)
                moved_to.append(dst)
            for c in INGEST_COLUMNS:
                for dst in moved_to:
                    host[c] = np.concatenate(
                        [host[c], pq.read_table(dst, columns=[c]).column(0).to_numpy()])
            want = _ingest_host_reference(host, key)
            c0 = counters()
            session.device_stats = DeviceTierStats()
            t0 = time.perf_counter()
            if INGEST_BATCH_API[i] == "append":
                hs.append(name, session.read.parquet(moved_to))
            else:  # append_batch writes the batch as one file and appends it
                from hyperspace_tpu_torch.columnar import io as cio

                batch = cio.read_parquet(moved_to)
                for dst in moved_to:
                    os.unlink(dst)
                moved_to = [ingest.append_batch(session, name, batch,
                                                filename=f"part-ingest-{seed}.parquet")]
            append_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            while not view_maintenance.refresh_idle():
                require(time.perf_counter() - t0 < INGEST_REFRESH_WAIT_S,
                        "ingest: the background refresh did not finish")
                time.sleep(0.001)
            refresh_s = time.perf_counter() - t0
            # the fold's delta scan (the new runs only) ran on the card
            fold_fragments = session.device_stats.device_fragments
            require(fold_fragments == 1 and not session.device_stats.declines,
                    f"ingest append {i}: the fold ran {fold_fragments} device fragments, "
                    f"declines {session.device_stats.declines}")
            entry = hs.get_index(name)
            runs = ingest.runs_per_bucket(entry)
            stats = run("range_stats")
            off = cache_off("range_stats")
            d = moved(c0)
            # every stale foldable entry is refreshed: the first folds from
            # the newest, the others then hit the stored fold
            require(d["cache.result.folds"] == 1 and d["cache.result.refreshes"] >= 1
                    and stats["route"] == "cached" and stats["rpc"]["dispatches"] == 0,
                    f"ingest append {i}: range_stats counters {d}, route {stats['route']}, "
                    f"rpc {stats['rpc']}")
            require(same_bits(stats["got"], off["got"]) and on_card_or_capped(off),
                    f"ingest append {i}: the folded range_stats differs from a cache-off run "
                    f"(fragments {off['fragments']}, declines {off['declines']})")
            compare_batches("range_stats", stats["floats"], want["range_stats"])
            results = {}
            for q in ("lookup_count", "range_sum"):
                results[q] = run(q)
                check_on_card(q, results[q], want, f"append {i}")
            last = results
            rec = {"seed": seed, "api": INGEST_BATCH_API[i], "files": len(moved_to),
                   "rows": d["ingest.rows_appended"], "append_s": append_s,
                   "fold_refresh_s": refresh_s, "range_stats_hit_ms": stats["s"] * 1e3,
                   "range_stats_recompute_s": off["s"],
                   "range_stats_recompute_on_card": off["fragments"] == 1,
                   "lookup_count_s": results["lookup_count"]["s"],
                   "range_sum_s": results["range_sum"]["s"],
                   "runs_per_bucket": sorted(set(runs.values())),
                   "version_dirs": len(entry.index_version_dirs())}
            require(d["ingest.appends"] == 1 and rec["runs_per_bucket"] == [i + 2],
                    f"ingest append {i}: {d}, runs per bucket {runs}")
            out["appends"].append(rec)
            log({"ingest": "append", "card": card, **rec})

        # (3) a pin scope held across compaction and vacuum
        c0 = counters()
        pre = last["lookup_count"]["got"]
        with ingest.pin_scope():
            plan = forms["lookup_count"]().optimized_plan()
            pinned = ingest.current_pins()
            require(len(pinned) >= 1, "ingest: the held plan pinned nothing")
            t0 = time.perf_counter()
            hs.compact_index(name, min_runs=2)
            out["compact_s"] = time.perf_counter() - t0
            compacted = ingest.runs_per_bucket(hs.get_index(name))
            require(set(compacted.values()) == {1},
                    f"ingest: after compaction, runs per bucket {compacted}")
            t0 = time.perf_counter()
            hs.vacuum_outdated_index(name)
            out["vacuum_deferred_s"] = time.perf_counter() - t0
            deferred = moved(c0)["ingest.vacuum.deferred"]
            require(deferred >= 1, "ingest: vacuum deferred no pinned version")
            held = _columns(execute_plan(plan, session))
            require(same_bits(held, pre), "ingest: the held query's result changed")
        t0 = time.perf_counter()
        hs.vacuum_outdated_index(name)
        out["vacuum_s"] = time.perf_counter() - t0
        d = moved(c0)
        require(d["ingest.vacuum.versions_removed"] >= 1,
                f"ingest: the second vacuum retired nothing ({d})")
        c1 = counters()
        after = {q: run(q) for q in forms}
        d1 = moved(c1)
        require(d1["cache.result.folds"] == 0 and d1["cache.result.misses"] == 3,
                f"ingest: after compaction the forms should recompute ({d1})")
        for q in ("lookup_count", "range_sum"):
            check_on_card(q, after[q], want, "compacted")
        require(on_card_or_capped(after["range_stats"]),
                f"ingest compacted: range_stats {after['range_stats']['declines']}")
        compare_batches("range_stats", after["range_stats"]["floats"], want["range_stats"])
        out["compaction"] = {"compact_s": out["compact_s"], "deferred": deferred,
                             "versions_removed": d["ingest.vacuum.versions_removed"],
                             "runs_per_bucket": sorted(set(compacted.values())),
                             "recompute_s": {q: after[q]["s"] for q in forms}}
        log({"ingest": "compaction", "card": card, **out["compaction"],
             "vacuum_deferred_s": out["vacuum_deferred_s"], "vacuum_s": out["vacuum_s"]})

        # (4) verify mode
        os.environ["HYPERSPACE_RESULT_CACHE"] = "verify"
        c2 = counters()
        for q in forms:
            r = run(q)
            require(same_bits(r["got"], after[q]["got"]), f"ingest verify: {q} differs")
        d2 = moved(c2)
        require(d2["cache.result.verified"] == 3 and d2["cache.result.hits"] == 3,
                f"ingest verify: {d2}")
        out["verified"] = d2["cache.result.verified"]
        log({"ingest": "verify", "card": card, "verified": out["verified"]})
    finally:
        if saved_mode is None:
            os.environ.pop("HYPERSPACE_RESULT_CACHE", None)
        else:
            os.environ["HYPERSPACE_RESULT_CACHE"] = saved_mode
        RESULT_CACHE.clear()

    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the ingest phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ("filter_weighted_sum", "filter_sum"):
        require(out["launches"][k] > 0, f"the ingest phase launched {k} no time")
    return out


# ---------------------------------------------------------------------------
# approx phase
# ---------------------------------------------------------------------------

APPROX_FRACTIONS = (0.01, 0.1)
APPROX_QUERY = "q3_revenue"
APPROX_WARM_RUNS = 1
APPROX_ARROW_FILES = 40  # (c)'s lineitem files of the SF10 lake
APPROX_DEADLINE_SHARE = 0.5  # the degraded submit's deadline, as a share of the exact wall
ADAPT_MIX = ("q6_count", "q6_sum", "q1_sums", "lookup_count", "range_sum", "q3_agg")
# the planted mis-estimates' seeded tables: the phase's one cut (a few
# million rows, not SF10); the join keeps tools/adapt_smoke.py's geometry
# (4 buckets that pad to one band wave each under a 2 MB grant)
ADAPT_ROWS = 2_000_000
ADAPT_JOIN_ROWS = 150_000
ADAPT_JOIN_GRANT_MB = "2.0"
ADAPT_SEED = 7


def _approx_run(session, df_fn, fraction=None) -> dict:
    """One collect under a plan-statistics collector (and the sampled
    tier's scope when ``fraction`` is set): its columns, wall, approx block,
    routes and the bucketed joins' paths."""
    from hyperspace_tpu_torch.plan import sampling
    from hyperspace_tpu_torch.telemetry import plan_stats

    stats = session.device_stats
    j0 = dict(stats.join_paths)
    t0 = time.perf_counter()
    with plan_stats.collect_scope() as col:
        if fraction is None:
            batch = df_fn().collect()
        else:
            with sampling.approx_scope(fraction):
                batch = df_fn().collect()
    summary = col.summary()
    return {"got": _columns(batch), "s": time.perf_counter() - t0,
            "approx": summary.get("approx"), "routes": sorted(summary["routes"]),
            "join_paths": {k: v - j0.get(k, 0) for k, v in stats.join_paths.items()
                           if v != j0.get(k, 0)}}


def _approx_tier(lake: str, e2e: dict, q3_agg_exact: dict, card: str) -> dict:
    """(a): the sampled tier over a fresh warehouse of the SF10 lake;
    ``q3_agg_exact`` is q3_agg's mode-0 result over the same lake's
    end-to-end indexes (the same data files)."""
    import numpy as np

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import serve
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.models import sample_store
    from hyperspace_tpu_torch.plan import sampling
    from hyperspace_tpu_torch.telemetry.attribution import LEDGER
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY

    def val(n: str) -> int:
        m = REGISTRY.get(n)
        return 0 if m is None else int(m.value)

    os.environ["HYPERSPACE_APPROX"] = "1"
    os.environ["HYPERSPACE_APPROX_FRACTIONS"] = ",".join(f"{f:g}" for f in APPROX_FRACTIONS)
    out: dict = {"build_s": {}, "build_s_without_twins": {}, "twins": {}}
    session = HyperspaceSession(os.path.join(DATA_DIR, "approx_wh")).enable_hyperspace()
    hs = Hyperspace(session)
    for table, spec in (("lineitem", tpch.LI_ORDERKEY), ("orders", tpch.OD_ORDERKEY)):
        t0 = time.perf_counter()
        tpch.build_index(session, hs, lake, table, "CI", spec)
        out["build_s"][spec[0]] = time.perf_counter() - t0
        out["build_s_without_twins"][spec[0]] = e2e.get("index_build_s", {}).get(spec[0])
        files = [f.name for f in hs.get_index(spec[0]).index_data_files()]
        metas = [sample_store.load_sample_meta(p) for p in files]
        require(all(metas), f"approx: {spec[0]} has a data file without a sample meta")
        n = sum(m["rows"] for m in metas)
        per = {}
        for f in APPROX_FRACTIONS:
            twins = [sample_store.sample_path(p, f) for p in files]
            require(all(os.path.exists(t) for t in twins), f"approx: {spec[0]} misses a twin at {f}")
            kept = sum(m["kept"][str(sample_store.fraction_ppm(f))] for m in metas)
            per[f"{f:g}"] = {"twins": len(twins), "kept_rows": kept, "target_rows": f * n,
                             "kept_over_target": kept / (f * n)}
            # whole keys are kept: within five binomial deviations over the
            # keys (the metas' distinct hashes), or 5% where that is wider
            keys = sum(m["key_ndv"] for m in metas)
            tol = max(0.05, 5.0 * math.sqrt((1.0 - f) / (f * keys)))
            require(abs(kept / (f * n) - 1.0) < tol,
                    f"approx: {spec[0]} keeps {kept} rows at {f} of {n}")
        out["twins"][spec[0]] = {"rows": n, "data_files": len(files), "fractions": per}
    log({"approx": "twins", "card": card, **out})

    q = lambda: tpch.q3_revenue(session, lake)  # noqa: E731
    # the staticcheck phase's sampled plan: q3_revenue's at each fraction,
    # substituted over the twins, verified (a PlanInvariantError fails)
    from hyperspace_tpu_torch.staticcheck.plan_verifier import verify_plan

    out["verified_sampled_plans"] = {}
    for f in APPROX_FRACTIONS:
        sp = sampling.build_sampled_plan(session, q().optimized_plan(), f)
        require(not isinstance(sp, str), f"approx: {APPROX_QUERY} declined at {f}: {sp}")
        nodes0 = val("staticcheck.plan.nodes")
        require(verify_plan(sp.plan, session) == [], "approx: sampled plan violations")
        out["verified_sampled_plans"][f"{f:g}"] = val("staticcheck.plan.nodes") - nodes0
    log({"staticcheck": "sampled_plans", "card": card,
         "query": APPROX_QUERY, "nodes": out["verified_sampled_plans"]})
    exact = [_approx_run(session, q) for _ in range(1 + APPROX_WARM_RUNS)]
    for r in exact:
        # no groups: the batched plain join on the card, the sum on the host
        require(r["join_paths"] == {"batched": 1},
                f"approx: exact {APPROX_QUERY} took {r['join_paths']}")
        require(same_bits(r["got"], exact[0]["got"]), f"approx: exact {APPROX_QUERY} repeats")
    want = {k: float(v[0]) for k, v in exact[0]["got"].items()}
    # q3_agg under the scope is declined (group-on-key) and keeps the exact
    # bits; its groups add up to the revenue
    g0 = val("approx.ineligible.group-on-key")
    agg_scoped = _approx_run(session, lambda: tpch.q3_agg(session, lake), APPROX_FRACTIONS[-1])
    require(same_bits(agg_scoped["got"], q3_agg_exact), "approx: q3_agg under the scope differs")
    require(rel_err(float(np.sum(agg_scoped["got"]["revenue"], dtype=np.float64)),
                    want["revenue"]) <= REL_TOL,
            "approx: q3_revenue differs from the sum of q3_agg's groups")
    require(val("approx.ineligible.group-on-key") == g0 + 1,
            "approx: q3_agg was not declined as group-on-key")
    require(agg_scoped["approx"] and agg_scoped["approx"].get("reason") == "group-on-key",
            f"approx: q3_agg's approx block {agg_scoped['approx']}")
    out["exact"] = {"result": want, "first_s": exact[0]["s"],
                    "warm_s": [r["s"] for r in exact[1:]], "routes": exact[0]["routes"],
                    "join_paths": exact[0]["join_paths"]}
    out["q3_agg_declined"] = {"reason": "group-on-key", "bits_equal": True}

    def covered(r, f) -> dict:
        a = r["approx"]
        require(a and a.get("fraction") == f, f"approx: the sampled tier did not engage at {f}")
        est = {}
        for name in ("revenue", "count"):
            e = float(r["got"][name][0])
            hw = a["outputs"][name]["ci95_max"]
            require(abs(e - want[name]) <= hw,
                    f"approx: {name} at {f}: {e} +- {hw} misses the exact {want[name]}")
            est[name] = {"estimate": e, "half_width": hw, "rel_half_width": hw / abs(want[name]),
                         "rel_error": rel_err(e, want[name])}
        return est

    out["sampled"] = {}
    for f in sorted(APPROX_FRACTIONS, reverse=True):
        runs = [_approx_run(session, q, f) for _ in range(1 + APPROX_WARM_RUNS)]
        for r in runs:
            require(f"sampled(f={f:g})" in r["routes"], f"approx: routes {r['routes']} at {f}")
            # the inner level groups by the join key: the fused device join
            require(r["join_paths"] == {"stacked_agg": 1},
                    f"approx: the sampled join took {r['join_paths']} at {f}")
        out["sampled"][f"{f:g}"] = {"first": covered(runs[0], f), "first_s": runs[0]["s"],
                                    "warm_s": [r["s"] for r in runs[1:]],
                                    "warm": [covered(r, f) for r in runs[1:]],
                                    "route": runs[0]["routes"],
                                    "join_paths": runs[0]["join_paths"]}
        log({"approx": "sampled", "card": card, "fraction": f, **out["sampled"][f"{f:g}"],
             "exact_first_s": exact[0]["s"], "exact_warm_s": out["exact"]["warm_s"]})

    os.environ["HYPERSPACE_APPROX"] = "verify"
    v0 = sampling.APPROX.snapshot()["verify_checked"]
    r = _approx_run(session, q, APPROX_FRACTIONS[-1])
    covered(r, APPROX_FRACTIONS[-1])
    require(sampling.APPROX.snapshot()["verify_checked"] == v0 + 1, "approx: verify did not run")
    out["verify_s"] = r["s"]
    os.environ["HYPERSPACE_APPROX"] = "1"

    # the served degrade: the cost model learns the exact wall; a deadline
    # of half of it is unmeetable exact, and the 0.1 tier's prior fits
    label = APPROX_QUERY
    exact_s = out["exact"]["warm_s"][-1]
    serve.COST_MODEL.update(label, exact_s)
    deadline = exact_s * APPROX_DEADLINE_SHARE
    sched = serve.QueryScheduler(max_concurrent=1, queue_depth=4)
    rejected = False
    try:
        h = sched.submit(q().collect, label=label, deadline_s=deadline, allow_approx=True)
        served = _columns(h.result(600))
        try:
            sched.submit(q().collect, label=label, deadline_s=deadline, allow_approx=False)
        except serve.DeadlineUnmeetable:
            rejected = True
    finally:
        sched.shutdown()
    require(rejected, "approx: the allow_approx=False submit was not rejected")
    rec = [x for x in LEDGER.recent_records() if x["query_id"] == h.query_id][-1]
    a = rec.get("approx") or {}
    require(a.get("degraded") and a.get("engaged") is True,
            f"approx: the served degrade did not engage: {a}")
    require(LEDGER.recent_records()[-1]["outcome"] == "rejected",
            "approx: the rejected submit left no rejected record")
    served_est = covered({"got": served, "approx": a}, a["fraction"])
    out["served"] = {"deadline_s": deadline, "fraction": a["fraction"], "wall_ms": rec["total_ms"],
                     "estimate": served_est, "rejected_without_approx": rejected}
    log({"approx": "served", "card": card, **out["served"]})
    return out


def _approx_adaptive(K, e2e: dict, session, card: str) -> dict:
    """(b): the adaptive executor over the end-to-end indexes in
    ``session`` (warm: the serve phase's), then the three planted
    mis-estimates on seeded tables."""
    import glob

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import CoveringIndexConfig, Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.models import covering
    from hyperspace_tpu_torch.plan import join_memory
    from hyperspace_tpu_torch.plan.expr import Count, Max, Min, col, lit
    from hyperspace_tpu_torch.serve import budget as serve_budget
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY

    def val(n: str) -> float:
        m = REGISTRY.get(n)
        return 0 if m is None else m.value

    lake = e2e["lake"]
    os.environ["HYPERSPACE_APPROX"] = "0"
    out: dict = {"mix": {}}
    if session is None:
        session = HyperspaceSession(e2e["warehouse"]).enable_hyperspace()
    launches0 = dict(K.LAUNCHES)
    for q in ADAPT_MIX:
        fn = getattr(tpch, q)
        os.environ["HYPERSPACE_ADAPTIVE"] = "0"
        static = _columns(fn(session, lake).collect())
        os.environ["HYPERSPACE_ADAPTIVE"] = "verify"
        v0 = val("adaptive.verified")
        t0 = time.perf_counter()
        got = _columns(fn(session, lake).collect())
        out["mix"][q] = {"verify_s": time.perf_counter() - t0,
                         "verified": val("adaptive.verified") - v0}
        require(same_bits(got, static), f"adaptive verify: {q} differs from mode 0")
        require(out["mix"][q]["verified"] == 1, f"adaptive verify: {q} was not verified")
        if q == "q3_agg":
            out["q3_agg_exact"] = static
    out["mix_launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    out["verified"] = sum(v["verified"] for v in out["mix"].values())
    log({"approx": "adaptive_mix", "card": card, "mix": out["mix"],
         "mix_launches": out["mix_launches"], "verified": out["verified"]})

    root = os.path.join(DATA_DIR, "adapt")
    rng = np.random.default_rng(ADAPT_SEED)
    os.environ["HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS"] = "1"

    def write(path: str, table: dict) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pq.write_table(pa.table(table), path)

    t_sec = time.perf_counter()
    # (i) join re-plan under footer byte statistics planted 64x low
    write(os.path.join(root, "jl", "l.parquet"),
          {"k": rng.integers(0, 600, ADAPT_JOIN_ROWS), "p": rng.uniform(0, 100, ADAPT_JOIN_ROWS)})
    write(os.path.join(root, "jr", "r.parquet"),
          {"rk": np.arange(500), "w": rng.uniform(size=500)})
    s = HyperspaceSession(os.path.join(root, "wh"), conf={C.INDEX_NUM_BUCKETS: 4})
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(os.path.join(root, "jl")), CoveringIndexConfig("jl_idx", ["k"], ["p"]))
    hs.create_index(s.read.parquet(os.path.join(root, "jr")), CoveringIndexConfig("jr_idx", ["rk"], ["w"]))
    s.enable_hyperspace()

    def join_q():
        lhs = s.read.parquet(os.path.join(root, "jl")).select("k", "p")
        rhs = s.read.parquet(os.path.join(root, "jr")).select("rk", "w")
        return _columns(lhs.join(rhs, col("k") == col("rk")).group_by("k").agg(
            Count(lit(1)).alias("n"), Min(col("p")).alias("lo"),
            Max(col("p")).alias("hi")).sort("k").collect())

    real = join_memory._bucket_estimates
    join_memory._bucket_estimates = lambda side, b: (
        lambda r, nb: (r, nb / 64.0))(*real(side, b))
    saved = {k: os.environ.get(k) for k in ("HYPERSPACE_JOIN_BROADCAST_ROWS",
                                            "HYPERSPACE_DEVICE_BUDGET_MB",
                                            "HYPERSPACE_PARK_WAIT_MS")}
    os.environ.update({"HYPERSPACE_JOIN_BROADCAST_ROWS": "10",
                       "HYPERSPACE_DEVICE_BUDGET_MB": ADAPT_JOIN_GRANT_MB,
                       "HYPERSPACE_PARK_WAIT_MS": "1"})
    serve_budget.reset_device_budget()
    try:
        legs = {}
        for mode in ("0", "1"):
            os.environ["HYPERSPACE_ADAPTIVE"] = mode
            c0 = {n: val(n) for n in ("join.spill.parks", "join.spill.spills", "adaptive.replan")}
            got = join_q()
            legs[mode] = {"got": got, **{n: val(n) - v for n, v in c0.items()}}
    finally:
        join_memory._bucket_estimates = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        serve_budget.reset_device_budget()
    static, adapted = legs["0"], legs["1"]
    require(same_bits(adapted["got"], static["got"]), "adaptive join: bits differ from static")
    require(adapted["adaptive.replan"] >= 1, "adaptive join: no banded→split flip")
    stalls = lambda d: d["join.spill.parks"] + d["join.spill.spills"]  # noqa: E731
    require(stalls(adapted) < stalls(static),
            f"adaptive join: {stalls(adapted)} parks and spills against static {stalls(static)}")
    out["join_replan"] = {"flips": adapted["adaptive.replan"],
                          "static_parks_spills": stalls(static),
                          "adaptive_parks_spills": stalls(adapted),
                          "s": time.perf_counter() - t_sec}
    t_sec = time.perf_counter()

    # (ii) a worst-order col-vs-col conjunction: reordered, same bits
    write(os.path.join(root, "flt", "p.parquet"),
          {c: rng.integers(0, 100, ADAPT_ROWS) for c in ("a", "b", "c")})
    f_s = HyperspaceSession(os.path.join(root, "wh_flt"))

    def filter_df():
        return f_s.read.parquet(os.path.join(root, "flt")).filter(
            (col("a") != col("c")) & (col("a") > col("b")) & (col("b") >= col("c"))
        ).select("a", "b", "c")

    os.environ["HYPERSPACE_ADAPTIVE"] = "1"
    r0 = val("adaptive.reorder")
    adapted_f = _columns(filter_df().collect())
    reorders = val("adaptive.reorder") - r0
    report = Hyperspace(f_s).explain_analyze(filter_df())
    os.environ["HYPERSPACE_ADAPTIVE"] = "0"
    static_f = _columns(filter_df().collect())
    require(same_bits(adapted_f, static_f), "adaptive reorder: bits differ from static")
    require(reorders >= 1, "adaptive reorder: no switch")
    lines = [ln for ln in report.splitlines() if "[adapted:" in ln]
    require(bool(lines), "adaptive reorder: EXPLAIN ANALYZE shows no [adapted: ...] line")
    out["conjunct_reorder"] = {"reorders": reorders, "explain": lines,
                               "rows_kept": len(adapted_f["a"]), "s": time.perf_counter() - t_sec}
    t_sec = time.perf_counter()

    # (iii) sketch NDVs planted 10^9 high: the index scan aborts and re-plans
    saved_rgs = covering.INDEX_ROW_GROUP_SIZE
    os.environ["HYPERSPACE_SKETCHES"] = "1"
    covering.INDEX_ROW_GROUP_SIZE = 1024
    ev = os.path.join(root, "events")
    per = ADAPT_ROWS // 4
    try:
        for i in range(4):
            base = i * per
            keys = np.arange(base, base + per)
            write(os.path.join(ev, f"part-{i:02d}.parquet"),
                  {"ev_k": keys, "ev_cat": pa.array(np.char.add("c", (keys % 3).astype(str))),
                   "ev_v": rng.uniform(0, 1, per)})
        a_s = HyperspaceSession(os.path.join(root, "wh_ev"), conf={C.INDEX_NUM_BUCKETS: 2})
        Hyperspace(a_s).create_index(a_s.read.parquet(ev),
                                     CoveringIndexConfig("ev_idx", ["ev_k"], ["ev_cat", "ev_v"]))
    finally:
        covering.INDEX_ROW_GROUP_SIZE = saved_rgs
    sides = sorted(glob.glob(os.path.join(root, "wh_ev", "indexes", "ev_idx", "**",
                                          "_sketch.*.json"), recursive=True))
    require(bool(sides), "adaptive abort: no sketch sidecars")
    for side in sides:
        with open(side) as f:
            raw = json.load(f)
        if "ev_cat" in raw.get("ndv", {}):
            raw["ndv"]["ev_cat"] = 10**9
            with open(side, "w") as f:
                json.dump(raw, f)
    os.environ["HYPERSPACE_STREAM_CHUNK_MB"] = "0.02"
    try:
        def scan_q():
            return _columns(a_s.read.parquet(ev).filter(col("ev_cat") == "c1").group_by(
                "ev_cat").agg(Count(lit(1)).alias("n"), Min(col("ev_v")).alias("lo"),
                              Max(col("ev_v")).alias("hi")).collect())

        raw_bits = scan_q()  # Hyperspace off: the raw scan
        a_s.enable_hyperspace()
        os.environ["HYPERSPACE_ADAPTIVE"] = "1"
        a0, p0 = val("adaptive.abort"), val("adaptive.scan_replans")
        got = scan_q()
        aborts, replans = val("adaptive.abort") - a0, val("adaptive.scan_replans") - p0
    finally:
        os.environ.pop("HYPERSPACE_STREAM_CHUNK_MB", None)
        os.environ.pop("HYPERSPACE_SKETCHES", None)
        os.environ["HYPERSPACE_ADAPTIVE"] = "0"
    require(same_bits(got, raw_bits), "adaptive abort: the re-planned result is not the raw scan's")
    require(aborts >= 1 and replans >= 1, f"adaptive abort: {aborts} aborts, {replans} re-plans")
    out["scan_abort"] = {"aborts": aborts, "scan_replans": replans, "tampered_sidecars": len(sides),
                         "rows": ADAPT_ROWS, "s": time.perf_counter() - t_sec}
    log({"approx": "adaptive_planted", "card": card, "join_replan": out["join_replan"],
         "conjunct_reorder": out["conjunct_reorder"], "scan_abort": out["scan_abort"]})
    shutil.rmtree(root, ignore_errors=True)
    return out


def _approx_arrow(K, lake: str, card: str) -> dict:
    """(c): li_orderkey as Arrow IPC files over the first
    APPROX_ARROW_FILES lineitem files, held to the same index as parquet.
    The parquet scan skips row groups and the Arrow scan masks every row,
    so the kernel sums arrays of other lengths in another order: the bits
    agree at this cut, not at every one (at 20 files range_sum's did not)."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpch

    cut = os.path.join(DATA_DIR, "approx_cut")
    _hard_link_tree(os.path.join(lake, "lineitem"), os.path.join(cut, "lineitem"),
                    APPROX_ARROW_FILES)
    os.environ["HYPERSPACE_ADAPTIVE"] = "0"
    out: dict = {}
    for fmt in ("parquet", "arrow"):
        s = HyperspaceSession(os.path.join(DATA_DIR, f"approx_{fmt}"),
                              conf={C.INDEX_FORMAT: fmt})
        hs = Hyperspace(s)
        t0 = time.perf_counter()
        tpch.build_index(s, hs, cut, "lineitem", "CI", tpch.LI_ORDERKEY)
        build_s = time.perf_counter() - t0
        files = hs.get_index(tpch.LI_ORDERKEY[0]).content.files()
        require(all(f.endswith(f".{fmt}") for f in files), f"arrow: {fmt} index files {files[:2]}")
        s.enable_hyperspace()
        res = {"build_s": build_s, "files": len(files),
               "bytes": sum(os.path.getsize(f) for f in files), "queries": {}}
        for q in ("lookup_count", "range_sum"):
            runs = []
            for _ in range(1 + APPROX_WARM_RUNS):
                l0 = dict(K.LAUNCHES)
                t0 = time.perf_counter()
                got = _columns(getattr(tpch, q)(s, cut).collect())
                runs.append({"got": got, "s": time.perf_counter() - t0,
                             "launches": {k: K.LAUNCHES[k] - l0[k] for k in l0
                                          if K.LAUNCHES[k] != l0[k]}})
            require(all(same_bits(r["got"], runs[0]["got"]) for r in runs),
                    f"arrow: {fmt} {q} repeats")
            res["queries"][q] = {"got": runs[0]["got"], "launches": runs[0]["launches"],
                                 "first_s": runs[0]["s"], "warm_s": [r["s"] for r in runs[1:]]}
        out[fmt] = res
    for q in ("lookup_count", "range_sum"):
        a, p = out["arrow"]["queries"][q], out["parquet"]["queries"][q]
        require(same_bits(a["got"], p["got"]), f"arrow: {q} differs from the parquet index")
        require(a["launches"] == p["launches"] == {EXPECTED_KERNEL[q]: 1},
                f"arrow: {q} launches {a['launches']} against parquet {p['launches']}")
    for fmt in out:
        for q in out[fmt]["queries"]:
            out[fmt]["queries"][q]["got"] = _floats(out[fmt]["queries"][q]["got"])
    log({"approx": "arrow", "card": card, **out})
    shutil.rmtree(cut, ignore_errors=True)
    return out


APPROX_KNOBS = ("HYPERSPACE_APPROX", "HYPERSPACE_APPROX_FRACTIONS", "HYPERSPACE_ADAPTIVE",
                "HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS")


def approx_phase(K, e2e: dict, session, card: str) -> dict:
    """The approximate tier, the adaptive executor and the Arrow IPC index
    format, through the user's entry points (the knobs restored afterwards):
    (a) a fresh warehouse with HYPERSPACE_APPROX=1 and fractions 0.01 and
        0.1: li_orderkey and od_orderkey built over the SF10 lake, every
        data file with its twins and meta, each fraction's kept rows within
        5% of f·rows; q3_revenue exact (first and warm), then under
        approx_scope(0.1) and (0.01), first and warm, each through the
        device join over the twins with intervals covering the exact answer;
        one pass under HYPERSPACE_APPROX=verify; q3_agg under the scope
        declined as group-on-key with its exact bits; a served q3_revenue
        whose deadline (half the exact wall the cost model learned) degrades
        to the sampled tier (engaged, covering exact), and the same submit
        with allow_approx=False rejected;
    (b) the warm mix over the end-to-end indexes, in ``session`` (the
        serve phase's, warm for each; None makes a new one), under
        HYPERSPACE_ADAPTIVE=verify, bit for bit mode 0; then the three
        planted mis-estimates of tools/adapt_smoke.py on seeded tables: a
        join over footer statistics 64x low (banded→split, fewer parks and
        spills than static), a worst-order col-vs-col conjunction over
        ADAPT_ROWS rows ([adapted: …] in EXPLAIN ANALYZE) and sketch NDVs
        10^9 high over ADAPT_ROWS rows (the index scan aborts, is vetoed,
        and the result is the raw scan's), each with the static bits;
    (c) li_orderkey as Arrow IPC files over the SF10 lake's first
        APPROX_ARROW_FILES lineitem files: lookup_count and range_sum equal
        the parquet index's bits and launch the same kernel once per run."""
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in APPROX_KNOBS}
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    out: dict = {}
    parts: dict = {}
    try:
        t0 = time.perf_counter()
        out["adaptive"] = _approx_adaptive(K, e2e, session, card)
        parts["adaptive"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["sampled"] = _approx_tier(e2e["lake"], e2e, out["adaptive"].pop("q3_agg_exact"),
                                      card)
        parts["sampled"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["arrow"] = _approx_arrow(K, e2e["lake"], card)
        parts["arrow"] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(os.path.join(DATA_DIR, "approx_wh"), ignore_errors=True)
        for fmt in ("parquet", "arrow"):
            shutil.rmtree(os.path.join(DATA_DIR, f"approx_{fmt}"), ignore_errors=True)
    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the approx phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    for k in ON_PATH:
        require(out["launches"][k] > 0, f"the approx phase launched {k} no time")
    out["parts_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "approx", "card": card, "seconds": out["phase_s"], "parts_s": parts,
         "launches": out["launches"]})
    return out


# ---------------------------------------------------------------------------
# tpcds phase
# ---------------------------------------------------------------------------

# store_returns rows: TPC-DS SF10's 2,875,432, rounded up to 8 equal files
TPCDS_ROWS = 2_880_000
TPCDS_SEED = 0  # generate_tpcds's default seed
TPCDS_WARM_RUNS = 2
TPCDS_INDEXES = ["sr_datekey", "dd_datekey"]
TPCDS_KEYS = {"q1_customer_total_return": ("sr_customer_sk", "sr_store_sk"),
              "q1_store_avg": ("sr_store_sk",)}
TPCDS_BLOOM = (50_000, 0.01)  # sr_cust_bloom's sizing
# z-address of (date, store, customer): 1095 dates in 11 bits, 25 stores in
# 5, the customer key scaled to 16
TPCDS_ZORDER_BITS = (11, 5, 16)


def compare_grouped(q: str, got: dict, want: dict, keys: tuple) -> None:
    """Rows matched on the group keys (sorted by them): the same keys
    exactly, every other column within REL_TOL."""
    import numpy as np

    require(list(got) == list(want), f"{q}: columns {list(got)} vs {list(want)}")
    n = len(want[keys[0]])
    require(n > 0 and len(got[keys[0]]) == n, f"{q}: {len(got[keys[0]])} rows vs {n}")
    g_order = np.lexsort([got[k] for k in reversed(keys)])
    w_order = np.lexsort([want[k] for k in reversed(keys)])
    for name in want:
        g, w = np.asarray(got[name])[g_order], np.asarray(want[name])[w_order]
        if name in keys:
            require(bool(np.array_equal(g, w)), f"{q}.{name}: keys differ from the host")
        else:
            g, w = g.astype(np.float64), w.astype(np.float64)
            require(bool(np.isfinite(g).all()), f"{q}.{name}: non-finite values")
            err = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
            require(err <= REL_TOL, f"{q}.{name}: off by relative {err}")


def device_forms_check(torch, lake: str, dev, card: str) -> dict:
    """The four device forms of ops/sketch.py and ops/zorder.py on ``dev``
    over the store_returns columns, against their numpy forms, bit for
    bit: segment min/max of sr_return_amt and sr_customer_sk per file, the
    bloom filter of file 0's customer keys (sr_cust_bloom's sizing) and its
    probe by every row's key, and the z-address of (date, store, scaled
    customer). Each form's device ms (synchronized wall) beside the numpy
    form's ms."""
    import numpy as np
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.ops import sketch, zorder

    d = os.path.join(lake, "store_returns")
    tables = [pq.read_table(os.path.join(d, f)) for f in sorted(os.listdir(d))]
    cols = {c: np.concatenate([t[c].to_numpy() for t in tables])
            for c in ("sr_returned_date_sk", "sr_store_sk", "sr_customer_sk", "sr_return_amt")}
    files = len(tables)
    seg = np.repeat(np.arange(files), [t.num_rows for t in tables])
    out = {"rows": len(seg), "device_ms": {}, "numpy_ms": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3

    def on_dev(*ts):
        for t in ts:
            require(t.device == dev, f"device forms: a result on {t.device}, not {dev}")

    def same(name: str, got, want) -> None:
        on_dev(got)
        g = got.cpu().numpy()
        require(g.shape == want.shape and bool(np.array_equal(g, want)),
                f"device forms: {name} differs from its numpy form")

    for c in ("sr_return_amt", "sr_customer_sk"):
        (mn, mx), ms = timed(lambda: sketch.segment_min_max_torch(cols[c], seg, files, dev))
        (wmn, wmx), np_ms = timed(lambda: sketch.segment_min_max_np(cols[c], seg, files))
        same(f"segment_min_max({c}) min", mn, wmn)
        same(f"segment_min_max({c}) max", mx, wmx)
        out["device_ms"][f"segment_min_max_torch:{c}"] = ms
        out["numpy_ms"][f"segment_min_max_np:{c}"] = np_ms

    keys = cols["sr_customer_sk"]
    first = [keys[seg == 0]]
    bf = sketch.BloomFilter.create(*TPCDS_BLOOM)
    _, np_ms = timed(lambda: bf.add_words(first))
    bits, ms = timed(lambda: sketch.bloom_build_bits_torch(first, bf.num_bits, bf.num_hashes,
                                                          dev))
    same("bloom_build_bits (packed)", bits, np.unpackbits(bf.bits, bitorder="little"))
    out["device_ms"]["bloom_build_bits_torch"], out["numpy_ms"]["BloomFilter.add_words"] = ms, np_ms
    hits, ms = timed(lambda: sketch.bloom_probe_bits_torch(bits, [keys], bf.num_hashes, dev))
    want, np_ms = timed(lambda: bf.might_contain_words([keys]))
    same("bloom_probe_bits", hits, want)
    require(bool(want[seg == 0].all()), "device forms: the bloom filter lost a key")
    out["device_ms"]["bloom_probe_bits_torch"] = ms
    out["numpy_ms"]["BloomFilter.might_contain_words"] = np_ms
    out["bloom_hit_share"] = float(want.mean())

    fields = [(cols["sr_returned_date_sk"].astype(np.uint64), TPCDS_ZORDER_BITS[0]),
              (cols["sr_store_sk"].astype(np.uint64), TPCDS_ZORDER_BITS[1]),
              (zorder.scale_min_max(keys, keys.min(), keys.max(), TPCDS_ZORDER_BITS[2]),
               TPCDS_ZORDER_BITS[2])]
    z, ms = timed(lambda: zorder.interleave_bits_torch(fields, dev))
    wz, np_ms = timed(lambda: zorder.interleave_bits(fields))
    same("interleave_bits", z, wz.astype(np.int64))
    out["device_ms"]["interleave_bits_torch"], out["numpy_ms"]["interleave_bits"] = ms, np_ms
    log({"tpcds": "device_forms", "card": card, **out})
    return out


def tpcds_phase(torch, K, card: str, rows: int = TPCDS_ROWS) -> dict:
    """TPC-DS q1, the JAX package's plan-stability query, on the card:
    generate_tpcds at ``rows`` store_returns rows (seed 0), tpcds_indexes
    (sr_datekey, dd_datekey, sr_cust_bloom), then q1_customer_total_return
    and q1_store_avg with Hyperspace on, once cold and twice warm: each
    plan must read sr_datekey and dd_datekey, each run must take the
    batched plain join on the device tier (two fetches, no decline) and
    give the first run's bits, and the result must equal the host executor
    over the raw source (keys exact, sums within REL_TOL). Then the four
    device forms against their numpy forms (device_forms_check)."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import constants as C
    from hyperspace_tpu_torch.benchmark import tpcds
    from hyperspace_tpu_torch.plan.gpu_exec import DeviceTierStats

    t_phase = time.perf_counter()
    root = os.path.join(DATA_DIR, "tpcds")
    shutil.rmtree(root, ignore_errors=True)
    lake, warehouse = os.path.join(root, "lake"), os.path.join(root, "warehouse")
    out: dict = {"rows": rows, "seed": TPCDS_SEED, "queries": {}}
    t0 = time.perf_counter()
    out["source_bytes"] = tpcds.generate_tpcds(lake, rows_store_returns=rows, seed=TPCDS_SEED)
    out["generate_s"] = time.perf_counter() - t0
    session = HyperspaceSession(warehouse)  # device=None: the card
    t0 = time.perf_counter()
    tpcds.tpcds_indexes(session, Hyperspace(session), lake)
    out["index_build_s"] = time.perf_counter() - t0
    host = HyperspaceSession(warehouse, conf={C.EXEC_TPU_ENABLED: False})
    t0 = time.perf_counter()
    want = {q: _columns(fn(host, lake).collect()) for q, fn in tpcds.TPCDS_QUERIES.items()}
    out["host_s"] = time.perf_counter() - t0
    log({"tpcds": "data", "card": card, "rows": rows, "source_bytes": out["source_bytes"],
         "generate_s": out["generate_s"], "index_build_s": out["index_build_s"],
         "host_reference_s": out["host_s"]})
    del host

    session.enable_hyperspace()
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    runs = 1 + TPCDS_WARM_RUNS
    for q, fn in tpcds.TPCDS_QUERIES.items():
        used = [n.index_info.index_name for n in fn(session, lake).optimized_plan().preorder()
                if getattr(n, "index_info", None) is not None]
        require(used == TPCDS_INDEXES, f"{q}: plan reads {used}, expected {TPCDS_INDEXES}")
        session.device_stats = DeviceTierStats()
        ms, first = [], None
        for _ in range(runs):
            t0 = time.perf_counter()
            got = _columns(fn(session, lake).collect())
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = got
            else:
                require(same_bits(got, first), f"{q}: a warm run differs from the first run")
        stats = session.device_stats
        require(stats.join_paths == {"batched": runs} and stats.plain_join_fetches == 2 * runs
                and not stats.declines,
                f"{q}: join paths {stats.join_paths}, fetches {stats.plain_join_fetches}, "
                f"declines {stats.declines}")
        compare_grouped(q, first, want[q], TPCDS_KEYS[q])
        out["queries"][q] = {"indexes": used, "first_run_ms": ms[0], "warm_ms": ms[1:],
                             "rows_out": len(first[TPCDS_KEYS[q][0]]),
                             "join_paths": stats.join_paths, "matches_host": True}
        log({"query": q, "card": card, **out["queries"][q]})
    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the tpcds phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    out["device_forms"] = device_forms_check(torch, lake, session.device, card)
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "tpcds", "card": card, "seconds": out["phase_s"], "launches": out["launches"]})
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


# ---------------------------------------------------------------------------
# gates phase
# ---------------------------------------------------------------------------

GATES_SEEDS = 150  # differential seeds, 0-149 (600 before part (f) came)
GATES_KERNEL_ROWS = 1 << 22
GATES_KERNEL_FILES = 16
GATES_KERNEL_SEED = 31
GATES_KERNEL_SEEDS = 8  # per kernel shape (16 before part (f) came)
# (f): each serving-plane gate and its run() keywords beyond the
# reference's defaults. serve_smoke's clients submit the mix once, not
# twice (a depth cut). qos_smoke's fairness window is 180 results, not
# the reference's 60: at 60 the ratio is dominated by the first
# dispatches (every clock at 0, one tenant's whole backlog starts first)
# and the in-flight tail, and the reference's own tools/qos_smoke.py
# passed 1.8 in one of eight runs at 5,000 lineitem rows on a CPU
FEATURE_GATES = (("serve", {"repeats": 1}), ("qos", {"target": 180}), ("plan_stats", {}),
                 ("workload", {}), ("result_cache", {}), ("ingest", {}))
# what each gate's line logs beside ok and seconds
FEATURE_KEYS = {
    "serve": ("rows", "clients", "served_runs", "wave_runs", "bit_identical",
              "attribution_conserved", "ledger_records", "lock_violations"),
    "qos": ("rows", "served", "fairness_ratio", "cost_per_weight", "typed_rejections",
            "tenant_rejection_counters", "attribution_conserved_per_tenant"),
    "plan_stats": ("rows", "sections", "bit_identical", "annotated_ok",
                   "estimator_observations", "qerror_conserved"),
    "workload": ("rows", "journal_records", "outcomes", "index_order", "cold",
                 "failures"),
    "result_cache": ("rows", "hits", "misses", "hit_ratio", "folds", "replay_mismatches",
                     "snapshots_replayed", "zero_exec_on_hit", "attribution_conserved"),
    "ingest": ("batches", "served_queries", "pinned_queries", "snapshots_seen",
               "compactions", "vacuumed_versions", "crash_cells", "lock_violations"),
}


def gates_phase(K, card: str, device="cuda", seeds: int = GATES_SEEDS,
                kernel_rows: int = GATES_KERNEL_ROWS, chaos_rows: int | None = None,
                race: dict | None = None, features: dict | None = None) -> dict:
    """The port's correctness gates on ``device`` (tools/ and examples/):
    (a) the differential soak over ``seeds`` seeds, (b) the kernel-shaped
    leg at ``kernel_rows`` rows, (c) the chaos query sweep (at
    ``chaos_rows`` lineitem rows, default the tool's), (d) race_stress
    (``race``: its run() keywords, default its defaults), (e) the five
    examples, (f) the six serving-plane gates (``features``: per gate,
    run() keywords over FEATURE_GATES'). Every failure raises. Kernels 1-3
    launch in (b) and in (f)'s serve and qos gates, and no plain version
    runs."""
    import importlib

    import numpy as np

    from hyperspace_tpu_torch import examples
    from hyperspace_tpu_torch.tools import chaos_stress, race_stress
    from hyperspace_tpu_torch.tools import differential as D
    from hyperspace_tpu_torch.tools.differential_soak import soak

    t_phase = time.perf_counter()
    root = os.path.join(DATA_DIR, "gates")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out: dict = {}
    parts: dict = {}
    launches0, plain0 = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    t_part = time.perf_counter()

    def part_done(name: str) -> None:
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # (a) the differential soak's world and loop
    world = os.path.join(root, "differential")
    session = D.build_world(world, device, soak=True)
    r = soak(session, world, range(seeds), device)
    log({"gates": "differential", "card": card, "seeds": r["seeds"],
         "hybrid_seeds": r["hybrid_seeds"], "by_tier": r["by_tier"],
         "seconds": r["seconds"], "failures": r["failures"]})
    require(r["seeds"] == seeds and not r["failures"],
            f"differential: {r['mismatches']} mismatches, {r['errors']} errors: {r['failures']}")
    out["differential"] = r
    del session
    part_done("differential")

    # (b) the kernel-shaped leg
    kroot = os.path.join(root, "kernel_world")
    session = D.build_kernel_world(kroot, kernel_rows, GATES_KERNEL_FILES, GATES_KERNEL_SEED,
                                   device)
    part_done("kernel_world")
    shapes = {}
    for shape in D.KERNEL_SHAPES:
        before = dict(K.LAUNCHES)
        worst = 0.0
        for seed in range(GATES_KERNEL_SEEDS):
            q = D.kernel_query(session, kroot, np.random.default_rng(seed), shape)
            got, want = D.kernel_differential(session, q)
            require(D.rows_close(got, want, D.KERNEL_REL),
                    f"kernel leg {shape} seed {seed}: {got} vs the host's {want}")
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float) and b:
                        worst = max(worst, rel_err(a, b))
        require(worst <= D.KERNEL_REL, f"kernel leg {shape}: relative error {worst}")
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        require(launched[shape] > 0, f"kernel leg {shape}: its kernel never launched "
                                     f"({launched})")
        shapes[shape] = {"seeds": GATES_KERNEL_SEEDS, "launches": launched,
                         "max_rel_err": worst}
        log({"gates": "kernel_leg", "card": card, "shape": shape, **shapes[shape]})
    out["kernel_leg"] = {"rows": kernel_rows, "files": GATES_KERNEL_FILES, "shapes": shapes}
    del session
    part_done("kernel_leg")

    # (c) the chaos query sweep
    r = chaos_stress.run(device, **({} if chaos_rows is None else {"rows": chaos_rows}),
                         crash=False, workdir=root)
    log({"gates": "chaos", "card": card, "query_sweep": r["query_sweep"],
         "point_fired": r["point_fired"], "injected_total": r["injected_total"],
         "failures": r["failures"], "cache_consistency": r["cache_consistency"],
         "lifecycle_leaks": r["lifecycle_leaks"]})
    require(r["ok"], f"chaos sweep: {r['failures']} {r['cache_consistency']} "
                     f"{r['lifecycle_leaks']}")
    out["chaos"] = {k: r[k] for k in ("rows", "query_runs", "query_sweep", "injected_total")}
    part_done("chaos")

    # (d) race_stress
    r = race_stress.run(device, workdir=root, **(race or {}))
    log({"gates": "race", "card": card, **{k: r[k] for k in (
        "rows", "threads", "repeats", "runs", "bit_identical", "mismatches", "errors",
        "lock_acquisitions", "lock_violations", "cache_consistency", "lifecycle_leaks")}})
    require(r["ok"], f"race_stress: {r}")
    out["race"] = {k: r[k] for k in ("rows", "threads", "repeats", "runs", "lock_acquisitions",
                                     "lock_violations")}
    part_done("race")

    # (e) the five examples, in-process
    for name in examples.EXAMPLES:
        t0 = time.perf_counter()
        importlib.import_module(f"hyperspace_tpu_torch.examples.{name}").main(
            device=device, workdir=root)
        log({"gates": "example", "card": card, "example": name,
             "seconds": time.perf_counter() - t0})
    part_done("examples")

    # (f) the serving-plane gates
    plain_f = dict(K.PLAIN_CALLS)
    out["features"] = {}
    for name, kw in FEATURE_GATES:
        tool = importlib.import_module(f"hyperspace_tpu_torch.tools.{name}_smoke")
        before = dict(K.LAUNCHES)
        r = tool.run(device, root=root, **{**kw, **(features or {}).get(name, {})})
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        line = {k: r[k] for k in FEATURE_KEYS[name]}
        if "kernels" in r:
            line["kernel_threads"] = r["kernels"]["threads_by_kernel"]
        log({"gates": f"{name}_smoke", "card": card, "ok": r["ok"], "seconds": r["seconds"],
             "launches": launched, **line})
        require(r["ok"], f"{name}_smoke: {r}")
        if "kernels" in r:
            require(r["kernels"]["ok"] and all(launched[k] > 0 for k in ON_PATH),
                    f"{name}_smoke: kernels 1-3 did not each launch from the workers: "
                    f"{r['kernels']} {launched}")
        out["features"][name] = {"seconds": r["seconds"], "launches": launched, **line}
    require(K.PLAIN_CALLS == plain_f, f"plain versions ran in the serving-plane gates: "
            f"{ {k: K.PLAIN_CALLS[k] - plain_f[k] for k in plain_f} }")
    part_done("features")

    out["launches"] = {k: K.LAUNCHES[k] - launches0[k] for k in launches0}
    require(K.PLAIN_CALLS == plain0, f"plain versions ran in the gates phase: "
            f"{ {k: K.PLAIN_CALLS[k] - plain0[k] for k in plain0} }")
    shutil.rmtree(root, ignore_errors=True)
    out["parts_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log({"phase": "gates", "card": card, "seconds": out["phase_s"], "parts_s": parts,
         "launches": out["launches"]})
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

    # the cache budgets, set through the JAX package's knobs before any
    # session reads them (the build and footer-statistics caches keep its
    # defaults)
    os.environ.update(H100_CACHE_MB)
    from hyperspace_tpu_torch.utils import env as hs_env

    sizing = {k: hs_env.cache_bytes(k) >> 20 for k in CACHE_KNOBS}
    log({"phase": "cache_sizing", "card": smi, "mb": sizing})

    build_s = K.build_kernels()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for src, text in K.BUILD_LOG.items():
            f.write(f"== {src}\n{text}\n")
    log({"phase": "build", "card": smi, "seconds": build_s, "sources": list(K.SOURCES)})

    timed_n = _pad_pow2(args.rows)
    sizes = sorted({0, 1, 1023, 1025, 1_000_003, 1 << 26, timed_n})
    phase_s: dict = {}  # each phase's wall seconds, in order

    def phase(name: str, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        log({"phase_s": name, "card": smi, "seconds": phase_s[name]})
        return r

    kernels, timed = phase("kernels", kernel_phase, torch, K, R, sizes, timed_n, smi,
                           args.profile)
    e2e = phase("end_to_end", end_to_end_phase, torch, K, args.rows, smi, args.profile)
    lifecycle = phase("lifecycle", lifecycle_phase, torch, K, e2e, args.rows, smi, args.profile)
    skipping = phase("skipping", skipping_phase, torch, K, e2e, args.rows, smi, args.profile)
    pipeline = phase("pipeline", pipeline_phase, torch, K, e2e, lifecycle, args.rows, smi)
    join = phase("join", join_phase, torch, K, e2e, args.rows, smi)
    sources = phase("sources", sources_phase, torch, K, e2e, args.rows, smi)
    ref_cache = phase("reference_cache", reference_cache_check, e2e, smi)
    analysis = phase("analysis", analysis_phase, torch, K, e2e, args.rows, smi)
    warm_session = analysis.pop("session")
    served = phase("serve", serve_phase, K, e2e, warm_session, smi)
    static = phase("staticcheck", staticcheck_phase, K, e2e, warm_session, smi)
    # before the ingest phase, whose appends leave every lineitem index but
    # li_orderkey stale: the approx phase reads the end-to-end indexes
    approx = phase("approx", approx_phase, K, e2e, warm_session, smi)
    mesh = phase("mesh", mesh_phase, torch, K, e2e, warm_session, smi)
    del warm_session
    ingest = phase("ingest", ingest_phase, torch, K, e2e, args.rows, smi)
    tpcds = phase("tpcds", tpcds_phase, torch, K, smi)
    del e2e["want"], e2e["device_results"], e2e["warm_results"]
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    order = phase("order", order_phase, torch, min(ORDER_ROWS, _pad_pow2(args.rows)), smi)
    gates = phase("gates", gates_phase, K, smi)
    # after the queries' profiles: a profiler session before them lost
    # their short runs' device events
    for name, call in timed.items():
        profile_kernel(torch, call, name)

    line = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        r = kernels[name]
        by_query = {q: v["launches"][name]
                    for q, v in {**e2e["queries"], **skipping["queries"],
                                 **sources["queries"]}.items()
                    if v["launches"][name]}
        by_phase = {"end_to_end": e2e["main_path_launches"][name],
                    "lifecycle": lifecycle["launches"][name],
                    "skipping": skipping["launches"][name],
                    "pipeline": pipeline["launches"][name],
                    "join": join["launches"][name],
                    "sources": sources["launches"][name],
                    "analysis": analysis["launches"][name],
                    "serve": served["launches"][name],
                    "staticcheck": static["launches"][name],
                    "approx": approx["launches"][name],
                    "mesh": mesh["launches"][name],
                    "ingest": ingest["launches"][name],
                    "tpcds": tpcds["launches"][name],
                    "gates": gates["launches"][name]}
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
            "launches_by_query": by_query, "runs_per_query": 1 + WARM_RUNS,
            "runs_per_skipping_query": 1 + SKIP_WARM_RUNS,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "composition_ms": r["composition_ms"], "composition": r["composition"],
            "on_path": name in ON_PATH,
            "status": f"built, {r['checks']} checks against the plain version passed",
        })
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": {"kind": kind, "nvidia_smi": smi}, "build_s": build_s,
                   "kernels": kernels, "end_to_end": e2e, "lifecycle": lifecycle,
                   "skipping": skipping, "pipeline": pipeline, "join": join,
                   "sources": sources, "reference_cache": ref_cache,
                   "analysis": analysis, "serve": served, "staticcheck": static,
                   "approx": approx, "mesh": mesh,
                   "ingest": ingest, "tpcds": tpcds, "order": order, "gates": gates,
                   "cache_sizing_mb": sizing,
                   "phase_s": phase_s, "total_s": time.perf_counter() - t_start}, f, indent=1)
    log({"phase": "done", "card": smi, "phase_s": phase_s,
         "total_s": time.perf_counter() - t_start})
    log({"kernels": line})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
