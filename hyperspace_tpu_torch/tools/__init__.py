"""The port's correctness gates (counterparts of the reference repo's
``tools/``): the randomized differential harness and its soak, the chaos
and race gates, the trace report, and the serving-plane feature smokes
(serve, qos, plan_stats, workload, result_cache, ingest). Each runs on
the card unless given ``--device cpu``, prints one JSON line and exits 0
only when its gates hold:

    python -m hyperspace_tpu_torch.tools.differential_soak [N] [--device cpu]
    python -m hyperspace_tpu_torch.tools.chaos_stress [--device cpu]
    python -m hyperspace_tpu_torch.tools.race_stress [--device cpu]
    python -m hyperspace_tpu_torch.tools.serve_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.qos_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.plan_stats_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.workload_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.result_cache_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.ingest_smoke [--device cpu] [--rows N]
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl [--agg]

Each feature smoke's ``run(device, root, **sizes)`` is what
``chip_smoke.py`` and the tests call in process.
"""
