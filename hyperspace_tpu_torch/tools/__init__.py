"""The port's correctness gates (counterparts of the reference repo's
``tools/``): the randomized differential harness and its soak, the chaos
and race gates, and the trace report. Each runs on the card unless given
``--device cpu``, prints one JSON line and exits 0 only when its gates
hold:

    python -m hyperspace_tpu_torch.tools.differential_soak [N] [--device cpu]
    python -m hyperspace_tpu_torch.tools.chaos_stress [--device cpu]
    python -m hyperspace_tpu_torch.tools.race_stress [--device cpu]
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl [--agg]
"""
