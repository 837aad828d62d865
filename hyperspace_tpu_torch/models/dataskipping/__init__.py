"""Data-skipping sketches: the min-max predicate converters that
predicate-driven pruning evaluates over parquet row-group statistics. The
data-skipping index kind itself is not ported."""
