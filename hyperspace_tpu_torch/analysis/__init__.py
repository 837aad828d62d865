"""explain, whyNot, index statistics and the min/max layout analyzer
(counterpart of hyperspace_tpu/analysis/)."""
