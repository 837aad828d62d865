"""The multi-device tier (counterpart of hyperspace_tpu/parallel/): device
meshes, the bucket exchange, the distributed aggregate, the mesh join probe
and the skew-aware placement of bucketed-join waves and streamed chunks."""
