"""The data-skipping index kind (counterpart of
hyperspace_tpu/models/dataskipping/): per-file sketches that prune a
source scan's files, and the per-row-group sidecar sketch store of
covering indexes (sketch_store.py)."""

from .index import DataSkippingIndex, DataSkippingIndexConfig
from .sketches import (
    BloomFilterSketch,
    MinMaxSketch,
    PartitionSketch,
    Sketch,
    ValueListSketch,
    ZRegionSketch,
)
from . import rule  # noqa: F401  (registers ApplyDataSkippingIndex)

__all__ = [
    "DataSkippingIndex",
    "DataSkippingIndexConfig",
    "BloomFilterSketch",
    "MinMaxSketch",
    "PartitionSketch",
    "Sketch",
    "ValueListSketch",
    "ZRegionSketch",
]
