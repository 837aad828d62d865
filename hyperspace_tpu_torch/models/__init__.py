"""Index kinds. Importing this package registers each kind for log-entry
deserialization and hooks the kinds' rewrite rules into the score-based
optimizer, in the JAX package's order: ApplyDataSkippingIndex, then
ZOrderFilterIndexRule (ties go to the later rule)."""

from .base import Index, IndexConfig, IndexerContext, UpdateMode
from .covering import CoveringIndex, CoveringIndexConfig
from .dataskipping import (
    BloomFilterSketch,
    DataSkippingIndex,
    DataSkippingIndexConfig,
    MinMaxSketch,
    ValueListSketch,
    ZRegionSketch,
)
from .zorder import ZOrderCoveringIndex, ZOrderCoveringIndexConfig

__all__ = [
    "Index",
    "IndexConfig",
    "IndexerContext",
    "UpdateMode",
    "CoveringIndex",
    "CoveringIndexConfig",
    "DataSkippingIndex",
    "DataSkippingIndexConfig",
    "MinMaxSketch",
    "BloomFilterSketch",
    "ValueListSketch",
    "ZRegionSketch",
    "ZOrderCoveringIndex",
    "ZOrderCoveringIndexConfig",
]
