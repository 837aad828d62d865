"""hyperspace_tpu_torch: the PyTorch/CUDA port of hyperspace_tpu.

The covering-index query path: build a hash-bucketed, sorted covering
index (or a z-ordered one) over a parquet lake, rewrite filter, join and
aggregate queries to read it, prune its buckets and row groups by the
query's predicate, and run the fragments on the card through hand-written
CUDA kernels. A data-skipping index prunes a source scan's files by
per-file sketches. Indexes are refreshed, optimized, deleted, restored and
vacuumed as the lake changes, and hybrid scan serves an index whose source
gained or lost files. Sources are parquet, CSV, JSON, ORC, text and avro
directories (hive-partitioned or not, glob roots included), snapshot
(Delta-style) tables and Iceberg-style tables, whose older snapshots use
the index version built for them.
The JAX package ``hyperspace_tpu`` is the reference this package is held
against; nothing here imports it, or JAX.
"""

from . import models  # noqa: F401  (registers the index kinds and their rules)
from .hyperspace import Hyperspace
from .models import (
    BloomFilterSketch,
    CoveringIndexConfig,
    DataSkippingIndexConfig,
    MinMaxSketch,
    ValueListSketch,
    ZOrderCoveringIndexConfig,
    ZRegionSketch,
)
from .session import HyperspaceSession
from .sources.delta import SnapshotTable
from .sources.iceberg import IcebergStyleTable

__all__ = ["BloomFilterSketch", "CoveringIndexConfig", "DataSkippingIndexConfig",
           "Hyperspace", "HyperspaceSession", "IcebergStyleTable", "MinMaxSketch",
           "SnapshotTable", "ValueListSketch", "ZOrderCoveringIndexConfig", "ZRegionSketch"]
