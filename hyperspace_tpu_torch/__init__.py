"""hyperspace_tpu_torch: the PyTorch/CUDA port of hyperspace_tpu.

The covering-index query path: build a hash-bucketed, sorted covering
index (or a z-ordered one) over a parquet lake, rewrite filter, join and
aggregate queries to read it, prune its buckets and row groups by the
query's predicate, and run the fragments on the card through hand-written
CUDA kernels. Indexes are refreshed, optimized, deleted, restored and
vacuumed as the lake changes, and hybrid scan serves an index whose source
gained or lost files.
The JAX package ``hyperspace_tpu`` is the reference this package is held
against; nothing here imports it, or JAX.
"""

from . import models  # noqa: F401  (registers the index kinds and their rules)
from .hyperspace import Hyperspace
from .models.covering import CoveringIndexConfig
from .models.zorder import ZOrderCoveringIndexConfig
from .session import HyperspaceSession

__all__ = ["CoveringIndexConfig", "Hyperspace", "HyperspaceSession",
           "ZOrderCoveringIndexConfig"]
