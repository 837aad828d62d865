"""hyperspace_tpu_torch: the PyTorch/CUDA port of hyperspace_tpu.

The covering-index query path: build a hash-bucketed, sorted covering
index over a parquet lake, rewrite filter queries to read it, and run the
filter-aggregate fragment on the card through hand-written CUDA kernels.
The JAX package ``hyperspace_tpu`` is the reference this package is held
against; nothing here imports it, or JAX.
"""

from . import models  # noqa: F401  (registers the covering index kind)
from .hyperspace import Hyperspace
from .models.covering import CoveringIndexConfig
from .session import HyperspaceSession

__all__ = ["CoveringIndexConfig", "Hyperspace", "HyperspaceSession"]
