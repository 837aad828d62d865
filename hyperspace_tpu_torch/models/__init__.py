"""Index kinds. Importing this package registers each kind for log-entry
deserialization and hooks the kinds' rewrite rules into the score-based
optimizer."""

from .covering import CoveringIndex, CoveringIndexConfig
from .zorder import ZOrderCoveringIndex, ZOrderCoveringIndexConfig

__all__ = [
    "CoveringIndex",
    "CoveringIndexConfig",
    "ZOrderCoveringIndex",
    "ZOrderCoveringIndexConfig",
]
