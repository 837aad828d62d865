from .index import ZOrderCoveringIndex, ZOrderCoveringIndexConfig
from .fields import MinMaxZOrderField, PercentileZOrderField, ZOrderField
from . import rule  # noqa: F401  (registers ZOrderFilterIndexRule)

__all__ = [
    "ZOrderCoveringIndex",
    "ZOrderCoveringIndexConfig",
    "MinMaxZOrderField",
    "PercentileZOrderField",
    "ZOrderField",
]
