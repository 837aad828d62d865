"""Typed view over the session's conf dict (counterpart of
hyperspace_tpu/config.py, reduced to the keys this slice reads)."""

from __future__ import annotations

from typing import Any, Mapping

from . import constants as C
from .exceptions import HyperspaceError


def _as_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")


class HyperspaceConf:
    def __init__(self, conf: Mapping[str, Any]):
        self._conf = conf

    def get(self, key: str, default: Any = None) -> Any:
        return self._conf.get(key, default)

    @property
    def apply_enabled(self) -> bool:
        return _as_bool(self._conf.get(C.APPLY_ENABLED, C.APPLY_ENABLED_DEFAULT))

    @property
    def num_buckets(self) -> int:
        v = self._conf.get(C.INDEX_NUM_BUCKETS)
        if v is None:
            v = self._conf.get(C.INDEX_NUM_BUCKETS_LEGACY, C.INDEX_NUM_BUCKETS_DEFAULT)
        n = int(v)
        if n <= 0:
            raise HyperspaceError(f"{C.INDEX_NUM_BUCKETS} must be positive: {n}")
        return n

    @property
    def cache_expiry_seconds(self) -> int:
        return int(
            self._conf.get(
                C.INDEX_CACHE_EXPIRY_SECONDS, C.INDEX_CACHE_EXPIRY_SECONDS_DEFAULT
            )
        )

    @property
    def exec_device_enabled(self) -> bool:
        return _as_bool(self._conf.get(C.EXEC_TPU_ENABLED, C.EXEC_TPU_ENABLED_DEFAULT))

    @property
    def exec_exact_f64_aggregates(self) -> bool:
        return _as_bool(
            self._conf.get(C.EXEC_EXACT_F64_AGG, C.EXEC_EXACT_F64_AGG_DEFAULT)
        )

    @property
    def index_stats_columns(self) -> str:
        v = str(self._conf.get(C.INDEX_STATS_COLUMNS, C.INDEX_STATS_COLUMNS_DEFAULT)).lower()
        if v not in ("clustered", "all"):
            raise HyperspaceError(f"{C.INDEX_STATS_COLUMNS} must be clustered|all: {v}")
        return v

    @property
    def index_compression(self) -> str:
        return str(self._conf.get(C.INDEX_COMPRESSION, C.INDEX_COMPRESSION_DEFAULT)).lower()
