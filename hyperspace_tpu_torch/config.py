"""Typed view over the session's conf dict (counterpart of
hyperspace_tpu/config.py, reduced to the keys the port reads)."""

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
    def default_source_formats(self) -> tuple[str, ...]:
        """The formats the default source provider takes."""
        raw = str(self._conf.get(C.DEFAULT_SOURCE_FORMATS, C.DEFAULT_SOURCE_FORMATS_DEFAULT))
        return tuple(p.strip().lower() for p in raw.split(",") if p.strip())

    @property
    def dataskipping_auto_partition_sketch(self) -> bool:
        return _as_bool(self._conf.get(C.DATASKIPPING_AUTO_PARTITION_SKETCH,
                                       C.DATASKIPPING_AUTO_PARTITION_SKETCH_DEFAULT))

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
    def lineage_enabled(self) -> bool:
        return _as_bool(self._conf.get(C.INDEX_LINEAGE_ENABLED, C.INDEX_LINEAGE_ENABLED_DEFAULT))

    @property
    def hybrid_scan_enabled(self) -> bool:
        return _as_bool(self._conf.get(C.HYBRID_SCAN_ENABLED, C.HYBRID_SCAN_ENABLED_DEFAULT))

    def _ratio(self, key: str, default: float) -> float:
        v = float(self._conf.get(key, default))
        if not 0.0 <= v <= 1.0:
            raise HyperspaceError(f"{key} must be in [0,1]: {v}")
        return v

    @property
    def hybrid_scan_max_appended_ratio(self) -> float:
        return self._ratio(C.HYBRID_SCAN_MAX_APPENDED_RATIO,
                           C.HYBRID_SCAN_MAX_APPENDED_RATIO_DEFAULT)

    @property
    def hybrid_scan_max_deleted_ratio(self) -> float:
        return self._ratio(C.HYBRID_SCAN_MAX_DELETED_RATIO,
                           C.HYBRID_SCAN_MAX_DELETED_RATIO_DEFAULT)

    @property
    def filter_rule_use_bucket_spec(self) -> bool:
        return _as_bool(self._conf.get(C.FILTER_RULE_USE_BUCKET_SPEC,
                                       C.FILTER_RULE_USE_BUCKET_SPEC_DEFAULT))

    @property
    def optimize_file_size_threshold(self) -> int:
        return int(self._conf.get(C.OPTIMIZE_FILE_SIZE_THRESHOLD,
                                  C.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT))

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

    @property
    def index_format(self) -> str:
        v = str(self._conf.get(C.INDEX_FORMAT, C.INDEX_FORMAT_DEFAULT)).lower()
        if v not in ("parquet", "arrow"):
            raise HyperspaceError(f"{C.INDEX_FORMAT} must be 'parquet' or 'arrow', got {v!r}")
        return v

    @property
    def build_max_bytes_in_memory(self) -> int:
        return int(self._conf.get(C.BUILD_MAX_BYTES_IN_MEMORY,
                                  C.BUILD_MAX_BYTES_IN_MEMORY_DEFAULT))

    @property
    def event_logger_class(self) -> str | None:
        return self._conf.get(C.EVENT_LOGGER_CLASS)

    @property
    def display_mode(self) -> str:
        return str(self._conf.get(C.DISPLAY_MODE, C.DISPLAY_MODE_DEFAULT))
