"""HyperspaceSession: conf, warehouse, reader, the rewrite toggle, and the
device the device tier runs on (counterpart of hyperspace_tpu/session.py).

``device=None`` means the CUDA card: the device tier runs there by
default, and a query that reaches it on a machine without CUDA raises
DeviceUnavailableError instead of quietly running on the CPU. Tests and
host-only callers pass ``device="cpu"``, which runs the device tier's
plain PyTorch bodies on the host.

The session owns the caches the device tier uses: decoded index chunks
(host), device-resident columns, host-side group-key factorizations and
built fragment kernels. Their budgets are the JAX package's knobs, read
when the session is made: ``HYPERSPACE_INDEX_CACHE_MB`` (1024),
``HYPERSPACE_DEVICE_CACHE_MB`` (6144) and
``HYPERSPACE_HOST_DERIVED_CACHE_MB`` (512); the session also sets the
process-wide source-column and footer-statistics caches' budgets
(``HYPERSPACE_BUILD_CACHE_MB`` 2048, ``HYPERSPACE_STATS_CACHE_MB`` 64).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from . import constants as C
from .config import HyperspaceConf
from .exceptions import DeviceUnavailableError
from .utils import env


class HyperspaceSession:
    def __init__(
        self,
        warehouse_dir: str = ".",
        conf: dict[str, Any] | None = None,
        device: str | torch.device | None = None,
    ):
        from .columnar.io import IndexChunkCache, configure_caches
        from .models.dataskipping.rule import DataSkippingStats
        from .plan.gpu_exec import DeviceTierStats
        from .plan.kernel_cache import KernelCache
        from .utils.device_cache import DeviceColumnCache

        self.warehouse_dir = os.path.abspath(warehouse_dir)
        self._conf: dict[str, Any] = dict(conf or {})
        self.conf = HyperspaceConf(self._conf)
        self.extra_optimizations: list[Any] = []
        self._device_request = device
        self._resolved_device: "torch.device | None" = None
        self.index_chunk_cache = IndexChunkCache(env.cache_bytes("HYPERSPACE_INDEX_CACHE_MB"))
        self.device_cache = DeviceColumnCache(env.cache_bytes("HYPERSPACE_DEVICE_CACHE_MB"))
        self.host_derived_cache = DeviceColumnCache(
            env.cache_bytes("HYPERSPACE_HOST_DERIVED_CACHE_MB"), "host_derived")
        configure_caches()
        self.kernel_cache = KernelCache("kernel", 256)
        self.device_stats = DeviceTierStats()
        self.dataskipping_stats = DataSkippingStats()

    @property
    def device(self) -> torch.device:
        """The device-tier device; raises when CUDA is asked for (the
        default) and absent. A CUDA request without an index takes the
        current device of the thread that first asks and keeps it, so the
        scheduler's worker threads run on the session's card, not on each
        thread's own current device."""
        resolved = self._resolved_device
        if resolved is not None:
            return resolved
        req = self._device_request
        dev = torch.device("cuda" if req is None else req)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise DeviceUnavailableError(
                    "the device tier runs on CUDA by default and "
                    "torch.cuda.is_available() is false; create the session with "
                    "device='cpu' to run it on the host"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self._resolved_device = dev
        return dev

    # --- conf ---
    def set_conf(self, key: str, value: Any) -> None:
        self._conf[key] = value

    def unset_conf(self, key: str) -> None:
        self._conf.pop(key, None)

    def get_conf(self, key: str, default: Any = None) -> Any:
        return self._conf.get(key, default)

    # --- rewrite toggle ---
    def enable_hyperspace(self) -> "HyperspaceSession":
        from .rules.apply import ApplyHyperspace

        self.set_conf(C.APPLY_ENABLED, True)
        if not any(isinstance(r, ApplyHyperspace) for r in self.extra_optimizations):
            self.extra_optimizations.append(ApplyHyperspace(self))
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        from .rules.apply import ApplyHyperspace

        self.set_conf(C.APPLY_ENABLED, False)
        self.extra_optimizations = [
            r for r in self.extra_optimizations if not isinstance(r, ApplyHyperspace)
        ]
        return self

    def is_hyperspace_enabled(self) -> bool:
        from .rules.apply import ApplyHyperspace

        return self.conf.apply_enabled and any(
            isinstance(r, ApplyHyperspace) for r in self.extra_optimizations
        )

    @property
    def read(self):
        from .plan.dataframe import DataFrameReader

        return DataFrameReader(self)

    def create_dataframe(self, data: dict, schema=None):
        """An in-memory DataFrame from a dict of column -> values."""
        from .columnar.table import ColumnBatch
        from .plan.dataframe import DataFrame
        from .plan.nodes import InMemoryScan

        return DataFrame(self, InMemoryScan(ColumnBatch.from_pydict(data, schema)))
