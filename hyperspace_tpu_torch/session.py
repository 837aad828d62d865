"""HyperspaceSession: conf, warehouse, reader, the rewrite toggle, and the
device the device tier runs on (counterpart of hyperspace_tpu/session.py).

``device=None`` means the CUDA card: the device tier runs there by
default, and a query that reaches it on a machine without CUDA raises
DeviceUnavailableError instead of quietly running on the CPU. Tests and
host-only callers pass ``device="cpu"``, which runs the device tier's
plain PyTorch bodies on the host.

The session owns the caches the device tier uses: decoded index chunks
(host), device-resident columns, host-side group-key factorizations and
built fragment kernels.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from . import constants as C
from .config import HyperspaceConf
from .exceptions import DeviceUnavailableError

_GB = 1 << 30
# budgets sized for one H100 (80 GB) on a host with ~96 GB: an SF10 index
# slice is ~2 GB decoded on the host and ~1.3 GB padded on the card
INDEX_CHUNK_CACHE_BYTES = 16 * _GB
DEVICE_CACHE_BYTES = 16 * _GB
HOST_DERIVED_CACHE_BYTES = 2 * _GB


class HyperspaceSession:
    def __init__(
        self,
        warehouse_dir: str = ".",
        conf: dict[str, Any] | None = None,
        device: str | torch.device | None = None,
    ):
        from .columnar.io import IndexChunkCache
        from .plan.gpu_exec import DeviceTierStats
        from .plan.kernel_cache import KernelCache
        from .utils.device_cache import DeviceColumnCache

        self.warehouse_dir = os.path.abspath(warehouse_dir)
        self._conf: dict[str, Any] = dict(conf or {})
        self.conf = HyperspaceConf(self._conf)
        self.extra_optimizations: list[Any] = []
        self._device_request = device
        self.index_chunk_cache = IndexChunkCache(INDEX_CHUNK_CACHE_BYTES)
        self.device_cache = DeviceColumnCache(DEVICE_CACHE_BYTES)
        self.host_derived_cache = DeviceColumnCache(HOST_DERIVED_CACHE_BYTES)
        self.kernel_cache = KernelCache()
        self.device_stats = DeviceTierStats()

    @property
    def device(self) -> torch.device:
        """The device-tier device; raises when CUDA is asked for (the
        default) and absent."""
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
        return dev

    # --- conf ---
    def set_conf(self, key: str, value: Any) -> None:
        self._conf[key] = value

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

    @property
    def read(self):
        from .plan.dataframe import DataFrameReader

        return DataFrameReader(self)
