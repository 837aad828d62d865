"""Device-resident column cache (counterpart of
hyperspace_tpu/utils/device_cache.py, lean).

Index columns stay on the card across queries: an entry is keyed by the
object identity of the host numpy buffers it was built from (the index
chunk cache in columnar/io.py hands repeated scans the same buffers) plus a
derivation tag. A weakref to each source buffer guards against id() reuse:
an entry hits only while every weakref still resolves to the same object.
Eviction is least-recently-used by device bytes. Every miss is a
host-to-device transfer and adds its bytes to ``uploaded_bytes``, so a warm
query that uploads nothing leaves the counter where it was. A second
instance with a host budget caches host-side derivations (group-key
factorizations) the same way.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    return 0


class DeviceColumnCache:
    def __init__(self, budget_bytes: int):
        self.budget_bytes = budget_bytes
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.uploaded_bytes = 0

    def get_or_put(self, srcs: Sequence, tag, builder: Callable):
        """The device value derived from host buffers ``srcs`` under
        ``tag``, built (and uploaded) by ``builder()`` on a miss."""
        srcs = tuple(srcs)
        key = (tuple(id(s) for s in srcs), tag)
        with self._lock:
            entry = self._d.get(key)
            if entry is not None:
                refs, value, nbytes = entry
                if all(r() is s for r, s in zip(refs, srcs)):
                    self._d.move_to_end(key)
                    return value
                del self._d[key]  # an id was reused by another buffer
                self._bytes -= nbytes
        value = builder()
        nbytes = _nbytes(value)
        with self._lock:
            self.uploaded_bytes += nbytes
            if nbytes > self.budget_bytes:
                return value
            self._d[key] = (tuple(weakref.ref(s) for s in srcs), value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget_bytes:
                _, (_r, _v, nb) = self._d.popitem(last=False)
                self._bytes -= nb
        return value

    @property
    def resident_bytes(self) -> int:
        return self._bytes
