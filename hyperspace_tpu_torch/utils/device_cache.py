"""Device-resident column cache (counterpart of
hyperspace_tpu/utils/device_cache.py, lean).

Index columns stay on the card across queries: an entry is keyed by the
object identity of the host numpy buffers it was built from (the index
chunk cache in columnar/io.py hands repeated scans the same buffers) plus a
derivation tag. A weakref to each source buffer guards against id() reuse:
an entry hits only while every weakref still resolves to the same object.
Eviction is least-recently-used by device bytes, within
``HYPERSPACE_DEVICE_CACHE_MB`` (6144; 0 keeps nothing), read when the
session is made; ``hits``, ``misses``, ``evictions`` and ``evicted_bytes``
count as the JAX package's ``cache.device.*`` counters do. Every miss is a
host-to-device transfer and adds its bytes to ``uploaded_bytes``, so a warm
query that uploads nothing leaves the counter where it was; an entry built
on the card from other entries (the pipelined executor's concatenated
column, keyed on every chunk buffer under ``("cat", padded, device)``) is
put with ``meter=False``. A second
instance caches host-side derivations (group-key factorizations) the same
way, within ``HYPERSPACE_HOST_DERIVED_CACHE_MB`` (512).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from ..columnar.table import Column, ColumnBatch


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, ColumnBatch):
        return sum(_nbytes(c) for c in value.columns.values())
    if isinstance(value, Column):
        return _nbytes(value.data) + _nbytes(value.validity)
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
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0

    def _build(self, builder: Callable, meter: bool):
        value = builder()
        nbytes = _nbytes(value)
        if meter:
            with self._lock:
                self.uploaded_bytes += nbytes
        return value, nbytes

    def get_or_put(self, srcs: Sequence, tag, builder: Callable, meter: bool = True,
                   store: bool = True):
        """The device value derived from host buffers ``srcs`` under
        ``tag``, built (and uploaded) by ``builder()`` on a miss; with
        ``meter=False`` the build uploads nothing and is not counted. With
        ``store=False`` (buffers no later query will hand over again) it is
        built and counted, and not kept; so it is with a budget of 0."""
        if self.budget_bytes <= 0:
            return self._build(builder, meter)[0]
        if not store:
            with self._lock:
                self.misses += 1
            return self._build(builder, meter)[0]
        srcs = tuple(srcs)
        key = (tuple(id(s) for s in srcs), tag)
        with self._lock:
            entry = self._d.get(key)
            if entry is not None:
                refs, value, nbytes = entry
                if all(r() is s for r, s in zip(refs, srcs)):
                    self._d.move_to_end(key)
                    self.hits += 1
                    return value
                del self._d[key]  # an id was reused by another buffer
                self._bytes -= nbytes
            self.misses += 1
        value, nbytes = self._build(builder, meter)
        if nbytes > self.budget_bytes:
            return value
        with self._lock:
            self._d[key] = (tuple(weakref.ref(s) for s in srcs), value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget_bytes and self._d:
                _, (_r, _v, nb) = self._d.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1
                self.evicted_bytes += nb
        return value

    @property
    def resident_bytes(self) -> int:
        return self._bytes
