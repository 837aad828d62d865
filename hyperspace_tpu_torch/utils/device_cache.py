"""Device-resident column cache (counterpart of
hyperspace_tpu/utils/device_cache.py, lean).

Index columns stay on the card across queries: an entry is keyed by the
object identity of the host numpy buffers it was built from (the index
chunk cache in columnar/io.py hands repeated scans the same buffers) plus a
derivation tag. A weakref to each source buffer guards against id() reuse:
an entry hits only while every weakref still resolves to the same object.
Eviction is least-recently-used by device bytes, within
``HYPERSPACE_DEVICE_CACHE_MB`` (6144; 0 keeps nothing), read when the
session is made. ``hits``, ``misses``, ``evictions`` and ``evicted_bytes``
count per session and, process-wide, as the ``cache.device.*`` counters
and the ``cache.device.bytes`` gauge of the metrics registry. Every miss is
a host-to-device transfer: it runs in an ``upload`` span, the RpcMeter
counts one upload of its bytes, and ``uploaded_bytes`` grows by them, so a
warm query that uploads nothing leaves both where they were. An entry
built on the card from other entries (the pipelined executor's
concatenated column, keyed on every chunk buffer under ``("cat", padded,
device)``) is put with ``meter=False``; a transfer that is not cached (a
sort key, a per-query group-id column) goes through ``record_upload``. A
second instance caches host-side derivations (group-key factorizations)
the same way, within ``HYPERSPACE_HOST_DERIVED_CACHE_MB`` (512), under
``cache.host_derived.*``; its builds move nothing to the card.

Builds run outside the lock, so two queries that miss on one key at once
both build it; the second to finish serves the copy the first stored,
so every caller holds one object and its bytes count once
(``check_consistency``).

The port counts the entries it holds. The JAX package also caches the
padded valid-rows masks of its device tier; the port fills them on the
card and holds no mask entry, so its ``cache.device.*`` counts differ from
the JAX package's by those.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from ..columnar.table import Column, ColumnBatch
from ..telemetry import trace
from ..telemetry.metrics import REGISTRY
from ..staticcheck.concurrency import TrackedLock
from .rpc_meter import METER


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
    def __init__(self, budget_bytes: int, metric: str = "device"):
        self.budget_bytes = budget_bytes
        self.metric = metric  # the registry's cache.<metric>.* names
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = TrackedLock(f"device_cache.{metric}")
        self.uploaded_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0

    def _count(self, event: str, n: int = 1) -> None:
        REGISTRY.counter(f"cache.{self.metric}.{event}").inc(n)

    def record_upload(self, nbytes: int) -> None:
        """A host-to-device transfer that is not cached."""
        with self._lock:
            self.uploaded_bytes += nbytes
        METER.record_upload(nbytes)

    def _build(self, builder: Callable, meter: bool):
        if not meter or self.metric != "device":
            value = builder()
            return value, _nbytes(value)
        from ..telemetry import attribution

        with trace.span("upload"), attribution.phase("upload"):
            value = builder()
            nbytes = _nbytes(value)
            with self._lock:
                self.uploaded_bytes += nbytes
            METER.record_upload(nbytes)
            trace.add_attr("nbytes", nbytes)
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
            self._count("misses")
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
                    self._count("hits")
                    return value
                del self._d[key]  # an id was reused by another buffer
                self._bytes -= nbytes
            self.misses += 1
        self._count("misses")
        value, nbytes = self._build(builder, meter)
        if nbytes > self.budget_bytes:
            return value
        refs = tuple(weakref.ref(s) for s in srcs)
        evicted_n = evicted_b = 0
        with self._lock:
            existing = self._d.get(key)
            if existing is not None:
                # a concurrent build of the same key stored first: serve the
                # resident copy, so every caller holds the same object, and
                # drop this one (its bytes were never counted). The entry's
                # refs are live: we hold srcs, so their ids cannot be reused
                value = existing[1]
            else:
                self._d[key] = (refs, value, nbytes)
                self._bytes += nbytes
            while self._bytes > self.budget_bytes and self._d:
                _, (_r, _v, nb) = self._d.popitem(last=False)
                self._bytes -= nb
                evicted_n += 1
                evicted_b += nb
            self.evictions += evicted_n
            self.evicted_bytes += evicted_b
            occupancy = self._bytes
        if evicted_n:
            self._count("evictions", evicted_n)
            self._count("evicted_bytes", evicted_b)
        REGISTRY.gauge(f"cache.{self.metric}.bytes").set(occupancy)
        return value

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def check_consistency(self) -> bool:
        """The occupancy equals the sum of the resident entries' sizes."""
        with self._lock:
            return self._bytes == sum(e[2] for e in self._d.values())
