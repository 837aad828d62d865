"""A small bounded LRU map (counterpart of hyperspace_tpu/utils/lru.py, at
the site where the JAX package uses it: the runtime tags of a log entry):
recency moves on both get and set, so hot entries survive churn.
Thread-safe, under the ``TrackedLock`` ``lru.<name>``; ``get_or_put``
builds a missing value once across concurrently missing threads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..staticcheck.concurrency import TrackedLock


class BoundedLRU:
    def __init__(self, maxlen: int, name: str = "lru"):
        self.maxlen = maxlen
        self._d: OrderedDict = OrderedDict()
        self._lock = TrackedLock(f"lru.{name}")
        self._inflight: dict = {}

    def get(self, key, default=None):
        with self._lock:
            try:
                value = self._d[key]
            except KeyError:
                return default
            self._d.move_to_end(key)
            return value

    def set(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxlen:
                self._d.popitem(last=False)

    def get_or_put(self, key, factory):
        """The value under ``key``, built with ``factory()`` once across
        concurrently missing threads (the others wait, then read it; a
        failed build wakes them, and one builds)."""
        while True:
            with self._lock:
                if key in self._d:
                    self._d.move_to_end(key)
                    return self._d[key]
                event = self._inflight.get(key)
                building = event is None
                if building:
                    event = self._inflight[key] = threading.Event()
            if not building:
                event.wait()
                continue
            try:
                value = factory()
            except BaseException:
                with self._lock:
                    self._inflight.pop(key, None)
                event.set()
                raise
            with self._lock:
                self._d[key] = value
                self._d.move_to_end(key)
                while len(self._d) > self.maxlen:
                    self._d.popitem(last=False)
                self._inflight.pop(key, None)
            event.set()
            return value

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d
