"""A small bounded LRU map (counterpart of hyperspace_tpu/utils/lru.py, at
the site where the JAX package uses it: the runtime tags of a log entry):
recency moves on both get and set, so hot entries survive churn.
Thread-safe, under the ``TrackedLock`` ``lru.<name>``. The JAX package's
class also builds values single-flight (``get_or_put``), which no site of
the port calls.
"""

from __future__ import annotations

from collections import OrderedDict

from ..staticcheck.concurrency import TrackedLock


class BoundedLRU:
    def __init__(self, maxlen: int, name: str = "lru"):
        self.maxlen = maxlen
        self._d: OrderedDict = OrderedDict()
        self._lock = TrackedLock(f"lru.{name}")

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

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d
