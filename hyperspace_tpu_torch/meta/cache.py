"""Creation-time-expiring cache of the index entry list (counterpart of
hyperspace_tpu/meta/cache.py): a value expires
``hyperspace.index.cache.expiryDurationInSeconds`` after it was set, and
every index action clears it."""

from __future__ import annotations

import time
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class CreationTimeBasedCache(Generic[T]):
    def __init__(self, expiry_seconds_fn: Callable[[], float]):
        # read on every access, so a conf change takes effect at once
        self._expiry_seconds_fn = expiry_seconds_fn
        self._value: Optional[T] = None
        self._cached_at = 0.0

    def get(self) -> Optional[T]:
        if self._value is None:
            return None
        if time.time() - self._cached_at > float(self._expiry_seconds_fn()):
            self._value = None
        return self._value

    def set(self, value: T) -> None:
        self._value = value
        self._cached_at = time.time()

    def clear(self) -> None:
        self._value = None
