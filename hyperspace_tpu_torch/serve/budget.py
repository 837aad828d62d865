"""Device-byte accountant (counterpart of the device ledger in
hyperspace_tpu/serve/budget.py, lean: one device, no tenants, no metrics).

The band scheduler of the plain co-bucketed join (plan/device_join.py)
reserves each wave's padded device footprint through this ledger before it
dispatches, and releases it once the wave's results are on the host. The
limit is ``HYPERSPACE_DEVICE_BUDGET_MB`` (default 4096; 0 disables the
ledger). A stream that holds nothing is always granted its reservation,
even past the limit (the zero-holder progress rule), so joins that share
the ledger cannot deadlock.
"""

from __future__ import annotations

import os
import threading

DEVICE_BUDGET_MB_DEFAULT = 4096.0


class BudgetStream:
    """One consumer's handle on the ledger (one join execution)."""

    __slots__ = ("_acct", "held", "_closed")

    def __init__(self, acct: "BudgetAccountant"):
        self._acct = acct
        self.held = 0
        self._closed = False

    def try_reserve(self, nbytes: int) -> bool:
        """Reserve ``nbytes``; False when over the limit and holding bytes."""
        return self._acct._reserve(self, nbytes)

    def release(self, nbytes: int) -> None:
        self._acct._release(self, nbytes)

    def close(self) -> None:
        """Return whatever the stream still holds; idempotent."""
        if not self._closed:
            self._closed = True
            self._acct._release(self, self.held)


class BudgetAccountant:
    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._held = 0
        # wakes consumers parked on a full ledger when bytes come back
        self._released = threading.Condition(threading.Lock())

    def stream(self) -> BudgetStream:
        return BudgetStream(self)

    def _reserve(self, s: BudgetStream, nbytes: int) -> bool:
        with self._lock:
            if s.held > 0 and self._held + nbytes > self.max_bytes:
                return False
            s.held += nbytes
            self._held += nbytes
            return True

    def _release(self, s: BudgetStream, nbytes: int) -> None:
        with self._lock:
            n = min(nbytes, s.held)
            s.held -= n
            self._held -= n
        with self._released:
            self._released.notify_all()

    def wait_for_release(self, timeout: float) -> None:
        """Block until some stream releases or ``timeout`` seconds pass;
        callers loop (a wake-up is a hint, not a grant)."""
        with self._released:
            self._released.wait(timeout)

    def held_bytes(self) -> int:
        with self._lock:
            return self._held


def configured_device_budget_bytes() -> int:
    """``HYPERSPACE_DEVICE_BUDGET_MB`` in bytes; 0 disables the ledger."""
    try:
        mb = float(os.environ.get("HYPERSPACE_DEVICE_BUDGET_MB", DEVICE_BUDGET_MB_DEFAULT))
    except ValueError:
        mb = DEVICE_BUDGET_MB_DEFAULT
    return int(mb * 2**20)


_lock = threading.Lock()
_DEVICE: list = []  # the process-wide accountant, made at first use


def device_budget() -> BudgetAccountant:
    """The device-byte accountant every plain-join band scheduler reserves
    through, sized by the knob when first used."""
    with _lock:
        if not _DEVICE:
            _DEVICE.append(BudgetAccountant(configured_device_budget_bytes()))
        return _DEVICE[0]

