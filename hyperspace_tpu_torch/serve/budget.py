"""Byte ledgers (counterpart of hyperspace_tpu/serve/budget.py, lean: no
tenants and no queries).

Two process-wide accountants share one class. The global read-ahead
ledger (``global_budget()``) bounds the decoded bytes every streaming
consumer holds undelivered: the chunk streamer of multi-file scans
(columnar/io.iter_chunks) and the bucket-pair read-ahead of the bucketed
join (plan/bucket_join._iter_bucket_pairs) each open a ``stream(label)``
on it, reserve an estimate per chunk or pair before submitting its decode
and release it on delivery. Its limit is ``HYPERSPACE_GLOBAL_BUDGET_MB``
(default 1024), or ``HYPERSPACE_IO_BUDGET_MB`` when only that is set.

The device ledger: the band schedulers of the co-bucketed joins (plan/
device_join.py), plain and fused, reserve each wave's padded device
footprint through this ledger before it dispatches, and releases it once the wave's results are on the host. The
limit is ``HYPERSPACE_DEVICE_BUDGET_MB`` (default 4096; 0 disables the
ledger). A stream that holds nothing is always granted its reservation,
even past the limit (the zero-holder progress rule), so joins that share
the ledger cannot deadlock.

Each ledger counts in the metrics registry under its name, as the
reference's do: ``<name>.reservations``, ``<name>.force_grants`` (a
zero-holder grant past the limit), ``<name>.stalls`` and the occupancy
gauge ``<name>_bytes``; the names are ``serve.budget`` and
``serve.device_budget``.
"""

from __future__ import annotations

import os
import threading

from ..telemetry.metrics import REGISTRY
from ..utils import env

DEVICE_BUDGET_MB_DEFAULT = 4096.0


class BudgetStream:
    """One consumer's handle on a ledger (a scan stream, a pair loader, one
    join execution), pumped from one thread."""

    __slots__ = ("_acct", "label", "held", "_closed")

    def __init__(self, acct: "BudgetAccountant", label: str = ""):
        self._acct = acct
        self.label = label
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
    def __init__(self, max_bytes: int, name: str = "serve.budget"):
        self.max_bytes = max_bytes
        self.name = name  # the registry's metric prefix
        self._lock = threading.Lock()
        self._held = 0
        # wakes consumers parked on a full ledger when bytes come back
        self._released = threading.Condition(threading.Lock())

    def stream(self, label: str = "") -> BudgetStream:
        return BudgetStream(self, label)

    def _reserve(self, s: BudgetStream, nbytes: int) -> bool:
        forced = False
        with self._lock:
            granted = not (s.held > 0 and self._held + nbytes > self.max_bytes)
            if granted:
                forced = self._held + nbytes > self.max_bytes
                s.held += nbytes
                self._held += nbytes
            occupancy = self._held
        if granted:
            REGISTRY.counter(f"{self.name}.reservations").inc()
            if forced:
                REGISTRY.counter(f"{self.name}.force_grants").inc()
            REGISTRY.gauge(f"{self.name}_bytes").set(occupancy)
        else:
            REGISTRY.counter(f"{self.name}.stalls").inc()
        return granted

    def _release(self, s: BudgetStream, nbytes: int) -> None:
        with self._lock:
            n = min(nbytes, s.held)
            s.held -= n
            self._held -= n
            occupancy = self._held
        with self._released:
            self._released.notify_all()
        REGISTRY.gauge(f"{self.name}_bytes").set(occupancy)

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
    """The device-byte accountant every join band scheduler reserves
    through, sized by the knob when first used; the join strategy plan
    reads its limit as the grant."""
    with _lock:
        if not _DEVICE:
            _DEVICE.append(BudgetAccountant(configured_device_budget_bytes(),
                                            "serve.device_budget"))
        return _DEVICE[0]


def reset_device_budget() -> BudgetAccountant:
    """Re-read ``HYPERSPACE_DEVICE_BUDGET_MB`` and install a fresh device
    ledger (never mid-query)."""
    with _lock:
        _DEVICE[:] = [BudgetAccountant(configured_device_budget_bytes(),
                                       "serve.device_budget")]
        return _DEVICE[0]


def configured_budget_bytes() -> int:
    """``HYPERSPACE_GLOBAL_BUDGET_MB`` in bytes; when it is unset, an
    explicitly set ``HYPERSPACE_IO_BUDGET_MB`` carries over."""
    raw = env.read_raw("HYPERSPACE_GLOBAL_BUDGET_MB")
    if raw is None:
        raw = env.read_raw("HYPERSPACE_IO_BUDGET_MB")
    try:
        if raw is not None:
            return int(float(raw) * 2**20)
    except ValueError:
        pass
    return int(env.DEFAULTS["HYPERSPACE_GLOBAL_BUDGET_MB"] * 2**20)


_GLOBAL: list = []  # the process-wide read-ahead accountant, made at first use


def global_budget() -> BudgetAccountant:
    """The read-ahead accountant every streaming consumer reserves through,
    sized by the knob when first used."""
    with _lock:
        if not _GLOBAL:
            _GLOBAL.append(BudgetAccountant(configured_budget_bytes()))
        return _GLOBAL[0]


def reset_global_budget() -> BudgetAccountant:
    """Re-read the knob and install a fresh read-ahead ledger (never
    mid-query)."""
    with _lock:
        _GLOBAL[:] = [BudgetAccountant(configured_budget_bytes())]
        return _GLOBAL[0]
