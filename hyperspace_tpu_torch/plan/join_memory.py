"""The device-memory ledger of the plain co-bucketed join: admission with
park, spill and resume (counterpart of hyperspace_tpu/plan/join_memory.py,
lean).

The band scheduler (plan/device_join._BandScheduler) reserves each wave's
padded device footprint on the device-byte accountant
(serve/budget.device_budget) before it dispatches. A reservation that does
not fit PARKS the wave instead of declining the join to the host: the
scheduler spills its own oldest in-flight waves (fetching their results to
the host releases their reservations) until the wave fits; when nothing of
its own is left, it waits a bounded time (``_PARK_WAIT_MS``) for other
joins' releases and then takes the zero-holder grant. Spilling changes when
a wave's results come back, never what they are.

Not ported yet: the per-bucket strategy plan (``plan_join_memory``,
``JoinMemoryPlan``) and the grant-derived split row count it uses
(``grant_bytes``, ``derive_split_rows``); the plan reads footer statistics
from the pruning cache the port does not have. Without a plan, the split
row count is the fixed ``plan/device_join._JOIN_SPLIT_ROWS``, the
reference's own path when no plan is active.
"""

from __future__ import annotations

import time
from typing import Callable

from ..serve import budget as serve_budget

_PARK_POLL_S = 0.02  # release-condition wait quantum
_PARK_WAIT_MS = 50.0  # bounded wait for other joins' releases, then grant


class DeviceLedger:
    """One join execution's handle on the device-byte accountant, and the
    park/spill/resume admission loop the band scheduler drives. ``close()``
    (the caller's ``finally``) returns every outstanding byte."""

    __slots__ = ("_acct", "_stream", "enabled")

    def __init__(self):
        self._acct = serve_budget.device_budget()
        self.enabled = self._acct.max_bytes > 0
        self._stream = self._acct.stream() if self.enabled else None

    def admit(self, nbytes: int, spill_one: Callable[[], bool]) -> None:
        """Reserve ``nbytes`` for one band wave before it dispatches. When
        the ledger is full, ``spill_one()`` retires this join's oldest
        in-flight wave until the wave fits or nothing of ours is left; then
        a bounded wait for other joins' releases; then the zero-holder
        grant admits it."""
        if self._stream is None or nbytes <= 0:
            return
        acct, stream = self._acct, self._stream
        deadline = None
        while True:
            if acct.held_bytes() + nbytes <= acct.max_bytes:
                if stream.try_reserve(nbytes):
                    return
                continue  # lost a race with another reservation: re-check
            if spill_one():
                continue  # freed some of our own bytes: retry
            if deadline is None:
                deadline = time.perf_counter() + _PARK_WAIT_MS / 1000.0
            if time.perf_counter() >= deadline and stream.try_reserve(nbytes):
                return  # zero-holder grant past the limit
            acct.wait_for_release(_PARK_POLL_S)

    def release(self, nbytes: int) -> None:
        if self._stream is not None and nbytes > 0:
            self._stream.release(nbytes)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
