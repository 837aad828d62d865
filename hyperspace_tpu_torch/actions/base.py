"""Action: the two-phase index-mutating transaction (counterpart of
hyperspace_tpu/actions/base.py).

run() = validate, begin (write the transient entry at base_id+1), op, end
(write the final entry at base_id+2 and the latestStable pointer). A taken
log id means another writer won the optimistic-concurrency race: the
transaction re-reads the log and runs again, up to
``HYPERSPACE_ACTION_RETRIES`` attempts in all (3; read at every run, as in
the JAX package). A NoChangesError from validate or op ends
the action as a no-op, with no state transition. op() runs in the
maintenance read scope (columnar/io.py), as the JAX package's does.

Every running action registers its index path, so recovery can tell a live
in-process transaction (its transient entry is healthy) from one a crash
left behind.

Telemetry, as in the JAX package: the whole run is an ``action:<Name>``
span, a lost race counts ``action.retry.attempts`` (and
``action.retry.gave_up`` when the budget is spent), and an action with an
``event_class`` logs its CRUD event ("started", then "succeeded", "noop:
..." or "failed: ...") to its ``event_logger``, the last argument of every
action's constructor, which the index manager passes from the session
(``telemetry/logger.event_logger_for``).
"""

from __future__ import annotations

import logging
import os
import time

from . import states as S
from .. import constants as C
from ..columnar.io import maintenance_scope
from ..exceptions import ConcurrentWriteError, HyperspaceError, NoChangesError
from ..meta.entry import LogEntry
from ..meta.log_manager import IndexLogManager
from ..staticcheck.concurrency import TrackedLock, guarded_by
from ..telemetry import trace
from ..telemetry.events import AppInfo, HyperspaceEvent
from ..telemetry.metrics import REGISTRY
from ..utils import env

logger = logging.getLogger(__name__)

_TX_LOCK = TrackedLock("actions.active_tx")
_ACTIVE_TX: dict[str, int] = guarded_by(
    {},  # abspath(index_path) -> nesting depth
    _TX_LOCK,
    name="actions.base._ACTIVE_TX",
    note="recovery must skip indexes with a live in-process transaction",
)


def _tx_key(index_path: str) -> str:
    return os.path.abspath(index_path)


def _tx_enter(index_path: str) -> None:
    key = _tx_key(index_path)
    with _TX_LOCK:
        _ACTIVE_TX[key] = _ACTIVE_TX.get(key, 0) + 1


def _tx_exit(index_path: str) -> None:
    key = _tx_key(index_path)
    with _TX_LOCK:
        depth = _ACTIVE_TX.get(key, 0) - 1
        if depth <= 0:
            _ACTIVE_TX.pop(key, None)
        else:
            _ACTIVE_TX[key] = depth


def action_in_progress(index_path: str) -> bool:
    """True while an in-process action's transaction is live on this index
    (recovery must not roll back its transient entry)."""
    with _TX_LOCK:
        return _ACTIVE_TX.get(_tx_key(index_path), 0) > 0


class Action:
    transient_state: str = "?"
    final_state: str = "?"
    event_class: "type[HyperspaceEvent] | None" = None  # its CRUD event

    def __init__(self, log_manager: IndexLogManager, event_logger=None):
        self.log_manager = log_manager
        self.base_id: int = 0
        self.event_logger = event_logger

    def validate(self) -> None:
        """Raise HyperspaceError if the action cannot run from this state;
        NoChangesError to end it as a no-op."""

    def op(self) -> None:
        raise NotImplementedError

    def log_entry(self) -> LogEntry:
        raise NotImplementedError

    def reset_for_retry(self) -> None:
        """Re-read whatever the action cached from the log before a retry."""

    def event_index_name(self) -> str:
        """The index name the action's event carries: the latest stable
        entry's (what a cancel rolls back to)."""
        stable = self.log_manager.get_latest_stable_log()
        return getattr(stable, "name", "") if stable else ""

    def event(self, message: str) -> "HyperspaceEvent | None":
        if self.event_class is None:
            return None
        return self.event_class(AppInfo.current(), message,
                                index_name=self.event_index_name())

    def _log_event(self, message: str) -> None:
        if self.event_logger is not None:
            ev = self.event(message)
            if ev is not None:
                self.event_logger.log_event(ev)

    def run(self) -> None:
        from ..telemetry import workload

        index_path = self.log_manager.index_path
        outcome = "failed"
        t0 = time.perf_counter()
        with trace.span(f"action:{type(self).__name__}") as sp:
            self._log_event("started")
            _tx_enter(index_path)
            try:
                # nested chokepoints (sketch sidecar writes) attribute to
                # the index under maintenance
                with workload.maintenance_scope(os.path.basename(os.path.abspath(index_path))):
                    attempts = self._run_with_conflict_retry()
                self._log_event("succeeded")
                sp.set_attr("outcome", "succeeded")
                outcome = "succeeded"
                if attempts > 1:
                    sp.set_attr("attempts", attempts)
            except NoChangesError as e:
                logger.info("No-op action: %s", e)
                self._log_event(f"noop: {e}")
                sp.set_attr("outcome", "noop")
                outcome = "noop"
            except Exception as e:
                self._log_event(f"failed: {e}")
                sp.set_attr("outcome", "failed")
                raise
            finally:
                _tx_exit(index_path)
                # the action's wall time is this index's maintenance cost
                # (a no-op with the workload plane off)
                workload.charge_maintenance(index_path, type(self).__name__,
                                            time.perf_counter() - t0, outcome)

    def _run_with_conflict_retry(self) -> int:
        total = max(1, env.env_int("HYPERSPACE_ACTION_RETRIES"))
        attempt = 1
        while True:
            try:
                self.validate()
                self.begin()
                with maintenance_scope():
                    self.op()
                self.end()
                return attempt
            except ConcurrentWriteError as e:
                if attempt >= total:
                    REGISTRY.counter("action.retry.gave_up").inc()
                    if attempt > 1:
                        raise type(e)(f"{e} (conflict survived {attempt} attempts)") from e
                    raise
                REGISTRY.counter("action.retry.attempts").inc()
                trace.add_event("retry:action", attempt=attempt, error=str(e)[:120])
                logger.info("%s lost the optimistic-concurrency race (%s); re-reading "
                            "the log and retrying (%d/%d)", type(self).__name__, e,
                            attempt, total)
                attempt += 1
                self.reset_for_retry()

    def begin(self) -> None:
        latest = self.log_manager.get_latest_id()
        self.base_id = latest if latest is not None else -1
        entry = self.transient_entry()
        entry.stamp()
        log_id = self.base_id + C.LOG_ID_TRANSIENT_OFFSET
        if not self.log_manager.write_log(log_id, entry):
            raise ConcurrentWriteError(
                f"Another operation is in progress (log id {log_id} already exists)"
            )

    def transient_entry(self) -> LogEntry:
        """The entry ``begin`` writes at base_id + 1."""
        return LogEntry(state=self.transient_state)

    def end(self) -> None:
        entry = self.log_entry()
        entry.state = self.final_state
        entry.stamp()
        self.log_manager.delete_latest_stable_log()
        final_id = self.base_id + C.LOG_ID_FINAL_OFFSET
        if not self.log_manager.write_log(final_id, entry):
            raise ConcurrentWriteError(f"Concurrent commit at log id {final_id}")
        if entry.state in S.STABLE_STATES:
            self.log_manager.create_latest_stable_log(final_id)


class IndexMutationAction(Action):
    """An action on an existing index: loads the latest entry and checks
    the allowed prior states."""

    allowed_prior_states: frozenset[str] = frozenset()

    def __init__(self, log_manager: IndexLogManager, event_logger=None):
        super().__init__(log_manager, event_logger)
        self._prev = log_manager.get_latest_log()

    @property
    def previous_entry(self):
        if self._prev is None:
            raise HyperspaceError("Index does not exist")
        return self._prev

    def reset_for_retry(self) -> None:
        self._prev = self.log_manager.get_latest_log()

    def event_index_name(self) -> str:
        return getattr(self._prev, "name", "")

    def validate(self) -> None:
        prev = self.log_manager.get_latest_log()
        if prev is None:
            raise HyperspaceError("Index does not exist")
        if self.allowed_prior_states and prev.state not in self.allowed_prior_states:
            raise HyperspaceError(
                f"{type(self).__name__} requires state in "
                f"{sorted(self.allowed_prior_states)}, found {prev.state}"
            )
