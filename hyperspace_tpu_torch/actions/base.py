"""Action: the two-phase index-mutating transaction (counterpart of
hyperspace_tpu/actions/base.py, without the conflict retry and the
recovery registry).

run() = validate, begin (write the transient entry at base_id+1), op, end
(write the final entry at base_id+2 and the latestStable pointer). A taken
log id means another writer won the optimistic-concurrency race.
"""

from __future__ import annotations

from . import states as S
from .. import constants as C
from ..exceptions import ConcurrentWriteError
from ..meta.entry import LogEntry
from ..meta.log_manager import IndexLogManager


class Action:
    transient_state: str = "?"
    final_state: str = "?"

    def __init__(self, log_manager: IndexLogManager):
        self.log_manager = log_manager
        self.base_id: int = 0

    def validate(self) -> None:
        """Raise HyperspaceError if the action cannot run from this state."""

    def op(self) -> None:
        raise NotImplementedError

    def log_entry(self) -> LogEntry:
        raise NotImplementedError

    def run(self) -> None:
        self.validate()
        self.begin()
        self.op()
        self.end()

    def begin(self) -> None:
        latest = self.log_manager.get_latest_id()
        self.base_id = latest if latest is not None else -1
        entry = LogEntry(state=self.transient_state)
        entry.stamp()
        log_id = self.base_id + C.LOG_ID_TRANSIENT_OFFSET
        if not self.log_manager.write_log(log_id, entry):
            raise ConcurrentWriteError(
                f"Another operation is in progress (log id {log_id} already exists)"
            )

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
