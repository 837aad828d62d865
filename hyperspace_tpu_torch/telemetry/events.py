"""Typed telemetry events (counterpart of
hyperspace_tpu/telemetry/events.py).

Reference parity: telemetry/HyperspaceEvent.scala:28-166 — one event class
per action (Create/Delete/Restore/Vacuum/VacuumOutdated/Refresh/
RefreshIncremental/RefreshQuick/Optimize/Cancel) plus
HyperspaceIndexUsageEvent emitted on every successful rewrite; AppInfo tags.
"""

from __future__ import annotations

import getpass
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AppInfo:
    user: str = ""
    app_id: str = ""
    app_name: str = "hyperspace_tpu"

    @staticmethod
    def current() -> "AppInfo":
        try:
            user = getpass.getuser()
        except Exception:
            user = ""
        return AppInfo(user=user, app_id=str(os.getpid()))


@dataclass
class HyperspaceEvent:
    app_info: AppInfo
    message: str = ""

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class HyperspaceIndexCRUDEvent(HyperspaceEvent):
    index_name: str = ""


class CreateActionEvent(HyperspaceIndexCRUDEvent):
    pass


class DeleteActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RestoreActionEvent(HyperspaceIndexCRUDEvent):
    pass


class VacuumActionEvent(HyperspaceIndexCRUDEvent):
    pass


class VacuumOutdatedActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RefreshActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RefreshIncrementalActionEvent(HyperspaceIndexCRUDEvent):
    pass


class RefreshQuickActionEvent(HyperspaceIndexCRUDEvent):
    pass


class OptimizeActionEvent(HyperspaceIndexCRUDEvent):
    pass


class CancelActionEvent(HyperspaceIndexCRUDEvent):
    pass


class IngestAppendActionEvent(HyperspaceIndexCRUDEvent):
    pass


class IngestCompactActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when a query plan is rewritten to use indexes
    (ref: HyperspaceIndexUsageEvent, logged from the join/filter rules)."""

    index_names: list[str] = field(default_factory=list)
    rule: str = ""
