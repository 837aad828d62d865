"""Pluggable event logging (counterpart of
hyperspace_tpu/telemetry/logger.py).

Reference parity: telemetry/HyperspaceEventLogging.scala:30-68 — logger class
resolved once from conf (`hyperspace.telemetry.eventLoggerClass`), NoOp by
default; tests inject a capturing logger the same way.

The conf holds a class path. The JAX package's own logger classes
(``hyperspace_tpu.telemetry.logger.<Name>``) map to the port's classes of
the same name by string, so one conf steers both packages and the port
never imports the JAX package; any other path is imported.
"""

from __future__ import annotations

import importlib
import logging
from typing import TYPE_CHECKING

from .events import HyperspaceEvent

if TYPE_CHECKING:
    from ..session import HyperspaceSession

logger = logging.getLogger("hyperspace_tpu_torch.telemetry")


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


class PythonLoggingEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        logger.info("%s: %s", event.name, event.__dict__)


# the JAX package's module paths of these classes, mapped to this module
_JAX_LOGGER_MODULES = ("hyperspace_tpu.telemetry.logger", "hyperspace_tpu.telemetry")


def event_logger_for(session: "HyperspaceSession") -> EventLogger:
    # cached on the session itself (id()-keyed dicts break after GC reuse)
    cached = getattr(session, "_event_logger", None)
    if cached is not None:
        return cached
    name = session.conf.event_logger_class
    if not name:
        inst: EventLogger = NoOpEventLogger()
    else:
        mod, _, cls = str(name).rpartition(".")
        if mod in _JAX_LOGGER_MODULES:
            mod = __name__
        inst = getattr(importlib.import_module(mod), cls)()
    session._event_logger = inst
    return inst


def clear_event_logger_cache(session: "HyperspaceSession | None" = None) -> None:
    if session is not None and hasattr(session, "_event_logger"):
        del session._event_logger
