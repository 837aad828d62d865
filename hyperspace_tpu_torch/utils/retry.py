"""Bounded retry with deterministic backoff for transient host IO
(counterpart of hyperspace_tpu/utils/retry.py).

A multi-file scan would otherwise die on one transient IO error while
every other file decodes fine. This is the one retry policy for host IO:
bounded attempts, exponential backoff with deterministic jitter (no RNG
state), and a transient/permanent classifier, so that a structural error
(a missing file, a bad schema) fails at once instead of burning retries.

``columnar/io.py`` wraps the per-file decode units (parquet, CSV, JSON,
ORC) and the footer-statistics read in it: every scan path funnels
through them.

Observability, as in the JAX package: ``io.retry.attempts`` counts
re-attempts (0 on a clean run), ``io.retry.gave_up`` counts exhaustion,
and each re-attempt emits a ``retry:<what>`` span event with the attempt
and the error's type. The sleep is injectable (``clock=``), so tests run
whole backoff schedules without sleeping.

Knob: ``HYPERSPACE_IO_RETRIES``, the total attempts per unit (default 3;
1 turns retrying off), read at every call.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable

from . import env

# attempt k (1-based re-attempt) sleeps
#   min(MAX_DELAY, BASE * 2**(k-1)) * (0.5 + 0.5 * jitter)
# where jitter in [0, 1) is a crc32 of (what, k): fixed for a call site and
# attempt, different across sites
BASE_DELAY_S = 0.05
MAX_DELAY_S = 2.0


def is_transient(err: BaseException) -> bool:
    """Worth re-attempting with the same inputs: OS-level IO errors
    (pyarrow's ``ArrowIOError`` and the injected ``InjectedIOError``
    included), except missing paths, permissions and directory mix-ups,
    where a retry re-fails. Everything else (HyperspaceError, ValueError,
    MemoryError, injected crashes) is permanent."""
    if isinstance(err, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    return isinstance(err, (OSError, ConnectionError, TimeoutError))


def _jitter(what: str, attempt: int) -> float:
    return (zlib.crc32(f"{what}:{attempt}".encode()) % 1000) / 1000.0


def backoff_delay(what: str, attempt: int) -> float:
    """Sleep before re-attempt ``attempt`` (1-based) of unit ``what``."""
    raw = min(MAX_DELAY_S, BASE_DELAY_S * (2 ** (attempt - 1)))
    return raw * (0.5 + 0.5 * _jitter(what, attempt))


def retry_attempts() -> int:
    try:
        return max(1, env.env_int("HYPERSPACE_IO_RETRIES"))
    except ValueError:
        return 3


def retry_call(
    fn: Callable,
    what: str,
    attempts: "int | None" = None,
    classify: Callable[[BaseException], bool] = is_transient,
    clock: "Callable[[float], None] | None" = None,
):
    """``fn()`` with up to ``attempts`` tries (``HYPERSPACE_IO_RETRIES`` by
    default); only errors ``classify`` deems transient (``is_transient`` by
    default) are re-attempted, after ``backoff_delay`` on ``clock``
    (``time.sleep`` by default). The last failure propagates unchanged."""
    total = retry_attempts() if attempts is None else max(1, attempts)
    sleep = time.sleep if clock is None else clock
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            attempt += 1
            if attempt >= total or not classify(e):
                if attempt > 1:
                    from ..telemetry.metrics import REGISTRY

                    REGISTRY.counter("io.retry.gave_up").inc()
                raise
            from ..telemetry import trace
            from ..telemetry.metrics import REGISTRY

            REGISTRY.counter("io.retry.attempts").inc()
            trace.add_event(f"retry:{what}", attempt=attempt, error=type(e).__name__)
            sleep(backoff_delay(what, attempt))
