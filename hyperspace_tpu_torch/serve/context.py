"""Per-query serving context: identity, priority, cooperative cancellation
(counterpart of hyperspace_tpu/serve/context.py).

Every query the scheduler admits runs its whole execution (plan → streamers
→ kernels) on one worker thread under a ``QueryContext`` installed via
``query_scope``. The context is what makes a query addressable while it
runs: the budget accountant tags reservations with it, the trace layer's
``serve:query`` span carries its id, and ``cancel()`` flips the one flag
every streaming loop polls.

Cancellation is cooperative and chunk-granular: ``check_cancelled()`` sits
inside the ordered chunk/pair streamers (columnar/io.iter_chunks,
bucket_join._iter_bucket_pairs), the pipelined fold loops (plan/gpu_exec),
the join ledger's park loop (plan/join_memory) and the per-node executor
walk (plan/executor.execute_plan), so a cancelled
query unwinds at the next chunk boundary. The unwind path is the streams'
existing ``finally`` blocks — read-ahead futures cancel, IO pools release,
and budget reservations return to the global accountant — which is exactly
the "releases everything within a scheduler tick" contract tests pin.

``QueryCancelledError`` deliberately derives from ``BaseException`` (the
``InjectedCrash`` precedent in utils/faults.py): ``except Exception``
handlers on the query path (a chunk decode's typed rewrap, the retry
layer) must never absorb a cancel into a retry or a different error. Every
``finally`` on the way out releases what it holds: the pin scope, budget
streams, device-ledger waves and read-ahead futures.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
from typing import Optional


class QueryCancelledError(BaseException):
    """The running query was cancelled via its handle. BaseException so no
    ``except Exception`` on the query path (a typed rewrap, a retry) can
    swallow a cancel (see module docstring); catch it explicitly via
    ``QueryHandle.result()``."""


_ids = itertools.count(1)


class QueryContext:
    """Identity + cancellation flag of one admitted query. ``tenant`` is
    the owning tenant's name (the QoS dimension: per-tenant queues, budget
    partitions, and ledger rollups all key on it; "default" when the
    submitter never said otherwise) and ``deadline_s`` the optional SLO
    the admission door checked against. ``device_home`` is the device
    ordinal the scheduler placed the query on; the port has one card and
    no mesh tier, so it stays None."""

    __slots__ = ("query_id", "label", "priority", "tenant", "deadline_s",
                 "device_home", "approx_fraction", "_cancelled")

    def __init__(self, label: str = "query", priority: int = 0,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None):
        self.query_id = next(_ids)
        self.label = label
        self.priority = priority
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.device_home: Optional[int] = None
        # sampling fraction the QoS degrade policy selected for this query
        # (serve/scheduler.py); None = exact. plan/sampling.py reads it at
        # collect time.
        self.approx_fraction: Optional[float] = None
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"QueryContext(id={self.query_id}, label={self.label!r})"


# the running query of the current thread (None outside the serving layer);
# a contextvar so nested scopes restore correctly on exit
_current: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_serve_query", default=None
)


def current_query() -> Optional[QueryContext]:
    """The QueryContext this thread is executing under, or None (direct
    ``collect()`` callers outside any scheduler)."""
    return _current.get()


class query_scope:
    """Install ``ctx`` as the thread's current query for the duration."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: QueryContext):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> QueryContext:
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False


def check_cancelled() -> None:
    """Raise ``QueryCancelledError`` when the current query was cancelled.
    One contextvar read + one Event check — cheap enough for per-chunk and
    per-plan-node call sites; a no-op outside the serving layer."""
    ctx = _current.get()
    if ctx is not None and ctx.cancelled:
        raise QueryCancelledError(
            f"query {ctx.query_id} ({ctx.label}) cancelled"
        )
