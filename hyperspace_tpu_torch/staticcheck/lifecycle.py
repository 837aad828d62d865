"""Resource lifecycle auditor: every acquire must meet its release
(counterpart of hyperspace_tpu/staticcheck/lifecycle.py).

The port holds resources that are acquired and released on different
paths: snapshot pins and protected versions (``ingest/snapshots.py``),
global and per-device ``BudgetStream`` reservations (``serve/budget.py``),
device-ledger wave grants (``plan/join_memory.py``), attribution scopes
(``telemetry/attribution.py``) and result-cache in-flight markers
(``cache/result_cache.py``). Each can leak on a ``QueryCancelledError`` /
``InjectedCrash`` unwind; both are BaseExceptions, so an ``except
Exception`` cleanup path never runs for them.

1. **Resource registry.** ``tracked_resource(kind, ...)`` is the one
   instrumentation point, installed at those chokepoints. Under
   ``HYPERSPACE_LIFECYCLE_AUDIT=1`` each call records a live handle
   (owner: query id, thread, tenant; plus the acquire call chain) and
   ``release_resource(handle)`` retires it. Off (the default) the whole
   thing is one module-global flag check returning 0, and results are bit
   for bit the same with the audit on or off.

2. **Quiescence gate.** ``check_quiescent()`` raises
   :class:`ResourceLeakError` naming every live handle with its acquire
   chain: after cancellation storms, crash cells, parked or spilled joins
   and degraded runs, the process must drain to zero live handles.
   Counters: ``staticcheck.lifecycle.{acquires,releases,leaks}``.
   ``report()`` is the ``staticcheck:lifecycle`` report, in the lock
   auditor's shape.

3. **Release-path lint.** ``tools/hslint.py``'s HS5xx passes check the
   same contract lexically: HS501 (acquire without a guaranteed release),
   HS502 (cleanup under ``except Exception``), HS503 (a ``finally`` that
   can itself raise before releasing).

The bookkeeping lock ``_BOOK`` is a deliberately *plain* leaf (never held
across any other acquisition; the audit must not feed the graphs it
audits), and acquire call chains come from a bounded ``sys._getframe``
walk, with no traceback objects.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Optional

from ..utils import env
from .concurrency import guarded_by

# ---------------------------------------------------------------------------
# audit switch
# ---------------------------------------------------------------------------

_AUDIT = env.env_bool("HYPERSPACE_LIFECYCLE_AUDIT")


def audit_enabled() -> bool:
    return _AUDIT


def set_audit(on: bool) -> bool:
    """Toggle the lifecycle audit at runtime (tests, gates). Returns the
    previous state. The env knob only sets the import-time default."""
    global _AUDIT
    prev = _AUDIT
    _AUDIT = bool(on)
    return prev


# ---------------------------------------------------------------------------
# global state (all guarded by _BOOK, a deliberately untracked leaf lock)
# ---------------------------------------------------------------------------

_BOOK = threading.Lock()


@dataclass(frozen=True)
class LiveHandle:
    """One live (acquired, not yet released) resource handle."""

    hid: int
    kind: str  # "snapshot.pin" | "budget.stream" | "ledger.wave" | ...
    detail: str
    query: object  # owning query id (None outside the scheduler)
    tenant: Optional[str]
    thread: str
    site: str  # acquire call chain, innermost first

    def describe(self) -> str:
        owner = (
            f"query={self.query!r} tenant={self.tenant!r} "
            f"thread={self.thread!r}"
        )
        what = f"{self.kind}" + (f" ({self.detail})" if self.detail else "")
        return f"#{self.hid} {what} owner[{owner}] acquired at {self.site}"


# hid -> LiveHandle; monotonically numbered so leak reports sort by age
_LIVE: dict = {}
_STATE = {"next": 1}


class ResourceLeakError(RuntimeError):
    """Quiescence check failed: live resource handles remain. Carries the
    leaked handles; the message names each one with its acquire chain."""

    def __init__(self, message: str, leaks: list):
        super().__init__(message)
        self.leaks = list(leaks)


_OWN_FILE = __file__
_SITE_DEPTH = 4  # app frames kept per acquire chain


def _acquire_site() -> str:
    """Bounded ``outer <- ...`` call chain of the acquiring frame — cheap
    (``sys._getframe`` walk, no traceback objects) because it runs on every
    audited acquire, deep enough to name the owning scope in leak reports."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - shallow stack
        return "<unknown>"
    while f is not None and f.f_code.co_filename == _OWN_FILE:
        f = f.f_back
    frames = []
    while f is not None and len(frames) < _SITE_DEPTH:
        frames.append(
            f"{f.f_code.co_filename}:{f.f_lineno} ({f.f_code.co_name})"
        )
        f = f.f_back
    return " <- ".join(frames) if frames else "<unknown>"


_counters = None


def _lifecycle_counters():
    """(acquires, releases, leaks) metric counters, created lazily so
    importing this module never drags in telemetry at interpreter start."""
    global _counters
    if _counters is None:
        from ..telemetry.metrics import REGISTRY

        _counters = (
            REGISTRY.counter("staticcheck.lifecycle.acquires"),
            REGISTRY.counter("staticcheck.lifecycle.releases"),
            REGISTRY.counter("staticcheck.lifecycle.leaks"),
        )
    return _counters


def _inc_unattributed(counter, n: int = 1) -> None:
    """Increment with per-query attribution suspended. The audit's own
    bookkeeping fires while the enclosing query's attribution target is
    installed (a scope's acquire runs under the OUTER scope's ledger), so
    an attributed write would make armed runs' ledgers differ from
    disarmed ones — and tests pin exact ledger contents."""
    from ..telemetry.metrics import _attr_target

    tok = _attr_target.set(None)
    try:
        counter.inc(n)
    finally:
        _attr_target.reset(tok)


# ---------------------------------------------------------------------------
# the instrumentation point
# ---------------------------------------------------------------------------

def tracked_resource(kind: str, detail: str = "", query=None,
                     tenant: "str | None" = None) -> int:
    """Record one resource acquisition; returns the handle id to pass to
    :func:`release_resource` at the release site.

    Disarmed (the default) this is one flag check returning 0 — no
    counters, no allocation, no frame walk — so instrumented chokepoints
    cost nothing on the bit-identity path. Armed, the handle records its
    owner: ``query``/``tenant`` default to the thread's current serving
    context (None outside the scheduler), mirroring ``BudgetAccountant
    .stream``'s owner resolution."""
    if not _AUDIT:
        return 0
    _inc_unattributed(_lifecycle_counters()[0])
    if query is None:
        try:
            from ..serve.context import current_query

            ctx = current_query()
            if ctx is not None:
                query = ctx.query_id
                if tenant is None:
                    tenant = getattr(ctx, "tenant", None)
        except Exception:
            query = None
    site = _acquire_site()
    thread = threading.current_thread().name
    with _BOOK:
        hid = _STATE["next"]
        _STATE["next"] = hid + 1
        _LIVE[hid] = LiveHandle(
            hid, kind, str(detail), query, tenant, thread, site
        )
    return hid


def release_resource(handle: int) -> None:
    """Retire a handle from :func:`tracked_resource`. ``0`` (the disarmed
    sentinel) is a no-op, so release sites never need their own flag
    check; releasing after the audit was disarmed still drains the table
    (a mid-run ``set_audit(False)`` must not manufacture leaks)."""
    if not handle:
        return
    with _BOOK:
        h = _LIVE.pop(handle, None)
    if h is not None:
        _inc_unattributed(_lifecycle_counters()[1])


def live_handles() -> list:
    """Every live handle, oldest first (gates, tests, ``report()``)."""
    with _BOOK:
        return sorted(_LIVE.values(), key=lambda h: h.hid)


def check_quiescent(raise_on_leak: bool = True) -> list:
    """The gate assertion: at quiescence (every query drained, every
    maintenance action finished) zero handles may remain live. Returns the
    leak list (empty = clean); with ``raise_on_leak`` (the default) a
    non-empty list raises :class:`ResourceLeakError` naming every leaked
    handle with its owner and acquire chain. Feeds
    ``staticcheck.lifecycle.leaks``."""
    from ..telemetry import trace

    with trace.span("staticcheck:lifecycle"):
        leaks = live_handles()
    if leaks:
        _inc_unattributed(_lifecycle_counters()[2], len(leaks))
        if raise_on_leak:
            lines = "\n".join(f"  {h.describe()}" for h in leaks)
            raise ResourceLeakError(
                f"{len(leaks)} leaked resource handle(s) at quiescence:\n"
                f"{lines}", leaks,
            )
    return leaks


def reset() -> None:
    """Drop every live handle (NOT the counters) — test isolation between
    planted-leak cases."""
    with _BOOK:
        _LIVE.clear()


# ---------------------------------------------------------------------------
# report hook
# ---------------------------------------------------------------------------

def report() -> dict:
    """The ``staticcheck:lifecycle`` report: live handles by kind plus the
    audit counters, in the lock auditor's ``report()`` shape."""
    from ..telemetry.metrics import REGISTRY

    def val(n: str) -> int:
        m = REGISTRY.get(n)
        return 0 if m is None else int(m.value)

    live = live_handles()
    kinds: dict = {}
    for h in live:
        kinds[h.kind] = kinds.get(h.kind, 0) + 1
    return {
        "audit_enabled": _AUDIT,
        "live": [
            {"kind": h.kind, "detail": h.detail, "query": h.query,
             "tenant": h.tenant, "thread": h.thread, "site": h.site}
            for h in live
        ],
        "kinds": kinds,
        "acquires": val("staticcheck.lifecycle.acquires"),
        "releases": val("staticcheck.lifecycle.releases"),
        "leaks": val("staticcheck.lifecycle.leaks"),
    }


# this module's own shared state is guarded by _BOOK (the untracked leaf —
# see the module docstring); declared so HS305 holds this file to the same
# standard it enforces everywhere else
guarded_by(_LIVE, "staticcheck.lifecycle._BOOK",
           name="staticcheck.lifecycle._LIVE")
guarded_by(_STATE, "staticcheck.lifecycle._BOOK",
           name="staticcheck.lifecycle._STATE")


if __name__ == "__main__":  # pragma: no cover - tooling entry
    import json

    print(json.dumps(report(), indent=2))
