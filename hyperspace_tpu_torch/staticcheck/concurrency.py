"""Concurrency soundness layer: tracked locks, an acquisition-order graph,
and a guarded-state registry (counterpart of
hyperspace_tpu/staticcheck/concurrency.py).

The kernel cache, the chunk/stats/device caches, the IO pools, the metrics
registry and the serving plane are hit from pool workers and from
concurrent tenants' queries. This module makes their locking contracts
checkable instead of remembered:

1. **TrackedLock + lock registry.** Every named lock of the package wraps
   its ``threading.Lock`` in a :class:`TrackedLock`; construction registers
   the name process-wide, so ``registered_locks()`` is the live catalog of
   shared-state guards (``trace.roots``, ``kernel_cache.kernel``,
   ``io.cache.index_chunk``, ``serve.scheduler``, ...), under the JAX
   package's names.

2. **Acquisition-order graph.** Under ``HYPERSPACE_LOCK_AUDIT=1`` every
   acquisition records the acquiring thread's held-set: holding A while
   acquiring B inserts the edge A->B (with both call sites) into one global
   graph. Inserting an edge that closes a cycle raises
   :class:`LockOrderError` naming the full cycle and both stack sites, so
   a *potential* deadlock is caught on the first inconsistent nesting,
   long before the interleaving that would actually deadlock. Counters:
   ``staticcheck.lock.{acquisitions,edges,violations}``. ``report()`` is
   the ``staticcheck:locks`` report.

3. **Guarded-state registry.** ``guarded_by(obj, lock)`` declares which
   lock protects a shared mutable container. ``tools/hslint.py``'s HS305
   pass refuses module-level mutable shared state with no registered
   guard; ``guarded_state()`` lists every declaration for the report.

Cost: with the audit off (the default) a TrackedLock acquisition pays one
module-global flag check over a bare ``threading.Lock``. With the audit on,
the held-set lives in thread-local state and call sites are captured with
``sys._getframe`` (no traceback objects); results are bit for bit the same
either way.

The internal bookkeeping lock (``_BOOK``) and the per-metric value locks
in telemetry/metrics.py are deliberately *plain* leaf locks: they are
never held across any other acquisition (the audit path itself must not
feed the graph it maintains; a thread inside lock bookkeeping sets a
re-entrancy flag and its nested acquisitions go untracked).
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass

from ..utils import env

# ---------------------------------------------------------------------------
# audit switch
# ---------------------------------------------------------------------------

_AUDIT = env.env_bool("HYPERSPACE_LOCK_AUDIT")


def audit_enabled() -> bool:
    return _AUDIT


def set_audit(on: bool) -> bool:
    """Toggle the acquisition-order audit at runtime (tests, harnesses).
    Returns the previous state. The env knob only sets the import-time
    default."""
    global _AUDIT
    prev = _AUDIT
    _AUDIT = bool(on)
    return prev


# ---------------------------------------------------------------------------
# global state (all guarded by _BOOK, a deliberately untracked leaf lock)
# ---------------------------------------------------------------------------

_BOOK = threading.Lock()
_tls = threading.local()

# name -> number of TrackedLock instances constructed under it. Symmetric
# same-name instances (e.g. one lock per cache *family*) share a node in
# the order graph; self-edges are skipped.
_LOCKS: dict[str, int] = {}

# (from_name, to_name) -> (from_site, to_site) of the FIRST recording
_EDGES: dict[tuple[str, str], tuple[str, str]] = {}
# adjacency view of _EDGES for cycle checks
_ADJ: dict[str, set[str]] = {}


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the global acquisition-order
    graph — a potential deadlock. Carries the cycle (lock names, in order)
    and the two call sites that disagree."""

    def __init__(self, message: str, cycle: tuple, held_site: str, acquire_site: str):
        super().__init__(message)
        self.cycle = cycle
        self.held_site = held_site
        self.acquire_site = acquire_site


def _held() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _in_bookkeeping() -> bool:
    return getattr(_tls, "book", False)


_OWN_FILE = __file__


def _call_site() -> str:
    """``file:line (function)`` of the nearest frame outside this module —
    cheap (``sys._getframe`` walk, no traceback objects) because it runs on
    every audited acquisition."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - shallow stack
        return "<unknown>"
    while f is not None and f.f_code.co_filename == _OWN_FILE:
        f = f.f_back
    if f is None:  # pragma: no cover - all frames internal
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno} ({f.f_code.co_name})"


_counters = None


def _lock_counters():
    """(acquisitions, edges, violations) metric counters, created lazily so
    importing this module never drags in telemetry at interpreter start."""
    global _counters
    if _counters is None:
        from ..telemetry.metrics import REGISTRY

        _counters = (
            REGISTRY.counter("staticcheck.lock.acquisitions"),
            REGISTRY.counter("staticcheck.lock.edges"),
            REGISTRY.counter("staticcheck.lock.violations"),
        )
    return _counters


def _find_path(src: str, dst: str) -> "list[str] | None":
    """Shortest path src -> dst over the current edge set (caller holds
    _BOOK), or None. Used to detect that inserting dst->src would cycle."""
    if src == dst:
        return [src]
    parents: dict[str, str] = {src: src}
    frontier = [src]
    while frontier:
        nxt: list[str] = []
        for node in frontier:
            for peer in _ADJ.get(node, ()):
                if peer in parents:
                    continue
                parents[peer] = node
                if peer == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(parents[path[-1]])
                    path.reverse()
                    return path
                nxt.append(peer)
        frontier = nxt
    return None


def _record_acquire(name: str, site: str) -> None:
    """Audit bookkeeping for one acquisition attempt: count it, and when the
    thread already holds another lock, insert the nesting edge and check the
    graph for a cycle BEFORE the underlying acquire happens (so a violation
    raises with nothing new held)."""
    acqs, edges, violations = _lock_counters()
    acqs.inc()
    held = _held()
    if not held:
        return
    outer_name, outer_site = held[-1]
    if outer_name == name:
        return  # reentrant / symmetric same-name leaf: not an ordering edge
    key = (outer_name, name)
    with _BOOK:
        if key in _EDGES:
            return
        # would outer -> name close a cycle? i.e. does name already
        # (transitively) precede outer?
        path = _find_path(name, outer_name)
        if path is None:
            _EDGES[key] = (outer_site, site)
            _ADJ.setdefault(outer_name, set()).add(name)
            new_edge = True
            conflict = None
        else:
            new_edge = False
            # the first edge on the reverse path carries the call sites that
            # established the opposite order
            conflict = _EDGES.get((path[0], path[1])) if len(path) > 1 else None
            cycle = tuple([outer_name] + path[:-1])
    if new_edge:
        edges.inc()
        return
    violations.inc()
    reverse_site = conflict[0] if conflict else "<declared>"
    msg = (
        "lock order violation: acquiring "
        f"{name!r} while holding {outer_name!r} closes the cycle "
        f"{' -> '.join(cycle)} -> {cycle[0]}; "
        f"{outer_name!r} held at {outer_site}, {name!r} requested at {site}; "
        f"the opposite order {path[0]!r} -> {path[1]!r} "
        f"was first recorded at {reverse_site}"
    )
    raise LockOrderError(msg, cycle, outer_site, site)


# ---------------------------------------------------------------------------
# TrackedLock
# ---------------------------------------------------------------------------

class TrackedLock:
    """A named ``threading.Lock``/``RLock`` that participates in the
    process-wide lock registry and (under ``HYPERSPACE_LOCK_AUDIT=1``) the
    acquisition-order graph.

    Drop-in for the ``with self._lock:`` idiom; ``acquire``/``release``
    keep the stdlib signature. Several instances may share one name when
    they are symmetric leaves of the same family (per-metric value locks
    stay plain instead — see the module docstring)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()
        with _BOOK:
            _LOCKS[name] = _LOCKS.get(name, 0) + 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _AUDIT and not _in_bookkeeping():
            site = _call_site()
            _tls.book = True
            try:
                _record_acquire(self.name, site)
            finally:
                _tls.book = False
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                _held().append((self.name, site))
            return ok
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        if _AUDIT:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == self.name:
                    del held[i]
                    break
        self._lock.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self._lock, "locked", None)
        return locked() if locked is not None else False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TrackedLock({self.name!r})"


def registered_locks() -> dict:
    """{name: instance count} of every TrackedLock constructed so far."""
    with _BOOK:
        return dict(_LOCKS)


def declare_order(outer: str, inner: str) -> None:
    """Pre-declare the intended nesting order ``outer`` before ``inner``:
    seeds the runtime graph (so the FIRST observed inverse nesting raises
    instead of silently defining the order backwards). Raises
    :class:`LockOrderError` if the declaration itself closes a cycle."""
    key = (outer, inner)
    with _BOOK:
        if key in _EDGES:
            return
        path = _find_path(inner, outer)
        if path is not None:
            cycle = tuple([outer] + path[:-1])
            raise LockOrderError(
                f"declare_order({outer!r}, {inner!r}) closes the cycle "
                f"{' -> '.join(cycle)} -> {cycle[0]}",
                cycle, "<declared>", "<declared>",
            )
        _EDGES[key] = ("<declared>", "<declared>")
        _ADJ.setdefault(outer, set()).add(inner)


# Static mirror of declared nesting edges, consumed by hslint's HS306 pass
# (lexically nested `with <lock>:` blocks must either match an entry here /
# a module-local DECLARED_EDGES, or carry a justified suppression). Keys are
# the STATIC lock expressions as written at the site, e.g.
# ("self._lock", "_roots_lock").
DECLARED_EDGES: set = set()


# ---------------------------------------------------------------------------
# guarded-state registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GuardEntry:
    """One shared-mutable-container declaration: what it is, which lock
    guards it."""

    name: str  # dotted name of the container (module-qualified)
    lock: str  # TrackedLock name, or "<import-time>" for build-once state
    kind: str  # container type name
    note: str


_GUARDS: dict[int, GuardEntry] = {}
_GUARD_LIST: list[GuardEntry] = []


def guarded_by(obj, lock, name: str = "", note: str = ""):
    """Declare that ``lock`` (a TrackedLock, a lock name string, or None for
    import-time-only state) guards the shared mutable container ``obj``.
    Returns ``obj`` so declarations can wrap initializers:

        _roots = guarded_by([], _roots_lock, name="trace._roots")

    The declaration is what hslint's HS305 pass checks for; at runtime it
    feeds ``guarded_state()`` / ``report()``.
    """
    if isinstance(lock, TrackedLock):
        lock_name = lock.name
    elif lock is None:
        lock_name = "<import-time>"
    else:
        lock_name = str(lock)
    entry = GuardEntry(
        name=name or f"<{type(obj).__name__}@{id(obj):#x}>",
        lock=lock_name,
        kind=type(obj).__name__,
        note=note,
    )
    with _BOOK:
        _GUARDS[id(obj)] = entry
        _GUARD_LIST.append(entry)
    return obj


def guard_of(obj) -> "GuardEntry | None":
    """The registered guard of ``obj``, or None."""
    with _BOOK:
        return _GUARDS.get(id(obj))


def guarded_state() -> list:
    """Every guard declaration made so far, in declaration order."""
    with _BOOK:
        return list(_GUARD_LIST)


# ---------------------------------------------------------------------------
# report hook + test plumbing
# ---------------------------------------------------------------------------

def report() -> dict:
    """The ``staticcheck:locks`` report: registry, observed order edges with
    their first-recording sites, guard declarations, and the audit
    counters."""
    from ..telemetry.metrics import REGISTRY

    def val(n: str) -> int:
        m = REGISTRY.get(n)
        return 0 if m is None else int(m.value)

    with _BOOK:
        edges = [
            {"from": k[0], "to": k[1], "from_site": v[0], "to_site": v[1]}
            for k, v in sorted(_EDGES.items())
        ]
        locks = dict(_LOCKS)
        guards = [
            {"name": g.name, "lock": g.lock, "kind": g.kind, "note": g.note}
            for g in _GUARD_LIST
        ]
    return {
        "audit_enabled": _AUDIT,
        "locks": locks,
        "edges": edges,
        "guarded": guards,
        "acquisitions": val("staticcheck.lock.acquisitions"),
        "edge_count": val("staticcheck.lock.edges"),
        "violations": val("staticcheck.lock.violations"),
    }


def reset_order_graph() -> None:
    """Clear the observed edge set (NOT the lock registry or the metric
    counters) — test isolation between planted-inversion cases."""
    with _BOOK:
        _EDGES.clear()
        _ADJ.clear()


# this module's own shared state is guarded by _BOOK (the untracked leaf —
# see the module docstring); declared here so the HS305 pass holds this
# file to the same standard it enforces everywhere else
guarded_by(_LOCKS, "staticcheck._BOOK", name="staticcheck.concurrency._LOCKS")
guarded_by(_EDGES, "staticcheck._BOOK", name="staticcheck.concurrency._EDGES")
guarded_by(_ADJ, "staticcheck._BOOK", name="staticcheck.concurrency._ADJ")
guarded_by(_GUARDS, "staticcheck._BOOK", name="staticcheck.concurrency._GUARDS")
guarded_by(
    _GUARD_LIST, "staticcheck._BOOK", name="staticcheck.concurrency._GUARD_LIST"
)


if __name__ == "__main__":  # pragma: no cover - tooling entry
    import json

    print(json.dumps(report(), indent=2))
