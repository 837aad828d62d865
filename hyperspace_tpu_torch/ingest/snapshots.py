"""Snapshot-pinned reads: refcounts of index data versions (counterpart of
hyperspace_tpu/ingest/snapshots.py).

With continuous ingestion, index data has many versions and each is
mortal: every append publishes a new immutable version, compaction
supersedes delta runs and vacuum deletes them. A query resolves its index
file set once, when it is planned (``rule_utils.index_scan``), and streams
those files for the rest of its life. The contract that keeps concurrent
maintenance sound:

    a file set resolved at plan time stays readable until the query drains.

- ``DataFrame.collect()`` opens a :class:`pin_scope`; every index scan the
  rewrite makes inside it pins a :class:`Snapshot` (the entry id and the
  ``v__=N`` data versions its content references), raising a refcount per
  ``(index_path, version)``. The scope's exit releases every pin, whether
  the query succeeded or failed.
- Deletions consult the registry: ``VacuumOutdatedAction`` defers pinned
  versions (``ingest.vacuum.deferred``) to a later pass, and recovery never
  removes a pinned version.
- Maintenance actions *protect* the version they build
  (:class:`protected_version`) from the staging and orphan sweeps of this
  process, from ``stage_version`` to the final log commit; protection is
  released in the action's ``finally``, even on an injected crash.

The registry lock is a leaf ``TrackedLock``: nothing else is acquired
under it, and counters are emitted outside it. Each pin and each
protection is a lifecycle-audit handle (``snapshot.pin``,
``snapshot.protect``) under ``HYPERSPACE_LIFECYCLE_AUDIT``.
"""

from __future__ import annotations

import contextvars
import os
import time
from dataclasses import dataclass
from typing import Optional

from ..staticcheck.concurrency import TrackedLock
from ..staticcheck.lifecycle import release_resource, tracked_resource


@dataclass(frozen=True)
class Snapshot:
    """One query's pinned view of one index: the log entry and the data
    versions (hence files) it resolved when it was planned."""

    index_name: str
    index_path: str  # abspath of the index root
    entry_id: int
    versions: frozenset  # data versions (ints) the entry references
    files: tuple  # the resolved file paths


def _versions_of_entry(entry) -> frozenset:
    out = set()
    for d in entry.index_version_dirs():
        try:
            out.add(int(d.split("=", 1)[1]))
        except (IndexError, ValueError):
            continue
    return frozenset(out)


class SnapshotRegistry:
    """Process-wide refcounts of (index_path, data_version) pins, the
    protected versions of in-flight maintenance builds, and the clock of
    vacuum's grace period."""

    def __init__(self):
        self._lock = TrackedLock("ingest.snapshots")
        self._refs: dict = {}  # (index_path, version) -> pin refcount
        self._protected: dict = {}  # (index_path, version) -> nesting depth
        self._superseded_at: dict = {}  # (index_path, version) -> monotonic s
        # lifecycle-audit handles: id(Snapshot) -> handle for pins (each
        # pin() returns a distinct Snapshot), (path, version) -> LIFO handle
        # stack for nested protection
        self._pin_handles: dict = {}
        self._prot_handles: dict = {}

    # --- pinning ---

    def pin(self, index_path: str, entry) -> Snapshot:
        index_path = os.path.abspath(index_path)
        snap = Snapshot(
            index_name=entry.name,
            index_path=index_path,
            entry_id=entry.id,
            versions=_versions_of_entry(entry),
            files=tuple(entry.content.files()),
        )
        lc = tracked_resource("snapshot.pin", f"{snap.index_name}#{snap.entry_id}")
        with self._lock:
            for v in snap.versions:
                key = (index_path, v)
                self._refs[key] = self._refs.get(key, 0) + 1
            if lc:
                self._pin_handles[id(snap)] = lc
        from ..telemetry.metrics import REGISTRY

        REGISTRY.counter("ingest.snapshot.pins").inc()
        return snap

    def release(self, snap: Snapshot) -> None:
        with self._lock:
            for v in snap.versions:
                key = (snap.index_path, v)
                n = self._refs.get(key, 0) - 1
                if n <= 0:
                    self._refs.pop(key, None)
                else:
                    self._refs[key] = n
            lc = self._pin_handles.pop(id(snap), 0)
        release_resource(lc)
        from ..telemetry.metrics import REGISTRY

        REGISTRY.counter("ingest.snapshot.releases").inc()

    def is_pinned(self, index_path: str, version: int) -> bool:
        key = (os.path.abspath(index_path), version)
        with self._lock:
            return self._refs.get(key, 0) > 0

    def active_pins(self) -> int:
        with self._lock:
            return sum(self._refs.values())

    # --- maintenance protection ---

    def protect_version(self, index_path: str, version: int) -> None:
        key = (os.path.abspath(index_path), version)
        lc = tracked_resource("snapshot.protect", f"{key[0]}@v{version}")
        with self._lock:
            self._protected[key] = self._protected.get(key, 0) + 1
            if lc:
                self._prot_handles.setdefault(key, []).append(lc)

    def unprotect_version(self, index_path: str, version: int) -> None:
        key = (os.path.abspath(index_path), version)
        with self._lock:
            depth = self._protected.get(key, 0) - 1
            if depth <= 0:
                self._protected.pop(key, None)
            else:
                self._protected[key] = depth
            stack = self._prot_handles.get(key)
            lc = stack.pop() if stack else 0
            if stack is not None and not stack:
                self._prot_handles.pop(key, None)
        release_resource(lc)

    def is_protected(self, index_path: str, version: int) -> bool:
        key = (os.path.abspath(index_path), version)
        with self._lock:
            return self._protected.get(key, 0) > 0

    def protected_versions(self, index_path: str) -> set:
        index_path = os.path.abspath(index_path)
        with self._lock:
            return {v for (p, v), n in self._protected.items() if p == index_path and n > 0}

    # --- vacuum grace ---

    def grace_elapsed(self, index_path: str, version: int, grace_s: float) -> bool:
        """True once ``version`` has been seen superseded (unreferenced by
        the latest entry) for at least ``grace_s`` seconds; the first
        sighting starts the clock."""
        key = (os.path.abspath(index_path), version)
        now = time.monotonic()
        with self._lock:
            first = self._superseded_at.setdefault(key, now)
        return (now - first) >= grace_s

    def forget_version(self, index_path: str, version: int) -> None:
        """Drop the grace clock of a deleted version (its id may return)."""
        key = (os.path.abspath(index_path), version)
        with self._lock:
            self._superseded_at.pop(key, None)


REGISTRY = SnapshotRegistry()


class protected_version:
    """Protects one in-flight maintenance output version from the staging
    and orphan sweeps of this process. Nestable; released on any exit."""

    __slots__ = ("_path", "_version")

    def __init__(self, index_path: str, version: int):
        self._path = index_path
        self._version = version

    def __enter__(self):
        REGISTRY.protect_version(self._path, self._version)
        return self

    def __exit__(self, *exc) -> bool:
        REGISTRY.unprotect_version(self._path, self._version)
        return False


# the per-query pin scope: ``DataFrame.collect()`` opens it and
# ``rule_utils.index_scan`` pins into it. Context variables keep it local
# to the thread (and task), so concurrent queries carry their own lists.
_PIN_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_torch_pin_scope", default=None
)
# observation sink: records every Snapshot pinned while it is active
_OBSERVE: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_torch_pin_observe", default=None
)


class pin_scope:
    """Collects every snapshot pinned during one query execution and
    releases them all on exit, whether the query succeeded or failed."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _PIN_SCOPE.set([])
        return self

    def __exit__(self, *exc) -> bool:
        pins = _PIN_SCOPE.get()
        _PIN_SCOPE.reset(self._token)
        for snap in pins or ():
            REGISTRY.release(snap)
        return False


class observe_pins:
    """Records every Snapshot pinned while active (across nested pin
    scopes) into ``self.pins``."""

    __slots__ = ("pins", "_token")

    def __init__(self):
        self.pins: list = []

    def __enter__(self):
        self._token = _OBSERVE.set(self.pins)
        return self

    def __exit__(self, *exc) -> bool:
        _OBSERVE.reset(self._token)
        return False


def current_pins() -> tuple:
    """The Snapshots the active pin scope has pinned so far (empty outside
    a scope). The result cache keys on them: the pinned entry ids are the
    data-version part of a cached result's identity."""
    scope = _PIN_SCOPE.get()
    return tuple(scope) if scope else ()


def pin_current(session, entry) -> Optional[Snapshot]:
    """Pin ``entry``'s snapshot into the active pin scope; nothing outside
    a scope (explain and whyNot resolve plans they never run)."""
    scope = _PIN_SCOPE.get()
    if scope is None:
        return None
    from ..meta.path_resolver import PathResolver

    index_path = PathResolver(session.conf, session.warehouse_dir).get_index_path(entry.name)
    snap = REGISTRY.pin(index_path, entry)
    scope.append(snap)
    sink = _OBSERVE.get()
    if sink is not None:
        sink.append(snap)
    return snap
