"""The snapshot-keyed cross-query result cache (counterpart of
hyperspace_tpu/cache/result_cache.py).

A repeated dashboard query would otherwise scan, upload and dispatch from
the start every time. The cache's invalidation is exact, never heuristic:

    key = (plan structure fingerprint, plan files fingerprint,
           pinned snapshot ids)

- the fingerprints (plan/kernel_cache.py) canonicalize the whole optimized
  plan: node kinds, expression reprs, prune decisions and the (path, size,
  mtime) of every scanned file;
- the snapshot ids are the (index_path, entry_id) pins the query's pin
  scope collected when it was planned (ingest/snapshots.py): immutable,
  atomically published data versions.

A hit therefore returns a result bit-identical to a new run: the same plan
over the same immutable bytes. Only plans that pinned at least one index
snapshot are cached (a raw source scan has no version authority, an
in-memory scan no stable identity).

Incremental view maintenance (view_maintenance.py): an append publishes a
snapshot whose content is old + delta, so the exact key misses; but an
exactly-foldable fragment (a global count, min, max or integer sum) is not
recomputed from the start: the miss finds a same-template entry whose file
set is a subset of the new plan's, runs the fragment over the delta files
only, through the ordinary executor (on the card like any query), and folds
``result_new = result_old (+) agg(delta)``.

Modes (``HYPERSPACE_RESULT_CACHE``, read at every call): ``0`` off (the
default: every query runs exactly as without the cache), ``1`` on,
``verify`` on, with every hit and every fold recomputed from the start and
a divergence raised. ``HYPERSPACE_RESULT_CACHE_MB`` is the byte budget
(LRU past it).

Population is single-flight: concurrent identical queries compute once,
the others wait and read; a failed build clears its in-flight marker and
wakes the waiters. The store lock is a leaf: builds (query execution) and
counters run outside it. Counters ``cache.result.{hits, misses,
evictions, folds, fold_rows, refreshes, verified}``, the gauge
``cache.result.bytes``, the ``cache:probe`` span, and the ``cached`` and
``folded`` route notes that EXPLAIN ANALYZE renders, as in the JAX
package.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from collections import OrderedDict
from typing import Optional

from ..exceptions import HyperspaceError
from ..staticcheck.concurrency import TrackedLock
from ..staticcheck.lifecycle import release_resource, tracked_resource
from ..utils import env


def _mode() -> str:
    return env.env_str("HYPERSPACE_RESULT_CACHE") or "0"


def enabled() -> bool:
    return _mode() != "0"


def is_verify() -> bool:
    return _mode() == "verify"


def _max_bytes() -> int:
    return int(env.env_float("HYPERSPACE_RESULT_CACHE_MB") * 1024 * 1024)


def _digest(obj) -> str:
    return hashlib.blake2b(repr(obj).encode(), digest_size=16).hexdigest()


def batch_nbytes(batch) -> int:
    """A ColumnBatch's bytes for the budget: data, validity, and an
    estimate for string dictionaries."""
    total = 0
    for c in batch.columns.values():
        total += c.data.nbytes
        if c.validity is not None:
            total += c.validity.nbytes
        if c.dictionary is not None:
            total += sum(len(s) for s in c.dictionary) + 8 * len(c.dictionary)
    return total


def _file_ids(scan) -> frozenset:
    return frozenset((f.name, f.size, f.modified_time) for f in scan.files)


class CachedResult:
    """One stored result and what a later probe needs: the snapshots it is
    exact for, each scan's file identity (the fold's subset test), the fold
    spec when the fragment folds exactly, and the pre-optimization plan and
    (weakly) its session, so a background refresh can run the template
    again after a version advance."""

    __slots__ = (
        "key", "structure_key", "result", "nbytes", "snapshots", "scan_files",
        "fold_spec", "fold_depth", "raw_plan", "session_ref",
    )

    def __init__(self, key, structure_key, result, snapshots, scan_files, fold_spec,
                 fold_depth, raw_plan, session):
        self.key = key
        self.structure_key = structure_key
        self.result = result
        self.nbytes = batch_nbytes(result)
        self.snapshots = tuple(snapshots)
        self.scan_files = tuple(scan_files)  # per-scan frozensets, preorder
        self.fold_spec = fold_spec
        self.fold_depth = fold_depth
        self.raw_plan = raw_plan
        self.session_ref = weakref.ref(session) if session is not None else None


class ResultCache:
    """A byte-bounded LRU of CachedResults, with a secondary index by
    template (structure key) for the fold's candidates, and single-flight
    population. Thread-safe; the lock is a leaf."""

    def __init__(self, name: str = "result"):
        self.name = name
        self._lock = TrackedLock(f"cache.{name}")
        self._d: OrderedDict = OrderedDict()  # key -> CachedResult
        self._by_structure: dict = {}  # structure_key -> OrderedDict[key, None]
        self._bytes = 0
        self._inflight: dict = {}
        self._inflight_lc: dict = {}  # key -> lifecycle-audit handle

    # --- metrics (outside the lock) ---

    def _count(self, event: str, n: int = 1) -> None:
        from ..telemetry.metrics import REGISTRY

        REGISTRY.counter(f"cache.{self.name}.{event}").inc(n)

    def _publish_bytes(self) -> None:
        from ..telemetry.metrics import REGISTRY

        with self._lock:
            b = self._bytes
        REGISTRY.gauge(f"cache.{self.name}.bytes").set(b)

    # --- store ---

    def _unlink(self, entry: CachedResult) -> None:
        """Remove ``entry`` from both maps; the caller holds the lock."""
        self._d.pop(entry.key, None)
        self._bytes -= entry.nbytes
        sk = self._by_structure.get(entry.structure_key)
        if sk is not None:
            sk.pop(entry.key, None)
            if not sk:
                self._by_structure.pop(entry.structure_key, None)

    def put(self, entry: CachedResult) -> None:
        evicted = 0
        limit = _max_bytes()
        with self._lock:
            old = self._d.get(entry.key)
            if old is not None:
                self._unlink(old)
            self._d[entry.key] = entry
            self._d.move_to_end(entry.key)
            self._bytes += entry.nbytes
            self._by_structure.setdefault(entry.structure_key, OrderedDict())[entry.key] = None
            while self._bytes > limit and len(self._d) > 1:
                _k, victim = next(iter(self._d.items()))
                self._unlink(victim)
                evicted += 1
            # one entry over the whole budget is not kept either
            if self._bytes > limit and entry.key in self._d:
                self._unlink(entry)
                evicted += 1
        if evicted:
            self._count("evictions", evicted)
        self._publish_bytes()

    def get(self, key) -> Optional[CachedResult]:
        """The entry under ``key`` (now the most recent), or None; counts
        nothing (``get_or_compute`` is the query path's lookup)."""
        with self._lock:
            entry = self._d.get(key)
            if entry is not None:
                self._d.move_to_end(key)
        return entry

    def get_or_compute(self, key, build):
        """(entry, hit). The first caller that misses runs ``build()``
        (which executes the query, outside the lock) while the key is
        marked in flight; concurrent probes of the key wait on its event
        and read the stored entry. A failed build clears the marker and
        wakes the waiters, so one of them takes over."""
        while True:
            with self._lock:
                entry = self._d.get(key)
                if entry is not None:
                    self._d.move_to_end(key)
                    return entry, True
                event = self._inflight.get(key)
                building = event is None
                if building:
                    event = self._inflight[key] = threading.Event()
                    self._inflight_lc[key] = tracked_resource("cache.inflight", self.name)
            if not building:
                event.wait()
                continue
            try:
                entry = build()
            except BaseException:
                with self._lock:
                    self._inflight.pop(key, None)
                    lc = self._inflight_lc.pop(key, 0)
                event.set()
                release_resource(lc)
                raise
            try:
                if entry is not None:
                    self.put(entry)
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                    lc = self._inflight_lc.pop(key, 0)
                event.set()
                release_resource(lc)
            return entry, False

    # --- fold candidates and maintenance ---

    def fold_candidates(self, structure_key) -> list:
        """The template's entries, newest first (the newest is closest to
        the new snapshot, so its delta is the smallest)."""
        with self._lock:
            keys = list(self._by_structure.get(structure_key, ()))
            return [self._d[k] for k in reversed(keys) if k in self._d]

    def entries_for_index(self, index_path: str) -> list:
        with self._lock:
            return [e for e in self._d.values()
                    if any(s.index_path == index_path for s in e.snapshots)]

    def invalidate_version(self, index_path: str, version: int) -> int:
        """Drop every entry pinned to (index_path, version): vacuum calls it
        when it deletes the version. Exact keys already keep such entries
        from being hit; this also takes them out of the fold candidates
        and frees their bytes."""
        with self._lock:
            victims = [e for e in self._d.values()
                       if any(s.index_path == index_path and version in s.versions
                              for s in e.snapshots)]
            for e in victims:
                self._unlink(e)
        if victims:
            self._publish_bytes()
        return len(victims)

    # --- introspection ---

    def check_consistency(self) -> bool:
        """Byte accounting, index coherence and no leaked in-flight marker
        (call at quiescence)."""
        with self._lock:
            actual = sum(e.nbytes for e in self._d.values())
            indexed = {k for sk in self._by_structure.values() for k in sk}
            return (actual == self._bytes and self._bytes <= max(_max_bytes(), 0)
                    and indexed == set(self._d) and not self._inflight)

    def state(self) -> dict:
        from ..telemetry.metrics import REGISTRY

        def val(n: str) -> int:
            m = REGISTRY.get(f"cache.{self.name}.{n}")
            return 0 if m is None else int(m.value)

        with self._lock:
            entries = len(self._d)
            byts = self._bytes
            foldable = sum(1 for e in self._d.values() if e.fold_spec)
        return {
            "mode": _mode(),
            "entries": entries,
            "foldable_entries": foldable,
            "bytes": byts,
            "max_bytes": _max_bytes(),
            "hits": val("hits"),
            "misses": val("misses"),
            "evictions": val("evictions"),
            "folds": val("folds"),
            "fold_rows": val("fold_rows"),
            "refreshes": val("refreshes"),
            "verified": val("verified"),
        }

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._by_structure.clear()
            self._bytes = 0
        self._publish_bytes()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


RESULT_CACHE = ResultCache()


# --- the collect() chokepoint ---

def _canonical_bits(batch) -> tuple:
    """A result's bit-exact comparable form: names, dtypes, and values with
    floats at .hex() precision and NULLs explicit."""
    out = []
    for name, c in batch.columns.items():
        vals = [x.hex() if isinstance(x, float) else x for x in c.decode().tolist()]
        out.append((name, c.dtype, vals))
    return tuple(out)


def _build_key(plan, pins):
    from ..plan.kernel_cache import plan_files_fingerprint, plan_structure_fingerprint

    structure_key = _digest(plan_structure_fingerprint(plan))
    files_key = _digest(plan_files_fingerprint(plan))
    snap_key = tuple(sorted((s.index_path, s.entry_id) for s in pins))
    return (structure_key, files_key, snap_key), structure_key


def _cacheable(plan, pins) -> bool:
    from ..plan.nodes import InMemoryScan

    if not pins:
        return False  # no snapshot authority: raw or in-memory plans
    return not any(isinstance(n, InMemoryScan) for n in plan.preorder())


def _verify_or_raise(session, plan, result, origin: str) -> None:
    """Verify mode: recompute from the start and compare bit for bit."""
    from ..plan.executor import execute_plan
    from ..telemetry.metrics import REGISTRY

    fresh = execute_plan(plan, session)
    if _canonical_bits(fresh) != _canonical_bits(result):
        raise HyperspaceError(
            f"result-cache verify divergence on {origin}: cached result does not "
            f"match recomputation (plan:\n{plan.pretty()})"
        )
    REGISTRY.counter("cache.result.verified").inc()


def serve_collect(session, raw_plan, plan):
    """``DataFrame.collect``'s chokepoint: serve a hit with no scan, upload
    or dispatch, fold from an older snapshot of the same template on an
    additive miss, or execute and store. With the cache off, or a plan that
    is not cacheable (no pins, an in-memory leaf), it is plain execution."""
    from ..plan.executor import execute_plan
    from ..telemetry import plan_stats, trace
    from ..telemetry.metrics import REGISTRY

    if not enabled():
        return execute_plan(plan, session)
    from ..ingest.snapshots import current_pins

    pins = current_pins()
    if not _cacheable(plan, pins):
        return execute_plan(plan, session)

    with trace.span("cache:probe"):
        key, structure_key = _build_key(plan, pins)
    outcome = {"via": "full"}

    def build() -> CachedResult:
        from .view_maintenance import classify_plan, try_fold
        from ..plan.nodes import FileScan

        REGISTRY.counter("cache.result.misses").inc()
        fold_spec = classify_plan(plan)
        result = None
        depth = 0
        if fold_spec is not None:
            folded = try_fold(session, plan, fold_spec,
                              RESULT_CACHE.fold_candidates(structure_key))
            if folded is not None:
                result, depth = folded
                outcome["via"] = "fold"
        if result is None:
            result = execute_plan(plan, session)
        return CachedResult(
            key, structure_key, result, pins,
            [_file_ids(n) for n in plan.preorder() if isinstance(n, FileScan)],
            fold_spec, depth, raw_plan, session,
        )

    entry, hit = RESULT_CACHE.get_or_compute(key, build)
    if hit:
        REGISTRY.counter("cache.result.hits").inc()
        plan_stats.note_route(plan.plan_id, "cached")
        _log_cache_index_usage(session, plan, "ResultCacheHit")
        if is_verify():
            _verify_or_raise(session, plan, entry.result, "hit")
    elif outcome["via"] == "fold":
        plan_stats.note_route(plan.plan_id, "folded")
        _log_cache_index_usage(session, plan, "ResultCacheFold")
        if is_verify():
            _verify_or_raise(session, plan, entry.result, "fold")
    return entry.result


def _log_cache_index_usage(session, plan, rule: str) -> None:
    """A served result bypasses the rules, so the indexes of the cached
    plan log their usage event here, through the rules' own chokepoint,
    and the avoided index scan is credited to the workload plane."""
    from ..plan.nodes import FileScan
    from ..rules.rule_utils import log_index_usage
    from ..telemetry import workload

    index_bytes: dict[str, int] = {}
    for n in plan.preorder():
        if isinstance(n, FileScan) and n.index_info is not None:
            name = n.index_info.index_name
            index_bytes[name] = index_bytes.get(name, 0) + sum(f.size for f in n.files)
    if not index_bytes:
        return
    names = sorted(index_bytes)
    log_index_usage(session, rule, names,
                    f"Result cache served plan using indexes: {', '.join(names)}")
    for name in names:
        workload.note_index_applied(name, index_bytes[name], rule=rule)


def result_cache_state_string() -> str:
    """Profile's ``== Result cache ==`` block."""
    s = RESULT_CACHE.state()
    lines = ["== Result cache =="]
    if s["mode"] == "0":
        lines.append("disabled (HYPERSPACE_RESULT_CACHE=0)")
        return "\n".join(lines)
    looked = s["hits"] + s["misses"]
    ratio = f"{s['hits'] / looked:.2%}" if looked else "n/a"
    lines.append(
        f"mode={s['mode']} entries={s['entries']} (foldable={s['foldable_entries']}) "
        f"bytes={s['bytes']}/{s['max_bytes']}"
    )
    lines.append(
        f"hits={s['hits']} misses={s['misses']} hit_ratio={ratio} evictions={s['evictions']}"
    )
    lines.append(
        f"folds={s['folds']} fold_rows={s['fold_rows']} refreshes={s['refreshes']} "
        f"verified={s['verified']}"
    )
    return "\n".join(lines)
