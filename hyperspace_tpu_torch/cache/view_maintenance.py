"""Incremental view maintenance over the ingest log (counterpart of
hyperspace_tpu/cache/view_maintenance.py).

An append publishes an immutable version whose content is ``old + delta``,
so for an exactly-foldable fragment

    agg(files_new) == agg(files_old) (+) agg(files_new - files_old)

bit for bit: integer adds are associative, min and max idempotent, and
SQL NULL (no qualifying row) is the identity of every fold. Three pieces:

- :func:`classify_plan`: a whole optimized plan folds when it is the
  fragment shape (a global Aggregate over [Project] over [Filter] over one
  FileScan) and each output is a Count, a non-string Min or Max, or an
  integer Sum; anything else recomputes on a miss;
- :func:`try_fold`: on a miss with same-template candidates at older
  snapshots, take one whose file set is a subset of the new plan's, run
  the fragment over the delta files only and fold the two one-row
  results. The delta plan runs through the ordinary executor, so its scan
  streams, prunes and dispatches on the card like any query's; a failure
  raises, never falls back to the host;
- :func:`maybe_refresh`: after a version advance (an append's commit, a
  background compaction), one wave per index on the shared IO pool runs
  each stale foldable entry's stored template again through the cache
  (a ``cache:refresh`` span, ``cache.result.refreshes``): it folds when the
  advance was additive and recomputes when compaction rewrote the layout.
  The JAX package also charges the wave to an attribution-ledger record of
  its own; the port has no attribution ledger yet.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class FoldSpec:
    """Per-output fold kinds of an exactly-foldable global aggregate."""

    names: tuple  # output column names, in plan order
    kinds: tuple  # "count" | "sum" | "min" | "max" per name


def classify_plan(plan) -> Optional[FoldSpec]:
    """A FoldSpec when ``plan`` is an exactly-foldable fragment, else None.
    Grouped aggregates are left out on purpose: their row order follows the
    first occurrence of each group, which an append can change, and the bar
    here is bit identity."""
    from ..columnar.table import STRING
    from ..plan import expr as X
    from ..plan.executor import _unwrap_agg
    from ..plan.gpu_exec import _match_fragment
    from ..plan.nodes import FileScan

    frag = _match_fragment(plan)
    if frag is None or frag.agg.group_exprs:
        return None
    if sum(isinstance(n, FileScan) for n in plan.preorder()) != 1:
        return None
    schema = plan.schema
    names, kinds = [], []
    for e in frag.agg.agg_exprs:
        name, agg = _unwrap_agg(e)
        if isinstance(agg, X.Count):
            kinds.append("count")
        elif isinstance(agg, (X.Min, X.Max)):
            if schema.field(name).dtype == STRING:
                return None  # dictionary codes do not decompose
            kinds.append("min" if isinstance(agg, X.Min) else "max")
        elif isinstance(agg, X.Sum) and schema.field(name).dtype.startswith("int"):
            kinds.append("sum")
        else:
            return None  # float sums and averages do not decompose exactly
        names.append(name)
    return FoldSpec(tuple(names), tuple(kinds))


def _is_null_scalar(col) -> bool:
    return col.validity is not None and not bool(col.validity[0])


def fold_results(old, delta, spec: FoldSpec):
    """Two one-row aggregate batches combined under ``spec``. NULL is the
    identity of every fold but count; two non-NULL sides share the plan's
    dtype, which is checked, not trusted."""
    import numpy as np

    from ..columnar.table import Column, ColumnBatch
    from ..exceptions import HyperspaceError

    out = {}
    for name, kind in zip(spec.names, spec.kinds):
        a = old.column(name)
        b = delta.column(name)
        if kind == "count":
            out[name] = Column(a.data.astype(np.int64) + b.data.astype(np.int64), "int64")
            continue
        if _is_null_scalar(a):
            out[name] = b
            continue
        if _is_null_scalar(b):
            out[name] = a
            continue
        if a.dtype != b.dtype:
            raise HyperspaceError(f"fold dtype drift on {name!r}: {a.dtype} vs {b.dtype}")
        if kind == "sum":
            data = a.data + b.data
        elif kind == "min":
            data = np.minimum(a.data, b.data)
        else:
            data = np.maximum(a.data, b.data)
        out[name] = Column(data, a.dtype)
    return ColumnBatch(out)


def _delta_scan_files(candidate, plan):
    """(the plan's scan, its files the candidate lacks) when the
    candidate's one scan reads a subset of the new plan's files; None when
    the advance was not additive (compaction rewrote runs: recompute)."""
    from ..plan.nodes import FileScan

    scans = [n for n in plan.preorder() if isinstance(n, FileScan)]
    if len(scans) != 1 or len(candidate.scan_files) != 1:
        return None
    new_ids = {(f.name, f.size, f.modified_time): f for f in scans[0].files}
    old_ids = candidate.scan_files[0]
    if not old_ids <= set(new_ids):
        return None
    return scans[0], [new_ids[i] for i in sorted(set(new_ids) - old_ids)]


def _delta_rows(files) -> int:
    """The delta's input rows from the footers (for the counter only)."""
    from ..columnar import io as cio

    try:
        return sum(cio.file_num_rows(f.name) for f in files)
    except Exception:
        return 0


def _fold_depth_cap() -> int:
    from ..utils import env

    return env.env_int("HYPERSPACE_RESULT_CACHE_FOLD_DEPTH")


def try_fold(session, plan, spec: FoldSpec, candidates):
    """(result, fold depth) from the first additive candidate, or None (the
    caller recomputes). The delta fragment runs through the ordinary
    executor in a ``cache:fold`` span."""
    from ..plan.executor import execute_plan
    from ..telemetry import trace
    from ..telemetry.metrics import REGISTRY

    cap = max(1, _fold_depth_cap())
    for cand in candidates:
        if cand.fold_spec != spec or cand.fold_depth >= cap:
            continue
        located = _delta_scan_files(cand, plan)
        if located is None:
            continue
        scan, delta = located
        if not delta:
            # the same bytes under a new entry id: the old result is the new
            return cand.result, cand.fold_depth
        with trace.span("cache:fold", delta_files=len(delta)):
            delta_plan = plan.transform_up(lambda n: n.copy(files=delta) if n is scan else n)
            delta_result = execute_plan(delta_plan, session)
            result = fold_results(cand.result, delta_result, spec)
        REGISTRY.counter("cache.result.folds").inc()
        REGISTRY.counter("cache.result.fold_rows").inc(_delta_rows(delta))
        return result, cand.fold_depth + 1
    return None


# --- background refresh (the ingest log's hook) ---

_REFRESH_LOCK = threading.Lock()
_REFRESH_INFLIGHT: set = set()  # abspath(index_path) with a wave in flight


def refresh_idle() -> bool:
    """True when no background refresh wave is scheduled or running."""
    with _REFRESH_LOCK:
        return not _REFRESH_INFLIGHT


def maybe_refresh(session, index_name: str) -> int:
    """Schedule the background refresh of every stale foldable entry pinned
    to ``index_name`` (after an append's commit and after a background
    compaction). Returns the entries scheduled; 0 with the cache off or
    empty, or while a wave of the index is in flight."""
    from .result_cache import RESULT_CACHE, enabled

    if not enabled():
        return 0
    from ..meta.path_resolver import PathResolver

    index_path = os.path.abspath(
        PathResolver(session.conf, session.warehouse_dir).get_index_path(index_name))
    latest = _latest_entry_id(session, index_name)
    if latest is None:
        return 0
    stale = [
        e for e in RESULT_CACHE.entries_for_index(index_path)
        if e.fold_spec is not None and e.raw_plan is not None
        and any(s.index_path == index_path and s.entry_id < latest for s in e.snapshots)
    ]
    if not stale:
        return 0
    with _REFRESH_LOCK:
        if index_path in _REFRESH_INFLIGHT:
            return 0
        _REFRESH_INFLIGHT.add(index_path)
    from ..utils.workers import shared_io_pool

    shared_io_pool().submit(_refresh_wave, index_path, stale)
    return len(stale)


def _latest_entry_id(session, index_name: str) -> Optional[int]:
    from ..ingest import latest_stable_entry

    entry = latest_stable_entry(session, index_name)
    return None if entry is None else entry.id


def _refresh_wave(index_path: str, entries) -> None:
    """Every scheduled refresh of one index, then the in-flight marker
    cleared. One template failing (its session gone, its index dropped)
    never blocks the others; the failure is logged."""
    try:
        for entry in entries:
            try:
                _refresh_entry(entry)
            except BaseException:
                logger.warning("background result-cache refresh failed", exc_info=True)
    finally:
        with _REFRESH_LOCK:
            _REFRESH_INFLIGHT.discard(index_path)


def _refresh_entry(entry) -> None:
    """Run one cached template again against the live source: its source
    files resolved anew (the stored plan's leaves predate the append), then
    an ordinary collect, which probes the cache, folds when additive,
    recomputes otherwise, and stores the result at the new snapshot. The
    work is charged to its own ``cache:refresh`` ledger record, so
    per-query attribution stays conserved while refreshes interleave with
    serving traffic."""
    from ..plan.dataframe import DataFrame
    from ..serve.context import QueryContext
    from ..telemetry import attribution, trace
    from ..telemetry.attribution import LEDGER
    from ..telemetry.metrics import REGISTRY

    session = entry.session_ref() if entry.session_ref is not None else None
    if session is None:
        return
    stats = LEDGER.begin(QueryContext(label="cache:refresh"))
    try:
        with trace.span("cache:refresh"), attribution.scope(stats):
            plan = _reresolve_sources(session, entry.raw_plan)
            DataFrame(session, plan).collect()
            # inside the scope: the refresh's own counters (this one
            # included) charge its record
            REGISTRY.counter("cache.result.refreshes").inc()
    except BaseException as e:
        LEDGER.finish(stats, "failed", e)
        raise
    LEDGER.finish(stats, "done")


def _reresolve_sources(session, raw_plan):
    """The stored pre-optimization plan with each source FileScan's files
    listed anew from its roots (the index rewrite matches only when the
    query's source files equal what the latest entry signed)."""
    from ..plan.nodes import FileScan

    def fresh(n):
        if not isinstance(n, FileScan) or n.index_info is not None:
            return n
        reader = session.read
        reader._options = dict(n.options)
        return reader._load(n.fmt, n.root_paths).plan

    return raw_plan.transform_up(fresh)
