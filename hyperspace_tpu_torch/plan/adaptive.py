"""Mid-query adaptive re-optimization (counterpart of
hyperspace_tpu/plan/adaptive.py): runtime actuals steer the running query,
at three sites, each switch bit-identical by construction (the snapshot is
pinned for the whole collect, and per-bucket or per-chunk partials fold to
exactly the monolithic result):

1. **Per-bucket-pair join re-planning**: as the first pairs of a bucketed
   join retire, ``device_join`` feeds each pair's observed bytes to
   ``JoinMemoryPlan.observe_actual``, and later pairs re-derive broadcast,
   banded or split with the observed-over-predicted correction
   (plan/join_memory.JoinMemoryPlan.split_rows). A flipped strategy changes
   how a pair is dispatched, never its values.
2. **Filter conjunct reordering**: the host Filter measures each
   conjunct's selectivity and cost over the warmup chunks, then evaluates
   the most selective and cheapest first, on the surviving rows only
   (``conjunct_mask``). AND commutes, so the mask is the same in any order.
3. **Scan abort-and-replan**: a streamed index scan whose pruning keeps
   ``HYPERSPACE_ADAPTIVE_ABORT_FACTOR`` times more than its ``PruneSpec``
   predicted aborts at a chunk boundary after the warmup chunks
   (``monitor_scan_chunks``); the index is vetoed for the query, and the
   collect loop re-plans against the same pinned snapshot
   (``execute_collect``), to the next candidate or the raw scan.

``HYPERSPACE_ADAPTIVE``: ``0`` (default) off, every hook one mode read;
``1`` adapts; ``verify`` adapts and reruns the final plan statically,
raising on any difference at ``.hex()`` precision. Every switch becomes a
plan-statistics event (EXPLAIN ANALYZE's ``[adapted: banded→split @pair
7]``), a workload-journal note, an ``adaptive.*`` counter and an
``adapt.*`` estimator observation.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

import numpy as np

from ..exceptions import HyperspaceError
from ..telemetry import trace
from ..telemetry.metrics import REGISTRY
from ..utils import env

# a query aborts and re-plans at most this many times; then the monitor
# disarms and the running plan runs to its end
_MAX_REPLANS = 2

# the conjunct reorder's evaluation chunk
_REORDER_CHUNK_ROWS = 1 << 16

# EXPLAIN ANALYZE's unit per site
SITE_UNITS = {"replan": "pair", "reorder": "chunk", "abort": "chunk"}

_FORCED: contextvars.ContextVar = contextvars.ContextVar("hs_adaptive_forced", default=None)
_REPLAN: contextvars.ContextVar = contextvars.ContextVar("hs_adaptive_replan", default=None)


# --- mode and knobs ----------------------------------------------------------

def mode() -> str:
    """``HYPERSPACE_ADAPTIVE``: "0" (default, off) / "1" / "verify"; a
    ``force_mode`` scope overrides it (the verify baseline)."""
    forced = _FORCED.get()
    if forced is not None:
        return forced
    v = env.env_str("HYPERSPACE_ADAPTIVE").strip().lower()
    if v == "verify":
        return "verify"
    if v in ("1", "true", "on"):
        return "1"
    return "0"


def active() -> bool:
    return mode() != "0"


def abort_factor() -> float:
    try:
        return env.env_float("HYPERSPACE_ADAPTIVE_ABORT_FACTOR")
    except ValueError:
        return float(env.DEFAULTS["HYPERSPACE_ADAPTIVE_ABORT_FACTOR"])


def warmup_chunks() -> int:
    try:
        return max(1, env.env_int("HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS"))
    except ValueError:
        return int(env.DEFAULTS["HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS"])


class force_mode:
    """Pin ``mode()`` to ``value`` for the block, over the knob."""

    __slots__ = ("_value", "_token")

    def __init__(self, value: str):
        self._value = value
        self._token = None

    def __enter__(self):
        self._token = _FORCED.set(self._value)
        return self

    def __exit__(self, *exc) -> bool:
        _FORCED.reset(self._token)
        return False


# --- switch events -----------------------------------------------------------

def record_switch(site: str, from_: str, to: str, *, index: str = "",
                  ratio: float = 0.0, at: int = 0) -> None:
    """One adaptation: a counter, a plan-statistics event, a journal note
    and a zero-width span. ``site`` is replan / reorder / abort, ``at`` the
    pair or chunk it took effect at, ``ratio`` the observed-over-predicted
    trigger."""
    REGISTRY.counter(f"adaptive.{site}").inc()
    from ..telemetry import plan_stats, workload

    plan_stats.note_switch(site, from_, to, index=index, ratio=ratio, at=at)
    workload.note_adaptive(site, from_, to, index=index, ratio=ratio, at=at)
    if trace.enabled():
        with trace.span(f"adapt:{site}", index=index, at=int(at),
                        ratio=round(float(ratio), 3), **{"from": from_, "to": to}):
            pass


# --- site 3: scan abort-and-replan ---------------------------------------------

class ScanAbortAndReplan(HyperspaceError):
    """Raised at a chunk boundary by the scan monitor; only
    ``execute_collect``'s replan loop catches it."""

    def __init__(self, index_name: str, ratio: float, at_chunk: int):
        super().__init__(
            f"index scan {index_name!r} underdelivered its prune prediction "
            f"({ratio:.1f}x): abort at chunk {at_chunk} and replan"
        )
        self.index_name = index_name
        self.ratio = ratio
        self.at_chunk = at_chunk


def vetoed_indexes() -> frozenset:
    """The indexes this query's replan loop aborted out of (the candidate
    collector drops them); empty outside a replan scope."""
    st = _REPLAN.get()
    return frozenset(st["vetoed"]) if st is not None else frozenset()


def monitor_scan_chunks(chunks, scan, selection):
    """``chunks`` wrapped in the abort monitor, or unchanged unless the query
    is in an armed replan scope and the scan's pruning kept
    ``HYPERSPACE_ADAPTIVE_ABORT_FACTOR`` times its prediction. The monitored
    stream yields the warmup chunks, then raises ``ScanAbortAndReplan`` at
    the next boundary (never when the scan ends inside the warmup)."""
    if not active():
        return chunks
    st = _REPLAN.get()
    if st is None or st["replans"] >= _MAX_REPLANS:
        return chunks
    spec = scan.prune_spec
    if spec is None or scan.index_info is None:
        return chunks
    if spec.index_name in st["vetoed"]:
        return chunks
    from . import pruning

    ratio, predicted, actual = pruning.prune_underdelivery(scan, selection)
    if predicted <= 0 or ratio < abort_factor():
        return chunks
    from ..columnar import io as cio

    _row_groups, files = selection
    total = cio.count_chunk_groups([f.name for f in files])
    warm = warmup_chunks()
    if total <= warm:
        return chunks
    from ..telemetry import plan_stats

    plan_stats.observe("adapt.scan_fraction", predicted, actual,
                       index=spec.index_name, plan_id=scan.plan_id)
    return _monitored(chunks, spec.index_name, ratio, warm)


def _monitored(inner, index_name: str, ratio: float, warm: int):
    try:
        n = 0
        for chunk in inner:
            yield chunk
            n += 1
            if n >= warm:
                record_switch("abort", index_name, "replan", index=index_name,
                              ratio=ratio, at=n)
                raise ScanAbortAndReplan(index_name, ratio, n)
    finally:
        inner.close()  # stops the read-ahead


# --- site 2: conjunct reordering -----------------------------------------------

def _conjunct_data_mask(conj, batch) -> np.ndarray:
    """A conjunct's share of the top-level AND: the ``data & validity`` of
    its Kleene result (the Filter consumes only ``data``, and ``data`` is
    within ``valid`` at every level)."""
    c = conj.eval(batch)
    d = np.asarray(c.data, dtype=bool)
    if c.validity is not None:
        d = d & c.validity
    return d


def conjunct_mask(condition, batch) -> Optional[np.ndarray]:
    """The host Filter's adaptive mask, or None for the static path (off,
    not a multi-conjunct AND, or too few rows to learn from). The first
    ``HYPERSPACE_ADAPTIVE_WARMUP_CHUNKS`` chunks of ``_REORDER_CHUNK_ROWS``
    evaluate every conjunct in written order, measuring selectivity and
    cost; the rest evaluate most selective and cheapest first, each on the
    rows still alive."""
    if not active():
        return None
    from .expr import And, split_conjunction

    if not isinstance(condition, And):
        return None
    conjuncts = split_conjunction(condition)
    k = len(conjuncts)
    if k < 2:
        return None
    n = batch.num_rows
    warm = warmup_chunks()
    if n <= _REORDER_CHUNK_ROWS * (warm + 1):
        return None
    refs = [sorted(c.references()) for c in conjuncts]
    if any(not r for r in refs):
        return None  # a constant conjunct: the static evaluator's

    out = np.empty(n, dtype=bool)
    kept = [0] * k
    cost = [0.0] * k
    seen = 0
    warm_rows = min(warm * _REORDER_CHUNK_ROWS, n)
    for lo in range(0, warm_rows, _REORDER_CHUNK_ROWS):
        hi = min(lo + _REORDER_CHUNK_ROWS, warm_rows)
        chunk = batch.slice(lo, hi)
        acc = np.ones(hi - lo, dtype=bool)
        for i, conj in enumerate(conjuncts):
            t0 = time.perf_counter()
            m = _conjunct_data_mask(conj, chunk)
            cost[i] += time.perf_counter() - t0
            kept[i] += int(m.sum())
            acc &= m
        out[lo:hi] = acc
        seen += hi - lo

    # most selective first, then cheapest, then written order
    order = sorted(range(k), key=lambda i: (kept[i] / max(seen, 1), cost[i] / max(seen, 1), i))
    if order != list(range(k)):
        record_switch(
            "reorder",
            ",".join(str(i) for i in range(k)),
            ",".join(str(i) for i in order),
            ratio=1.0 - kept[order[0]] / max(seen, 1),
            at=warm,
        )

    from ..columnar.table import ColumnBatch

    for lo in range(warm_rows, n, _REORDER_CHUNK_ROWS):
        hi = min(lo + _REORDER_CHUNK_ROWS, n)
        chunk = batch.slice(lo, hi)
        alive = np.ones(hi - lo, dtype=bool)
        for i in order:
            idx = np.nonzero(alive)[0]
            if not idx.size:
                break
            if idx.size == hi - lo:
                alive &= _conjunct_data_mask(conjuncts[i], chunk)
                continue
            sub = ColumnBatch({c: chunk.column(c).take(idx) for c in refs[i]})
            alive[idx] = _conjunct_data_mask(conjuncts[i], sub)
        out[lo:hi] = alive
    return out


# --- site 1: the join re-plan's warmup ---------------------------------------

def join_warmup_pairs() -> int:
    """Bucket pairs observed before a later pair's strategy may flip."""
    return warmup_chunks()


# --- the collect orchestrator --------------------------------------------------

def execute_collect(session, raw_plan, optimized, reoptimize):
    """The collect chokepoint: mode 0 is ``serve_collect``; 1 and verify
    install the replan scope, answer ``ScanAbortAndReplan`` by vetoing the
    index and re-optimizing against the same pinned snapshot, and (verify)
    rerun the final plan statically, raising on a difference."""
    from ..cache.result_cache import serve_collect

    m = mode()
    if m == "0":
        return serve_collect(session, raw_plan, optimized)
    st = {"replans": 0, "vetoed": set()}
    token = _REPLAN.set(st)
    plan = optimized
    try:
        while True:
            try:
                out = serve_collect(session, raw_plan, plan)
                break
            except ScanAbortAndReplan as e:
                st["vetoed"].add(e.index_name)
                st["replans"] += 1
                REGISTRY.counter("adaptive.scan_replans").inc()
                plan = reoptimize()
    finally:
        _REPLAN.reset(token)
    if m == "verify":
        _verify_static(session, plan, out)
    return out


def same_values(a, b) -> bool:
    """``pruning._comparable(a) == pruning._comparable(b)`` without building
    Python lists (the JAX package's comparison, which takes seconds over a
    few million groups): the same names, dtypes and nulls, strings by value,
    other values equal, floats bit for bit with every NaN alike (as
    ``float.hex`` renders them)."""
    from ..columnar.table import STRING

    if list(a.columns) != list(b.columns):
        return False
    for name in a.columns:
        ca, cb = a.column(name), b.column(name)
        if ca.dtype != cb.dtype or len(ca.data) != len(cb.data):
            return False
        n = len(ca.data)
        va = ca.validity if ca.validity is not None else np.ones(n, dtype=bool)
        vb = cb.validity if cb.validity is not None else np.ones(n, dtype=bool)
        if not np.array_equal(va, vb):
            return False
        if ca.dtype == STRING:
            xa = np.asarray(ca.dictionary, dtype=object)[np.asarray(ca.data)[va]]
            xb = np.asarray(cb.dictionary, dtype=object)[np.asarray(cb.data)[vb]]
            if not np.array_equal(xa, xb):
                return False
            continue
        xa, xb = np.asarray(ca.data)[va], np.asarray(cb.data)[vb]
        if xa.dtype.kind == "f" or xb.dtype.kind == "f":
            xa, xb = xa.astype(np.float64), xb.astype(np.float64)
            na, nb = np.isnan(xa), np.isnan(xb)
            if not np.array_equal(na, nb):
                return False
            if not np.array_equal(xa[~na].view(np.uint64), xb[~nb].view(np.uint64)):
                return False
        elif not np.array_equal(xa, xb):
            return False
    return True


def _verify_static(session, plan, out) -> None:
    """Run the final plan again with every adaptation pinned off and
    require the same values (floats at ``.hex()`` precision)."""
    from .executor import execute_plan

    with force_mode("0"):
        baseline = execute_plan(plan, session)
    if not same_values(out, baseline):
        raise HyperspaceError(
            "HYPERSPACE_ADAPTIVE=verify mismatch: adaptive execution "
            "diverges from the static run of the same plan"
        )
    REGISTRY.counter("adaptive.verified").inc()
