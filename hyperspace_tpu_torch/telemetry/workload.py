"""Workload intelligence plane: durable journal + drift detection
(counterpart of hyperspace_tpu/telemetry/workload.py).

Hyperspace's core loop is candidate generation and what-if analysis over an
*observed workload*, but the query log (attribution.py) is a bounded
in-memory window that dies with the process. This module adds the durable
substrate an index advisor consumes:

- **Durable workload journal.** Every finished query — served and direct
  ``collect:<RootKind>`` records alike, because both funnel through
  ``QueryStatsLedger.finish`` — appends one structured JSONL record to a
  size-rotated journal under ``HYPERSPACE_WORKLOAD_DIR``. The record is the
  query-log record plus a ``workload`` block: normalized predicate shapes
  (the plan/pruning.py ``predicate_shape`` vocabulary), join keys, columns
  touched, candidate indexes with their ``tag_reason_if`` reject codes,
  chosen index + prune kind, and per-estimator q-error counts. Writes run
  on the shared IO pool OUTSIDE any query lock; the reader skips torn tail
  lines (crash tolerance); rotation + bounded retention mirror the
  slow-query sink. Unset (the default) the plane is completely off: zero
  writes, zero spans, bit-identical results (tests pin it).

- **Per-index utility attribution.** Chokepoints across rules / pruning /
  actions note what each index did for (and cost) each query into the
  running ``QueryStats``; ``on_query_finished`` settles the notes into the
  process-wide :class:`~.index_ledger.IndexUtilityLedger` AND mirrors every
  charge into ``workload.index.*`` / ``workload.maintenance.*`` counters at
  the same site with the same value — so per-index sums conserve against
  the global counter deltas exactly.

- **Drift detection.** :class:`DriftDetector` freezes the FIRST
  ``HYPERSPACE_WORKLOAD_BASELINE`` observations per key as the baseline and
  compares a rolling ``HYPERSPACE_WORKLOAD_WINDOW`` against it — per query
  label (``serve.query.total_ms`` medians) and per estimator
  (``estimator.qerror.*`` geomeans). Crossing
  ``HYPERSPACE_WORKLOAD_DRIFT_FACTOR`` emits ``workload.drift.*`` counters
  (on the transition, not per sample) and a structured regressions list
  surfaced by ``hs.workload_report()``, the exporter ``/snapshot``
  ``workload`` block, and ``/healthz`` degraded-reasons.

Fault point: ``workload.journal`` (utils/faults.py) brackets the journal
line write — ``crash_after`` dies between the payload and its newline, the
torn-tail case ``load()`` must absorb.
"""

from __future__ import annotations

import collections
import contextvars
import json
import math
import os
import statistics
import threading
import time
from typing import Optional

from ..utils import env, faults
from .index_ledger import INDEX_LEDGER

_JOURNAL_NAME = "workload.jsonl"
_NOTE_CAP = 64  # bounded per-query note lists (journal rows stay small)


def enabled() -> bool:
    """The whole plane keys off ``HYPERSPACE_WORKLOAD_DIR``: unset means no
    notes, no charges, no writes — the bit-identical default."""
    return bool(env.env_str("HYPERSPACE_WORKLOAD_DIR"))


def journal_dir() -> Optional[str]:
    return env.env_str("HYPERSPACE_WORKLOAD_DIR") or None


def _current_stats():
    from .attribution import _attr_target

    return _attr_target.get()


# ---------------------------------------------------------------------------
# per-query note chokepoints (rules / pruning / cache call these)
# ---------------------------------------------------------------------------

def note_plan(plan) -> None:
    """Called once per collect with the optimized plan: join keys, columns
    touched, and predicate shapes ride the query's workload notes."""
    if not enabled():
        return
    stats = _current_stats()
    if stats is None:
        return
    try:
        from ..plan.nodes import FileScan, Filter, Join
        from ..plan.pruning import predicate_shape

        cols: set = set()
        for n in plan.preorder():
            if isinstance(n, Join) and n.condition is not None:
                keys = ",".join(sorted(n.condition.references()))
                stats.note_workload("join_keys", keys, cap=_NOTE_CAP)
            elif isinstance(n, Filter):
                refs = tuple(sorted(n.condition.references()))
                shape = predicate_shape(n.condition, refs)
                if shape:
                    stats.note_workload("shapes", shape, cap=_NOTE_CAP)
            elif isinstance(n, FileScan):
                cols |= set(n.required_columns or n.full_schema.names)
                if n.prune_spec is not None and n.pushed_filter is not None:
                    shape = predicate_shape(
                        n.pushed_filter, n.prune_spec.key_columns
                    )
                    if shape:
                        stats.note_workload("shapes", shape, cap=_NOTE_CAP)
        for c in sorted(cols):
            stats.note_workload("columns", c, cap=_NOTE_CAP * 4)
    except Exception:  # noqa: BLE001 - notes must never fail a collect
        pass


def note_candidate_reject(index_names, code: str) -> None:
    """``tag_reason_if`` chokepoint: which candidate indexes the rules
    rejected for this query, and why (the whyNot reject code)."""
    if not enabled():
        return
    stats = _current_stats()
    if stats is None:
        return
    for name in index_names:
        stats.note_workload(
            "candidates", {"index": name, "code": code}, cap=_NOTE_CAP
        )


def note_index_applied(index_name: str, raw_bytes: int,
                       rule: str = "rewrite") -> None:
    """A rewrite (or a result-cache serve) chose ``index_name``;
    ``raw_bytes`` is the counterfactual cost — the source bytes the replaced
    leaf (or the avoided index scan) would have decoded. Settled into the
    utility ledger at finish, so only executed queries charge benefit."""
    if not enabled():
        return
    stats = _current_stats()
    if stats is None:
        return
    stats.note_workload(
        "applied",
        {"index": index_name, "raw_bytes": int(raw_bytes), "rule": rule},
        cap=_NOTE_CAP,
    )


def note_prune(index_name: str, kind: str, shape: str = "",
               bytes_skipped: int = 0, rowgroups_skipped: int = 0) -> None:
    """Pruning chokepoints (bucket stage at plan time, row-group/sketch
    stage at exec time): per-index skip deltas, noted with the SAME values
    the global ``pruning.*`` counters were just incremented by — that is
    what makes the per-index sums conserve against them."""
    if not enabled():
        return
    stats = _current_stats()
    if stats is None:
        return
    stats.note_workload(
        "pruned",
        {
            "index": index_name, "kind": kind, "shape": shape,
            "bytes_skipped": int(bytes_skipped),
            "rowgroups_skipped": int(rowgroups_skipped),
        },
        cap=_NOTE_CAP,
    )


# ---------------------------------------------------------------------------
# maintenance attribution (actions/base.py + sketch_store call these)
# ---------------------------------------------------------------------------

_MAINT_INDEX: contextvars.ContextVar = contextvars.ContextVar(
    "hs_maintenance_index", default=None
)

_ACTION_KINDS = (
    ("create", "create"), ("append", "ingest_delta"), ("ingest", "ingest_delta"),
    ("compact", "compact"), ("vacuum", "vacuum"), ("refresh", "refresh"),
    ("optimize", "optimize"), ("restore", "restore"), ("delete", "delete"),
    ("cancel", "cancel"),
)


def action_kind(action_name: str) -> str:
    n = action_name.lower()
    for needle, kind in _ACTION_KINDS:
        if needle in n:
            return kind
    return n


class maintenance_scope:
    """Installed by ``Action.run`` so nested chokepoints (sketch sidecar
    writes) can attribute to the index under maintenance."""

    __slots__ = ("_name", "_token")

    def __init__(self, index_name: str):
        self._name = index_name
        self._token = None

    def __enter__(self):
        self._token = _MAINT_INDEX.set(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        _MAINT_INDEX.reset(self._token)
        return False


def charge_maintenance(index_path: str, action_name: str, wall_s: float,
                       outcome: str = "succeeded") -> None:
    """``Action.run`` chokepoint: every index-mutating transaction charges
    its wall time as maintenance cost against the index it mutated."""
    if not enabled():
        return
    try:
        from .metrics import REGISTRY

        name = os.path.basename(os.path.abspath(index_path))
        kind = action_kind(action_name)
        INDEX_LEDGER.maybe_recover(journal_dir())
        INDEX_LEDGER.charge_maintenance(name, kind, wall_s, outcome)
        REGISTRY.counter("workload.maintenance.actions").inc()
        REGISTRY.counter("workload.maintenance.ms").inc(
            round(wall_s * 1000, 3)
        )
        _persist_ledger()
    except Exception:  # noqa: BLE001 - attribution must never fail an action
        pass


def charge_sketch_write() -> None:
    """Sketch sidecar write chokepoint: counted as a ``sketch`` maintenance
    action against the index currently under maintenance (best-effort: a
    write outside any maintenance scope has no index to charge)."""
    if not enabled():
        return
    name = _MAINT_INDEX.get()
    if name is None:
        return
    try:
        from .metrics import REGISTRY

        INDEX_LEDGER.charge_maintenance(name, "sketch", 0.0, "succeeded")
        REGISTRY.counter("workload.maintenance.actions").inc()
    except Exception:  # noqa: BLE001 - attribution must never fail a write
        pass


# ---------------------------------------------------------------------------
# the durable journal
# ---------------------------------------------------------------------------

class WorkloadJournal:
    """Size-rotated JSONL journal under ``HYPERSPACE_WORKLOAD_DIR``.

    One leaf lock serializes append + rotation (file IO inside, the
    slow-query-sink precedent); appends are submitted to the shared IO pool
    by ``on_query_finished`` so no query lock is ever held across a write.
    ``load()`` skips any line that fails to parse — a torn tail from a
    crash mid-write costs that one record, never the journal."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._size = 0  # current journal file size (cached)
        self._checked_tail = False
        self._writes = 0
        self._rotations = 0
        self._pending: set = set()

    # --- config -----------------------------------------------------------

    @staticmethod
    def _config() -> tuple:
        return (
            journal_dir(),
            max(1024.0, env.env_float("HYPERSPACE_WORKLOAD_ROTATE_MB") * 1e6),
            max(1, env.env_int("HYPERSPACE_WORKLOAD_RETAIN")),
        )

    def _sync_dir(self, d: str) -> None:
        """Under the lock: (re)anchor cached state when the dir changes."""
        if self._dir != d:
            self._dir = d
            self._checked_tail = False
            path = os.path.join(d, _JOURNAL_NAME)
            try:
                self._size = os.path.getsize(path)
            except OSError:
                self._size = 0

    # --- write path -------------------------------------------------------

    def submit(self, record: dict) -> None:
        """Queue one record for append on the shared IO pool (the
        ``on_query_finished`` path — never block a finishing query on
        disk)."""
        from ..utils.workers import shared_io_pool

        fut = shared_io_pool().submit(self._append_safe, record)
        with self._lock:
            self._pending.add(fut)
        fut.add_done_callback(self._discard_pending)

    def _discard_pending(self, fut) -> None:
        with self._lock:
            self._pending.discard(fut)

    def flush(self, timeout_s: float = 30.0) -> None:
        """Wait for queued appends to land (tests, reports)."""
        import concurrent.futures

        with self._lock:
            pending = list(self._pending)
        if pending:
            concurrent.futures.wait(pending, timeout=timeout_s)

    def _append_safe(self, record: dict) -> None:
        from .metrics import REGISTRY

        try:
            self.append(record)
        except Exception:  # noqa: BLE001 - a full disk must not kill the pool
            REGISTRY.counter("workload.journal.errors").inc()

    def append(self, record: dict) -> None:
        """Synchronous append + rotation (the IO-pool task body; tests call
        it directly for deterministic fault injection)."""
        d, rotate_bytes, retain = self._config()
        if not d:
            return
        line = json.dumps(record, default=str)
        faults.fire("workload.journal")
        with self._lock:
            os.makedirs(d, exist_ok=True)
            self._sync_dir(d)
            path = os.path.join(d, _JOURNAL_NAME)
            if not self._checked_tail:
                self._checked_tail = True
                self._heal_torn_tail(path)
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                # crash_after dies HERE: payload on disk, newline not —
                # the torn tail load() must skip
                faults.fire_after("workload.journal")
                f.write("\n")
            self._size += len(line) + 1
            self._writes += 1
            if self._size >= rotate_bytes:
                self._rotate(d, path, retain)
        from .metrics import REGISTRY

        REGISTRY.counter("workload.journal.records").inc()

    def _heal_torn_tail(self, path: str) -> None:
        """First append of a process: a predecessor that died mid-write left
        the file without a trailing newline — terminate that torn line so
        the next record starts clean (the torn line itself stays skipped)."""
        try:
            with open(path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
                    self._size += 1
        except OSError:  # healing is best-effort; load() skips torn lines anyway
            pass

    def _rotate(self, d: str, path: str, retain: int) -> None:
        """Under the lock: current file -> next rotated slot, oldest slots
        past the retention bound deleted."""
        seqs = self._rotated_seqs(d)
        nxt = (seqs[-1] + 1) if seqs else 1
        try:
            os.replace(path, os.path.join(d, f"workload.{nxt:06d}.jsonl"))
        except OSError:
            return
        self._size = 0
        self._rotations += 1
        for seq in self._rotated_seqs(d)[:-retain]:
            try:
                os.remove(os.path.join(d, f"workload.{seq:06d}.jsonl"))
            except OSError:  # retention is best-effort; retried next rotation
                pass
        from .metrics import REGISTRY

        REGISTRY.counter("workload.journal.rotations").inc()

    @staticmethod
    def _rotated_seqs(d: str) -> list[int]:
        out = []
        try:
            names = os.listdir(d)
        except OSError:
            return []
        for n in names:
            parts = n.split(".")
            if (
                len(parts) == 3 and parts[0] == "workload"
                and parts[2] == "jsonl" and parts[1].isdigit()
            ):
                out.append(int(parts[1]))
        return sorted(out)

    # --- read path --------------------------------------------------------

    def files(self, d: Optional[str] = None) -> list[str]:
        """Rotation-ordered journal files (oldest first, current last)."""
        d = d or journal_dir()
        if not d:
            return []
        out = [
            os.path.join(d, f"workload.{seq:06d}.jsonl")
            for seq in self._rotated_seqs(d)
        ]
        cur = os.path.join(d, _JOURNAL_NAME)
        if os.path.exists(cur):
            out.append(cur)
        return out

    def load(self, d: Optional[str] = None,
             limit: Optional[int] = None) -> list[dict]:
        """Every parseable journal record in write order; torn/corrupt
        lines are skipped (counted in ``workload.journal.torn_skipped``)."""
        records: list[dict] = []
        torn = 0
        for path in self.files(d):
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            records.append(json.loads(line))
                        except ValueError:
                            torn += 1
            except OSError:
                continue
        if torn:
            from .metrics import REGISTRY

            REGISTRY.counter("workload.journal.torn_skipped").inc(torn)
        if limit is not None:
            records = records[-limit:]
        return records

    def state(self) -> dict:
        d = journal_dir()
        with self._lock:
            st = {
                "enabled": bool(d),
                "dir": d,
                "writes": self._writes,
                "rotations": self._rotations,
                "current_bytes": self._size if d else 0,
            }
        st["files"] = len(self.files(d)) if d else 0
        return st

    def reset_for_testing(self) -> None:
        self.flush(timeout_s=5.0)
        with self._lock:
            self._dir = None
            self._size = 0
            self._checked_tail = False
            self._writes = 0
            self._rotations = 0


JOURNAL = WorkloadJournal()


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------

class DriftDetector:
    """Rolling-window vs frozen-baseline comparison per key.

    Keys are ``("latency", label)`` fed from finished-query records and
    ``("estimator", name)`` fed from the accuracy ledger. The first
    ``HYPERSPACE_WORKLOAD_BASELINE`` samples freeze the baseline; the last
    ``HYPERSPACE_WORKLOAD_WINDOW`` form the comparison window. Latency
    compares medians, estimators compare geomean q-errors (values stored as
    logs); a ratio past ``HYPERSPACE_WORKLOAD_DRIFT_FACTOR`` with at least
    ``HYPERSPACE_WORKLOAD_DRIFT_MIN`` samples on both sides is a
    regression (latency additionally requires the window median to clear
    the baseline by ``HYPERSPACE_WORKLOAD_DRIFT_ABS_MS``). Counters fire on the transition INTO drift, so a sustained
    regression is one event, not one per query."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[tuple, dict] = {}

    @staticmethod
    def _config() -> tuple:
        return (
            max(1, env.env_int("HYPERSPACE_WORKLOAD_BASELINE")),
            max(1, env.env_int("HYPERSPACE_WORKLOAD_WINDOW")),
            max(1.0, env.env_float("HYPERSPACE_WORKLOAD_DRIFT_FACTOR")),
            max(1, env.env_int("HYPERSPACE_WORKLOAD_DRIFT_MIN")),
            max(0.0, env.env_float("HYPERSPACE_WORKLOAD_DRIFT_ABS_MS")),
        )

    def observe_latency(self, label: str, total_ms: float) -> None:
        self._observe(("latency", label), float(total_ms))

    def observe_qerror(self, estimator: str, q: float) -> None:
        # stored as log(q): the window mean is then the log-geomean
        self._observe(("estimator", estimator), math.log(max(q, 1e-9)))

    def _observe(self, key: tuple, value: float) -> None:
        base_n, win, factor, min_n, abs_ms = self._config()
        transition = None
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "baseline": [],
                    "recent": collections.deque(maxlen=win),
                    "in_drift": False,
                }
            if len(s["baseline"]) < base_n:
                s["baseline"].append(value)
            else:
                s["recent"].append(value)
            reg = self._evaluate(key, s, factor, min_n, abs_ms)
            was = s["in_drift"]
            s["in_drift"] = reg is not None
            if reg is not None and not was:
                transition = reg
        from .metrics import REGISTRY

        REGISTRY.counter("workload.drift.checks").inc()
        if transition is not None:
            REGISTRY.counter(f"workload.drift.{key[0]}").inc()
            from . import trace

            if trace.enabled():
                trace.add_event("workload:drift", **transition)

    @staticmethod
    def _evaluate(key: tuple, s: dict, factor: float,
                  min_n: int, abs_ms: float = 0.0) -> Optional[dict]:
        base, recent = s["baseline"], s["recent"]
        if len(base) < min_n or len(recent) < min_n:
            return None
        kind = key[0]
        if kind == "estimator":
            b = math.exp(sum(base) / len(base))
            c = math.exp(sum(recent) / len(recent))
        else:
            b = statistics.median(base)
            c = statistics.median(recent)
        ratio = c / max(b, 1e-9)
        if ratio <= factor:
            return None
        # Scheduler/GC jitter makes microsecond-scale medians ratio-noisy:
        # a latency regression must also clear an absolute floor.
        if kind == "latency" and (c - b) < abs_ms:
            return None
        return {
            "kind": kind, "key": key[1],
            "baseline": round(b, 3), "current": round(c, 3),
            "ratio": round(ratio, 3),
            "baseline_n": len(base), "window_n": len(recent),
        }

    def regressions(self) -> list[dict]:
        """Structured list of keys currently past the drift bound."""
        _, _, factor, min_n, abs_ms = self._config()
        out = []
        with self._lock:
            items = [(k, dict(s, baseline=list(s["baseline"]),
                              recent=collections.deque(s["recent"])))
                     for k, s in sorted(self._series.items())]
        for key, s in items:
            reg = self._evaluate(key, s, factor, min_n, abs_ms)
            if reg is not None:
                out.append(reg)
        return out

    def snapshot(self) -> dict:
        base_n, win, factor, min_n, _abs_ms = self._config()
        with self._lock:
            n = len(self._series)
        return {
            "series": n,
            "baseline_n": base_n,
            "window": win,
            "factor": factor,
            "min_samples": min_n,
            "regressions": self.regressions(),
        }

    def reset_for_testing(self) -> None:
        with self._lock:
            self._series.clear()


DRIFT = DriftDetector()


# ---------------------------------------------------------------------------
# the finish hook (QueryStatsLedger.finish calls this, outside its lock)
# ---------------------------------------------------------------------------

def journal_record(stats, record: dict) -> dict:
    """The JSONL journal row: the query-log record plus the ``workload``
    block settled from the query's chokepoint notes."""
    wl = stats.workload_notes()
    qerr = {
        k[len("estimator.qerror."):]: v.get("count", 0)
        for k, v in record.get("histograms", {}).items()
        if k.startswith("estimator.qerror.")
    }
    applied = {}
    for a in wl.get("applied", ()):
        cur = applied.get(a["index"])
        # a cache-serve note supersedes the rewrite note for the same
        # index (the serve is what actually happened; the rewrite's scan
        # never ran); among same-rule notes the largest counterfactual wins
        if (
            cur is None
            or (cur["rule"] == "rewrite" and a["rule"] != "rewrite")
            or (cur["rule"] == a["rule"] and a["raw_bytes"] > cur["raw_bytes"])
        ):
            applied[a["index"]] = a
    pruned = wl.get("pruned", ())
    chosen = []
    for name, a in sorted(applied.items()):
        kinds = sorted({p["kind"] for p in pruned if p["index"] == name})
        chosen.append({
            "index": name, "rule": a["rule"], "raw_bytes": a["raw_bytes"],
            "prune_kind": "+".join(kinds) or "none",
        })
    return {
        "v": 1,
        **record,
        "workload": {
            "shapes": sorted(set(wl.get("shapes", ()))),
            "join_keys": sorted(set(wl.get("join_keys", ()))),
            "columns": sorted(set(wl.get("columns", ()))),
            "candidates": list(wl.get("candidates", ())),
            "chosen": chosen,
            "pruned": list(pruned),
            # mid-query adaptation switches: the port has no adaptive
            # executor yet, so the list stays empty (the JAX record's shape)
            "adaptive": list(wl.get("adaptive", ())),
            "qerror_counts": qerr,
        },
    }


def on_query_finished(stats, record: dict) -> None:
    """Settle one finished query into the plane: journal append (async, IO
    pool), utility-ledger benefit charges (+ the mirroring global
    counters), and the drift detector's latency window. No-op — one env
    read — when the plane is disabled."""
    if not enabled():
        return
    try:
        from .metrics import REGISTRY

        INDEX_LEDGER.maybe_recover(journal_dir())
        jrec = journal_record(stats, record)
        wl = jrec["workload"]
        # --- benefit settlement: counterfactual raw-scan bytes minus the
        # query's actual attributed decode, split across chosen indexes;
        # prune-stage skips credit on top (same values the pruning.*
        # counters saw). Ledger charge and global counter move together.
        chosen = wl["chosen"]
        actual = record.get("bytes_read", 0)
        share = actual / len(chosen) if chosen else 0.0
        for c in chosen:
            benefit = max(0.0, c["raw_bytes"] - share)
            INDEX_LEDGER.charge_query(
                c["index"], benefit_bytes=benefit, seq=record.get("seq", 0),
                when_s=record.get("started_s", time.time()),
                rule=c["rule"],
            )
            REGISTRY.counter("workload.index.applied").inc()
            REGISTRY.counter("workload.index.benefit_bytes").inc(
                round(benefit, 3)
            )
        for p in wl["pruned"]:
            INDEX_LEDGER.charge_prune(
                p["index"], bytes_skipped=p["bytes_skipped"],
                rowgroups_skipped=p["rowgroups_skipped"],
            )
            REGISTRY.counter("workload.index.bytes_skipped").inc(
                p["bytes_skipped"]
            )
            REGISTRY.counter("workload.index.rowgroups_skipped").inc(
                p["rowgroups_skipped"]
            )
        if record.get("outcome") == "done":
            DRIFT.observe_latency(record.get("label", "query"),
                                  record.get("total_ms", 0.0))
        JOURNAL.submit(jrec)
        _persist_ledger(throttled=True)
    except Exception:  # noqa: BLE001 - the plane must never fail a query
        from .metrics import REGISTRY

        REGISTRY.counter("workload.journal.errors").inc()


def observe_qerror(estimator: str, q: float) -> None:
    """Accuracy-ledger hook (plan_stats.EstimatorAccuracy.observe)."""
    if not enabled():
        return
    DRIFT.observe_qerror(estimator, q)


# --- ledger persistence (throttled; IO outside every lock) ------------------

_persist_lock = threading.Lock()  # leaf: plain counter guard
_persist_count = 0


def _persist_ledger(throttled: bool = False) -> None:
    global _persist_count
    d = journal_dir()
    if not d:
        return
    if throttled:
        with _persist_lock:
            _persist_count += 1
            if _persist_count % 16:
                return
    from ..utils.workers import shared_io_pool

    shared_io_pool().submit(INDEX_LEDGER.persist_safe, d)


# ---------------------------------------------------------------------------
# report / snapshot surfaces
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """The exporter ``/snapshot`` ``workload`` block."""
    out = {
        "enabled": enabled(),
        "journal": JOURNAL.state(),
        "drift": DRIFT.snapshot(),
        "indexes": INDEX_LEDGER.report(),
        "cold_indexes": INDEX_LEDGER.cold_candidates(),
    }
    return out


def workload_report_string(limit: int = 512) -> str:
    """The ``hs.workload_report()`` body: journal state, the shape/label
    mix of the journaled workload, and the drift regressions."""
    lines = ["== Workload intelligence =="]
    if not enabled():
        lines.append("disabled (set HYPERSPACE_WORKLOAD_DIR to enable)")
        return "\n".join(lines)
    JOURNAL.flush(timeout_s=5.0)
    st = JOURNAL.state()
    lines.append(
        f"journal: dir={st['dir']} files={st['files']} "
        f"writes={st['writes']} rotations={st['rotations']} "
        f"current_bytes={st['current_bytes']}"
    )
    records = JOURNAL.load(limit=limit)
    labels: collections.Counter = collections.Counter()
    shapes: collections.Counter = collections.Counter()
    outcomes: collections.Counter = collections.Counter()
    for r in records:
        labels[r.get("label", "?")] += 1
        outcomes[r.get("outcome", "?")] += 1
        for s in (r.get("workload") or {}).get("shapes", ()):
            shapes[s] += 1
    lines.append(
        f"records (last {len(records)}): "
        + (" ".join(f"{k}={v}" for k, v in sorted(outcomes.items()))
           or "(none)")
    )
    if labels:
        lines.append("  top labels: " + ", ".join(
            f"{k} x{v}" for k, v in labels.most_common(8)
        ))
    if shapes:
        lines.append("  top shapes: " + ", ".join(
            f"{k} x{v}" for k, v in shapes.most_common(8)
        ))
    drift = DRIFT.snapshot()
    lines.append(
        f"drift: series={drift['series']} window={drift['window']} "
        f"baseline_n={drift['baseline_n']} factor={drift['factor']}"
    )
    regs = drift["regressions"]
    if not regs:
        lines.append("  (no regressions)")
    for r in regs:
        lines.append(
            f"  REGRESSION {r['kind']}:{r['key']} baseline={r['baseline']} "
            f"current={r['current']} ratio={r['ratio']}x "
            f"(n={r['window_n']})"
        )
    return "\n".join(lines)


def healthz_reasons() -> list[str]:
    """Drift regressions as /healthz degraded-reasons (empty when the plane
    is off — health behavior is bit-identical to pre-workload then)."""
    if not enabled():
        return []
    try:
        return [
            f"workload_drift:{r['kind']}:{r['key']}"
            for r in DRIFT.regressions()
        ]
    except Exception:  # noqa: BLE001 - the health endpoint must stay up
        return []


def reset_for_testing() -> None:
    JOURNAL.reset_for_testing()
    DRIFT.reset_for_testing()
    INDEX_LEDGER.reset_for_testing()
    global _persist_count
    with _persist_lock:
        _persist_count = 0
