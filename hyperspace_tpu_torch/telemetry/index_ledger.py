"""Per-index utility ledger: counterfactual benefit vs maintenance cost
(counterpart of hyperspace_tpu/telemetry/index_ledger.py).

The advisor question "is this index worth keeping?" needs both sides of
the balance sheet per index, accumulated over the real workload:

- **Benefit** — settled once per finished query by
  ``workload.on_query_finished``: the counterfactual raw-scan bytes the
  chosen index replaced (the source leaf the rewrite removed, or the index
  scan a result-cache serve avoided) minus the query's actually-attributed
  decode share, plus the bucket/row-group/sketch bytes and row-groups the
  pruning stages skipped (the same deltas the global ``pruning.*`` /
  ``pruning.sketch.*`` counters saw).
- **Maintenance** — charged at the action chokepoint (``Action.run``):
  every create / ingest_delta / compact / vacuum / sketch write bills its
  wall time to the index it mutated.

Bytes convert to seconds through the QoS cost model
(``HYPERSPACE_QOS_COST_MBPS``), so ``net_utility_s = benefit_s -
maintenance_s`` is one comparable number; *heat* (query hits, last-used
time/seq) and *cold candidates* (maintained but never applied, or net
negative) fall out of the same rows.

The ledger is process-wide and survives restarts: it persists as one JSON
file (atomic tmp+rename) in the workload journal dir and is lazily
rebuilt by ``maybe_recover`` on first charge after a restart. All
mutation under one leaf lock; file IO happens OUTSIDE the lock (callers
persist via the shared IO pool).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from ..utils import env

_LEDGER_NAME = "index_ledger.json"


def _new_entry() -> dict:
    return {
        "queries": 0,
        "benefit_bytes": 0.0,
        "bytes_skipped": 0,
        "rowgroups_skipped": 0,
        "maintenance_s": 0.0,
        "maintenance_actions": {},  # kind -> count
        "rules": {},  # rule -> count
        "last_used_s": 0.0,
        "last_used_seq": 0,
    }


class IndexUtilityLedger:
    """Process-wide per-index benefit/maintenance accumulator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._indexes: dict[str, dict] = {}
        self._recovered = False

    # --- charging ---------------------------------------------------------

    def charge_query(self, index_name: str, benefit_bytes: float, seq: int,
                     when_s: float, rule: str = "rewrite") -> None:
        with self._lock:
            e = self._indexes.setdefault(index_name, _new_entry())
            e["queries"] += 1
            e["benefit_bytes"] += float(benefit_bytes)
            e["rules"][rule] = e["rules"].get(rule, 0) + 1
            e["last_used_s"] = max(e["last_used_s"], float(when_s))
            e["last_used_seq"] = max(e["last_used_seq"], int(seq))

    def charge_prune(self, index_name: str, bytes_skipped: int = 0,
                     rowgroups_skipped: int = 0) -> None:
        with self._lock:
            e = self._indexes.setdefault(index_name, _new_entry())
            e["bytes_skipped"] += int(bytes_skipped)
            e["rowgroups_skipped"] += int(rowgroups_skipped)

    def charge_maintenance(self, index_name: str, kind: str, wall_s: float,
                           outcome: str = "succeeded") -> None:
        with self._lock:
            e = self._indexes.setdefault(index_name, _new_entry())
            e["maintenance_s"] += float(wall_s)
            e["maintenance_actions"][kind] = (
                e["maintenance_actions"].get(kind, 0) + 1
            )

    # --- reporting --------------------------------------------------------

    @staticmethod
    def _cost_mbps() -> float:
        return max(1.0, env.env_float("HYPERSPACE_QOS_COST_MBPS"))

    def report(self) -> list[dict]:
        """One row per known index, net-utility-descending: the
        ``hs.index_report()`` and exporter table."""
        mbps = self._cost_mbps()
        with self._lock:
            rows = [
                dict(e, name=name,
                     maintenance_actions=dict(e["maintenance_actions"]),
                     rules=dict(e["rules"]))
                for name, e in self._indexes.items()
            ]
        for r in rows:
            saved = r["benefit_bytes"] + r["bytes_skipped"]
            r["benefit_s"] = round(saved / (mbps * 1e6), 6)
            r["net_utility_s"] = round(r["benefit_s"] - r["maintenance_s"], 6)
            r["benefit_bytes"] = round(r["benefit_bytes"], 1)
            r["maintenance_s"] = round(r["maintenance_s"], 6)
        rows.sort(key=lambda r: (-r["net_utility_s"], -r["queries"], r["name"]))
        return rows

    def cold_candidates(self) -> list[str]:
        """Indexes paying maintenance without pulling their weight: never
        applied to any query, or net-negative utility. The drop-candidate
        list the advisor (and an operator reading ``hs.index_report()``)
        starts from."""
        return [
            r["name"] for r in self.report()
            if r["queries"] == 0 or r["net_utility_s"] < 0
        ]

    def totals(self) -> dict:
        """Cross-index sums — the conservation side of the plane
        (must equal the ``workload.index.*`` / ``workload.maintenance.*``
        counter deltas)."""
        with self._lock:
            out = {
                "queries": 0, "benefit_bytes": 0.0, "bytes_skipped": 0,
                "rowgroups_skipped": 0, "maintenance_s": 0.0,
                "maintenance_actions": 0,
            }
            for e in self._indexes.values():
                out["queries"] += e["queries"]
                out["benefit_bytes"] += e["benefit_bytes"]
                out["bytes_skipped"] += e["bytes_skipped"]
                out["rowgroups_skipped"] += e["rowgroups_skipped"]
                out["maintenance_s"] += e["maintenance_s"]
                out["maintenance_actions"] += sum(
                    e["maintenance_actions"].values()
                )
        return out

    # --- persistence ------------------------------------------------------

    def maybe_recover(self, d: Optional[str]) -> None:
        """Lazy once-per-process rebuild from the journal dir's persisted
        ledger (first charge after a restart)."""
        if self._recovered or not d:
            return
        with self._lock:
            if self._recovered:
                return
            self._recovered = True
        self.recover(d)

    def recover(self, d: str) -> int:
        """Merge the persisted ledger into memory (persisted state is the
        floor: a live process that already accumulated more keeps its own
        numbers). Returns the number of indexes recovered."""
        path = os.path.join(d, _LEDGER_NAME)
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return 0
        loaded = data.get("indexes") or {}
        merged = 0
        with self._lock:
            for name, saved in loaded.items():
                if not isinstance(saved, dict):
                    continue
                e = self._indexes.setdefault(name, _new_entry())
                for k in ("queries", "bytes_skipped", "rowgroups_skipped",
                          "last_used_seq"):
                    e[k] = max(e[k], int(saved.get(k, 0)))
                for k in ("benefit_bytes", "maintenance_s", "last_used_s"):
                    e[k] = max(e[k], float(saved.get(k, 0.0)))
                for field in ("maintenance_actions", "rules"):
                    for kind, n in (saved.get(field) or {}).items():
                        e[field][kind] = max(e[field].get(kind, 0), int(n))
                merged += 1
        return merged

    def persist(self, d: str) -> str:
        """Atomic tmp+rename snapshot into the journal dir (IO outside the
        lock; called from the shared IO pool)."""
        with self._lock:
            payload = {
                "v": 1,
                "saved_s": time.time(),
                "indexes": {
                    name: dict(e,
                               maintenance_actions=dict(
                                   e["maintenance_actions"]),
                               rules=dict(e["rules"]))
                    for name, e in self._indexes.items()
                },
            }
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _LEDGER_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(tmp, path)
        return path

    def persist_safe(self, d: str) -> None:
        try:
            self.persist(d)
        except Exception:  # noqa: BLE001 - persistence is best-effort
            from .metrics import REGISTRY

            REGISTRY.counter("workload.journal.errors").inc()

    def reset_for_testing(self) -> None:
        with self._lock:
            self._indexes.clear()
            self._recovered = False


INDEX_LEDGER = IndexUtilityLedger()
