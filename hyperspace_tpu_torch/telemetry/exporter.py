"""Live metrics export + the serving health plane (counterpart of
hyperspace_tpu/telemetry/exporter.py).

Opt-in: nothing here runs unless ``HYPERSPACE_METRICS_PORT`` (HTTP
endpoints) or ``HYPERSPACE_SNAPSHOT_FILE`` (periodic JSONL sink) is set —
no thread, no socket, zero overhead otherwise. The first ``QueryScheduler``
constructed in the process calls ``maybe_start_from_env()``; embedders can
also call ``start_exporter()`` / ``start_snapshot_sink()`` directly.

Endpoints (stdlib ``http.server``, a daemon thread, localhost by default):

    /metrics    Prometheus text format — every registered counter, gauge,
                and histogram (cumulative le-buckets, _sum, _count), names
                prefixed ``hyperspace_`` with dots mangled to underscores.
                Each metric is one consistent cut (MetricsRegistry.export
                reads value + buckets under one lock), so a scrape during
                heavy serving never sees a torn bucket/count pair.
    /snapshot   One JSON object: registry snapshot, scheduler + global
                budget state (the serving block's ``device_budget`` entry
                carries the device-memory ledger: occupancy, open streams,
                parked/spilled/resumed join waves), the per-query ledger
                (active + recent query records), the result cache, the
                estimator ledger and the workload plane.
    /healthz    Serving health: queue depth vs cap, rolling error/degrade
                rates over the query-log window, workload drift. HTTP 200
                when "ok"; 503 when "degraded" (queue full, high error
                rate, or drift) — the shape load balancers poll.

The port has no circuit breaker (a device fault raises inside its query),
so neither /snapshot nor /healthz carries a breaker block, and /healthz
never degrades on one.

The JSONL snapshot sink appends the same /snapshot payload to a file every
``HYPERSPACE_SNAPSHOT_INTERVAL_S`` seconds (plus one final snapshot on
stop) so headless bench/soak runs keep a time series without a scraper.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import env

# module singletons, swapped only under _state_lock (same pattern as the
# scheduler / budget singletons in serve/)
_state_lock = threading.Lock()
_exporter: "Optional[MetricsExporter]" = None
_sink: "Optional[SnapshotSink]" = None


# ---------------------------------------------------------------------------
# payload builders (exported for tests and the JSONL sink)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "hyperspace_" + _NAME_RE.sub("_", name)


def _prom_num(v) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text() -> str:
    """The /metrics body: Prometheus text exposition of every registered
    metric, plus the per-tenant labeled series (QoS rollups). Histogram
    buckets are cumulative and always end at +Inf == _count (guaranteed by
    the per-metric consistent read)."""
    from .metrics import REGISTRY

    lines: list[str] = []
    for name, kind, value in REGISTRY.export():
        pn = _prom_name(name)
        if kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pn} {kind}")
            lines.append(f"{pn} {_prom_num(value)}")
            continue
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for bound, n in zip(value["bounds"], value["buckets"]):
            cum += n
            lines.append(f'{pn}_bucket{{le="{_prom_num(float(bound))}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {value["count"]}')
        lines.append(f"{pn}_sum {_prom_num(float(value['sum']))}")
        lines.append(f"{pn}_count {value['count']}")
    lines.extend(_tenant_prom_lines())
    lines.extend(_index_prom_lines())
    return "\n".join(lines) + "\n"


def _tenant_prom_lines() -> list[str]:
    """Per-tenant labeled gauges: the serving-plane tenant dimension the
    flat registry cannot carry (its names are unlabeled). Sourced from the
    attribution ledger's tenant rollups and the default scheduler's QoS
    state — one ``{tenant="..."}`` series per tenant per metric."""
    try:
        t = tenants_dict()
    except Exception:  # noqa: BLE001 - a tenants-block bug must not break /metrics
        return []
    rollups, sched = t["rollups"], t["scheduler"]
    series: dict[str, dict[str, float]] = {}
    for name in sorted(set(rollups) | set(sched)):
        r = rollups.get(name) or {}
        s = sched.get(name) or {}
        vals = {
            "queries": r.get("queries", 0),
            "wall_ms_total": r.get("total_ms", 0.0),
            "queue_wait_ms_total": r.get("queue_wait_ms", 0.0),
            "bytes_read_total": r.get("bytes_read", 0),
            "budget_stalls_total": r.get("budget_stalls", 0),
            "weight": s.get("weight", 1.0),
            "vclock_seconds": s.get("vclock", 0.0),
            "cost_seconds_total": s.get("cost_s", 0.0),
            "delivered_share": s.get("delivered_share", 0.0),
            "queued": s.get("queued", 0),
            "active": s.get("active", 0),
            "rejected_total": (
                s.get("rejected_rate", 0) + s.get("rejected_quota", 0)
                + s.get("rejected_deadline", 0)
            ),
        }
        label = _NAME_RE.sub("_", name)
        for metric, v in vals.items():
            series.setdefault(metric, {})[label] = v
    lines: list[str] = []
    for metric in sorted(series):
        pn = f"hyperspace_serve_tenant_{metric}"
        lines.append(f"# TYPE {pn} gauge")
        for label, v in sorted(series[metric].items()):
            lines.append(f'{pn}{{tenant="{label}"}} {_prom_num(v)}')
    return lines


def _index_prom_lines() -> list[str]:
    """Per-index labeled gauges from the workload plane's utility ledger —
    one ``{index="..."}`` series per index per metric. Empty (zero lines,
    zero work beyond one env read) when ``HYPERSPACE_WORKLOAD_DIR`` is
    unset."""
    from . import workload

    if not workload.enabled():
        return []
    try:
        rows = workload.INDEX_LEDGER.report()
    except Exception:  # noqa: BLE001 - an index-block bug must not break /metrics
        return []
    series: dict[str, dict[str, float]] = {}
    for r in rows:
        label = _NAME_RE.sub("_", r["name"])
        vals = {
            "queries_total": r["queries"],
            "benefit_bytes_total": r["benefit_bytes"],
            "bytes_skipped_total": r["bytes_skipped"],
            "rowgroups_skipped_total": r["rowgroups_skipped"],
            "maintenance_seconds_total": r["maintenance_s"],
            "net_utility_seconds": r["net_utility_s"],
            "last_used_seconds": r["last_used_s"],
        }
        for metric, v in vals.items():
            series.setdefault(metric, {})[label] = v
    lines: list[str] = []
    for metric in sorted(series):
        pn = f"hyperspace_index_{metric}"
        lines.append(f"# TYPE {pn} gauge")
        for label, v in sorted(series[metric].items()):
            lines.append(f'{pn}{{index="{label}"}} {_prom_num(v)}')
    return lines


def tenants_dict() -> dict:
    """The /snapshot ``tenants`` block: the default scheduler's per-tenant
    QoS state (weights, clocks, quotas, delivered share) plus the
    attribution ledger's per-tenant rollups. Tenants the ledger knows but
    the default scheduler doesn't (embedders running their own scheduler
    instance) still show their registry contract."""
    from ..serve import serve_state
    from ..serve.tenant import TENANTS
    from .attribution import LEDGER

    sched = dict(serve_state().get("tenants") or {})
    rollups = LEDGER.tenant_rollups()
    registry = TENANTS.state()
    for name in set(rollups) | set(registry):
        if name not in sched and name in registry:
            sched[name] = registry[name]
    return {"scheduler": sched, "rollups": rollups}


def snapshot_dict() -> dict:
    """The /snapshot payload: one consistent-per-component cut of the
    whole observability plane."""
    from ..cache.result_cache import RESULT_CACHE
    from ..serve import serve_state
    from . import workload
    from .attribution import LEDGER
    from .metrics import REGISTRY
    from .plan_stats import ACCURACY

    return {
        "ts": round(time.time(), 3),
        "metrics": REGISTRY.snapshot(),
        "serving": serve_state(),
        "tenants": tenants_dict(),
        "queries": LEDGER.snapshot(),
        "result_cache": RESULT_CACHE.state(),
        "estimator": ACCURACY.snapshot(),
        "workload": workload.snapshot(),
    }


def health_dict() -> tuple[dict, int]:
    """(healthz payload, HTTP status). ok -> 200; degraded -> 503."""
    from ..serve import serve_state
    from . import workload
    from .attribution import LEDGER

    st = serve_state()
    window = LEDGER.health_window()
    depth = len(st["queued"])
    cap = st["queue_depth_limit"]
    queue_full = cap is not None and depth >= cap
    # structured degrade causes: load balancers key off status, operators
    # key off WHY (the workload plane adds drift reasons when enabled)
    reasons: list[str] = []
    if queue_full:
        reasons.append("queue_full")
    if window["window_records"] >= 8 and window["error_rate"] > 0.5:
        reasons.append("high_error_rate")
    drift_reasons = workload.healthz_reasons()
    reasons.extend(drift_reasons)
    status = "degraded" if reasons else "ok"
    payload = {
        "status": status,
        "queue_depth": depth,
        "queue_depth_limit": cap,
        "active_queries": len(st["active"]),
        "reasons": reasons,
        **window,
    }
    return payload, 200 if status == "ok" else 503


# ---------------------------------------------------------------------------
# HTTP endpoint thread
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "hyperspace-exporter"

    def log_message(self, *args) -> None:  # pragma: no cover - silence stderr
        pass

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        from .metrics import REGISTRY

        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = prometheus_text().encode("utf-8")
                code, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/snapshot":
                body = json.dumps(snapshot_dict(), default=str).encode("utf-8")
                code, ctype = 200, "application/json"
            elif path in ("/healthz", "/health"):
                payload, code = health_dict()
                body = json.dumps(payload, default=str).encode("utf-8")
                ctype = "application/json"
            else:
                body, code, ctype = b'{"error": "not found"}', 404, "application/json"
            REGISTRY.counter("exporter.scrapes").inc()
        except Exception as e:  # noqa: BLE001 - a scrape bug must 500, never kill the endpoint thread
            body = json.dumps({"error": repr(e)}).encode("utf-8")
            code, ctype = 500, "application/json"
            REGISTRY.counter("exporter.scrape_errors").inc()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsExporter:
    """The exporter endpoint: a ThreadingHTTPServer on a daemon thread.
    Construct via ``start_exporter()`` so the process singleton and the
    ``exporter.up`` gauge stay coherent."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from ..utils.workers import spawn_thread

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread = spawn_thread(
            self._server.serve_forever, name="hs-metrics-exporter"
        )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def start_exporter(port: Optional[int] = None,
                   host: str = "127.0.0.1") -> "Optional[MetricsExporter]":
    """Start (or return) the process exporter. With ``port=None`` the knob
    decides: unset means stay off and return None. Port 0 binds an
    ephemeral port (the bound port is on the returned object)."""
    from .metrics import REGISTRY

    global _exporter
    with _state_lock:
        if _exporter is not None:
            return _exporter
        if port is None:
            raw = env.read_raw("HYPERSPACE_METRICS_PORT")
            if raw is None or raw.strip() == "":
                return None
            port = int(raw)
        _exporter = MetricsExporter(port, host)
        exp = _exporter
    REGISTRY.gauge("exporter.up").set(1)
    return exp


def get_exporter() -> "Optional[MetricsExporter]":
    with _state_lock:
        return _exporter


def stop_exporter() -> None:
    """Stop the endpoint and release the port; idempotent."""
    from .metrics import REGISTRY

    global _exporter
    with _state_lock:
        exp, _exporter = _exporter, None
    if exp is not None:
        exp.stop()
        REGISTRY.gauge("exporter.up").set(0)


# ---------------------------------------------------------------------------
# periodic JSONL snapshot sink (headless runs)
# ---------------------------------------------------------------------------

class SnapshotSink:
    """Appends the /snapshot payload to a JSONL file on an interval; one
    final snapshot is written on stop so short runs still record their
    end state."""

    def __init__(self, path: str, interval_s: Optional[float] = None):
        from ..utils.workers import spawn_thread

        self.path = path
        self.interval_s = max(
            0.05,
            interval_s if interval_s is not None
            else env.env_float("HYPERSPACE_SNAPSHOT_INTERVAL_S"),
        )
        self._stop = threading.Event()
        self._thread = spawn_thread(self._loop, name="hs-metrics-snapshot")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def write_once(self) -> None:
        from .metrics import REGISTRY

        line = json.dumps(snapshot_dict(), default=str)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
        REGISTRY.counter("exporter.snapshots").inc()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            self.write_once()
        except OSError:
            pass  # teardown; a dead disk has no consumer here


def start_snapshot_sink(path: Optional[str] = None,
                        interval_s: Optional[float] = None
                        ) -> "Optional[SnapshotSink]":
    global _sink
    with _state_lock:
        if _sink is not None:
            return _sink
        if path is None:
            path = env.env_str("HYPERSPACE_SNAPSHOT_FILE")
            if not path:
                return None
        _sink = SnapshotSink(path, interval_s)
        return _sink


def stop_snapshot_sink() -> None:
    global _sink
    with _state_lock:
        sink, _sink = _sink, None
    if sink is not None:
        sink.stop()


def maybe_start_from_env() -> None:
    """Knob-gated autostart, called by the first QueryScheduler: both
    facilities stay completely off (no thread, no socket, no file) unless
    their knob is set. A bind failure warns instead of failing admission —
    serving beats scraping."""
    try:
        start_exporter()
    except OSError as e:
        import logging

        logging.getLogger(__name__).warning(
            "metrics exporter failed to bind (%s); serving continues "
            "without it", e,
        )
    start_snapshot_sink()
