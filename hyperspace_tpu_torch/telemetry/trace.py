"""Query-scoped tracing: nestable spans carrying wall time, attributes, and
per-span RpcMeter deltas (counterpart of hyperspace_tpu/telemetry/trace.py).

The action-level events (events.py/logger.py) answer "what index CRUD
happened"; this module answers "where did THIS query's time and device
traffic go".

On the card a kernel launch returns at once, so a ``kernel:*`` span holds
the launch and the device time lands in the blocking ``fetch`` span that
follows, as the JAX package's did under asynchronous dispatch. No span
synchronizes the device.

Span taxonomy (see docs/observability.md):

    query                 one end-to-end DataFrame.collect()
      plan                optimizer passes + index rewrite
        rule:<Name>       one optimizer-rule invocation on one plan node
        prune:plan        prune-plan derivation for one index scan
          prune:bucket    bucket pruning of the scan's file list
      exec:<op>           one host-executor node (Filter, Join, Aggregate, ...)
        kernel:<name>     one device kernel dispatch (fused_agg, sort, ...)
          upload / fetch  host<->device transfers inside the kernel
          compile:<kind>  a kernel-cache miss tracing a new executable
        pipeline:<route>  one streamed fragment (partial | concat)
          pipeline:chunk  one chunk's upload + dispatch (decode_ms attr)
          pipeline:fetch  one in-order partial fold (carries RPC deltas)
        join:load         one streamed bucket-pair load (consumer-side wait)
        join:plan         per-bucket strategy selection from footer stats
        join:band         one band wave's stacked upload + kernel dispatch
        join:park         one wave's device-ledger admission wait
        join:resume       zero-width marker: a parked wave re-admitted
        join:spill        one in-flight wave retired to the host (park path)
        join:probe        the blocking probe-totals fetch (plain join)
        join:fold         the blocking result fetch + host fold/expansion
        prune:rowgroup    row-group stats evaluation for one pruned scan
        prune:sketch      sidecar-sketch evaluation for one pruned scan
      action:<Name>       an index-maintenance transaction

Overhead contract: when tracing is disabled every instrumented site performs
ONE module-level bool check and (for `span()`) returns a shared no-op
context manager — no allocation, no clock read, no meter snapshot, and never
any per-row work. When enabled, each span costs two `perf_counter` calls and
two RpcMeter snapshots (a lock + five int reads), negligible against the
milliseconds-scale work spans wrap.

Force-enable from the environment (used by the verify flow to run the whole
tier-1 suite traced): ``HYPERSPACE_TRACE=1`` enables at import;
``HYPERSPACE_TRACE_FILE=/path/trace.jsonl`` additionally attaches a JSONL
sink.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Optional

from ..staticcheck.concurrency import TrackedLock, guarded_by
from ..utils import env
from ..utils.rpc_meter import METER, RpcMeter

_RPC_ZERO = {
    "dispatches": 0,
    "fetches": 0,
    "uploads": 0,
    "upload_bytes": 0,
    "fetch_bytes": 0,
}

# module-level enable flag: the single check every disabled-path site pays
_ENABLED = False

_ids = itertools.count(1)
_local = threading.local()
_roots_lock = TrackedLock("trace.roots")
_roots: list["Span"] = guarded_by([], _roots_lock, name="telemetry.trace._roots")
_MAX_ROOTS = 1024  # bound memory when force-enabled across a whole test run
_sink: "Optional[TraceSink]" = None


def enabled() -> bool:
    return _ENABLED


class Span:
    """One completed or in-flight span. Use via ``with trace.span(...)``."""

    __slots__ = (
        "span_id",
        "parent_id",
        "name",
        "attrs",
        "children",
        "start_s",
        "duration_s",
        "rpc",
        "_t0",
        "_rpc0",
    )

    def __init__(self, name: str, attrs: dict, parent_id: Optional[int]):
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.children: list[Span] = []
        self.start_s = time.time()
        self.duration_s = 0.0
        self.rpc = dict(_RPC_ZERO)
        self._t0 = 0.0
        self._rpc0: dict = {}

    # --- context manager ---
    def __enter__(self) -> "Span":
        stack = _stack()
        stack.append(self)
        self._rpc0 = METER.snapshot()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration_s = time.perf_counter() - self._t0
        self.rpc = RpcMeter.delta(self._rpc0, METER.snapshot())
        stack = _stack()
        # tolerate a corrupted stack (an instrumented site that leaked a
        # span) instead of mis-attributing children
        if stack and stack[-1] is self:
            stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.children.append(self)
        else:
            with _roots_lock:
                _roots.append(self)
                if len(_roots) > _MAX_ROOTS:
                    del _roots[: len(_roots) - _MAX_ROOTS]
        sink = _sink
        if sink is not None:
            try:
                sink.write_span(self)
            except Exception:
                pass  # hslint: HS402 — a broken sink must never fail the query
        return False

    # --- enrichment ---
    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        """Append a structured sub-record (e.g. a rule reject reason)."""
        self.attrs.setdefault("events", []).append({"event": name, **attrs})
        return self

    # --- serialization ---
    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": self.start_s,
            "duration_ms": round(self.duration_s * 1000, 3),
            "attrs": self.attrs,
            "rpc": self.rpc,
        }


class _NoOpSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoOpSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key: str, value: Any) -> "_NoOpSpan":
        return self

    def add_event(self, name: str, **attrs) -> "_NoOpSpan":
        return self


NOOP_SPAN = _NoOpSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """Open a span (context manager). Near-free no-op when disabled."""
    if not _ENABLED:
        return NOOP_SPAN
    stack = _stack()
    parent = stack[-1] if stack else None
    return Span(name, attrs, parent.span_id if parent else None)


def current_span() -> Optional[Span]:
    if not _ENABLED:
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def add_attr(key: str, value: Any) -> None:
    """Attach an attribute to the innermost active span, if any."""
    sp = current_span()
    if sp is not None:
        sp.set_attr(key, value)


def add_event(name: str, **attrs) -> None:
    """Attach a structured event to the innermost active span, if any."""
    sp = current_span()
    if sp is not None:
        sp.add_event(name, **attrs)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

class TraceSink:
    def write_span(self, span: Span) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlTraceSink(TraceSink):
    """One JSON object per COMPLETED span, appended as a line. Children
    complete before parents, so a parent's line always follows its
    children's; `read_jsonl_trace` rebuilds the tree from parent ids."""

    def __init__(self, path: str):
        self.path = path
        self._lock = TrackedLock("trace.sink.jsonl")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write_span(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class ListTraceSink(TraceSink):
    """Collects completed spans in memory (tests / capture())."""

    def __init__(self):
        self.spans: list[Span] = []
        self._lock = TrackedLock("trace.sink.list")

    def write_span(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)


def read_jsonl_trace(path: str) -> list[dict]:
    """Load a JSONL trace back into a list of root span dicts with
    `children` lists rebuilt (round-trip of JsonlTraceSink)."""
    by_id: dict[int, dict] = {}
    order: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            d["children"] = []
            by_id[d["span_id"]] = d
            order.append(d)
    roots = []
    for d in order:
        parent = by_id.get(d.get("parent_id") or -1)
        if parent is not None:
            parent["children"].append(d)
        else:
            roots.append(d)
    return roots


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enable(sink: Optional[TraceSink] = None) -> None:
    """Turn tracing on process-wide, optionally attaching a sink."""
    global _ENABLED, _sink
    _sink = sink
    _ENABLED = True


def disable() -> None:
    global _ENABLED, _sink
    _ENABLED = False
    old = _sink
    _sink = None
    if old is not None:
        try:
            old.close()
        except Exception:
            pass  # hslint: HS402 — disable() is teardown; a close error has no consumer


def drain_roots() -> list[Span]:
    """Return (and clear) the completed top-level spans."""
    with _roots_lock:
        out = list(_roots)
        _roots.clear()
    return out


class capture:
    """Context manager: enable tracing for the block (restoring the prior
    state after) and collect the spans completed within it.

        with trace.capture() as cap:
            df.collect()
        print(cap.profile_string())
    """

    def __init__(self):
        self.sink = ListTraceSink()
        self._prev_enabled = False
        self._prev_sink: Optional[TraceSink] = None

    def __enter__(self) -> "capture":
        global _ENABLED, _sink
        self._prev_enabled = _ENABLED
        self._prev_sink = _sink
        _sink = self.sink
        _ENABLED = True
        return self

    def __exit__(self, *exc) -> bool:
        global _ENABLED, _sink
        _ENABLED = self._prev_enabled
        _sink = self._prev_sink
        return False

    @property
    def roots(self) -> list[Span]:
        return [s for s in self.sink.spans if _is_root_within(s, self.sink.spans)]

    def profile_string(self, metrics: bool = True) -> str:
        return profile_string(self.roots, include_metrics=metrics)


def _is_root_within(span: Span, universe: list[Span]) -> bool:
    ids = {s.span_id for s in universe}
    return span.parent_id not in ids


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_rpc(rpc: dict) -> str:
    if not any(rpc.values()):
        return ""
    return (
        f" [rpc: {rpc['dispatches']}d/{rpc['uploads']}u/{rpc['fetches']}f,"
        f" up={rpc['upload_bytes']}B, down={rpc['fetch_bytes']}B]"
    )


def _fmt_attrs(attrs: dict) -> str:
    shown = {k: v for k, v in attrs.items() if k != "events"}
    if not shown:
        return ""
    inner = ", ".join(f"{k}={v}" for k, v in sorted(shown.items()))
    return f" {{{inner}}}"


def _render(span, indent: int, lines: list[str]) -> None:
    # works on Span objects and read_jsonl_trace dicts alike
    get = span.get if isinstance(span, dict) else lambda k, d=None: getattr(span, k, d)
    dur_ms = (
        get("duration_ms")
        if isinstance(span, dict)
        else round(span.duration_s * 1000, 3)
    )
    attrs = get("attrs") or {}
    lines.append(
        "  " * indent
        + f"{get('name')}  {dur_ms:.3f} ms"
        + _fmt_attrs(attrs)
        + _fmt_rpc(get("rpc") or dict(_RPC_ZERO))
    )
    for ev in attrs.get("events", []):
        rest = ", ".join(f"{k}={v}" for k, v in ev.items() if k != "event")
        lines.append("  " * (indent + 1) + f"- {ev.get('event')}: {rest}")
    for c in get("children") or []:
        _render(c, indent + 1, lines)


def profile_string(roots, include_metrics: bool = True) -> str:
    """Render a span tree (Span objects or JSONL dicts) as an indented
    profile report, with the metrics-registry snapshot appended."""
    lines: list[str] = []
    for r in roots:
        _render(r, 0, lines)
    if include_metrics:
        from .metrics import REGISTRY

        snap = REGISTRY.snapshot()
        if snap:
            lines.append("")
            lines.append("metrics:")
            for name in sorted(snap):
                lines.append(f"  {name} = {snap[name]}")
    return "\n".join(lines)


# --- force-enable from the environment, read at import ---------------------
if env.env_bool("HYPERSPACE_TRACE"):  # pragma: no cover - env-gated
    _trace_file = env.env_str("HYPERSPACE_TRACE_FILE")
    enable(JsonlTraceSink(_trace_file) if _trace_file else None)
