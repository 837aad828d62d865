"""Pretty-print or aggregate a JSONL trace artifact of the port
(counterpart of the reference repo's ``tools/trace_report.py``, rebuilt on
the port's ``telemetry/trace.py``).

A trace file is written by ``HYPERSPACE_TRACE=1
HYPERSPACE_TRACE_FILE=trace.jsonl`` or by any
``telemetry.trace.JsonlTraceSink``. One JSON span per line; parents follow
their children (spans are written on completion).

Usage:
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl             # span trees
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --agg       # per-name rollup
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --top 20    # slowest spans
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --name kernel:   # filter trees
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --query 17  # one serving query
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --tenant gold # one tenant's queries
    python -m hyperspace_tpu_torch.tools.trace_report trace.jsonl --plan-stats # annotated exec trees

``--query <id>`` extracts a single serving query's span tree from a mixed
multi-query trace: it keeps only the ``serve:query`` subtree(s) whose
``query_id`` attribute matches (plus that query's ``serve:admit`` span),
and composes with --agg/--top to aggregate just that query's spans.

The span taxonomy is the JAX package's (docs/observability.md).
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict


def _load(path: str):
    from ..telemetry.trace import read_jsonl_trace

    return read_jsonl_trace(path)


def _walk(span: dict):
    yield span
    for c in span.get("children", []):
        yield from _walk(c)


_QUERY_SPANS = ("serve:query", "serve:admit")


def _query_trees(roots: list[dict], query_id: int) -> list[dict]:
    """The serving spans belonging to ONE query in a mixed trace: every
    ``serve:query`` subtree (and ``serve:admit`` marker) whose query_id
    attr matches, wherever it sits in the forest. A serving query's spans
    root at its own serve:query (thread-local trace stacks), so the
    matched subtrees ARE that query's complete execution. Both spans carry
    a ``tenant`` attribute, rendered with the rest of the attrs."""
    out = []
    for r in roots:
        for s in _walk(r):
            if (
                s["name"] in _QUERY_SPANS
                and (s.get("attrs") or {}).get("query_id") == query_id
            ):
                out.append(s)
    return out


def _tenant_trees(roots: list[dict], tenant: str) -> list[dict]:
    """Every serving query subtree belonging to ONE tenant — the QoS
    companion of --query: ``serve:query``/``serve:admit`` spans whose
    ``tenant`` attribute matches."""
    out = []
    for r in roots:
        for s in _walk(r):
            if (
                s["name"] in _QUERY_SPANS
                and (s.get("attrs") or {}).get("tenant") == tenant
            ):
                out.append(s)
    return out


def _print_trees(roots: list[dict], name_filter: str | None) -> None:
    from ..telemetry.trace import profile_string

    if name_filter:
        roots = [
            r
            for r in roots
            if any(name_filter in s["name"] for s in _walk(r))
        ]
    print(profile_string(roots, include_metrics=False))


def _aggregate(roots: list[dict]) -> None:
    agg: dict[str, dict] = defaultdict(
        lambda: {
            "count": 0,
            "total_ms": 0.0,
            "max_ms": 0.0,
            "dispatches": 0,
            "uploads": 0,
            "fetches": 0,
            "upload_bytes": 0,
            "fetch_bytes": 0,
        }
    )
    for r in roots:
        for s in _walk(r):
            a = agg[s["name"]]
            a["count"] += 1
            a["total_ms"] += s.get("duration_ms", 0.0)
            a["max_ms"] = max(a["max_ms"], s.get("duration_ms", 0.0))
            for k in ("dispatches", "uploads", "fetches", "upload_bytes", "fetch_bytes"):
                a[k] += (s.get("rpc") or {}).get(k, 0)
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"])
    hdr = f"{'span':<32}{'count':>7}{'total_ms':>12}{'max_ms':>10}{'disp':>6}{'up':>5}{'fetch':>6}{'up_B':>12}{'down_B':>12}"
    print(hdr)
    print("-" * len(hdr))
    for name, a in rows:
        print(
            f"{name:<32}{a['count']:>7}{a['total_ms']:>12.2f}{a['max_ms']:>10.2f}"
            f"{a['dispatches']:>6}{a['uploads']:>5}{a['fetches']:>6}"
            f"{a['upload_bytes']:>12}{a['fetch_bytes']:>12}"
        )


_PLAN_SPAN_PREFIXES = ("query", "serve:query", "exec:", "prune:", "cache:")


def _plan_stats_tree(span: dict) -> "dict | None":
    """The execution skeleton of one span tree: keep query/exec/prune/cache
    spans (the ones plan-stats annotations ride on), splicing out other
    levels so the printed tree mirrors the plan shape. Returns None when
    nothing execution-shaped is underneath."""

    def keep(s: dict) -> bool:
        return any(
            s["name"] == p or s["name"].startswith(p)
            for p in _PLAN_SPAN_PREFIXES
        )

    def kept_children(s: dict) -> list[dict]:
        out = []
        for c in s.get("children", []):
            if keep(c):
                t = dict(c)
                t["children"] = kept_children(c)
                out.append(t)
            else:
                out.extend(kept_children(c))  # splice the level out
        return out

    if keep(span):
        t = dict(span)
        t["children"] = kept_children(span)
        return t
    kids = kept_children(span)
    if not kids:
        return None
    return kids[0] if len(kids) == 1 else {
        "name": "(trace)", "duration_ms": span.get("duration_ms", 0.0),
        "attrs": {}, "rpc": {}, "children": kids,
    }


def _print_plan_stats(roots: list[dict]) -> None:
    """--plan-stats: the annotated execution trees. exec:* spans carry
    rows_out / route / bytes_scanned attributes (set by the executor when
    a plan-stats collector is active, e.g. HYPERSPACE_PLAN_STATS=1) and
    prune:* spans carry the estimator q-error events."""
    from ..telemetry.trace import profile_string

    trees = [t for t in (_plan_stats_tree(r) for r in roots) if t is not None]
    if not trees:
        print("(no exec/query spans in this trace)")
        return
    print(profile_string(trees, include_metrics=False))


def _top(roots: list[dict], n: int) -> None:
    spans = [s for r in roots for s in _walk(r)]
    spans.sort(key=lambda s: -s.get("duration_ms", 0.0))
    for s in spans[:n]:
        rpc = s.get("rpc") or {}
        print(
            f"{s.get('duration_ms', 0.0):>10.2f} ms  {s['name']:<28}"
            f" attrs={ {k: v for k, v in (s.get('attrs') or {}).items() if k != 'events'} }"
            f" rpc={ {k: v for k, v in rpc.items() if v} }"
        )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", help="JSONL trace file")
    p.add_argument("--agg", action="store_true", help="aggregate by span name")
    p.add_argument("--top", type=int, metavar="N", help="N slowest spans")
    p.add_argument("--name", help="only trees containing this span-name substring")
    p.add_argument(
        "--query", type=int, metavar="ID",
        help="only the serve:query/serve:admit subtree(s) with this query_id",
    )
    p.add_argument(
        "--tenant", metavar="NAME",
        help="only serve:query/serve:admit subtrees of this tenant",
    )
    p.add_argument(
        "--plan-stats", action="store_true",
        help="render annotated execution trees (exec/prune/cache spans "
             "with plan-stats attributes and q-error events)",
    )
    args = p.parse_args(argv)
    roots = _load(args.path)
    if args.query is not None:
        roots = _query_trees(roots, args.query)
        if not roots:
            print(f"(no serve:query spans with query_id={args.query})")
            return
    if args.tenant is not None:
        roots = _tenant_trees(roots, args.tenant)
        if not roots:
            print(f"(no serve:query spans with tenant={args.tenant!r})")
            return
    if not roots:
        print("(empty trace)")
        return
    if args.plan_stats:
        _print_plan_stats(roots)
    elif args.agg:
        _aggregate(roots)
    elif args.top:
        _top(roots, args.top)
    else:
        _print_trees(roots, args.name)


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # e.g. piped into head
        sys.stderr.close()
