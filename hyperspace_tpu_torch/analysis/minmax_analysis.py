"""MinMax layout analyzer — a user tool reporting how well file layout
supports range queries per column (counterpart of
hyperspace_tpu/analysis/minmax_analysis.py).

Reference parity: util/MinMaxAnalysisUtil.scala (entry point :768-780) — a
standalone analyzer (not wired into the rules) that reports per-column
file-overlap of value ranges: for each column, how many files a point/range
query would have to touch given the current physical layout, a bucketed
overlap chart across the value domain, and an estimated skip ratio. High
overlap ⇒ the column is a good z-order / covering-sort candidate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from typing import TYPE_CHECKING, Optional

import numpy as np

from ..columnar import io as cio
from ..columnar.table import STRING
from ..plan.nodes import FileScan
from ..utils.workers import io_pool

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame

_N_BUCKETS = 24  # domain buckets for the overlap chart
_CHART_WIDTH = 32


@dataclass
class ColumnLayoutStats:
    """Per-column layout statistics over a file set."""

    column: str
    n_files: int
    n_ranges: int  # distinct (min, max) pairs
    avg_files_per_point: float
    max_overlap: int
    skip_ratio_point: float  # expected fraction of files skipped per point query
    skip_ratio_range1: Optional[float]  # ... per 1%-of-domain range (numeric only)
    skip_ratio_range10: Optional[float]  # ... per 10%-of-domain range (numeric only)
    disjoint_sorted: bool  # file ranges are pairwise disjoint (perfect layout)
    widest_files: list  # [(path, min, max, width_fraction)] worst offenders
    bucket_overlaps: Optional[np.ndarray]  # [N_BUCKETS] mean files per bucket
    domain: Optional[tuple]  # (lo, hi) for numeric columns

    @property
    def clustered(self) -> bool:
        return self.avg_files_per_point <= max(1.5, 0.25 * self.n_files)


def _file_min_max(fmt: str, path: str, column: str):
    b = cio.read_files(fmt, [path], [column])
    if b.num_rows == 0:
        return None
    col = b.column(column)
    if col.dtype == STRING:
        vals = np.asarray(col.decode(), dtype=object).astype(str)
    else:
        vals = col.data
        if vals.dtype.kind == "f":
            vals = vals[~np.isnan(vals)]
            if not len(vals):
                return None
    return vals.min(), vals.max()


def _range_skip_ratio(mins, maxs, lo: float, hi: float, width_frac: float) -> float:
    """Expected fraction of files skipped by a range predicate spanning
    width_frac of the domain (sampled across the domain)."""
    n_files = len(mins)
    span = (hi - lo) * width_frac
    starts = np.linspace(lo, hi - span, 32) if hi > lo else np.array([lo])
    hits = np.array(
        [np.sum((mins <= s + span) & (maxs >= s)) for s in starts],
        dtype=np.float64,
    )
    return 1.0 - float(hits.mean()) / n_files if n_files else 0.0


def column_stats(scan: FileScan, column: str) -> Optional[ColumnLayoutStats]:
    with io_pool(8, "hs-minmax") as pool:
        stats_per_file = list(
            pool.map(lambda f: _file_min_max(scan.fmt, f.name, column), scan.files)
        )
    pairs = [
        (f.name, p) for f, p in zip(scan.files, stats_per_file) if p is not None
    ]
    if not pairs:
        return None
    mins = np.asarray([p[0] for _n, p in pairs])
    maxs = np.asarray([p[1] for _n, p in pairs])
    names = [n for n, _p in pairs]
    n_files = len(pairs)
    numeric = mins.dtype.kind not in ("U", "O", "S")
    # disjoint ranges = a point query touches exactly one file (perfect
    # layout for the column, whatever the file order on disk)
    order = np.argsort(mins, kind="stable")
    disjoint = bool((maxs[order][:-1] <= mins[order][1:]).all()) if n_files > 1 else True
    if numeric:
        lo, hi = float(mins.min()), float(maxs.max())
        points = np.linspace(lo, hi, 64)
        edges = np.linspace(lo, hi, _N_BUCKETS + 1)
        # per domain bucket: how many file ranges intersect it
        bucket_overlaps = np.array(
            [
                np.sum((mins <= edges[i + 1]) & (maxs >= edges[i]))
                for i in range(_N_BUCKETS)
            ],
            dtype=np.float64,
        )
        domain = (lo, hi)
        skip1 = _range_skip_ratio(mins, maxs, lo, hi, 0.01)
        skip10 = _range_skip_ratio(mins, maxs, lo, hi, 0.10)
        widths = (maxs - mins) / (hi - lo) if hi > lo else np.zeros(n_files)
        worst = np.argsort(widths)[::-1][:5]
        widest = [
            (names[i], mins[i], maxs[i], float(widths[i]))
            for i in worst
            if widths[i] > 0
        ]
    else:
        points = np.unique(np.concatenate([mins, maxs]))
        bucket_overlaps, domain = None, None
        skip1 = skip10 = None  # range ratios are undefined off a numeric domain
        widest = []
    hits = np.array(
        [np.sum((mins <= p) & (maxs >= p)) for p in points], dtype=np.float64
    )
    avg = float(hits.mean())
    return ColumnLayoutStats(
        column=column,
        n_files=n_files,
        n_ranges=len(set(zip(mins.tolist(), maxs.tolist()))),
        avg_files_per_point=avg,
        max_overlap=int(hits.max()),
        skip_ratio_point=1.0 - avg / n_files if n_files else 0.0,
        skip_ratio_range1=skip1,
        skip_ratio_range10=skip10,
        disjoint_sorted=disjoint,
        widest_files=widest,
        bucket_overlaps=bucket_overlaps,
        domain=domain,
    )


def _chart(stats: ColumnLayoutStats) -> list[str]:
    """ASCII overlap chart: domain buckets left to right, bar length = number
    of files a query in that bucket must touch."""
    if stats.bucket_overlaps is None or stats.domain is None:
        return []
    lo, hi = stats.domain
    peak = max(stats.n_files, 1)
    out = [f"  overlap across [{lo:g} .. {hi:g}] ({stats.n_files} files):"]
    edges = np.linspace(lo, hi, _N_BUCKETS + 1)
    for i, v in enumerate(stats.bucket_overlaps):
        bar = "#" * max(1, int(round(v / peak * _CHART_WIDTH))) if v else ""
        out.append(
            f"  [{edges[i]:>12.4g} .. {edges[i + 1]:>12.4g}) "
            f"{bar:<{_CHART_WIDTH}} {int(v)}"
        )
    return out


def _recommend(stats_list: list[ColumnLayoutStats]) -> list[str]:
    """Layout recommendations ranked by expected win (the reference
    analyzer's closing guidance, derived from the same overlap numbers)."""
    out: list[str] = []
    candidates = [
        s
        for s in stats_list
        if not s.disjoint_sorted
        and s.skip_ratio_range1 is not None  # numeric domains only
        and s.skip_ratio_range1 < 0.8
        and s.n_files > 1
    ]
    for s in sorted(candidates, key=lambda s: s.skip_ratio_range1):
        kind = (
            "ZOrderCoveringIndex (multi-column) or single-column sort"
            if s.n_ranges > 1
            else "DataSkippingIndex[MinMaxSketch]"
        )
        out.append(
            f"  {s.column}: point queries touch {s.avg_files_per_point:.1f} of "
            f"{s.n_files} files (1%-range skips {s.skip_ratio_range1:.0%}); "
            f"re-clustering via {kind} would cut scanned files toward 1."
        )
    for s in stats_list:
        if s.disjoint_sorted and s.n_files > 1:
            out.append(
                f"  {s.column}: file ranges are already disjoint — MinMax "
                f"sketch / parquet stats give near-perfect pruning as-is."
            )
    return out or ["  (no recommendation: layouts already serve these columns)"]


def analyze(df: "DataFrame", columns: list[str], verbose: bool = False) -> str:
    """Render a per-column layout report over the DataFrame's source files.
    verbose adds the per-column domain overlap chart and the widest-file
    table (the files that destroy pruning)."""
    from ..models.covering import _single_file_scan

    scan = _single_file_scan(df)
    lines = [
        "=" * 72,
        f"MinMax layout analysis over {len(scan.files)} files",
        "=" * 72,
        f"{'column':<20}{'ranges':>8}{'files/point':>13}{'max ovl':>9}"
        f"{'skip pt':>9}{'skip 1%':>9}{'skip 10%':>10}{'disjoint':>10}",
    ]
    charts: list[str] = []
    collected: list[ColumnLayoutStats] = []
    for c in columns:
        stats = column_stats(scan, c)
        if stats is None:
            lines.append(f"{c:<20}{'-':>8}{'-':>13}{'-':>9}{'-':>9}{'-':>9}{'-':>10}{'-':>10}")
            continue
        collected.append(stats)
        s1 = "-" if stats.skip_ratio_range1 is None else f"{stats.skip_ratio_range1:.0%}"
        s10 = "-" if stats.skip_ratio_range10 is None else f"{stats.skip_ratio_range10:.0%}"
        lines.append(
            f"{c:<20}{stats.n_ranges:>8}{stats.avg_files_per_point:>13.2f}"
            f"{stats.max_overlap:>9}{stats.skip_ratio_point:>9.0%}"
            f"{s1:>9}{s10:>10}"
            f"{'yes' if stats.disjoint_sorted else 'no':>10}"
        )
        if verbose:
            charts += ["", f"-- {c} " + "-" * (68 - len(c))] + _chart(stats)
            if stats.widest_files:
                charts.append("  widest file ranges (pruning offenders):")
                for path, mn, mx, w in stats.widest_files:
                    charts.append(
                        f"    {os.path.basename(str(path)):<40} "
                        f"[{mn:g} .. {mx:g}] spans {w:.0%} of domain"
                    )
    lines += charts
    lines += ["", "=" * 72, "Recommendations:", "=" * 72]
    lines += _recommend(collected)
    lines.append("")
    lines.append(
        "files/point ~ 1.0 means range queries on the column touch one "
        "file (well clustered); ~ num_files means the layout does not help. "
        "skip N% = expected fraction of files skipped by a range predicate "
        "spanning N% of the value domain."
    )
    return "\n".join(lines)


# --- HTML rendering + before/after comparison --------------------------------
# Reference parity: MinMaxAnalysisUtil's writer split (TextResultWriter /
# HtmlResultWriter, :104-510) and the Z-ORDER OPTIMIZE comparison mode
# (appendComparisonResult:117-169): the same per-column stats render either
# as text (side-by-side with an arrow at mid-height) or as self-contained
# HTML (the reference emits d3 scripts; here inline-styled bars carry the
# same information without a JS dependency).

_ARROW = "------->>>"


def _column_block(stats: ColumnLayoutStats, title: str) -> str:
    """One column's text report: headline numbers + the overlap chart."""
    lines = [
        title,
        f"  files analyzed      : {stats.n_files}",
        f"  distinct ranges     : {stats.n_ranges}",
        f"  files per point     : {stats.avg_files_per_point:.2f}",
        f"  max overlap         : {stats.max_overlap}",
        f"  point skip ratio    : {stats.skip_ratio_point:.0%}",
    ]
    if stats.skip_ratio_range1 is not None:
        lines.append(f"  1%-range skip ratio : {stats.skip_ratio_range1:.0%}")
    if stats.skip_ratio_range10 is not None:
        lines.append(f"  10%-range skip ratio: {stats.skip_ratio_range10:.0%}")
    lines.append(f"  disjoint layout     : {'yes' if stats.disjoint_sorted else 'no'}")
    lines += _chart(stats)
    return "\n".join(lines)


def _merge_side_by_side(before: str, after: str, gap: int = 8) -> str:
    """Zip two text blocks line-wise; the middle line carries the arrow
    (ref: TextResultWriter.mergeResultString:144-169)."""
    b_lines = before.splitlines()
    a_lines = after.splitlines()
    height = max(len(b_lines), len(a_lines))
    b_lines += [""] * (height - len(b_lines))
    a_lines += [""] * (height - len(a_lines))
    width = max((len(l) for l in b_lines), default=0)
    arrow_at = height // 2
    out = []
    for i, (b, a) in enumerate(zip(b_lines, a_lines)):
        mid = (
            _ARROW.center(gap + len(_ARROW))
            if i == arrow_at
            else " " * (gap + len(_ARROW))
        )
        out.append(f"{b:<{width}}{mid}{a}".rstrip())
    return "\n".join(out)


def _html_bar(frac: float, label: str) -> str:
    pct = max(0.0, min(1.0, frac)) * 100
    return (
        '<div style="background:#eee;width:320px;display:inline-block">'
        f'<div style="background:LightGreen;width:{pct:.0f}%">&nbsp;{label}</div></div>'
    )


def _html_column_report(stats: ColumnLayoutStats, title: str) -> str:
    """Self-contained HTML for one column: stat table + per-bucket overlap
    bars (the d3-free analogue of HtmlResultWriter's graph, :251-510)."""
    import html as _h

    rows = [
        ("files analyzed", stats.n_files),
        ("distinct ranges", stats.n_ranges),
        ("files per point", f"{stats.avg_files_per_point:.2f}"),
        ("max overlap", stats.max_overlap),
        ("point skip ratio", f"{stats.skip_ratio_point:.0%}"),
        (
            "1%-range skip ratio",
            "-" if stats.skip_ratio_range1 is None else f"{stats.skip_ratio_range1:.0%}",
        ),
        (
            "10%-range skip ratio",
            "-" if stats.skip_ratio_range10 is None else f"{stats.skip_ratio_range10:.0%}",
        ),
        ("disjoint layout", "yes" if stats.disjoint_sorted else "no"),
    ]
    parts = [f"<h4>{_h.escape(title)}</h4>", "<table>"]
    for k, v in rows:
        parts.append(f"<tr><td>{_h.escape(str(k))}</td><td>{_h.escape(str(v))}</td></tr>")
    parts.append("</table>")
    if stats.bucket_overlaps is not None and stats.domain is not None:
        lo, hi = stats.domain
        peak = max(stats.n_files, 1)
        edges = np.linspace(lo, hi, _N_BUCKETS + 1)
        parts.append("<div>overlap across the value domain (files touched):</div>")
        for i, v in enumerate(stats.bucket_overlaps):
            label = f"[{edges[i]:.4g} .. {edges[i + 1]:.4g}) {int(v)}"
            parts.append(_html_bar(v / peak, _h.escape(label)))
            parts.append("<br>")
    return "\n".join(parts)


def analyze_html(df: "DataFrame", columns: list[str]) -> str:
    """HTML report over the DataFrame's source files (ref: analyze(df, cols,
    format="html") → HtmlResultWriter)."""
    import html as _h

    from ..models.covering import _single_file_scan

    scan = _single_file_scan(df)
    parts = [
        "<html><body>",
        f"<h3>MinMax layout analysis over {len(scan.files)} files</h3>",
    ]
    collected = []
    for c in columns:
        stats = column_stats(scan, c)
        if stats is None:
            parts.append(
                f"<h4>{_h.escape(c)}</h4><div>(no values: empty or all-null)</div>"
            )
            continue
        collected.append(stats)
        parts.append(_html_column_report(stats, c))
    parts.append("<h3>Recommendations</h3><ul>")
    for line in _recommend(collected):
        parts.append(f"<li>{_h.escape(line.strip())}</li>")
    parts.append("</ul></body></html>")
    return "\n".join(parts)


def analyze_comparison(
    before_df: "DataFrame", after_df: "DataFrame", columns: list[str]
) -> str:
    """Before/after layout comparison — the reference's Z-ORDER OPTIMIZE
    verification report (appendComparisonResult): run the same per-column
    analysis on both layouts and render them side by side with the
    improvement called out."""
    from ..models.covering import _single_file_scan

    b_scan = _single_file_scan(before_df)
    a_scan = _single_file_scan(after_df)
    out = [
        "=" * 72,
        f"MinMax layout comparison: {len(b_scan.files)} files before, "
        f"{len(a_scan.files)} after",
        "=" * 72,
    ]
    for c in columns:
        b = column_stats(b_scan, c)
        a = column_stats(a_scan, c)
        if b is None or a is None:
            out.append(f"{c}: (no values on one side; skipped)")
            continue
        out.append("")
        out.append(
            _merge_side_by_side(
                _column_block(b, f"{c} — before"), _column_block(a, f"{c} — after")
            )
        )
        if b.avg_files_per_point > 0:
            gain = b.avg_files_per_point / max(a.avg_files_per_point, 1e-9)
            out.append(
                f"  point queries touch {gain:.1f}x fewer files after re-layout"
                if gain >= 1
                else f"  WARNING: layout regressed ({1 / gain:.1f}x more files per point)"
            )
    return "\n".join(out)
