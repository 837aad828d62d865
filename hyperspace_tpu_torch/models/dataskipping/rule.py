"""ApplyDataSkippingIndex: drop source files before the scan (counterpart
of hyperspace_tpu/models/dataskipping/rule.py).

On a Filter over a source scan, each data-skipping candidate translates
the condition against its sketches; the one with the most sketches (then
the greatest name) prunes the scan's file list through its sketch table.
A file the index does not know (appended since its build) is never
skipped. The score is 1, so any covering rewrite wins over skipping.

Every consultation counts ``dataskipping.files_scanned``,
``files_pruned`` and ``bytes_pruned`` in the metrics registry, traces a
``dataskipping`` event and logs the usage event, as the JAX package does;
the session's ``dataskipping_stats`` keeps the same numbers per session.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...columnar import io as cio
from ...meta.entry import IndexLogEntry
from ...plan.nodes import IndexScanInfo, LogicalPlan
from ...rules.base import (
    HyperspaceRule,
    IndexRankFilter,
    NO_CONVERTIBLE_PREDICATE,
    QueryPlanIndexFilter,
    index_type_filter,
    reason,
)
from ...rules.filter_rule import match_filter_pattern
from ...rules.rule_utils import find_scan_by_id, log_index_usage
from ...telemetry import trace
from ...telemetry.metrics import REGISTRY
from ...rules.score_optimizer import register_rule

TAG_DS_PREDICATE = "DATASKIPPING_INDEX_PREDICATE"


@dataclass
class DataSkippingStats:
    """What the rule did, per session: the reference's
    ``dataskipping.files_scanned``, ``files_pruned`` and ``bytes_pruned``
    counters, how many scans it pruned or consulted without pruning, and
    the last application's usage message."""

    consulted: int = 0
    files_scanned: int = 0
    files_pruned: int = 0
    bytes_pruned: int = 0
    last: dict = field(default_factory=dict)


class DSFilterPlanNodeFilter(QueryPlanIndexFilter):
    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        if m is None:
            return {}
        _, scan = m
        ds = index_type_filter("DS")(candidates.get(scan.plan_id, []))
        return {scan.plan_id: ds} if ds else {}


class DSFilterConditionFilter(QueryPlanIndexFilter):
    """Translate the condition and tag the entry with the keep-mask
    closure; an entry whose sketches bound no part of it drops."""

    def apply(self, plan, candidates):
        m = match_filter_pattern(plan)
        if m is None:
            return {}
        filter_node, scan = m
        out = []
        for e in candidates.get(scan.plan_id, []):
            translated = e.derived_dataset.translate_filter(filter_node.condition)
            if self.tag_reason_if(
                translated is not None, plan, e,
                reason(NO_CONVERTIBLE_PREDICATE,
                       "No sketch can bound any part of the filter condition."),
            ):
                e.set_tag(scan.plan_id, TAG_DS_PREDICATE, translated)
                self.tag_applicable_rule(plan, e, "ApplyDataSkippingIndex")
                out.append(e)
        return {scan.plan_id: out} if out else {}


class DataSkippingIndexRanker(IndexRankFilter):
    """The most sketches, then the greatest name."""

    def apply(self, plan, candidates):
        return {leaf_id: max(entries, key=lambda e: (len(e.derived_dataset.sketches), e.name))
                for leaf_id, entries in candidates.items() if entries}


class ApplyDataSkippingIndex(HyperspaceRule):
    @property
    def filters(self):
        return [DSFilterPlanNodeFilter(self.session), DSFilterConditionFilter(self.session)]

    @property
    def rank_filter(self):
        return DataSkippingIndexRanker(self.session)

    def apply_index(self, plan: LogicalPlan, chosen) -> LogicalPlan:
        out = plan
        for leaf_id, entry in chosen.items():
            out = _prune_scan(self.session, out, leaf_id, entry)
        return out

    def score(self, plan, chosen) -> int:
        return 1 if chosen else 0


def _sketch_table(entry: IndexLogEntry):
    """The entry's sketch table, cached on the entry by its file list
    (repeated planning of one query must not re-read it)."""
    files = tuple(entry.content.files())
    cached = getattr(entry, "_sketch_table_cache", None)
    if cached is not None and cached[0] == files:
        return cached[1]
    table = cio.read_parquet(list(files))
    entry._sketch_table_cache = (files, table)
    return table


def _prune_scan(session, plan: LogicalPlan, leaf_id: int, entry: IndexLogEntry) -> LogicalPlan:
    from .index import FILE_ID_COLUMN

    leaf = find_scan_by_id(plan, leaf_id)
    predicate = entry.get_tag(leaf_id, TAG_DS_PREDICATE)
    if leaf is None or predicate is None:
        return plan
    table = _sketch_table(entry)
    keep_ids = set(table.column(FILE_ID_COLUMN).data[predicate(table)].tolist())
    # files map to ids through the entry's recorded source files
    id_by_key = {(f.name, f.size, f.modified_time): f.id for f in entry.source_file_infos()}
    kept_files = []
    for f in leaf.files:
        fid = id_by_key.get((f.name, f.size, f.modified_time))
        if fid is None or fid in keep_ids:
            kept_files.append(f)  # an unknown file is never skipped
    n_pruned = len(leaf.files) - len(kept_files)
    bytes_pruned = sum(f.size for f in leaf.files) - sum(f.size for f in kept_files)
    # the effect counts even when nothing is pruned
    REGISTRY.counter("dataskipping.files_scanned").inc(len(kept_files))
    REGISTRY.counter("dataskipping.files_pruned").inc(n_pruned)
    REGISTRY.counter("dataskipping.bytes_pruned").inc(bytes_pruned)
    if trace.enabled():
        trace.add_event("dataskipping", index=entry.name, files_total=len(leaf.files),
                        files_pruned=n_pruned, bytes_pruned=bytes_pruned)
    message = f"Data skipping applied: {n_pruned} of {len(leaf.files)} files pruned"
    log_index_usage(session, "ApplyDataSkippingIndex", [entry.name], message)
    stats = session.dataskipping_stats
    stats.consulted += 1
    stats.files_scanned += len(kept_files)
    stats.files_pruned += n_pruned
    stats.bytes_pruned += bytes_pruned
    stats.last = {
        "index": entry.name, "files_total": len(leaf.files), "files_pruned": n_pruned,
        "bytes_pruned": bytes_pruned,
        "message": message,
    }
    if not n_pruned:
        return plan  # consulted, nothing pruned: the plan stays as it was
    pruned = leaf.copy(files=kept_files)
    pruned.index_info = IndexScanInfo(entry.name, "DS", entry.id)
    return plan.transform_up(lambda n: pruned if n is leaf else n)


register_rule(ApplyDataSkippingIndex)
