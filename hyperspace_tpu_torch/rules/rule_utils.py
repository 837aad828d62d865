"""Plan transformation for covering-index rewrites (counterpart of
hyperspace_tpu/rules/rule_utils.py).

The source scan becomes a scan of the index's files (with the bucket spec
when the rule asks for it), or, when the collector tagged the entry for
hybrid scan, that scan with a lineage filter dropping the deleted files'
rows, merged with a scan of the appended files: a plain Union for the
filter rules, or a BucketUnion whose appended side is re-bucketed
(RepartitionByExpr) for the join and aggregate rules, so the bucketed join
folds the appended rows into each bucket."""

from __future__ import annotations

import os
from typing import Optional

from .base import (
    TAG_COMMON_SOURCE_SIZE_IN_BYTES,
    TAG_HYBRIDSCAN_APPENDED,
    TAG_HYBRIDSCAN_DELETED,
    TAG_HYBRIDSCAN_REQUIRED,
)
from .. import constants as C
from ..columnar.table import Schema
from ..exceptions import HyperspaceError
from ..meta.entry import IndexLogEntry
from ..plan.expr import col
from ..plan.nodes import (
    BucketSpec,
    BucketUnion,
    FileScan,
    Filter,
    IndexScanInfo,
    LogicalPlan,
    Project,
    RepartitionByExpr,
    Union,
)
from ..plan.pruning import prune_spec_for


def log_index_usage(session, rule: str, index_names: list[str], message: str) -> None:
    """The one HyperspaceIndexUsageEvent emission of every rewrite and
    index-backed execution: the session's event logger gets the event, the
    ``rules.usage.<rule>`` counter counts each index, and the enclosing span
    gets an ``index_usage`` event when tracing is on."""
    from ..telemetry import trace
    from ..telemetry.events import AppInfo, HyperspaceIndexUsageEvent
    from ..telemetry.logger import event_logger_for
    from ..telemetry.metrics import REGISTRY

    event_logger_for(session).log_event(
        HyperspaceIndexUsageEvent(
            AppInfo.current(), message, index_names=list(index_names), rule=rule
        )
    )
    for name in index_names:
        REGISTRY.counter(f"rules.usage.{rule}").inc()
        if trace.enabled():
            trace.add_event("index_usage", rule=rule, index=name)


def find_scan_by_id(plan: LogicalPlan, plan_id: int) -> Optional[FileScan]:
    for n in plan.preorder():
        if isinstance(n, FileScan) and n.plan_id == plan_id:
            return n
    return None


def subtree_required_columns(plan: LogicalPlan) -> set[str]:
    """All source columns a linear subtree consumes: every expression
    reference, plus the output schema when no projection narrows it."""
    refs: set[str] = set()
    has_project = False
    for n in plan.preorder():
        if isinstance(n, Filter):
            refs |= n.condition.references()
        elif isinstance(n, Project):
            has_project = True
            for e in n.exprs:
                refs |= e.references()
    if not has_project:
        refs |= set(plan.schema.names)
    return refs


def is_plan_linear(plan: LogicalPlan) -> bool:
    """Only Project/Filter over a single FileScan."""
    nodes = plan.preorder()
    return all(isinstance(n, (Project, Filter, FileScan)) for n in nodes) and (
        sum(isinstance(n, FileScan) for n in nodes) == 1
    )


def common_bytes_ratio(entry: IndexLogEntry, leaf: FileScan) -> float:
    """Fraction of the scan's source bytes the index covers (below 1 only
    under hybrid scan); it scales the rules' scores."""
    total = sum(f.size for f in leaf.files)
    if not total:
        return 1.0
    common = entry.get_tag(leaf.plan_id, TAG_COMMON_SOURCE_SIZE_IN_BYTES)
    if common is None:
        return 1.0
    return min(1.0, common / total)


def index_visible_schema(entry: IndexLogEntry) -> Schema:
    schema = Schema.from_list(entry.derived_dataset._schema)
    return schema.select([n for n in schema.names if n != C.DATA_FILE_NAME_ID])


def index_scan(session, entry: IndexLogEntry, use_bucket_spec: bool = False,
               lineage_filter_ids: Optional[list[int]] = None) -> FileScan:
    """A scan over the index's data files, marked as an index scan; with
    ``use_bucket_spec`` it carries the index's bucket layout (the join
    rule's rewrite, which the bucketed join executes). A scan of a bucketed
    index also carries its PruneSpec. Its full schema keeps the lineage
    column, so a lineage filter can read it.

    The file set resolved here is what the query streams for its whole
    life, so the entry's data versions are pinned into the active pin scope
    (ingest/snapshots.py; ``DataFrame.collect`` opens it): compaction and
    vacuum cannot delete them until the query drains. Outside a scope
    (explain and whyNot) nothing is pinned."""
    from ..ingest.snapshots import pin_current

    pin_current(session, entry)
    dd = entry.derived_dataset
    files = entry.content.file_infos()
    root = os.path.commonpath([f.name for f in files]) if files else ""
    bucket_spec = None
    if use_bucket_spec and getattr(dd, "num_buckets", None):
        bucket_spec = BucketSpec(
            dd.num_buckets, tuple(dd.indexed_columns()), tuple(dd.indexed_columns())
        )
    return FileScan(
        [root],
        "parquet",
        Schema.from_list(dd._schema),
        files,
        bucket_spec=bucket_spec,
        index_info=IndexScanInfo(entry.name, dd.kind_abbr, entry.id),
        lineage_filter_ids=lineage_filter_ids,
        required_columns=index_visible_schema(entry).names,
        # the layout contract pruning reads: it holds whether or not the
        # scan executes as a bucketed join
        prune_spec=prune_spec_for(entry),
    )


def transform_plan_to_use_index(session, entry: IndexLogEntry, plan: LogicalPlan, leaf_id: int,
                                use_bucket_spec: bool, use_bucket_union: bool) -> LogicalPlan:
    """Swap the source leaf for the index scan, or its hybrid-scan form."""
    leaf = find_scan_by_id(plan, leaf_id)
    if leaf is None:
        raise HyperspaceError(f"Leaf {leaf_id} not found in plan")
    if not entry.get_tag(leaf_id, TAG_HYBRIDSCAN_REQUIRED):
        scan = index_scan(session, entry, use_bucket_spec)
        return plan.transform_up(lambda n: scan if n is leaf else n)

    appended = entry.get_tag(leaf_id, TAG_HYBRIDSCAN_APPENDED) or []
    deleted = entry.get_tag(leaf_id, TAG_HYBRIDSCAN_DELETED) or []
    # deleted files carry the ids the index's lineage column recorded
    scan = index_scan(session, entry, use_bucket_spec, [f.id for f in deleted] if deleted else None)
    if not appended:
        return plan.transform_up(lambda n: scan if n is leaf else n)
    # the appended files read the source format and project the index's
    # visible columns in order
    appended_plan: LogicalPlan = Project(
        [col(n) for n in index_visible_schema(entry).names],
        FileScan(leaf.root_paths, leaf.fmt, leaf.full_schema, appended,
                 options=dict(leaf.options)),
    )
    dd = entry.derived_dataset
    if use_bucket_union:
        # re-bucket only the appended rows into the index's layout
        spec = BucketSpec(dd.num_buckets, tuple(dd.indexed_columns()),
                          tuple(dd.indexed_columns()))
        merged: LogicalPlan = BucketUnion(
            [scan, RepartitionByExpr([col(c) for c in dd.indexed_columns()], dd.num_buckets,
                                     appended_plan)], spec)
    else:
        merged = Union([scan, appended_plan])
    return plan.transform_up(lambda n: merged if n is leaf else n)
