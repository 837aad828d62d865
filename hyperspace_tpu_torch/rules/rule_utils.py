"""Plan transformation for covering-index rewrites (counterpart of
hyperspace_tpu/rules/rule_utils.py, index-only scans; hybrid scan is not
ported)."""

from __future__ import annotations

import os
from typing import Optional

from .. import constants as C
from ..columnar.table import Schema
from ..exceptions import HyperspaceError
from ..meta.entry import IndexLogEntry
from ..plan.nodes import BucketSpec, FileScan, Filter, IndexScanInfo, LogicalPlan, Project
from ..plan.pruning import prune_spec_for


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
    """Fraction of the scan's source bytes the index covers. Without hybrid
    scan (not ported) an applicable index covers all of them."""
    return 1.0


def index_visible_schema(entry: IndexLogEntry) -> Schema:
    schema = Schema.from_list(entry.derived_dataset._schema)
    return schema.select([n for n in schema.names if n != C.DATA_FILE_NAME_ID])


def index_scan(entry: IndexLogEntry, use_bucket_spec: bool = False) -> FileScan:
    """A scan over the index's data files, marked as an index scan; with
    ``use_bucket_spec`` it carries the index's bucket layout (the join
    rule's rewrite, which the bucketed join executes). A scan of a bucketed
    index also carries its PruneSpec."""
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
        required_columns=index_visible_schema(entry).names,
        # the layout contract pruning reads: it holds whether or not the
        # scan executes as a bucketed join
        prune_spec=prune_spec_for(entry),
    )


def transform_plan_to_use_index(entry: IndexLogEntry, plan: LogicalPlan,
                                leaf_id: int, use_bucket_spec: bool = False) -> LogicalPlan:
    """Swap the source leaf for the index scan."""
    leaf = find_scan_by_id(plan, leaf_id)
    if leaf is None:
        raise HyperspaceError(f"Leaf {leaf_id} not found in plan")
    scan = index_scan(entry, use_bucket_spec)
    return plan.transform_up(lambda n: scan if n is leaf else n)
