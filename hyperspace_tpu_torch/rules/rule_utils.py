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
from ..plan.nodes import FileScan, Filter, IndexScanInfo, LogicalPlan, Project


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


def index_visible_schema(entry: IndexLogEntry) -> Schema:
    schema = Schema.from_list(entry.derived_dataset._schema)
    return schema.select([n for n in schema.names if n != C.DATA_FILE_NAME_ID])


def index_scan(entry: IndexLogEntry) -> FileScan:
    """A scan over the index's data files, marked as an index scan."""
    dd = entry.derived_dataset
    files = entry.content.file_infos()
    root = os.path.commonpath([f.name for f in files]) if files else ""
    return FileScan(
        [root],
        "parquet",
        Schema.from_list(dd._schema),
        files,
        index_info=IndexScanInfo(entry.name, dd.kind_abbr, entry.id),
        required_columns=index_visible_schema(entry).names,
    )


def transform_plan_to_use_index(entry: IndexLogEntry, plan: LogicalPlan,
                                leaf_id: int) -> LogicalPlan:
    """Swap the source leaf for the index scan."""
    leaf = find_scan_by_id(plan, leaf_id)
    if leaf is None:
        raise HyperspaceError(f"Leaf {leaf_id} not found in plan")
    scan = index_scan(entry)
    return plan.transform_up(lambda n: scan if n is leaf else n)
