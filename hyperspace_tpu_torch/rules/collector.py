"""Candidate index collection (counterpart of hyperspace_tpu/rules/collector.py):
per source scan, indexes whose columns exist in the relation and whose
recorded source signature matches the scan's files exactly."""

from __future__ import annotations

from ..meta.entry import IndexLogEntry
from ..meta.signatures import get_provider
from ..plan.nodes import FileScan, LogicalPlan


class _LeafPlan:
    """A single leaf as a signable plan."""

    def __init__(self, leaf: FileScan):
        self.leaf = leaf

    def preorder_kinds(self):
        return [self.leaf.kind]

    def leaf_file_infos(self):
        return [list(self.leaf.files)]


def _schema_ok(scan: FileScan, e: IndexLogEntry) -> bool:
    relation_cols = {c.lower() for c in scan.full_schema.names}
    return {c.lower() for c in e.derived_dataset.referenced_columns()} <= relation_cols


def _signature_ok(scan: FileScan, e: IndexLogEntry) -> bool:
    sig = e.signature.signatures[0]
    return get_provider(sig.provider).sign(_LeafPlan(scan)) == sig.value


class CandidateIndexCollector:
    def apply(
        self, plan: LogicalPlan, all_indexes: list[IndexLogEntry]
    ) -> dict[int, list[IndexLogEntry]]:
        out: dict[int, list[IndexLogEntry]] = {}
        for node in plan.preorder():
            if not isinstance(node, FileScan) or node.index_info is not None:
                continue
            entries = [
                e for e in all_indexes if _schema_ok(node, e) and _signature_ok(node, e)
            ]
            if entries:
                out[node.plan_id] = entries
        return out
