"""Candidate index collection (counterpart of hyperspace_tpu/rules/collector.py).

Per source scan: the indexes whose columns all exist in the relation
(ColumnSchemaFilter), then those whose recorded source signature matches
the scan's files (FileSignatureFilter). A quick-refreshed entry matches
through its current fingerprint and serves its recorded delta by hybrid
scan. With hybrid scan on, an entry whose files overlap the scan's is a
candidate too, within the appended and deleted byte ratios; it is tagged
with the files the rewrite must add and drop. The JAX package's snapshot
time travel (Delta and Iceberg sources) and adaptive vetoes wait with their
planes.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .base import (
    COL_SCHEMA_MISMATCH,
    NO_COMMON_FILES,
    NO_DELETE_SUPPORT,
    SOURCE_DATA_CHANGED,
    TAG_COMMON_SOURCE_SIZE_IN_BYTES,
    TAG_HYBRIDSCAN_APPENDED,
    TAG_HYBRIDSCAN_DELETED,
    TAG_HYBRIDSCAN_REQUIRED,
    TOO_MUCH_APPENDED,
    TOO_MUCH_DELETED,
    SourcePlanIndexFilter,
    reason,
)
from ..meta.entry import IndexLogEntry
from ..meta.signatures import get_provider
from ..plan.nodes import FileScan, LogicalPlan

if TYPE_CHECKING:
    from ..session import HyperspaceSession


class _LeafPlan:
    """A single leaf as a signable plan."""

    def __init__(self, leaf: FileScan):
        self.leaf = leaf

    def preorder_kinds(self):
        return [self.leaf.kind]

    def leaf_file_infos(self):
        return [list(self.leaf.files)]


class ColumnSchemaFilter(SourcePlanIndexFilter):
    """The index's columns must all exist in the relation."""

    def apply(self, plan: FileScan, entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
        relation_cols = {c.lower() for c in plan.full_schema.names}
        out = []
        for e in entries:
            cols = {c.lower() for c in e.derived_dataset.referenced_columns()}
            if self.tag_reason_if(
                cols <= relation_cols, plan, e,
                reason(COL_SCHEMA_MISMATCH, "Index and source have different schemas.",
                       indexCols=sorted(cols), relationCols=sorted(relation_cols)),
            ):
                out.append(e)
        return out


class FileSignatureFilter(SourcePlanIndexFilter):
    """Exact fingerprint match, or hybrid-scan overlap candidacy."""

    def apply(self, plan: FileScan, entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
        hybrid = self.session.conf.hybrid_scan_enabled
        out = []
        for e in entries:
            # an exact match (or a quick refresh's promise) wins whatever the
            # hybrid toggle: turning it on never makes an index less usable
            if self._signature_match(plan, e, tag_on_fail=not hybrid):
                out.append(e)
            elif hybrid and self._hybrid_candidate(plan, e):
                out.append(e)
        return out

    def _signature_match(self, plan: FileScan, e: IndexLogEntry, tag_on_fail: bool) -> bool:
        sig = e.signature.signatures[0]
        ok = get_provider(sig.provider).sign(_LeafPlan(plan)) == sig.value
        if ok and e.source_update() is not None:
            # quick-refreshed: the recorded delta is served by hybrid scan,
            # with no ratio thresholds (the user asked for it)
            self._tag_recorded_delta(plan, e)
            return True
        if not tag_on_fail:
            return ok
        return self.tag_reason_if(ok, plan, e,
                                  reason(SOURCE_DATA_CHANGED, "Index signature does not match."))

    def _tag_recorded_delta(self, plan: FileScan, e: IndexLogEntry) -> None:
        appended = e.appended_files()
        deleted = e.deleted_files()  # recorded with their build-time ids
        common_bytes = sum(f.size for f in e.source_file_infos() if f not in deleted)
        _set_hybrid_tags(plan, e, appended, deleted, common_bytes)

    def _hybrid_candidate(self, plan: FileScan, e: IndexLogEntry) -> bool:
        indexed_files = e.source_file_infos()
        current = set(plan.files)
        common = current & indexed_files
        if not self.tag_reason_if(bool(common), plan, e,
                                  reason(NO_COMMON_FILES,
                                         "No common files between source and index.")):
            return False
        appended = current - indexed_files
        deleted = indexed_files - current
        common_bytes = sum(f.size for f in common)
        appended_bytes = sum(f.size for f in appended)
        deleted_bytes = sum(f.size for f in deleted)
        total = common_bytes + appended_bytes
        appended_ratio = appended_bytes / total if total else 0.0
        old_total = common_bytes + deleted_bytes
        deleted_ratio = deleted_bytes / old_total if old_total else 0.0
        conf = self.session.conf
        if not self.tag_reason_if(
            appended_ratio <= conf.hybrid_scan_max_appended_ratio, plan, e,
            reason(TOO_MUCH_APPENDED,
                   f"Appended bytes ratio {appended_ratio:.3f} exceeds threshold.",
                   appendedRatio=f"{appended_ratio:.3f}"),
        ):
            return False
        if deleted and not self.tag_reason_if(
            e.derived_dataset.can_handle_deleted_files(), plan, e,
            reason(NO_DELETE_SUPPORT, "Index has no lineage for deleted files."),
        ):
            return False
        if not self.tag_reason_if(
            deleted_ratio <= conf.hybrid_scan_max_deleted_ratio, plan, e,
            reason(TOO_MUCH_DELETED,
                   f"Deleted bytes ratio {deleted_ratio:.3f} exceeds threshold.",
                   deletedRatio=f"{deleted_ratio:.3f}"),
        ):
            return False
        _set_hybrid_tags(plan, e, appended, deleted, common_bytes)
        return True


def _set_hybrid_tags(plan: FileScan, e: IndexLogEntry, appended, deleted,
                     common_bytes: int) -> None:
    """The contract with rule_utils.transform_plan_to_use_index, stamped in
    one place whichever path qualified the entry."""
    e.set_tag(plan.plan_id, TAG_HYBRIDSCAN_REQUIRED, bool(appended or deleted))
    e.set_tag(plan.plan_id, TAG_COMMON_SOURCE_SIZE_IN_BYTES, common_bytes)
    e.set_tag(plan.plan_id, TAG_HYBRIDSCAN_APPENDED, sorted(appended, key=lambda f: f.name))
    e.set_tag(plan.plan_id, TAG_HYBRIDSCAN_DELETED, sorted(deleted, key=lambda f: f.name))


class CandidateIndexCollector:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session

    def apply(self, plan: LogicalPlan, all_indexes: list[IndexLogEntry]
              ) -> dict[int, list[IndexLogEntry]]:
        schema_filter = ColumnSchemaFilter(self.session)
        signature_filter = FileSignatureFilter(self.session)
        out: dict[int, list[IndexLogEntry]] = {}
        for node in plan.preorder():
            # the reference's source providers support parquet relations; an
            # index scan is not a source relation
            if not isinstance(node, FileScan) or node.index_info is not None:
                continue
            if node.fmt != "parquet":
                continue
            entries = signature_filter.apply(node, schema_filter.apply(node, all_indexes))
            if entries:
                out[node.plan_id] = entries
        return out
