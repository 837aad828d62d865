"""Candidate index collection (counterpart of hyperspace_tpu/rules/collector.py).

Per source scan: the indexes whose columns all exist in the relation
(ColumnSchemaFilter), then those whose recorded source signature matches
the scan's files (FileSignatureFilter). A quick-refreshed entry matches
through its current fingerprint and serves its recorded delta by hybrid
scan. With hybrid scan on, an entry whose files overlap the scan's is a
candidate too, within the appended and deleted byte ratios; it is tagged
with the files the rewrite must add and drop. A scan is a candidate only
when a source provider supports it (sources/manager.py). A scan of an
older table snapshot (Delta- or Iceberg-style) may use the index log
version recorded against that snapshot: its entry is substituted for the
latest one (time travel). The JAX package's adaptive vetoes wait with
their plane.
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


TAG_SUBSTITUTE_ENTRY = "SUBSTITUTE_LOG_ENTRY"


class FileSignatureFilter(SourcePlanIndexFilter):
    """Exact fingerprint match, snapshot time travel, or hybrid-scan
    overlap candidacy."""

    def apply(self, plan: FileScan, entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
        hybrid = self.session.conf.hybrid_scan_enabled
        out = []
        for e in entries:
            # an exact match, a quick refresh's promise or time travel wins
            # whatever the hybrid toggle: turning it on never makes an index
            # less usable
            if self._signature_match(plan, e, tag_on_fail=not hybrid):
                sub = e.get_tag(plan.plan_id, TAG_SUBSTITUTE_ENTRY)
                out.append(sub if sub is not None else e)
            elif hybrid and self._hybrid_candidate(plan, e):
                out.append(e)
        return out

    def _signature_match(self, plan: FileScan, e: IndexLogEntry, tag_on_fail: bool) -> bool:
        sig = e.signature.signatures[0]
        current = get_provider(sig.provider).sign(_LeafPlan(plan))
        ok = current == sig.value
        if ok and e.source_update() is not None:
            # quick-refreshed: the recorded delta is served by hybrid scan,
            # with no ratio thresholds (the user asked for it)
            self._tag_recorded_delta(plan, e)
            return True
        if not ok and self._closest_snapshot_match(plan, e, current):
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

    def _closest_snapshot_match(self, plan: FileScan, e: IndexLogEntry, current_sig) -> bool:
        """Time travel: the log version recorded against the scan's table
        snapshot, when its signature is the scan's, is tagged to stand in
        for ``e``."""
        log_version = _closest_log_version_for_plan(plan, e.properties)
        if log_version is None or log_version == e.id:
            return False
        from ..index_manager import index_manager_for

        old = index_manager_for(self.session).get_index(e.name, log_version)
        if old is None or current_sig != old.signature.signatures[0].value:
            return False
        e.set_tag(plan.plan_id, TAG_SUBSTITUTE_ENTRY, old)
        return True

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
        from ..sources.manager import SourceProviderManager

        manager = SourceProviderManager(self.session)
        schema_filter = ColumnSchemaFilter(self.session)
        signature_filter = FileSignatureFilter(self.session)
        out: dict[int, list[IndexLogEntry]] = {}
        for node in plan.preorder():
            if not isinstance(node, FileScan) or not manager.is_supported_relation(node):
                continue
            entries = signature_filter.apply(node, schema_filter.apply(node, all_indexes))
            entries = _drop_adaptive_vetoes(entries)
            if entries:
                out[node.plan_id] = entries
        return out


def _drop_adaptive_vetoes(entries: list[IndexLogEntry]) -> list[IndexLogEntry]:
    """Drop the candidates the query's adaptive replan loop aborted out of
    (plan/adaptive.vetoed_indexes), so the re-plan takes the next candidate
    or the raw scan; outside a replan scope, one empty-set read."""
    from ..plan.adaptive import vetoed_indexes

    vetoed = vetoed_indexes()
    if not vetoed:
        return entries
    dropped = [e.name for e in entries if e.name in vetoed]
    if dropped:
        from ..telemetry import workload

        workload.note_candidate_reject(dropped, "ADAPTIVE_ABORT")
    return [e for e in entries if e.name not in vetoed]


def _closest_log_version_for_plan(plan: FileScan, properties) -> "int | None":
    """The index log version a snapshot scan travels to: by version order
    for a Delta-style table, by the snapshot's ancestry for an
    Iceberg-style one; None for any other scan."""
    from ..sources import delta as D
    from ..sources import iceberg as I

    fmt = plan.options.get("format")
    if fmt == D.SNAPSHOT_FORMAT:
        queried = plan.options.get(D.OPT_SNAPSHOT_VERSION)
        return None if queried is None else D.closest_index_version(properties, int(queried))
    if fmt == I.ICEBERG_FORMAT:
        queried = plan.options.get(I.OPT_SNAPSHOT_ID)
        table_path = plan.options.get(I.OPT_TABLE_PATH)
        if queried is None or table_path is None:
            return None
        return I.closest_index_version_by_ancestry(I.IcebergStyleTable(table_path), properties,
                                                   int(queried))
    return None
