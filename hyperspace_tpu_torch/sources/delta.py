"""Snapshot-versioned tables, the Delta-style provider (counterpart of
hyperspace_tpu/sources/delta.py).

A table is a directory of immutable parquet files and ``_snapshots/<v>.json``
manifests, one per version, each listing the files of that version and
its schema. ``SnapshotTable`` writes and scans it; the provider resolves
its scans. An index records, per log version, the table version it was
built from (``snapshotVersionHistory``, ``"logv:tablev"`` pairs), so a
query over an older version uses the index log version built closest
below it (time travel).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .interfaces import FileBasedRelation, FileBasedSourceProvider
from ..columnar import io as cio
from ..columnar.table import Schema
from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo, Relation
from ..plan.nodes import FileScan, LogicalPlan

SNAPSHOT_DIR = "_snapshots"
SNAPSHOT_FORMAT = "snapshot-parquet"
VERSION_HISTORY_PROPERTY = "snapshotVersionHistory"
OPT_SNAPSHOT_VERSION = "snapshotVersion"
OPT_TABLE_PATH = "snapshotTablePath"


class SnapshotTable:
    """A versioned table: immutable parquet files and JSON manifests."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.snap_dir = os.path.join(self.path, SNAPSHOT_DIR)

    def _next_version(self) -> int:
        v = self.latest_version()
        return 0 if v is None else v + 1

    def _write_manifest(self, version: int, files: list[str], schema: list[dict]) -> None:
        os.makedirs(self.snap_dir, exist_ok=True)
        with open(os.path.join(self.snap_dir, f"{version}.json"), "w") as f:
            json.dump({"version": version, "files": files, "schema": schema}, f)

    def commit(self, batch, mode: str = "append") -> int:
        """A new version holding ``batch`` as one new file: with ``append``
        the previous version's files too, with ``overwrite`` only it."""
        os.makedirs(self.snap_dir, exist_ok=True)
        version = self._next_version()
        fname = f"part-{version:05d}.parquet"
        cio.write_parquet(batch, os.path.join(self.path, fname))
        files = [fname]
        if mode == "append" and version > 0:
            files = self.snapshot_files(version - 1) + files
        self._write_manifest(version, files, [f.to_dict() for f in batch.schema])
        return version

    def delete_files(self, file_names: list[str]) -> int:
        """A new version without the named files (a logical delete)."""
        version = self._next_version()
        drop = set(file_names)
        files = [f for f in self.snapshot_files(version - 1) if f not in drop]
        self._write_manifest(version, files, self._manifest(version - 1)["schema"])
        return version

    def latest_version(self) -> Optional[int]:
        if not os.path.isdir(self.snap_dir):
            return None
        vs = [int(n[:-5]) for n in os.listdir(self.snap_dir) if n.endswith(".json")]
        return max(vs) if vs else None

    def _manifest(self, version: int) -> dict:
        p = os.path.join(self.snap_dir, f"{version}.json")
        if not os.path.exists(p):
            raise HyperspaceError(f"Snapshot version {version} not found at {self.path}")
        with open(p) as f:
            return json.load(f)

    def snapshot_files(self, version: int) -> list[str]:
        return list(self._manifest(version)["files"])

    def scan(self, session, version: int | None = None):
        """A DataFrame over a version (the latest by default)."""
        from ..plan.dataframe import DataFrame

        v = self.latest_version() if version is None else version
        if v is None:
            raise HyperspaceError(f"No snapshots at {self.path}")
        m = self._manifest(v)
        files = [FileInfo.from_path(os.path.join(self.path, fn)) for fn in m["files"]]
        scan = FileScan(
            [self.path], "parquet", Schema.from_list(m["schema"]), files,
            options={OPT_SNAPSHOT_VERSION: str(v), OPT_TABLE_PATH: self.path,
                     "format": SNAPSHOT_FORMAT},
        )
        return DataFrame(session, scan)


class DeltaStyleSource(FileBasedSourceProvider):
    """The provider of SnapshotTable scans; the recorded relation's format
    is ``snapshot-parquet``, so refresh reloads it here."""

    def _supported(self, node: LogicalPlan) -> bool:
        return (isinstance(node, FileScan) and node.options.get("format") == SNAPSHOT_FORMAT
                and node.index_info is None)

    def is_supported_relation(self, node: LogicalPlan) -> Optional[bool]:
        return True if self._supported(node) else None

    def get_relation(self, session, node: LogicalPlan) -> Optional[FileBasedRelation]:
        return SnapshotRelation(session, node) if self._supported(node) else None

    def reload_relation(self, session, metadata: Relation):
        if metadata.file_format != SNAPSHOT_FORMAT:
            return None
        return SnapshotTable(metadata.options[OPT_TABLE_PATH]).scan(session)


class SnapshotRelation(FileBasedRelation):
    @property
    def snapshot_version(self) -> int:
        return int(self.scan.options[OPT_SNAPSHOT_VERSION])

    def record_version_history(self, properties: dict[str, str], log_version: int) -> None:
        update_version_history(properties, self.snapshot_version, log_version)

    @property
    def file_format(self) -> str:
        return SNAPSHOT_FORMAT


def update_version_history(properties: dict[str, str], snapshot_version: int,
                           log_version: int) -> None:
    """Append the pair ``log_version:snapshot_version`` (explicit pairs: a
    delete or restore adds log versions that built nothing)."""
    parts = [p for p in properties.get(VERSION_HISTORY_PROPERTY, "").split(",") if p]
    parts.append(f"{log_version}:{snapshot_version}")
    properties[VERSION_HISTORY_PROPERTY] = ",".join(parts)


def parse_version_history(properties: dict[str, str]) -> list[tuple[int, int]]:
    """The ``(log_version, table_version)`` pairs; malformed ones skipped."""
    out = []
    for p in properties.get(VERSION_HISTORY_PROPERTY, "").split(","):
        a, sep, b = p.partition(":")
        if not sep:
            continue
        try:
            out.append((int(a), int(b)))
        except ValueError:
            continue
    return out


def closest_index_version(properties: dict[str, str], queried_version: int) -> Optional[int]:
    """The log version recorded against the largest table version at or
    below the queried one (the first such pair on a tie)."""
    best = None
    for log_version, table_version in parse_version_history(properties):
        if table_version <= queried_version and (best is None or table_version > best[1]):
            best = (log_version, table_version)
    return best[0] if best else None
