"""Tables addressed by snapshot ids, the Iceberg-style provider
(counterpart of hyperspace_tpu/sources/iceberg.py).

    table/
      part-<uuid>.parquet              immutable data files
      metadata/
        v<N>.metadata.json             schema, snapshots, current-snapshot-id
        snap-<snapshot-id>.json        a manifest list
        manifest-<uuid>.json           data-file entries

Snapshot ids are random 63-bit integers with parent ancestry, not
sequential versions: time travel addresses a snapshot by id or by time,
and the index log version a query uses is the one recorded against the
nearest ancestor of its snapshot. The ids and file names come from
``uuid4``-form values drawn from ``rng`` (a ``random.Random`` or a numpy
``Generator``), or from the system's randomness when it is None, as in
the JAX package.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

from .interfaces import FileBasedRelation, FileBasedSourceProvider
from ..columnar import io as cio
from ..columnar.table import Schema
from ..exceptions import HyperspaceError
from ..meta.entry import FileInfo, Relation
from ..plan.nodes import FileScan, LogicalPlan

METADATA_DIR = "metadata"
ICEBERG_FORMAT = "iceberg-parquet"
SNAPSHOT_ID_HISTORY_PROPERTY = "icebergSnapshotIdHistory"
OPT_SNAPSHOT_ID = "icebergSnapshotId"
OPT_TABLE_PATH = "icebergTablePath"


def _uuid4(rng=None) -> uuid.UUID:
    if rng is None:
        return uuid.uuid4()
    if hasattr(rng, "getrandbits"):  # random.Random
        bits = rng.getrandbits(128)
    else:  # numpy.random.Generator
        bits = int.from_bytes(rng.bytes(16), "big")
    return uuid.UUID(int=bits, version=4)


class IcebergStyleTable:
    """Metadata files point at manifest lists, manifest lists at manifests,
    manifests at data files."""

    def __init__(self, path: str, rng=None):
        self.path = os.path.abspath(path)
        self.meta_dir = os.path.join(self.path, METADATA_DIR)
        self.rng = rng

    def _new_snapshot_id(self) -> int:
        return _uuid4(self.rng).int & ((1 << 63) - 1)

    # --- metadata reads ---
    def _metadata_versions(self) -> list[int]:
        if not os.path.isdir(self.meta_dir):
            return []
        out = []
        for n in os.listdir(self.meta_dir):
            if n.startswith("v") and n.endswith(".metadata.json"):
                seg = n[1:-len(".metadata.json")]
                if seg.isdigit():  # another tool's files never break a read
                    out.append(int(seg))
        return sorted(out)

    def _load_metadata(self) -> Optional[dict]:
        vs = self._metadata_versions()
        if not vs:
            return None
        with open(os.path.join(self.meta_dir, f"v{vs[-1]}.metadata.json")) as f:
            return json.load(f)

    def current_snapshot_id(self) -> Optional[int]:
        md = self._load_metadata()
        return None if md is None else md.get("current-snapshot-id")

    def snapshots(self) -> list[dict]:
        md = self._load_metadata()
        return [] if md is None else list(md.get("snapshots", []))

    def _snapshot(self, snapshot_id: int) -> dict:
        for s in self.snapshots():
            if s["snapshot-id"] == snapshot_id:
                return s
        raise HyperspaceError(f"Snapshot {snapshot_id} not found at {self.path}")

    def parent_of(self, snapshot_id: int) -> Optional[int]:
        return self._snapshot(snapshot_id).get("parent-snapshot-id")

    def _manifests(self, snapshot_id: int) -> list[str]:
        s = self._snapshot(snapshot_id)
        with open(os.path.join(self.meta_dir, s["manifest-list"])) as f:
            return list(json.load(f)["manifests"])

    def data_files(self, snapshot_id: int) -> list[dict]:
        entries: list[dict] = []
        for m in self._manifests(snapshot_id):
            with open(os.path.join(self.meta_dir, m)) as f:
                entries.extend(json.load(f)["entries"])
        return entries

    # --- commits ---
    def _write_manifest(self, entries: list[dict]) -> str:
        name = f"manifest-{_uuid4(self.rng).hex}.json"
        with open(os.path.join(self.meta_dir, name), "w") as f:
            json.dump({"entries": entries}, f)
        return name

    def _commit_snapshot(self, manifests: list[str], schema_list: list[dict]) -> int:
        md = self._load_metadata() or {
            "format-version": 1,
            "table-uuid": _uuid4(self.rng).hex,
            "snapshots": [],
            "current-snapshot-id": None,
        }
        sid = self._new_snapshot_id()
        list_name = f"snap-{sid}.json"
        with open(os.path.join(self.meta_dir, list_name), "w") as f:
            json.dump({"manifests": manifests}, f)
        md["snapshots"] = md.get("snapshots", []) + [{
            "snapshot-id": sid,
            "parent-snapshot-id": md.get("current-snapshot-id"),
            "timestamp-ms": int(time.time() * 1000),
            "manifest-list": list_name,
            # each snapshot keeps its schema: time travel reads old files
            # through their own schema
            "schema": schema_list,
        }]
        md["current-snapshot-id"] = sid
        md["schema"] = schema_list
        vs = self._metadata_versions()
        nxt = (vs[-1] + 1) if vs else 1
        with open(os.path.join(self.meta_dir, f"v{nxt}.metadata.json"), "w") as f:
            json.dump(md, f)
        return sid

    def commit(self, batch, mode: str = "append") -> int:
        """A new data file and snapshot; its id. ``append`` carries the
        previous manifests over, ``overwrite`` keeps only the new one."""
        os.makedirs(self.meta_dir, exist_ok=True)
        fname = f"part-{_uuid4(self.rng).hex}.parquet"
        fpath = os.path.join(self.path, fname)
        cio.write_parquet(batch, fpath)
        entry = {"path": fname, "file_size": os.path.getsize(fpath),
                 "record_count": batch.num_rows}
        manifests = [self._write_manifest([entry])]
        cur = self.current_snapshot_id()
        if mode == "append" and cur is not None:
            manifests = self._manifests(cur) + manifests
        return self._commit_snapshot(manifests, [f.to_dict() for f in batch.schema])

    def delete_files(self, file_names: list[str]) -> int:
        """A new snapshot without the named data files: a manifest that
        held one is rewritten, the others carry over."""
        cur = self.current_snapshot_id()
        if cur is None:
            raise HyperspaceError(f"No snapshots at {self.path}")
        drop = set(file_names)
        manifests_out: list[str] = []
        for m in self._manifests(cur):
            with open(os.path.join(self.meta_dir, m)) as f:
                entries = json.load(f)["entries"]
            kept = [e for e in entries if e["path"] not in drop]
            if len(kept) == len(entries):
                manifests_out.append(m)
            elif kept:
                manifests_out.append(self._write_manifest(kept))
        return self._commit_snapshot(manifests_out, self._load_metadata().get("schema", []))

    # --- reads ---
    def snapshot_as_of(self, timestamp_ms: int) -> Optional[int]:
        """The latest snapshot at or before the time (the first on a tie)."""
        best = None
        for s in self.snapshots():
            if s["timestamp-ms"] <= timestamp_ms and (
                    best is None or s["timestamp-ms"] > best["timestamp-ms"]):
                best = s
        return None if best is None else best["snapshot-id"]

    def scan(self, session, snapshot_id: int | None = None, as_of_ms: int | None = None):
        """A DataFrame over a snapshot: by id, else as of a time, else the
        current one."""
        from ..plan.dataframe import DataFrame

        if snapshot_id is None and as_of_ms is not None:
            snapshot_id = self.snapshot_as_of(as_of_ms)
        if snapshot_id is None:
            snapshot_id = self.current_snapshot_id()
        if snapshot_id is None:
            raise HyperspaceError(f"No snapshots at {self.path}")
        md = self._load_metadata()
        snap = self._snapshot(snapshot_id)
        schema_list = snap.get("schema") or md["schema"]
        files = [FileInfo.from_path(os.path.join(self.path, e["path"]))
                 for e in self.data_files(snapshot_id)]
        scan = FileScan(
            [self.path], "parquet", Schema.from_list(schema_list), files,
            options={OPT_SNAPSHOT_ID: str(snapshot_id), OPT_TABLE_PATH: self.path,
                     "format": ICEBERG_FORMAT},
        )
        return DataFrame(session, scan)


class IcebergStyleSource(FileBasedSourceProvider):
    """The provider of IcebergStyleTable scans; the recorded relation's
    format is ``iceberg-parquet``, so refresh reloads it here."""

    def _supported(self, node: LogicalPlan) -> bool:
        return (isinstance(node, FileScan) and node.options.get("format") == ICEBERG_FORMAT
                and node.index_info is None)

    def is_supported_relation(self, node: LogicalPlan) -> Optional[bool]:
        return True if self._supported(node) else None

    def get_relation(self, session, node: LogicalPlan) -> Optional[FileBasedRelation]:
        return IcebergRelation(session, node) if self._supported(node) else None

    def reload_relation(self, session, metadata: Relation):
        if metadata.file_format != ICEBERG_FORMAT:
            return None
        return IcebergStyleTable(metadata.options[OPT_TABLE_PATH]).scan(session)


class IcebergRelation(FileBasedRelation):
    @property
    def snapshot_id(self) -> int:
        return int(self.scan.options[OPT_SNAPSHOT_ID])

    @property
    def file_format(self) -> str:
        return ICEBERG_FORMAT

    def record_version_history(self, properties: dict[str, str], log_version: int) -> None:
        parts = [p for p in properties.get(SNAPSHOT_ID_HISTORY_PROPERTY, "").split(",") if p]
        parts.append(f"{log_version}:{self.snapshot_id}")
        properties[SNAPSHOT_ID_HISTORY_PROPERTY] = ",".join(parts)


def parse_snapshot_history(properties: dict[str, str]) -> list[tuple[int, int]]:
    """The ``(log_version, snapshot_id)`` pairs; malformed ones skipped."""
    out = []
    for p in properties.get(SNAPSHOT_ID_HISTORY_PROPERTY, "").split(","):
        a, sep, b = p.partition(":")
        if not sep:
            continue
        try:
            out.append((int(a), int(b)))
        except ValueError:
            continue
    return out


def closest_index_version_by_ancestry(table: IcebergStyleTable, properties: dict[str, str],
                                      queried_snapshot_id: int) -> Optional[int]:
    """The log version recorded against the queried snapshot or its
    nearest ancestor (a later record of the same snapshot wins); None when
    the chain reaches an unknown snapshot or its root first."""
    recorded = {sid: log_version for log_version, sid in parse_snapshot_history(properties)}
    sid: Optional[int] = queried_snapshot_id
    seen = set()
    while sid is not None and sid not in seen:
        seen.add(sid)
        if sid in recorded:
            return recorded[sid]
        try:
            sid = table.parent_of(sid)
        except HyperspaceError:
            return None
    return None
