"""On-disk index metadata model (counterpart of hyperspace_tpu/meta/entry.py).

The JSON written here is the same, key for key, as the JAX package writes:
an index built by either package is read by the other.

Reference parity: index/IndexLogEntry.scala — Content:40-113, Directory:123-303,
FileInfo:308-332, Signature/LogicalPlanFingerprint:337-374, Relation:379-384,
Source:386-406, IndexLogEntry:408-590 (runtime tag map 537-589),
FileIdTracker:627-703; LogEntry envelope index/LogEntry.scala:21-47.

Layout on disk is a versioned JSON envelope:
  {"version": "0.1", "id": N, "state": "...", "timestamp": ms, "enabled": true,
   "name": ..., "derivedDataset": {...}, "content": {...}, "source": {...},
   "properties": {...}}

`derivedDataset` is polymorphic on its "kind" field; index kinds register
themselves in INDEX_KIND_REGISTRY (models/base.py) the way the reference uses
Jackson @JsonTypeInfo on the Index trait.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from ..exceptions import HyperspaceError, UnknownIndexKindError

LOG_VERSION = "0.1"

# Deserializers for polymorphic derivedDataset, keyed by "kind".
# models/base.py populates this at import time.
INDEX_KIND_REGISTRY: dict[str, Callable[[dict], Any]] = {}


# ---------------------------------------------------------------------------
# FileInfo / Directory / Content
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FileInfo:
    """One source or index data file: (name, size, mtime, stable id).

    `name` is the file name only when nested in a Directory tree, matching the
    reference's normalized form (IndexLogEntry.scala:308-332). Equality and
    hashing ignore `id` like the reference's equals/hashCode (:318-327).
    """

    name: str
    size: int
    modified_time: int  # epoch millis
    id: int = -1

    UNKNOWN_FILE_ID = -1

    def __eq__(self, other):
        return (
            isinstance(other, FileInfo)
            and self.name == other.name
            and self.size == other.size
            and self.modified_time == other.modified_time
        )

    def __hash__(self):
        return hash((self.name, self.size, self.modified_time))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "size": self.size,
            "modifiedTime": self.modified_time,
            "id": self.id,
        }

    @staticmethod
    def from_dict(d: dict) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"], d.get("id", -1))

    @staticmethod
    def from_path(path: str, file_id: int = -1) -> "FileInfo":
        st = os.stat(path)
        return FileInfo(path, st.st_size, int(st.st_mtime * 1000), file_id)


@dataclass
class Directory:
    """Tree node of the Content hierarchy (ref: IndexLogEntry.scala:123-303).

    `name` is a single path component except at the root, where it is the
    filesystem root prefix (e.g. "/" or "C:\\"). Files hold leaf names only.
    """

    name: str
    files: list[FileInfo] = field(default_factory=list)
    subdirs: list["Directory"] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "files": [f.to_dict() for f in self.files],
            "subDirs": [d.to_dict() for d in self.subdirs],
        }

    @staticmethod
    def from_dict(d: dict) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_dict(f) for f in d.get("files", [])],
            [Directory.from_dict(s) for s in d.get("subDirs", [])],
        )

    @staticmethod
    def from_files(files: Iterable[FileInfo]) -> "Directory":
        """Build a minimal directory tree from absolute file paths
        (ref: Directory.fromLeafFiles IndexLogEntry.scala:195-260)."""
        root = Directory(name="/")
        for f in files:
            parts = [p for p in os.path.abspath(f.name).split(os.sep) if p]
            node = root
            for comp in parts[:-1]:
                child = next((s for s in node.subdirs if s.name == comp), None)
                if child is None:
                    child = Directory(name=comp)
                    node.subdirs.append(child)
                node = child
            node.files.append(
                FileInfo(parts[-1], f.size, f.modified_time, f.id)
            )
        return root


@dataclass
class Content:
    """Root of a Directory tree with flattened-path helpers
    (ref: Content IndexLogEntry.scala:40-113)."""

    root: Directory

    def to_dict(self) -> dict:
        return {"root": self.root.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "Content":
        return Content(Directory.from_dict(d["root"]))

    @staticmethod
    def from_files(files: Iterable[FileInfo]) -> "Content":
        return Content(Directory.from_files(files))

    @staticmethod
    def from_directory_path(
        path: str,
        file_id_tracker: Optional["FileIdTracker"] = None,
        path_filter: Callable[[str], bool] | None = None,
    ) -> "Content":
        """List leaf files under `path` recursively (ref: Content.fromDirectory)."""
        infos = []
        for dirpath, _dirnames, filenames in os.walk(path):
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                if path_filter is not None and not path_filter(full):
                    continue
                st = os.stat(full)
                size, mtime = st.st_size, int(st.st_mtime * 1000)
                fid = -1
                if file_id_tracker is not None:
                    fid = file_id_tracker.add_file(full, size, mtime)
                infos.append(FileInfo(full, size, mtime, fid))
        return Content.from_files(infos)

    def files(self) -> list[str]:
        """All file paths, absolute (ref: Content.files :46-52)."""
        return [f.name for f in self.file_infos()]

    def file_infos(self) -> list[FileInfo]:
        """FileInfos with `name` re-expanded to the absolute path
        (ref: Content.fileInfos :54-65)."""
        out: list[FileInfo] = []

        def walk(node: Directory, prefix: str):
            base = (
                node.name
                if prefix == ""
                else os.path.join(prefix, node.name)
                if node.name != "/"
                else "/"
            )
            for f in node.files:
                out.append(
                    FileInfo(os.path.join(base, f.name), f.size, f.modified_time, f.id)
                )
            for d in node.subdirs:
                walk(d, base)

        walk(self.root, "")
        return out

    @property
    def size_in_bytes(self) -> int:
        return sum(f.size for f in self.file_infos())


# ---------------------------------------------------------------------------
# Signatures / fingerprint
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Signature:
    provider: str
    value: str

    def to_dict(self) -> dict:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_dict(d: dict) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source logical plan at index-build time
    (ref: IndexLogEntry.scala:337-374)."""

    signatures: list[Signature]
    kind: str = "LogicalPlan"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "properties": {"signatures": [s.to_dict() for s in self.signatures]},
        }

    @staticmethod
    def from_dict(d: dict) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            [Signature.from_dict(s) for s in d["properties"]["signatures"]],
            d.get("kind", "LogicalPlan"),
        )


# ---------------------------------------------------------------------------
# Relation / Source
# ---------------------------------------------------------------------------

@dataclass
class Update:
    """Source-file delta recorded by quick refresh, consumed by Hybrid Scan
    (ref: Update IndexLogEntry.scala / RefreshQuickAction)."""

    appended_files: Content | None = None
    deleted_files: Content | None = None

    def to_dict(self) -> dict:
        return {
            "appendedFiles": self.appended_files.to_dict()
            if self.appended_files
            else None,
            "deletedFiles": self.deleted_files.to_dict()
            if self.deleted_files
            else None,
        }

    @staticmethod
    def from_dict(d: dict | None) -> "Update | None":
        if d is None:
            return None
        return Update(
            Content.from_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_dict(d["deletedFiles"]) if d.get("deletedFiles") else None,
        )


@dataclass
class Relation:
    """Serialized source relation: enough to re-load the source DataFrame at
    refresh time (ref: Relation IndexLogEntry.scala:379-384 and
    RefreshActionBase.df:54-77)."""

    root_paths: list[str]
    content: Content  # source files at index-build time ("data")
    schema: list[dict]  # [{"name":..., "type":...}, ...] in source column order
    file_format: str
    options: dict[str, str] = field(default_factory=dict)
    update: Update | None = None

    def to_dict(self) -> dict:
        return {
            "rootPaths": self.root_paths,
            "data": {
                "properties": {
                    "content": self.content.to_dict(),
                    "update": self.update.to_dict() if self.update else None,
                },
                "kind": "HDFS",
            },
            "dataSchemaJson": self.schema,
            "fileFormat": self.file_format,
            "options": self.options,
        }

    @staticmethod
    def from_dict(d: dict) -> "Relation":
        props = d["data"]["properties"]
        return Relation(
            d["rootPaths"],
            Content.from_dict(props["content"]),
            d["dataSchemaJson"],
            d["fileFormat"],
            d.get("options", {}),
            Update.from_dict(props.get("update")),
        )


@dataclass
class SourcePlan:
    """Source logical plan descriptor (ref: SparkPlan in IndexLogEntry.scala:386-395;
    here the plan is our own IR so the field names say what they are)."""

    relations: list[Relation]
    raw_plan: str  # rendered logical plan, informational
    fingerprint: LogicalPlanFingerprint

    def to_dict(self) -> dict:
        return {
            "properties": {
                "relations": [r.to_dict() for r in self.relations],
                "rawPlan": self.raw_plan,
                "fingerprint": self.fingerprint.to_dict(),
            },
            "kind": "Plan",
        }

    @staticmethod
    def from_dict(d: dict) -> "SourcePlan":
        p = d["properties"]
        return SourcePlan(
            [Relation.from_dict(r) for r in p["relations"]],
            p.get("rawPlan", ""),
            LogicalPlanFingerprint.from_dict(p["fingerprint"]),
        )


@dataclass
class Source:
    plan: SourcePlan

    def to_dict(self) -> dict:
        return {"plan": self.plan.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "Source":
        return Source(SourcePlan.from_dict(d["plan"]))


# ---------------------------------------------------------------------------
# Log entries
# ---------------------------------------------------------------------------

@dataclass
class LogEntry:
    """Versioned JSON envelope (ref: index/LogEntry.scala:21-47)."""

    state: str
    id: int = 0
    timestamp: int = 0
    enabled: bool = True

    def stamp(self) -> None:
        self.timestamp = int(time.time() * 1000)

    def to_dict(self) -> dict:
        return {
            "version": LOG_VERSION,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "enabled": self.enabled,
        }

    @staticmethod
    def from_dict(d: dict) -> "LogEntry | IndexLogEntry":
        if d.get("version") != LOG_VERSION:
            raise HyperspaceError(f"Unsupported log version: {d.get('version')}")
        if "name" in d:
            return IndexLogEntry.from_dict(d)
        e = LogEntry(d["state"], d["id"], d["timestamp"], d.get("enabled", True))
        return e


class IndexLogEntry(LogEntry):
    """Full index metadata entry (ref: IndexLogEntry.scala:408-590)."""

    def __init__(
        self,
        name: str,
        derived_dataset: Any,  # models.base.Index
        content: Content,
        source: Source,
        properties: dict[str, str] | None = None,
        state: str = "",
        id: int = 0,
        timestamp: int = 0,
        enabled: bool = True,
    ):
        super().__init__(state=state, id=id, timestamp=timestamp, enabled=enabled)
        self.name = name
        self.derived_dataset = derived_dataset
        self.content = content
        self.source = source
        self.properties: dict[str, str] = dict(properties or {})

    # --- convenience accessors (ref: IndexLogEntry.scala:430-530) ---
    @property
    def kind(self) -> str:
        return self.derived_dataset.kind

    @property
    def relations(self) -> list[Relation]:
        return self.source.plan.relations

    @property
    def relation(self) -> Relation:
        # Indexes cover exactly one relation today (ref: RelationUtils).
        if len(self.relations) != 1:
            raise HyperspaceError("Index must have exactly one source relation")
        return self.relations[0]

    @property
    def signature(self) -> LogicalPlanFingerprint:
        return self.source.plan.fingerprint

    def index_data_size_in_bytes(self) -> int:
        return self.content.size_in_bytes

    # --- serialization ---
    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(
            {
                "name": self.name,
                "derivedDataset": self.derived_dataset.to_dict(),
                "content": self.content.to_dict(),
                "source": self.source.to_dict(),
                "properties": self.properties,
            }
        )
        return d

    @staticmethod
    def from_dict(d: dict) -> "IndexLogEntry":
        dd = d["derivedDataset"]
        kind = dd.get("kind")
        if kind not in INDEX_KIND_REGISTRY:
            raise UnknownIndexKindError(kind)
        derived = INDEX_KIND_REGISTRY[kind](dd)
        return IndexLogEntry(
            d["name"],
            derived,
            Content.from_dict(d["content"]),
            Source.from_dict(d["source"]),
            d.get("properties", {}),
            d["state"],
            d["id"],
            d["timestamp"],
            d.get("enabled", True),
        )

    def __eq__(self, other):
        return (
            isinstance(other, IndexLogEntry)
            and self.name == other.name
            and self.state == other.state
            and self.id == other.id
            and self.to_dict() == other.to_dict()
        )

    def __hash__(self):
        return hash((self.name, self.state, self.id))


# ---------------------------------------------------------------------------
# FileIdTracker
# ---------------------------------------------------------------------------

class FileIdTracker:
    """Assigns stable monotonically-increasing ids to (path, size, mtime)
    triples; ids survive refreshes so lineage columns stay valid
    (ref: FileIdTracker IndexLogEntry.scala:627-703)."""

    def __init__(self):
        self._ids: dict[tuple[str, int, int], int] = {}
        self._max_id = -1

    @property
    def max_id(self) -> int:
        return self._max_id

    def add_file(self, path: str, size: int, mtime: int) -> int:
        key = (path, size, mtime)
        if key not in self._ids:
            self._max_id += 1
            self._ids[key] = self._max_id
        return self._ids[key]
