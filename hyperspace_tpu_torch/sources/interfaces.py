"""The source-provider contract and the glob and listing helpers
(counterpart of hyperspace_tpu/sources/interfaces.py).

A provider answers, for a plan leaf: is it supported, what files back it,
how it is recorded in the log entry, and how it is reloaded over its
current files at refresh. It answers None for a leaf that is not its own,
so the manager can ask the next one.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import TYPE_CHECKING, Optional

from ..columnar.table import Schema
from ..exceptions import HyperspaceError
from ..meta.entry import Content, FileIdTracker, FileInfo, Relation
from ..plan.nodes import FileScan, LogicalPlan

if TYPE_CHECKING:
    from ..session import HyperspaceSession


class FileBasedRelation:
    """A supported scan seen as an indexable relation."""

    def __init__(self, session: "HyperspaceSession", scan: FileScan):
        self.session = session
        self.scan = scan

    @property
    def root_paths(self) -> list[str]:
        return self.scan.root_paths

    def all_files(self) -> list[FileInfo]:
        return list(self.scan.files)

    @property
    def schema(self) -> Schema:
        return self.scan.full_schema

    @property
    def file_format(self) -> str:
        return self.scan.fmt

    @property
    def options(self) -> dict[str, str]:
        return dict(self.scan.options)

    def record_version_history(self, properties: dict[str, str], log_version: int) -> None:
        """Record the table version this index log version was built from
        in the index properties (snapshot providers; nothing by default)."""

    def create_relation_metadata(self, file_id_tracker: FileIdTracker) -> Relation:
        """The relation as the log entry records it, each file with its
        stable id."""
        infos = [
            FileInfo(f.name, f.size, f.modified_time,
                     file_id_tracker.add_file(f.name, f.size, f.modified_time))
            for f in self.all_files()
        ]
        return Relation(
            root_paths=self.root_paths,
            content=Content.from_files(infos),
            schema=self.schema.to_list(),
            file_format=self.file_format,
            options=self.options,
        )


class FileBasedSourceProvider:
    """A provider: each method answers None for a leaf or relation that is
    not its own."""

    def get_relation(self, session: "HyperspaceSession", node: LogicalPlan
                     ) -> Optional[FileBasedRelation]:
        raise NotImplementedError

    def is_supported_relation(self, node: LogicalPlan) -> Optional[bool]:
        raise NotImplementedError

    def reload_relation(self, session: "HyperspaceSession", metadata: Relation):
        """A DataFrame over the recorded relation's current files."""
        raise NotImplementedError


def _wildcard_match_is_hidden(pattern: str, match: str) -> bool:
    """True when a wildcard segment of the pattern matched a hidden or
    metadata entry (a leading ``_`` or ``.``); a hidden segment the pattern
    names literally is allowed. A ``**`` pattern checks every segment."""
    ps, ms = pattern.split(os.sep), match.split(os.sep)
    if len(ps) != len(ms):
        return any(seg.startswith(("_", ".")) for seg in ms if seg)
    return any(_glob.has_magic(pseg) and mseg.startswith(("_", "."))
               for pseg, mseg in zip(ps, ms))


def expand_glob_roots(roots: list[str], allow_empty: bool = False) -> list[str]:
    """Wildcard roots expanded, sorted; a path that exists is taken
    literally (a directory named ``data[1]`` is itself). A wildcard never
    matches a hidden entry. A pattern matching nothing raises unless
    ``allow_empty`` (a refresh's re-expansion); no match at all raises
    always."""
    out: list[str] = []
    for root in roots:
        if os.path.exists(root) or not _glob.has_magic(root):
            out.append(root)
            continue
        matches = sorted(m for m in _glob.glob(root) if not _wildcard_match_is_hidden(root, m))
        if not matches and not allow_empty:
            raise HyperspaceError(f"Glob pattern matched nothing: {root}")
        out.extend(matches)
    if not out and roots:
        raise HyperspaceError(f"Glob scope matched no paths at all: {roots}")
    return out


def encode_glob_paths(roots: list[str]) -> str:
    """The root patterns as a JSON list of absolute paths (a path may hold
    a comma)."""
    return json.dumps([os.path.abspath(r) for r in roots])


def decode_glob_paths(value: str) -> list[str]:
    """``encode_glob_paths``'s list; a value that is no JSON list is read
    as the older comma-separated form."""
    try:
        out = json.loads(value)
        if isinstance(out, list):
            return [str(p) for p in out]
    except ValueError:
        pass
    return [p for p in value.split(",") if p]


def _data_files(root: str) -> list[FileInfo]:
    """The data files under a directory, in walk order and by name within
    a directory; hidden and metadata directories and files (``_*``, ``.*``,
    e.g. _hyperspace_log) are skipped."""
    files: list[FileInfo] = []
    for dirpath, _dirs, names in os.walk(root):
        rel = os.path.relpath(dirpath, root).split(os.sep)
        if any(p.startswith(("_", ".")) for p in rel if p != "."):
            continue
        for fn in sorted(names):
            if not fn.startswith(("_", ".")):
                files.append(FileInfo.from_path(os.path.join(dirpath, fn)))
    return files


def relist_files(root_paths: list[str]) -> list[FileInfo]:
    """A fresh listing of a relation's roots (a recorded glob scope is
    expanded by the caller first); a root that is gone raises."""
    files: list[FileInfo] = []
    for root in root_paths:
        if os.path.isfile(root):
            files.append(FileInfo.from_path(root))
        elif os.path.isdir(root):
            files.extend(_data_files(root))
        else:
            raise HyperspaceError(f"Source path disappeared: {root}")
    return files
