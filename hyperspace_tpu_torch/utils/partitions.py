"""Hive-style partition paths, ``.../key=value/...`` directories
(counterpart of hyperspace_tpu/utils/partitions.py).

Pure functions of a file's path and the read roots, so nothing can drift
from a scan's file list. Only directory components strictly below the
read root count: a ``=`` in an ancestor directory or in the file name never
makes a column.
"""

from __future__ import annotations

import os

from ..columnar.table import Field


def _relative_dir_components(path: str, roots: list[str]) -> list[str]:
    """The directory components of ``path`` below its (longest matching)
    read root; none when it lies under no root."""
    apath = os.path.abspath(path)
    for root in sorted((os.path.abspath(r) for r in roots), key=len, reverse=True):
        if apath == root:
            return []
        if apath.startswith(root.rstrip(os.sep) + os.sep):
            rel = os.path.relpath(os.path.dirname(apath), root)
            return [] if rel == "." else rel.split(os.sep)
    return []


def parse_partition_values(path: str, roots: list[str] | None = None) -> dict[str, str]:
    """The ``key=value`` directory components below the read root, in
    order (without roots: every directory component of the path). A key
    that starts with ``_`` or ``.`` is no partition."""
    comps = _relative_dir_components(path, roots) if roots else path.split(os.sep)[:-1]
    out: dict[str, str] = {}
    for comp in comps:
        if "=" in comp and not comp.startswith("="):
            k, _, v = comp.partition("=")
            if k and not k.startswith(("_", ".")):
                out[k] = v
    return out


def infer_partition_fields(file_paths: list[str], roots: list[str] | None = None
                           ) -> list[Field]:
    """The partition columns every file shares, in path order: int64 when
    every value parses as an integer, else string; none when the files
    disagree on the keys."""
    if not file_paths:
        return []
    per_file = [parse_partition_values(p, roots) for p in file_paths]
    keys = list(per_file[0])
    if any(list(pv) != keys for pv in per_file[1:]):
        return []
    fields = []
    for k in keys:
        try:
            for pv in per_file:
                int(pv[k])
            dtype = "int64"
        except ValueError:
            dtype = "string"
        fields.append(Field(k, dtype))
    return fields


def partition_key(path: str, keys: list[str], roots: list[str] | None = None) -> tuple:
    """The file's values of ``keys`` ("" where it has none)."""
    pv = parse_partition_values(path, roots)
    return tuple(pv.get(k, "") for k in keys)
