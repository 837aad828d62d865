"""Continuous ingestion into live indexes (counterpart of
hyperspace_tpu/ingest/__init__.py).

- ``Hyperspace.append(name, df)`` and :func:`append_batch` index new
  source data as append-only per-bucket delta runs, each batch an
  atomically published immutable data version (actions.py);
- queries pin the snapshot they were planned against, and a refcount
  keeps every pinned version's files on disk until the query drains
  (snapshots.py);
- compaction merges delta runs, and a refcount-gated vacuum retires the
  superseded versions (compaction.py, actions/lifecycle.py).
"""

from __future__ import annotations

import itertools
import os
from typing import TYPE_CHECKING

from .actions import IngestAppendAction, IngestCompactAction
from .compaction import maintenance_idle, maybe_schedule, needs_compaction, runs_per_bucket
from .snapshots import (
    REGISTRY,
    Snapshot,
    SnapshotRegistry,
    current_pins,
    observe_pins,
    pin_current,
    pin_scope,
    protected_version,
)

if TYPE_CHECKING:
    from ..session import HyperspaceSession

__all__ = [
    "IngestAppendAction",
    "IngestCompactAction",
    "REGISTRY",
    "Snapshot",
    "SnapshotRegistry",
    "append_batch",
    "current_pins",
    "latest_stable_entry",
    "maintenance_idle",
    "maybe_schedule",
    "needs_compaction",
    "observe_pins",
    "pin_current",
    "pin_scope",
    "protected_version",
    "runs_per_bucket",
]

_batch_seq = itertools.count()


def latest_stable_entry(session: "HyperspaceSession", index_name: str):
    """The latest stable IndexLogEntry of ``index_name``, even while a
    writer's transaction is open (the latest log id is then a transient
    entry); None only when the index has no stable entry."""
    from ..index_manager import index_manager_for
    from ..meta.entry import IndexLogEntry
    from ..meta.log_manager import IndexLogManager

    manager = index_manager_for(session)
    entry = manager.get_index(index_name)
    if entry is not None:
        return entry
    stable = IndexLogManager(manager.resolver.get_index_path(index_name)).get_latest_stable_log()
    return stable if isinstance(stable, IndexLogEntry) else None


def append_batch(session: "HyperspaceSession", index_name: str, data,
                 filename: "str | None" = None) -> str:
    """Write ``data`` (a column dict or a ColumnBatch) as one new parquet
    file under the index's source root and append it to the index in the
    same call; returns the new file's path. The default file name holds
    the entry id, the process id and a sequence number, so ingesters of
    one process never collide; ingesters in several processes pass
    ``filename``."""
    from ..columnar import io as cio
    from ..columnar.table import ColumnBatch
    from ..exceptions import HyperspaceError
    from ..index_manager import index_manager_for

    manager = index_manager_for(session)
    entry = latest_stable_entry(session, index_name)
    if entry is None:
        raise HyperspaceError(f"Index with name {index_name!r} could not be found")
    roots = entry.relation.root_paths
    if len(roots) != 1 or not os.path.isdir(roots[0]):
        raise HyperspaceError(f"append_batch needs a single directory source root, got {roots}")
    batch = data if isinstance(data, ColumnBatch) else ColumnBatch.from_pydict(data)
    name = filename or (
        f"part-ingest-{entry.id:05d}-{os.getpid()}-{next(_batch_seq):06d}.parquet")
    path = os.path.join(roots[0], name)
    if os.path.exists(path):
        raise HyperspaceError(f"append_batch target already exists: {path}")
    cio.write_parquet(batch, path)
    manager.append(index_name, session.read.parquet(path))
    return path
