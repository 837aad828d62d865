"""Index transaction log with optimistic concurrency (counterpart of
hyperspace_tpu/meta/log_manager.py).

Layout under each index root, shared with the JAX package:
    <index>/_hyperspace_log/<id>          immutable JSON log entries
    <index>/_hyperspace_log/latestStable  pointer file (JSON copy of entry)

A commit is "rename-if-absent": the entry is spooled to a temp file and
hard-linked to its id, which fails if another writer committed that id
first. Filesystems without hard links fall back to an O_CREAT|O_EXCL
create of the target. The recovery surface finds the temp spool files a
hard kill leaves behind and a latestStable pointer that lags the log. The
``log.write`` fault point (utils/faults.py) brackets the commit.
"""

from __future__ import annotations

import errno
import json
import os
import tempfile
import time
from typing import Optional

from .. import constants as C
from ..utils import faults
from .entry import LogEntry

STABLE_STATES = frozenset({"ACTIVE", "DELETED", "DOESNOTEXIST"})
_BARRIER_STATES = frozenset({"CREATING", "VACUUMING"})


class IndexLogManager:
    def __init__(self, index_path: str):
        self.index_path = index_path
        self.log_dir = os.path.join(index_path, C.HYPERSPACE_LOG)

    def _entry_path(self, log_id: int) -> str:
        return os.path.join(self.log_dir, str(log_id))

    def get_log(self, log_id: int) -> Optional[LogEntry]:
        p = self._entry_path(log_id)
        if not os.path.exists(p):
            return None
        with open(p, "r", encoding="utf-8") as f:
            return LogEntry.from_dict(json.load(f))

    def get_latest_id(self) -> Optional[int]:
        if not os.path.isdir(self.log_dir):
            return None
        ids = [int(n) for n in os.listdir(self.log_dir) if n.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[LogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[LogEntry]:
        """The latestStable pointer, else a backward scan that stops at
        CREATING/VACUUMING barriers."""
        ptr = os.path.join(self.log_dir, C.LATEST_STABLE_LOG)
        if os.path.exists(ptr):
            with open(ptr, "r", encoding="utf-8") as f:
                entry = LogEntry.from_dict(json.load(f))
            if entry.state in STABLE_STATES:
                return entry
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is None:
                continue
            if entry.state in STABLE_STATES:
                return entry
            if entry.state in _BARRIER_STATES:
                return None
        return None

    def get_index_versions(self, states: list[str] | None = None) -> list[int]:
        """Committed log ids, newest first, optionally of the given states."""
        if not os.path.isdir(self.log_dir):
            return []
        out = []
        for n in sorted(os.listdir(self.log_dir), key=lambda s: -int(s) if s.isdigit() else 0):
            if not n.isdigit():
                continue
            entry = self.get_log(int(n))
            if entry is not None and (states is None or entry.state in states):
                out.append(int(n))
        return out

    def write_log(self, log_id: int, entry: LogEntry) -> bool:
        """Commit ``entry`` as id ``log_id``; False if the id is taken."""
        os.makedirs(self.log_dir, exist_ok=True)
        target = self._entry_path(log_id)
        if os.path.exists(target):
            return False
        entry.id = log_id
        fd, tmp = tempfile.mkstemp(dir=self.log_dir, prefix=".tmp-")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry.to_dict(), f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            faults.fire("log.write", id=log_id, state=entry.state)
            try:
                os.link(tmp, target)  # fails iff target exists: the CAS
            except FileExistsError:
                return False
            except OSError as e:
                if e.errno not in (errno.EPERM, errno.EOPNOTSUPP, errno.ENOTSUP, errno.EMLINK):
                    raise
                if not self._exclusive_create(tmp, target):
                    return False
            faults.fire_after("log.write", id=log_id, state=entry.state)
            return True
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

    @staticmethod
    def _exclusive_create(tmp: str, target: str) -> bool:
        try:
            out = os.open(target, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return False
        try:
            with open(tmp, "rb") as src, os.fdopen(out, "wb") as dst:
                dst.write(src.read())
                dst.flush()
                os.fsync(dst.fileno())
        except OSError:
            os.unlink(target)  # a half-written target must not look committed
            raise
        return True

    def create_latest_stable_log(self, log_id: int) -> bool:
        entry = self.get_log(log_id)
        if entry is None or entry.state not in STABLE_STATES:
            return False
        ptr = os.path.join(self.log_dir, C.LATEST_STABLE_LOG)
        fd, tmp = tempfile.mkstemp(dir=self.log_dir, prefix=".tmp-")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry.to_dict(), f, indent=2)
            os.replace(tmp, ptr)
        except OSError:
            os.unlink(tmp)
            raise
        return True

    def stable_pointer_id(self) -> Optional[int]:
        """The log id the latestStable pointer records; None when it is
        absent or unreadable."""
        try:
            with open(os.path.join(self.log_dir, C.LATEST_STABLE_LOG), encoding="utf-8") as f:
                return int(json.load(f)["id"])
        except (OSError, ValueError, KeyError):
            return None

    def delete_latest_stable_log(self) -> None:
        try:
            os.unlink(os.path.join(self.log_dir, C.LATEST_STABLE_LOG))
        except FileNotFoundError:
            pass

    def stale_temp_files(self, min_age_s: float = 0.0) -> list[str]:
        """``.tmp-*`` spool files at least ``min_age_s`` old (a live
        writer's spool file lives for microseconds)."""
        if not os.path.isdir(self.log_dir):
            return []
        out = []
        for n in sorted(os.listdir(self.log_dir)):
            if not n.startswith(".tmp-"):
                continue
            p = os.path.join(self.log_dir, n)
            try:
                if time.time() - os.stat(p).st_mtime < min_age_s:
                    continue
            except FileNotFoundError:
                continue  # its writer finished while we listed
            out.append(p)
        return out

    def clear_temp_files(self, min_age_s: float = 0.0) -> int:
        removed = 0
        for p in self.stale_temp_files(min_age_s):
            try:
                os.unlink(p)
                removed += 1
            except FileNotFoundError:
                pass
        return removed
