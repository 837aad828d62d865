"""Versioned index-data directories (counterpart of
hyperspace_tpu/meta/data_manager.py).

Index data for version n lives at <index>/v__=<n>/. A build writes into
<index>/_staging/<n> and is renamed into place when it succeeds, so a live
version directory is all-or-nothing; a crash mid-build leaves only a
staging directory, which recovery removes. The ``data.publish`` fault
point (utils/faults.py) brackets the rename.

The sweeps consult the snapshot registry (ingest/snapshots.py): a staged
version that a live maintenance action protects is work in flight, not
debris, and a published version that an in-flight query pinned or a live
action protects is never an orphan.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

from .. import constants as C
from ..exceptions import HyperspaceError
from ..utils import faults

STAGING_DIR = "_staging"
_VERSION_RE = re.compile(re.escape(C.INDEX_VERSION_DIR_PREFIX) + r"=(\d+)$")


class IndexDataManager:
    def __init__(self, index_path: str):
        self.index_path = index_path

    def version_path(self, version: int) -> str:
        return os.path.join(self.index_path, f"{C.INDEX_VERSION_DIR_PREFIX}={version}")

    def get_all_versions(self) -> list[int]:
        if not os.path.isdir(self.index_path):
            return []
        out = []
        for name in os.listdir(self.index_path):
            m = _VERSION_RE.match(name)
            if m and os.path.isdir(os.path.join(self.index_path, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def get_latest_version(self) -> Optional[int]:
        versions = self.get_all_versions()
        return versions[-1] if versions else None

    def delete_version(self, version: int) -> None:
        p = self.version_path(version)
        if os.path.isdir(p):
            shutil.rmtree(p)

    def staging_path(self, version: int) -> str:
        return os.path.join(self.index_path, STAGING_DIR, str(version))

    def stage_version(self, version: int) -> str:
        """A fresh staging dir for ``version`` (a leftover of a failed
        attempt at the same version is replaced, never merged)."""
        p = self.staging_path(version)
        if os.path.isdir(p):
            shutil.rmtree(p)
        os.makedirs(p)
        return p

    def publish(self, version: int) -> None:
        """Rename ``_staging/<n>`` to ``v__=<n>``; a missing staging dir
        publishes nothing, an existing target is refused."""
        src = self.staging_path(version)
        if not os.path.isdir(src):
            return
        dst = self.version_path(version)
        faults.fire("data.publish", version=version)
        if os.path.isdir(dst):
            raise HyperspaceError(
                f"cannot publish index data version {version}: {dst} already "
                f"exists (orphan of a crashed publish? run recover())"
            )
        os.rename(src, dst)
        faults.fire_after("data.publish", version=version)
        self._prune_staging_root()

    def staged_versions(self) -> list[int]:
        root = os.path.join(self.index_path, STAGING_DIR)
        if not os.path.isdir(root):
            return []
        return sorted(int(n) for n in os.listdir(root) if n.isdigit())

    def clear_staging(self) -> int:
        """Remove every unpublished build that no live in-process action
        protects; returns how many. A crashed process leaves no
        protection, so recovery after a crash sweeps them all."""
        from ..ingest.snapshots import REGISTRY as SNAPSHOTS

        live = SNAPSHOTS.protected_versions(os.path.abspath(self.index_path))
        removed = 0
        for v in self.staged_versions():
            if v in live:
                continue
            shutil.rmtree(os.path.join(self.index_path, STAGING_DIR, str(v)))
            removed += 1
        self._prune_staging_root()
        return removed

    def orphan_version_dirs(self, referenced: set) -> list[int]:
        """Published versions that no committed entry references, that no
        in-flight query pinned and that no live action protects (an output
        between its publish and its final log commit is live)."""
        from ..ingest.snapshots import REGISTRY as SNAPSHOTS

        path = os.path.abspath(self.index_path)
        return [v for v in self.get_all_versions()
                if v not in referenced and not SNAPSHOTS.is_pinned(path, v)
                and not SNAPSHOTS.is_protected(path, v)]

    def _prune_staging_root(self) -> None:
        try:
            os.rmdir(os.path.join(self.index_path, STAGING_DIR))
        except OSError:
            pass  # hslint: HS402 — non-empty or absent root stays put
