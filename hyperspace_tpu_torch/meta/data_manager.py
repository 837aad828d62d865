"""Versioned index-data directories (counterpart of
hyperspace_tpu/meta/data_manager.py, create path only).

Index data for version n lives at <index>/v__=<n>/. A build writes into
<index>/_staging/<n> and is renamed into place when it succeeds, so a live
version directory is all-or-nothing.
"""

from __future__ import annotations

import os
import shutil

from .. import constants as C
from ..exceptions import HyperspaceError

STAGING_DIR = "_staging"


class IndexDataManager:
    def __init__(self, index_path: str):
        self.index_path = index_path

    def version_path(self, version: int) -> str:
        return os.path.join(self.index_path, f"{C.INDEX_VERSION_DIR_PREFIX}={version}")

    def staging_path(self, version: int) -> str:
        return os.path.join(self.index_path, STAGING_DIR, str(version))

    def stage_version(self, version: int) -> str:
        p = self.staging_path(version)
        if os.path.isdir(p):
            shutil.rmtree(p)
        os.makedirs(p)
        return p

    def publish(self, version: int) -> None:
        src = self.staging_path(version)
        if not os.path.isdir(src):
            return
        dst = self.version_path(version)
        if os.path.isdir(dst):
            raise HyperspaceError(
                f"cannot publish index data version {version}: {dst} already exists"
            )
        os.rename(src, dst)
        try:
            os.rmdir(os.path.join(self.index_path, STAGING_DIR))
        except OSError:
            pass  # another staged build is still there
