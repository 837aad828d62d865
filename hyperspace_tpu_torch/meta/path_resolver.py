"""Resolve index roots under the system path (counterpart of
hyperspace_tpu/meta/path_resolver.py)."""

from __future__ import annotations

import os

from .. import constants as C
from ..config import HyperspaceConf


class PathResolver:
    def __init__(self, conf: HyperspaceConf, warehouse_dir: str = "."):
        self._conf = conf
        self._warehouse = warehouse_dir

    @property
    def system_path(self) -> str:
        p = self._conf.get(C.SYSTEM_PATH)
        if p:
            return str(p)
        return os.path.join(self._warehouse, C.INDEXES_DIR)

    def get_index_path(self, name: str) -> str:
        """Case-insensitive match against existing index directories; falls
        back to <system>/<name> for a new index."""
        root = self.system_path
        if os.path.isdir(root):
            for existing in os.listdir(root):
                if existing.lower() == name.lower() and os.path.isdir(
                    os.path.join(root, existing)
                ):
                    return os.path.join(root, existing)
        return os.path.join(root, name)
