"""Index collection manager (counterpart of hyperspace_tpu/index_manager.py:
create and list; delete, refresh, optimize and recovery are not ported).

Enumerates the per-index logs under the system path, skipping, with a
warning, an index of a kind this package does not load; the read path
caches the entry list for ``hyperspace.index.cache.expiryDurationInSeconds``
and a create clears it.
"""

from __future__ import annotations

import logging
import os
import time
from typing import TYPE_CHECKING, Optional

from .actions import states as S
from .actions.create import CreateAction
from .exceptions import UnknownIndexKindError
from .meta.data_manager import IndexDataManager
from .meta.entry import IndexLogEntry
from .meta.log_manager import IndexLogManager
from .meta.path_resolver import PathResolver

if TYPE_CHECKING:
    from .models.base import IndexConfig
    from .plan.dataframe import DataFrame
    from .session import HyperspaceSession

logger = logging.getLogger(__name__)


class IndexCollectionManager:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session
        self.resolver = PathResolver(session.conf, session.warehouse_dir)
        self._cached: Optional[list[IndexLogEntry]] = None
        self._cached_at = 0.0

    def clear_cache(self) -> None:
        self._cached = None

    def create(self, df: "DataFrame", config: "IndexConfig") -> None:
        path = self.resolver.get_index_path(config.index_name)
        try:
            CreateAction(
                self.session, df, config, path, IndexLogManager(path),
                IndexDataManager(path),
            ).run()
        finally:
            self.clear_cache()

    def _all_indexes(self) -> list[IndexLogEntry]:
        root = self.resolver.system_path
        out: list[IndexLogEntry] = []
        if not os.path.isdir(root):
            return out
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if not os.path.isdir(path):
                continue
            lm = IndexLogManager(path)
            try:
                entry = lm.get_latest_log()
                if entry is not None and (
                    not isinstance(entry, IndexLogEntry)
                    or entry.state not in S.STABLE_STATES
                ):
                    # another writer's transaction is in flight: serve the
                    # last stable entry
                    entry = lm.get_latest_stable_log()
            except UnknownIndexKindError as e:
                # a kind this package does not load (the JAX package's data
                # skipping): skip it, so the other indexes still serve
                logger.warning("Skipping index %r of kind %r, which this package "
                               "cannot load", name, e.kind)
                continue
            if isinstance(entry, IndexLogEntry):
                out.append(entry)
        return out

    def get_indexes(self, states: list[str] | None = None) -> list[IndexLogEntry]:
        expiry = self.session.conf.cache_expiry_seconds
        if self._cached is None or time.time() - self._cached_at > expiry:
            self._cached = self._all_indexes()
            self._cached_at = time.time()
        return [e for e in self._cached if states is None or e.state in states]

    def get_index(self, name: str) -> Optional[IndexLogEntry]:
        e = IndexLogManager(self.resolver.get_index_path(name)).get_latest_log()
        return e if isinstance(e, IndexLogEntry) else None


def index_manager_for(session: "HyperspaceSession") -> IndexCollectionManager:
    m = getattr(session, "_index_manager", None)
    if m is None:
        m = IndexCollectionManager(session)
        session._index_manager = m
    return m
