"""The camelCase API surface (counterpart of hyperspace_tpu/compat.py).

The upstream Hyperspace Python binding's names (hyperspace.py and
indexconfig.py there): camelCase methods on the Hyperspace handle, the
session switches, and the ``IndexConfig`` / ``ZOrderIndexConfig`` aliases,
so a script written against that binding, or against the JAX package's
``compat`` module, runs on the port by changing its imports only.
"""

from __future__ import annotations

from .hyperspace import Hyperspace as _Hyperspace
from .models.covering import CoveringIndexConfig
from .models.zorder import ZOrderCoveringIndexConfig

# reference python binding names
IndexConfig = CoveringIndexConfig
ZOrderIndexConfig = ZOrderCoveringIndexConfig


class Hyperspace(_Hyperspace):
    """Hyperspace handle with the reference's camelCase surface."""

    def createIndex(self, df, config) -> None:  # noqa: N802
        self.create_index(df, config)

    def deleteIndex(self, name: str) -> None:  # noqa: N802
        self.delete_index(name)

    def restoreIndex(self, name: str) -> None:  # noqa: N802
        self.restore_index(name)

    def vacuumIndex(self, name: str) -> None:  # noqa: N802
        self.vacuum_index(name)

    def refreshIndex(self, name: str, mode: str = "full") -> None:  # noqa: N802
        self.refresh_index(name, mode)

    def optimizeIndex(self, name: str, mode: str = "quick") -> None:  # noqa: N802
        self.optimize_index(name, mode)

    def whyNot(self, df, indexName: str = "", extended: bool = False, redirectFunc=None):  # noqa: N802
        return self.why_not(df, indexName, extended, redirectFunc)


def enableHyperspace(session):  # noqa: N802
    """ref: Implicits.enableHyperspace (package.scala:40-44)."""
    return session.enable_hyperspace()


def disableHyperspace(session):  # noqa: N802
    return session.disable_hyperspace()


def isHyperspaceEnabled(session) -> bool:  # noqa: N802
    return session.is_hyperspace_enabled()
