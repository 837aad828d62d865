"""The source-provider manager (counterpart of
hyperspace_tpu/sources/manager.py).

The providers are the session's ``hyperspace.index.sources.fileBasedBuilders``
(dotted class names, comma-separated), or by default the default, the
snapshot (Delta-style) and the Iceberg-style providers. Every call asks
each provider, and exactly one may answer: two answers raise.

The setting is shared with the JAX package and may hold its class names;
they map to this package's own classes and are never imported. Another
``hyperspace_tpu.`` name raises; any other dotted name is imported.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING, Callable, Optional

from .default import DefaultFileBasedSource
from .delta import DeltaStyleSource
from .iceberg import IcebergStyleSource
from .interfaces import FileBasedRelation, FileBasedSourceProvider
from .. import constants as C
from ..exceptions import HyperspaceError
from ..meta.entry import Relation
from ..plan.nodes import LogicalPlan

if TYPE_CHECKING:
    from ..session import HyperspaceSession

_BUILTIN = {
    f"{pkg}.sources.{mod}.{cls.__name__}": cls
    for pkg in ("hyperspace_tpu", "hyperspace_tpu_torch")
    for mod, cls in (("default", DefaultFileBasedSource), ("delta", DeltaStyleSource),
                     ("iceberg", IcebergStyleSource))
}


def _provider_class(name: str):
    cls = _BUILTIN.get(name)
    if cls is not None:
        return cls
    if name.startswith("hyperspace_tpu."):
        raise HyperspaceError(f"Unknown source provider {name!r}")
    mod, _, cls_name = name.rpartition(".")
    return getattr(importlib.import_module(mod), cls_name)


class SourceProviderManager:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session
        names = session.get_conf(C.FILE_BASED_SOURCE_BUILDERS)
        if names:
            self._providers: list[FileBasedSourceProvider] = []
            for name in str(names).split(","):
                cls = _provider_class(name.strip())
                self._providers.append(
                    cls(session) if isinstance(cls, type)
                    and issubclass(cls, DefaultFileBasedSource) else cls())
        else:
            self._providers = [DefaultFileBasedSource(session), DeltaStyleSource(),
                               IcebergStyleSource()]

    def _run(self, fn: Callable[[FileBasedSourceProvider], Optional[object]], what: str):
        answers = [(p, r) for p in self._providers if (r := fn(p)) is not None]
        if not answers:
            return None
        if len(answers) > 1:
            raise HyperspaceError(
                f"Multiple source providers answered {what}: "
                f"{[type(p).__name__ for p, _ in answers]}"
            )
        return answers[0][1]

    def is_supported_relation(self, node: LogicalPlan) -> bool:
        return bool(self._run(lambda p: p.is_supported_relation(node), "is_supported"))

    def get_relation(self, node: LogicalPlan) -> Optional[FileBasedRelation]:
        return self._run(lambda p: p.get_relation(self.session, node), "get_relation")

    def reload_relation(self, metadata: Relation):
        df = self._run(lambda p: p.reload_relation(self.session, metadata), "reload")
        if df is None:
            raise HyperspaceError(
                f"No source provider can reload format {metadata.file_format!r}"
            )
        return df
