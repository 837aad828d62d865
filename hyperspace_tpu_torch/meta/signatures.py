"""Index <-> source staleness detection via plan signatures (counterpart of
hyperspace_tpu/meta/signatures.py).

Provider names are part of the on-disk format: a log entry records the
provider that signed it, and both packages write and accept the same names,
so each recognises the other's indexes. The names are plain strings here;
nothing is imported by them.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Protocol

from .entry import FileInfo
from ..exceptions import HyperspaceError


def md5_hex(s: str) -> str:
    return hashlib.md5(s.encode("utf-8")).hexdigest()


class SignablePlan(Protocol):
    def preorder_kinds(self) -> list[str]: ...
    def leaf_file_infos(self) -> list[list[FileInfo]]: ...


def _files_signature(files: Iterable[FileInfo]) -> str:
    parts = sorted(f"{f.name}:{f.size}:{f.modified_time}" for f in files)
    return md5_hex("".join(parts))


class FileBasedSignatureProvider:
    NAME = "hyperspace_tpu.meta.signatures.FileBasedSignatureProvider"

    def sign(self, plan: SignablePlan) -> Optional[str]:
        leaves = plan.leaf_file_infos()
        if not leaves:
            return None
        return md5_hex("".join(_files_signature(files) for files in leaves))


class PlanSignatureProvider:
    NAME = "hyperspace_tpu.meta.signatures.PlanSignatureProvider"

    def sign(self, plan: SignablePlan) -> Optional[str]:
        kinds = plan.preorder_kinds()
        if not kinds:
            return None
        return md5_hex("".join(kinds))


class IndexSignatureProvider:
    """Default provider: file- and plan-signatures combined."""

    NAME = "hyperspace_tpu.meta.signatures.IndexSignatureProvider"

    def sign(self, plan: SignablePlan) -> Optional[str]:
        f = FileBasedSignatureProvider().sign(plan)
        p = PlanSignatureProvider().sign(plan)
        if f is None or p is None:
            return None
        return md5_hex(f + p)


_PROVIDERS = {
    cls.NAME: cls
    for cls in (FileBasedSignatureProvider, PlanSignatureProvider, IndexSignatureProvider)
}


def get_provider(name: str):
    cls = _PROVIDERS.get(name)
    if cls is None:
        raise HyperspaceError(f"Unknown signature provider: {name!r}")
    return cls()


DEFAULT_PROVIDER_NAME = IndexSignatureProvider.NAME
