"""Index abstraction, the "derived dataset" contract (counterpart of
hyperspace_tpu/models/base.py, create path only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Sequence

from ..exceptions import HyperspaceError
from ..meta.entry import INDEX_KIND_REGISTRY, FileIdTracker

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession


@dataclass
class IndexerContext:
    session: "HyperspaceSession"
    file_id_tracker: FileIdTracker
    index_data_path: str


class Index:
    """Base of the index kinds. A kind registers its ``kind`` string in
    INDEX_KIND_REGISTRY so log entries deserialize polymorphically."""

    kind: str = "?"
    kind_abbr: str = "?"

    def indexed_columns(self) -> list[str]:
        raise NotImplementedError

    def referenced_columns(self) -> list[str]:
        raise NotImplementedError

    def properties(self) -> dict[str, str]:
        return {}

    def write(self, ctx: IndexerContext, index_data) -> None:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash((self.kind, tuple(self.indexed_columns())))


class IndexConfig:
    @property
    def index_name(self) -> str:
        raise NotImplementedError

    def referenced_columns(self) -> list[str]:
        raise NotImplementedError

    def create_index(
        self, ctx: IndexerContext, df: "DataFrame", properties: dict[str, str]
    ) -> tuple[Index, Any]:
        """(index object, index data to write)."""
        raise NotImplementedError


def register_index_kind(kind: str, loader: Callable[[dict], Index]) -> None:
    INDEX_KIND_REGISTRY[kind] = loader


def validate_column_names(names: Sequence[str], what: str) -> list[str]:
    out = list(names)
    if not out and what == "indexed":
        raise HyperspaceError("At least one indexed column required")
    if len(set(n.lower() for n in out)) != len(out):
        raise HyperspaceError(f"Duplicate {what} columns: {out}")
    return out
