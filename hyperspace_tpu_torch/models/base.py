"""Index abstraction, the "derived dataset" contract (counterpart of
hyperspace_tpu/models/base.py): create, write, and the maintenance
operations refresh and optimize."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Sequence

from ..exceptions import HyperspaceError
from ..meta.entry import INDEX_KIND_REGISTRY, FileIdTracker, FileInfo

if TYPE_CHECKING:
    from ..plan.dataframe import DataFrame
    from ..session import HyperspaceSession


class UpdateMode(enum.Enum):
    """How incremental refresh's output relates to the old index data."""

    MERGE = "merge"  # new data sits beside the old content
    OVERWRITE = "overwrite"  # new content replaces the old


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

    def statistics(self) -> dict[str, Any]:
        return {}

    def can_handle_deleted_files(self) -> bool:
        return False

    def write(self, ctx: IndexerContext, index_data) -> None:
        raise NotImplementedError

    def optimize(self, ctx: IndexerContext, files_to_optimize: list[FileInfo]) -> None:
        raise NotImplementedError(f"{self.kind} does not support optimize")

    def refresh_incremental(
        self, ctx: IndexerContext, appended_df: "DataFrame | None",
        deleted_files: list[FileInfo], index_content_files: list[FileInfo],
    ) -> tuple["Index", UpdateMode]:
        raise NotImplementedError(f"{self.kind} does not support incremental refresh")

    def ingest_delta(self, ctx: IndexerContext, delta_df: "DataFrame", version: int) -> int:
        """Write only ``delta_df``'s rows as append-only runs into the
        staged version dir (log-structured ingest); returns rows written."""
        raise NotImplementedError(f"{self.kind} does not support delta ingestion")

    def refresh_full(self, ctx: IndexerContext, df: "DataFrame") -> tuple["Index", Any]:
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
