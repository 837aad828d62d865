"""Hyperspace, the user-facing facade (counterpart of
hyperspace_tpu/hyperspace.py): create, the lifecycle actions (delete,
restore, vacuum, vacuum-outdated, refresh, optimize, cancel, recover), the
ingest verbs (``append``, ``compact_index``), introspection, and the
analysis views: ``explain``, ``why_not``, ``explain_analyze`` and
``profile``. The JAX package's workload views (``workload_report``,
``index_report``) are not ported yet."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from . import constants as C
from .analysis.statistics import index_statistics_df
from .exceptions import HyperspaceError
from .index_manager import index_manager_for
from .meta.entry import IndexLogEntry

if TYPE_CHECKING:
    from .models.base import IndexConfig
    from .plan.dataframe import DataFrame
    from .session import HyperspaceSession


def _emit(s: str, redirect) -> Optional[str]:
    """The report, or None after handing it to ``redirect``."""
    if redirect is not None:
        redirect(s)
        return None
    return s


class Hyperspace:
    def __init__(self, session: "HyperspaceSession"):
        self.session = session
        self._manager = index_manager_for(session)

    # --- index lifecycle ---
    def create_index(self, df: "DataFrame", config: "IndexConfig") -> None:
        self._manager.create(df, config)

    def delete_index(self, name: str) -> None:
        self._manager.delete(name)

    def restore_index(self, name: str) -> None:
        self._manager.restore(name)

    def vacuum_index(self, name: str) -> None:
        self._manager.vacuum(name)

    def vacuum_outdated_index(self, name: str) -> None:
        self._manager.vacuum_outdated(name)

    def refresh_index(self, name: str, mode: str = C.REFRESH_MODE_FULL) -> None:
        self._manager.refresh(name, mode)

    def optimize_index(self, name: str, mode: str = C.OPTIMIZE_MODE_QUICK) -> None:
        self._manager.optimize(name, mode)

    def append(self, name: str, df: "DataFrame") -> None:
        """Index ``df``'s new source files into the index as append-only
        per-bucket delta runs: one atomically published immutable
        snapshot, at a cost that follows the batch. Past
        ``HYPERSPACE_COMPACT_RUNS`` runs a background compaction follows."""
        self._manager.append(name, df)

    def compact_index(self, name: str, min_runs: int | None = None) -> None:
        """Merge the delta runs of buckets holding ``min_runs`` files or more
        into one sorted file per bucket; vacuum retires the superseded
        versions once their pins drain."""
        self._manager.compact(name, min_runs)

    def cancel(self, name: str) -> None:
        self._manager.cancel(name)

    def recover(self, name: str | None = None, force: bool = False) -> dict:
        """Repair crash debris (index_manager's module docstring has the
        list); it also runs when a session's manager is built."""
        return self._manager.recover(name, force=force)

    # --- analysis views ---
    def explain(self, df: "DataFrame", verbose: bool = False, redirect=None) -> Optional[str]:
        """The plan with and without the indexes, the differing lines
        highlighted, and the indexes used; ``verbose`` adds the index scan
        detail, the operator counts and the applicable indexes."""
        from .analysis.explain import explain_string

        return _emit(explain_string(self.session, df, verbose), redirect)

    def why_not(
        self, df: "DataFrame", index_name: str = "", extended: bool = False, redirect=None
    ) -> Optional[str]:
        """Why each candidate index was or was not applied to the query."""
        from .analysis.whynot import why_not_string

        return _emit(why_not_string(self.session, df, index_name or None, extended), redirect)

    def explain_analyze(self, df: "DataFrame", redirect=None) -> Optional[str]:
        """Execute the query once with the plan-statistics collector on and
        return the optimized plan annotated with per-node actual rows, wall
        time, route and bytes and the estimator q-errors; the run takes the
        same route and gives the same bits as a plain collect."""
        from .analysis.explain import explain_analyze_string

        return _emit(explain_analyze_string(self.session, df), redirect)

    def profile(self, df: "DataFrame", redirect=None) -> Optional[str]:
        """Execute the query once under tracing and return the per-query
        profile: the span tree with the metrics, and the estimator
        accuracy."""
        from .analysis.explain import profile_string

        return _emit(profile_string(self.session, df), redirect)

    # --- introspection ---
    def indexes(self) -> "DataFrame":
        """One row per index: the reference's summary columns."""
        return index_statistics_df(self.session, self._manager.get_indexes(), extended=False)

    def index(self, name: str) -> "DataFrame":
        """The detailed statistics row of one index."""
        entry = self._manager.get_index(name)
        if entry is None:
            raise HyperspaceError(f"Index with name {name!r} could not be found")
        return index_statistics_df(self.session, [entry], extended=True)

    def get_index_versions(self, name: str, states: list[str] | None = None) -> list[int]:
        return self._manager.get_index_versions(name, states)

    def get_index(self, name: str, log_version: int | None = None) -> Optional[IndexLogEntry]:
        return self._manager.get_index(name, log_version)
