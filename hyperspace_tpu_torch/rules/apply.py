"""ApplyHyperspace, the entry optimizer rule (counterpart of
hyperspace_tpu/rules/apply.py).

Index maintenance runs queries of its own, which must not be rewritten:
with_hyperspace_rule_disabled() guards them. As in the reference, the
rewrite is fail-open: if it raises, the warning is logged with its traceback
and the query runs on its original plan.
"""

from __future__ import annotations

import logging
import threading

from ..plan.nodes import LogicalPlan

logger = logging.getLogger(__name__)

_local = threading.local()


class with_hyperspace_rule_disabled:
    def __enter__(self):
        _local.disabled = getattr(_local, "disabled", 0) + 1

    def __exit__(self, *exc):
        _local.disabled = getattr(_local, "disabled", 1) - 1
        return False


def _rule_disabled() -> bool:
    return getattr(_local, "disabled", 0) > 0


class ApplyHyperspace:
    def __init__(self, session):
        self.session = session

    def __call__(self, plan: LogicalPlan) -> LogicalPlan:
        if not self.session.conf.apply_enabled or _rule_disabled():
            return plan
        try:
            return self._rewrite(plan)
        except Exception:  # the user's query must not break on a rewrite bug
            logger.warning("Hyperspace rewrite failed; using original plan", exc_info=True)
            return plan

    def _rewrite(self, plan: LogicalPlan) -> LogicalPlan:
        from ..actions.states import ACTIVE
        from ..index_manager import index_manager_for
        from .collector import CandidateIndexCollector
        from .score_optimizer import ScoreBasedIndexPlanOptimizer

        indexes = [
            e for e in index_manager_for(self.session).get_indexes([ACTIVE]) if e.enabled
        ]
        if not indexes:
            return plan
        candidates = CandidateIndexCollector().apply(plan, indexes)
        if not candidates:
            return plan
        return ScoreBasedIndexPlanOptimizer(self.session).apply(plan, candidates)
