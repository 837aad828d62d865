"""Concurrent multi-query serving: scheduler, QoS, global budget, cancellation
(counterpart of hyperspace_tpu/serve/__init__.py).

Public surface of the serving layer:

- ``QueryScheduler`` / ``get_scheduler()`` / ``submit()`` — admission-
  controlled concurrent execution with per-tenant weighted-fair
  scheduling, per-query priorities, a bounded run queue, and first-class
  cancellation.
- ``TENANTS`` / ``Tenant`` — the process-wide tenant registry: weights,
  token-bucket rate limits, in-flight/active quotas, budget fractions
  (``HYPERSPACE_TENANTS`` bootstraps it). ``TenantQuotaExceeded`` is the
  typed door rejection, distinct from global ``AdmissionRejected``;
  ``DeadlineUnmeetable`` is the SLO-admission fast rejection.
- ``global_budget()`` — the process-wide streaming byte budget every
  read-ahead stream (scan chunks, join pair loads) reserves through,
  partitioned per tenant while several tenants hold bytes.
- ``device_budget()`` — the device-resident byte ledger bucketed-join band
  waves reserve their upload footprint through (park/spill admission).
- ``current_query()`` / ``check_cancelled()`` — the per-query context the
  engine's streaming loops poll.
- ``serve_state()`` — aggregate serving snapshot (active/queued queries,
  tenants, budget occupancy) rendered by the profile.
"""

from .budget import (
    BudgetAccountant,
    BudgetStream,
    configured_budget_bytes,
    configured_device_budget_bytes,
    device_budget,
    global_budget,
    reset_device_budget,
    reset_global_budget,
)
from .context import (
    QueryCancelledError,
    QueryContext,
    check_cancelled,
    current_query,
    query_scope,
)
from .qos import COST_MODEL, CostModel, TenantQueues, query_cost
from .scheduler import (
    AdmissionRejected,
    DeadlineUnmeetable,
    QueryHandle,
    QueryScheduler,
    SchedulerShutdown,
    get_scheduler,
    reset_scheduler,
    serve_state,
    submit,
)
from .tenant import (
    DEFAULT_TENANT,
    TENANTS,
    Tenant,
    TenantQuotaExceeded,
    TenantRegistry,
    TenantSpecError,
    TokenBucket,
)

__all__ = [
    "AdmissionRejected",
    "BudgetAccountant",
    "BudgetStream",
    "COST_MODEL",
    "CostModel",
    "DEFAULT_TENANT",
    "DeadlineUnmeetable",
    "QueryCancelledError",
    "QueryContext",
    "QueryHandle",
    "QueryScheduler",
    "SchedulerShutdown",
    "TENANTS",
    "Tenant",
    "TenantQueues",
    "TenantQuotaExceeded",
    "TenantRegistry",
    "TenantSpecError",
    "TokenBucket",
    "check_cancelled",
    "configured_budget_bytes",
    "configured_device_budget_bytes",
    "current_query",
    "device_budget",
    "get_scheduler",
    "global_budget",
    "query_cost",
    "query_scope",
    "reset_device_budget",
    "reset_global_budget",
    "reset_scheduler",
    "serve_state",
    "submit",
]
