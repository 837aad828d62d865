"""Static and runtime checks of the port's own contracts (counterpart of
hyperspace_tpu/staticcheck/).

- ``plan_verifier``: walks an optimized logical plan and enforces its
  structural invariants (schema resolution, file-set containment, PruneSpec
  agreement, bucket-hint consistency, sampled-scan twins).
  ``HYPERSPACE_VERIFY_PLAN=1`` runs it on every ``DataFrame.optimized_plan``
  and before every sampled plan executes.
- ``kernel_audit``: records the aten ops of a built kernel's first call
  under a ``TorchDispatchMode`` and classifies hazards (device-to-host
  syncs, implicit f64 promotion, order-dependent float accumulation)
  under ``HYPERSPACE_KERNEL_AUDIT=1``, plus an always-on retrace watchdog
  over kernel-cache fingerprints.
- ``concurrency``: TrackedLock + the process-wide lock registry, the
  ``HYPERSPACE_LOCK_AUDIT=1`` acquisition-order graph (a cycle raises
  ``LockOrderError``), and the ``guarded_by`` shared-state registry.
- ``lifecycle``: ``tracked_resource`` / ``release_resource`` handles at
  the acquire/release chokepoints under ``HYPERSPACE_LIFECYCLE_AUDIT=1``,
  and ``check_quiescent()`` raising ``ResourceLeakError``.

``tools/hslint.py`` lints the package's conventions statically:
``python tools/hslint.py hyperspace_tpu_torch``.

Re-exports resolve lazily (PEP 562): low-level modules (telemetry/metrics,
utils/lru, columnar/io) import ``staticcheck.concurrency`` at
class-definition time, and an eager package ``__init__`` would drag
``kernel_audit``, which imports telemetry back, into their import cycle.
"""

_EXPORTS = {
    # plan_verifier
    "PlanInvariantError": "plan_verifier",
    "Violation": "plan_verifier",
    "maybe_verify_plan": "plan_verifier",
    "verify_plan": "plan_verifier",
    # kernel_audit
    "Hazard": "kernel_audit",
    "audit_enabled": "kernel_audit",
    "audit_call": "kernel_audit",
    "observe_compile": "kernel_audit",
    "reset_watchdog": "kernel_audit",
    # concurrency
    "TrackedLock": "concurrency",
    "LockOrderError": "concurrency",
    "GuardEntry": "concurrency",
    "guarded_by": "concurrency",
    "guard_of": "concurrency",
    "guarded_state": "concurrency",
    "declare_order": "concurrency",
    "registered_locks": "concurrency",
    "lock_report": "concurrency",
    # lifecycle
    "ResourceLeakError": "lifecycle",
    "LiveHandle": "lifecycle",
    "tracked_resource": "lifecycle",
    "release_resource": "lifecycle",
    "check_quiescent": "lifecycle",
    "live_handles": "lifecycle",
    "lifecycle_report": "lifecycle",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod_name = _EXPORTS.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    # concurrency.report / lifecycle.report are exported under the less
    # ambiguous names lock_report / lifecycle_report (kernel_audit already
    # exports audit_enabled)
    attr = "report" if name in ("lock_report", "lifecycle_report") else name
    value = getattr(mod, attr)
    globals()[name] = value
    return value
