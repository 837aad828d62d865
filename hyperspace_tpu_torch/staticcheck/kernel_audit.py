"""Kernel hazard auditor + retrace watchdog (counterpart of
hyperspace_tpu/staticcheck/kernel_audit.py).

Two failure classes the kernel cache cannot see on its own:

1. **Hazardous kernel bodies.** A cached device closure that syncs the
   card to the host serializes the pipeline; an implicit float64 promotion
   doubles the bytes the card moves and departs from the JAX package's
   device dtype contract (f64 is f32 on the device); an order-dependent
   float accumulation or a random op breaks the bit-identity contracts the
   smoke relies on. Under ``HYPERSPACE_KERNEL_AUDIT=1`` every cache-missed
   closure's FIRST call runs under a thread-local ``TorchDispatchMode``
   inside an ``audit:<kind>`` span; the mode records the aten ops the
   closure issues, and each op is classified:

   - ``HOST_CALLBACK``: a device-to-host sync, ``aten._local_scalar_dense``
     (``.item()``, ``int()`` or ``float()`` of a tensor) or a copy from the
     card to the CPU (``.cpu()``, and ``.tolist()`` of a card tensor; on a
     CPU tensor ``.tolist()`` reads memory without dispatching);
   - ``IMPLICIT_F64``: an op that outputs float64 from tensor inputs none
     of which is float64 (a factory op with no tensor input included),
     unless the kind lists the op in ``F64_ALLOW``;
   - ``NONDETERMINISTIC``: a float ``index_add``, ``scatter_add``,
     ``index_put_(accumulate=True)``, ``scatter_reduce`` with sum, prod or
     mean, or ``scatter`` with an add/multiply reduce (atomics add in
     arrival order on the card), and random ops. Integer adds and min/max
     reductions are order-free and do not count (ops/intsum.py).

   The hand-written CUDA kernels (ops/cuda_kernels.py) are launched through
   ``ctypes`` and are invisible to the dispatcher: the mode sees the
   tensors their wrappers allocate, never the kernels themselves. Their bits
   are held against the plain versions by the smoke's kernel phase. The
   classification is by op, as the JAX auditor's is by primitive, so a
   closure run on CPU tensors is audited the same way it is on the card
   (its device-to-host copies excepted: a CPU run has none).

2. **Retrace storms.** One query template is one fingerprint is one
   build. A call site that bakes a varying value into its fingerprint
   builds a fresh closure per query. The watchdog (always on; a list
   insert per cache miss) groups each cache's misses by kind and dtype
   signature (the last element of a fingerprint, or the signature the
   cache names for the forms that do not end with one) and warns with the
   fingerprint diff when one group exceeds ``HYPERSPACE_RETRACE_WARN``
   distinct keys.

Hazards and warnings land in the ``staticcheck.kernel.*`` metrics family
and the module logger. Nothing here alters a kernel's result: the audited
call is the cached closure's own first call, returned unchanged.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

from ..telemetry.metrics import REGISTRY
from ..utils import env
from .concurrency import TrackedLock, guarded_by

logger = logging.getLogger("hyperspace_tpu_torch.staticcheck")

# hazard codes
HOST_CALLBACK = "HOST_CALLBACK"
IMPLICIT_F64 = "IMPLICIT_F64"
NONDETERMINISTIC = "NONDETERMINISTIC"

# aten ops whose float form accumulates in arrival order on the card
_FLOAT_ACCUMULATE_OPS = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
})
_ACCUMULATE_PUT_OPS = frozenset({"index_put", "index_put_", "_index_put_impl_"})
_SCATTER_REDUCE_OPS = frozenset({"scatter_reduce", "scatter_reduce_"})
_ORDERED_REDUCES = frozenset({"sum", "prod", "mean", "add", "multiply"})

# aten ops whose results are not a pure function of their inputs
_RANDOM_OPS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "bernoulli_", "normal", "normal_", "uniform_",
    "exponential_", "geometric_", "log_normal_", "cauchy_", "random_",
    "multinomial", "native_dropout", "poisson",
})

# Ops a kind may use to produce float64 from non-float64 inputs, with the
# reason. The fused join bodies divide an exact int64 sum by the match count
# for an integer avg in f64, so the device avg equals the host executor's
# to the last bit; the JAX package's device divides in f32 only because x64
# is off on a TPU (hyperspace_tpu/plan/tpu_exec._device_dtype).
F64_ALLOW: dict = guarded_by({
    "join_stacked_agg": ("_to_copy",),
    "join_agg": ("_to_copy",),
}, None, name="staticcheck.kernel_audit.F64_ALLOW",
    note="built at import, read-only")


@dataclass(frozen=True)
class Hazard:
    """One hazardous op found in a kernel's first call."""

    kind: str  # kernel kind (cache key kind)
    code: str  # HOST_CALLBACK | IMPLICIT_F64 | NONDETERMINISTIC
    primitive: str  # the aten op, e.g. "aten.index_add_"
    detail: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.kind}: {self.primitive} — {self.detail}"


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _arg(args, kwargs, pos: int, name: str, default=None):
    if name in kwargs:
        return kwargs[name]
    return args[pos] if len(args) > pos else default


def classify_op(kind: str, func, args, kwargs, out, f64_allow: tuple = ()) -> list[Hazard]:
    """The hazards of one dispatched aten op (``func`` an OpOverload)."""
    import torch

    op = func.overloadpacket.__name__
    prim = f"aten.{op}"
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    hazards: list[Hazard] = []
    if op == "_local_scalar_dense":
        hazards.append(Hazard(
            kind, HOST_CALLBACK, prim,
            "a scalar read (.item()) inside a device kernel syncs "
            "the card and serializes the dispatch pipeline",
        ))
    elif any(t.device.type == "cpu" for t in outs) and any(
        t.device.type == "cuda" for t in ins
    ):
        hazards.append(Hazard(
            kind, HOST_CALLBACK, prim,
            "a copy from the card to the host inside a device kernel syncs "
            "the card and serializes the dispatch pipeline",
        ))
    floating = any(t.is_floating_point() or t.is_complex() for t in outs)
    ordered = False
    if op in _FLOAT_ACCUMULATE_OPS:
        ordered = floating
    elif op in _ACCUMULATE_PUT_OPS:
        ordered = floating and bool(_arg(args, kwargs, 3, "accumulate", False))
    elif op in _SCATTER_REDUCE_OPS:
        ordered = floating and _arg(args, kwargs, 4, "reduce") in _ORDERED_REDUCES
    elif op in ("scatter", "scatter_"):
        ordered = floating and _arg(args, kwargs, 4, "reduce") in _ORDERED_REDUCES
    if ordered:
        hazards.append(Hazard(
            kind, NONDETERMINISTIC, prim,
            "a float accumulation in arrival order breaks the bit-identity "
            "contract",
        ))
    if op in _RANDOM_OPS:
        hazards.append(Hazard(
            kind, NONDETERMINISTIC, prim,
            "non-deterministic op breaks the bit-identity contract",
        ))
    if op not in f64_allow and any(t.dtype == torch.float64 for t in outs):
        in_dts = [str(t.dtype).replace("torch.", "") for t in ins]
        if "float64" not in in_dts:
            hazards.append(Hazard(
                kind, IMPLICIT_F64, prim,
                f"produces float64 from {in_dts} — the device dtype contract "
                f"is f32; widen on the host instead",
            ))
    return hazards


def audit_call(kind: str, fn, args=(), kwargs=None, f64_allow: tuple = ()):
    """Run ``fn(*args, **kwargs)`` once under a dispatch mode that records
    every aten op it issues; returns ``(result, hazards)``. The result is
    ``fn``'s own: the mode only observes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    kwargs = kwargs or {}
    seen: list = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            kw = kw or {}
            out = func(*a, **kw)
            seen.append((func, a, kw, out))
            return out

    with _Recorder():
        result = fn(*args, **kwargs)
    hazards: list[Hazard] = []
    try:
        for func, a, kw, out in seen:
            hazards.extend(classify_op(kind, func, a, kw, out, f64_allow))
    except Exception as e:  # classifying must never fail the query
        REGISTRY.counter("staticcheck.kernel.audit_errors").inc()
        logger.debug("kernel audit skipped for %s: %s", kind, e)
    return result, hazards


_found_lock = TrackedLock("kernel_audit.hazards")
# every hazard recorded since the last reset, in arrival order
_FOUND: list = guarded_by([], _found_lock, name="staticcheck.kernel_audit._FOUND")


def _record_hazards(kind: str, hazards: list[Hazard]) -> None:
    REGISTRY.counter("staticcheck.kernel.hazards").inc(len(hazards))
    with _found_lock:
        _FOUND.extend(hazards)
    for h in hazards:
        REGISTRY.counter(f"staticcheck.kernel.hazard.{h.code}").inc()
        logger.warning("kernel audit: %s", h)


def hazards_found() -> list[Hazard]:
    """Every hazard the audit recorded since the last ``reset_hazards()``."""
    with _found_lock:
        return list(_FOUND)


def reset_hazards() -> None:
    with _found_lock:
        _FOUND.clear()


def audit_enabled() -> bool:
    return env.env_bool("HYPERSPACE_KERNEL_AUDIT")


# ---------------------------------------------------------------------------
# retrace watchdog
# ---------------------------------------------------------------------------

_LAST = object()  # "the fingerprint's last element is its dtype signature"


class _RetraceWatchdog:
    """Tracks distinct fingerprints per (cache, kind, dtype-signature)
    group; one warning (with the fingerprint diff) per storming group."""

    def __init__(self):
        self._lock = TrackedLock("kernel_audit.watchdog")
        self._seen: dict = {}  # (cache, kind, sig) -> [keys in arrival order]
        self._warned: set = set()

    def record(self, cache_name: str, kind: str, key, sig=_LAST) -> "str | None":
        """Register one cache-miss fingerprint; returns the warning text
        when this miss tips its group over the threshold, else None.
        ``sig`` names the dtype signature of a fingerprint form that does
        not end with one."""
        if sig is _LAST:
            sig = key[-1] if isinstance(key, tuple) and key else None
        group = (cache_name, kind, sig)
        threshold = env.env_int("HYPERSPACE_RETRACE_WARN")
        with self._lock:
            keys = self._seen.setdefault(group, [])
            if key in keys:
                return None
            keys.append(key)
            if len(keys) <= threshold or group in self._warned:
                return None
            self._warned.add(group)
            diff = _fingerprint_diff(keys[-2], keys[-1])
        REGISTRY.counter("staticcheck.kernel.retrace_storm").inc()
        msg = (
            f"retrace storm: kernel kind {kind!r} (cache {cache_name!r}) "
            f"accumulated {len(keys)} distinct fingerprints with identical "
            f"dtype signatures — a varying value is baked into the "
            f"fingerprint. Last two keys differ at: {diff}"
        )
        logger.warning("%s", msg)
        return msg

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()
            self._warned.clear()


WATCHDOG = _RetraceWatchdog()


def reset_watchdog() -> None:
    WATCHDOG.reset()


def _fingerprint_diff(a, b) -> str:
    """Human-readable positions where two fingerprint tuples diverge."""
    if not (isinstance(a, tuple) and isinstance(b, tuple)):
        return f"{a!r} vs {b!r}"
    parts = []
    for i in range(max(len(a), len(b))):
        av = a[i] if i < len(a) else "<absent>"
        bv = b[i] if i < len(b) else "<absent>"
        if av != bv:
            parts.append(f"pos {i}: {_short(av)} vs {_short(bv)}")
    return "; ".join(parts) or "<identical>"


def _short(v, limit: int = 120) -> str:
    s = repr(v)
    return s if len(s) <= limit else s[: limit - 3] + "..."


# ---------------------------------------------------------------------------
# kernel-cache hook
# ---------------------------------------------------------------------------

def observe_compile(cache_name: str, kind: str, key, kernel, sig=_LAST):
    """Called by ``KernelCache.get_or_build`` on every cache miss, after the
    build. Feeds the watchdog always; under ``HYPERSPACE_KERNEL_AUDIT=1``
    additionally wraps the closure so its FIRST call runs under the
    recording dispatch mode (an ``audit:<kind>`` span around it). The
    wrapper is transparent: same callable contract, same result, audited
    exactly once."""
    WATCHDOG.record(cache_name, kind, key, sig)
    if not audit_enabled():
        return kernel

    done = threading.Event()

    def audited(*args, **kwargs):
        if not done.is_set():
            done.set()
            return _audit_first_call(kind, kernel, args, kwargs)
        return kernel(*args, **kwargs)

    return audited


def _audit_first_call(kind: str, kernel, args, kwargs):
    from ..telemetry import trace

    with trace.span(f"audit:{kind}") as sp:
        result, hazards = audit_call(kind, kernel, args, kwargs, F64_ALLOW.get(kind, ()))
        REGISTRY.counter("staticcheck.kernel.audited").inc()
        sp.set_attr("hazards", len(hazards))
        if hazards:
            _record_hazards(kind, hazards)
    return result


def report() -> dict:
    """The ``staticcheck:kernels`` report: closures audited, hazards by
    kind and code, and retrace storms."""

    def val(n: str) -> int:
        m = REGISTRY.get(n)
        return 0 if m is None else int(m.value)

    by: dict = {}
    for h in hazards_found():
        key = f"{h.kind}:{h.code}"
        by[key] = by.get(key, 0) + 1
    return {
        "audit_enabled": audit_enabled(),
        "audited": val("staticcheck.kernel.audited"),
        "hazards": val("staticcheck.kernel.hazards"),
        "by_kind_code": by,
        "retrace_storms": val("staticcheck.kernel.retrace_storm"),
    }
