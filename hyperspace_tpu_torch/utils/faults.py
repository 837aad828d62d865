"""Deterministic fault injection at named chokepoints (counterpart of
hyperspace_tpu/utils/faults.py: the same points, spec grammar, typed
errors, counters and span events, so one ``HYPERSPACE_FAULTS`` spec arms
the same failures in both packages).

A handful of *named injection points* sit at the port's IO, device, log
and publish chokepoints, and a seeded spec arms typed failures at exactly
chosen hits. The recovery layers (``utils/retry.py`` backoff,
``IndexManager.recover()``) must then hold the "bit-identical or typed
error, never wrong answers" line. The port has no device breaker (a
failed kernel raises), so an injected device fault surfaces as the error
it raises.

Injection points (the catalog; a new point is added HERE):

    io.read_file     per-file parquet/csv/json/orc decode (columnar/io.py)
    io.footer        parquet footer-statistics parse (columnar/io.py)
    device.upload    host-to-device transfer (utils/rpc_meter.record_upload,
                     the funnel every real upload passes; a device-cache
                     hit moves no bytes and never faults)
    device.dispatch  device dispatch (utils/rpc_meter.record_dispatch)
    device.fetch     device-to-host fetch (utils/rpc_meter.device_get)
    kernel.compile   kernel build on a cache miss (plan/kernel_cache.py)
    log.write        transaction-log CAS commit (meta/log_manager.py)
    data.publish     staged index-data version publish (meta/data_manager.py)
    ingest.append    delta-run build of an ingest batch (ingest/actions.py),
                     bracketing stage -> write -> publish
    ingest.compact   delta-run compaction build (ingest/actions.py), the
                     same bracket around the compacted version
    workload.journal the workload journal's line write (telemetry/
                     workload.py): crash_after dies between the payload
                     and its newline, the torn tail the reader skips
    approx.sample    sample-twin writes beside an index data file
                     (models/sample_store.py), bracketing the tier loop
                     and the meta, so a crash leaves files without
                     twins (the sampled tier then declines them)

Spec grammar (``HYPERSPACE_FAULTS``, also ``arm()``):

    spec    = rule [";" rule ...]
    rule    = point ":" kind ":" trigger
    point   = exact name above, or a prefix wildcard like "device.*"
    kind    = "ioerror" | "oom" | "crash_before" | "crash_after"
    trigger = "n=K"                  fire on the K-th hit (1-based), once
            | "p=F[,seed=S]"         fire each hit with probability F,
                                     seeded (default seed 0)
            | "always"               fire on every hit

Kinds map to typed errors:

- ``ioerror`` raises :class:`InjectedIOError`, an ``IOError`` (the retry
  classifier treats it as transient) that is also a ``HyperspaceError``;
- ``oom`` raises :class:`InjectedOOMError`, ``MemoryError``-shaped;
- ``crash_before`` / ``crash_after`` raise :class:`InjectedCrash` before
  or after the guarded operation. It derives from ``BaseException``, so no
  ``except Exception`` on the way out absorbs it: what it leaves behind
  (stranded transient log entries, unpublished staging dirs,
  published-but-unlogged versions) is what ``recover()`` must repair.

Disarmed (``HYPERSPACE_FAULTS`` unset), every hook is one global read and
an immediate return: no counter, no span event, no change of behavior.

Every injected failure counts ``faults.injected`` and
``faults.injected.<point>`` and emits a ``fault:<point>`` span event with
the kind and hit number.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

from ..exceptions import HyperspaceError
from . import env

KINDS = ("ioerror", "oom", "crash_before", "crash_after")

POINTS = (
    "io.read_file",
    "io.footer",
    "device.upload",
    "device.dispatch",
    "device.fetch",
    "kernel.compile",
    "log.write",
    "data.publish",
    "ingest.append",
    "ingest.compact",
    "workload.journal",
    "approx.sample",
)


class InjectedIOError(IOError, HyperspaceError):
    """Injected transient IO failure (retryable; typed)."""


class InjectedOOMError(MemoryError, HyperspaceError):
    """Injected allocation failure (RESOURCE_EXHAUSTED analogue; typed)."""


class InjectedCrash(BaseException):
    """Simulated process death at an injection point. BaseException so no
    ``except Exception`` on the unwind path can swallow it — only the
    harness that armed the fault catches it."""


class FaultSpecError(HyperspaceError):
    """Malformed ``HYPERSPACE_FAULTS`` spec string."""


@dataclass
class FaultRule:
    """One armed rule; hit/fire bookkeeping is mutated under ``_PLAN_LOCK``."""

    point: str  # exact name, or "prefix.*"
    kind: str
    nth: int | None = None  # fire on exactly this hit (1-based)
    p: float | None = None  # or fire each hit with this probability
    always: bool = False
    seed: int = 0
    hits: int = 0
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def matches(self, point: str) -> bool:
        if self.point.endswith(".*"):
            return point.startswith(self.point[:-1])
        return point == self.point

    def should_fire(self) -> bool:
        """Called with the hit already counted; deterministic per seed."""
        if self.always:
            return True
        if self.nth is not None:
            return self.hits == self.nth
        return self.rng.random() < (self.p or 0.0)


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse a ``HYPERSPACE_FAULTS`` spec string into rules (see module
    docstring for the grammar); raises :class:`FaultSpecError` on any
    malformed rule so a typo'd spec fails loudly instead of silently
    injecting nothing."""
    rules: list[FaultRule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) != 3:
            raise FaultSpecError(
                f"fault rule {chunk!r} must be point:kind:trigger"
            )
        point, kind, trigger = (p.strip() for p in parts)
        base = point[:-2] if point.endswith(".*") else point
        if point.endswith(".*"):
            if not any(p.startswith(base + ".") or p == base for p in POINTS):
                raise FaultSpecError(f"unknown injection point {point!r}")
        elif point not in POINTS:
            raise FaultSpecError(
                f"unknown injection point {point!r}; known: {', '.join(POINTS)}"
            )
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r}; known: {', '.join(KINDS)}"
            )
        rule = FaultRule(point=point, kind=kind)
        if trigger == "always":
            rule.always = True
        else:
            for kv in trigger.split(","):
                if "=" not in kv:
                    raise FaultSpecError(
                        f"fault trigger {trigger!r} must be n=K, p=F[,seed=S], "
                        f"or always"
                    )
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                try:
                    if k == "n":
                        rule.nth = int(v)
                    elif k == "p":
                        rule.p = float(v)
                    elif k == "seed":
                        rule.seed = int(v)
                    else:
                        raise FaultSpecError(
                            f"unknown trigger key {k!r} in {chunk!r}"
                        )
                except ValueError as e:
                    raise FaultSpecError(
                        f"bad trigger value {kv!r} in {chunk!r}"
                    ) from e
            if (rule.nth is None) == (rule.p is None):
                raise FaultSpecError(
                    f"fault rule {chunk!r} needs exactly one of n=K / p=F"
                )
            if rule.nth is not None and rule.nth < 1:
                raise FaultSpecError(f"n must be >= 1 in {chunk!r}")
            if rule.p is not None and not (0.0 <= rule.p <= 1.0):
                raise FaultSpecError(f"p must be in [0, 1] in {chunk!r}")
        rule.rng = random.Random(rule.seed)
        rules.append(rule)
    return rules


# armed plan: None = disarmed (the fast path reads only this). Hit counting
# mutates rule state, and injection points fire from IO-pool workers, so
# all bookkeeping runs under one leaf lock.
_PLAN: "list[FaultRule] | None" = None
_PLAN_LOCK = threading.Lock()  # leaf: never acquires another lock inside


def arm(spec: str) -> list[FaultRule]:
    """Arm a spec programmatically. Returns the live rules, so callers can
    read their hit and fire counts afterwards."""
    global _PLAN
    rules = parse_spec(spec)
    with _PLAN_LOCK:
        _PLAN = rules if rules else None
    return rules


def disarm() -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def armed() -> bool:
    return _PLAN is not None


def _fire_rule(rule: FaultRule, point: str, ctx: dict) -> None:
    from ..telemetry import trace
    from ..telemetry.metrics import REGISTRY

    REGISTRY.counter("faults.injected").inc()
    REGISTRY.counter(f"faults.injected.{point}").inc()
    trace.add_event(
        f"fault:{point}", kind=rule.kind, hit=rule.hits, **ctx
    )
    detail = ", ".join(f"{k}={v}" for k, v in ctx.items())
    msg = f"injected {rule.kind} at {point} (hit {rule.hits}{', ' + detail if detail else ''})"
    if rule.kind == "ioerror":
        raise InjectedIOError(msg)
    if rule.kind == "oom":
        raise InjectedOOMError(msg)
    raise InjectedCrash(msg)


def _select(point: str, phase: str) -> "tuple[FaultRule, dict] | None":
    """Count a hit on every matching rule; return the first that fires in
    this phase. ``before`` fires ioerror/oom/crash_before; ``after`` fires
    crash_after (the hit was already counted by the before call)."""
    with _PLAN_LOCK:
        plan = _PLAN
        if plan is None:
            return None
        for rule in plan:
            if not rule.matches(point):
                continue
            if phase == "before":
                rule.hits += 1
                if rule.kind != "crash_after" and rule.should_fire():
                    rule.fired += 1
                    return rule, {}
            else:
                if rule.kind == "crash_after" and rule.should_fire():
                    rule.fired += 1
                    return rule, {}
    return None


def fire(point: str, **ctx) -> None:
    """Hook placed BEFORE the guarded operation. Counts one hit per armed
    matching rule and raises the typed failure when one triggers
    (ioerror / oom / crash_before). No-op (one global read) when disarmed."""
    if _PLAN is None:
        return
    hit = _select(point, "before")
    if hit is not None:
        _fire_rule(hit[0], point, ctx)


def fire_after(point: str, **ctx) -> None:
    """Hook placed AFTER the guarded operation succeeded: the crash_after
    half of a crash pair (the op took effect; the process dies before any
    follow-up). Uses the hit counted by the paired ``fire`` call."""
    if _PLAN is None:
        return
    hit = _select(point, "after")
    if hit is not None:
        _fire_rule(hit[0], point, ctx)


def snapshot() -> list[dict]:
    """The armed rules' state, for reports."""
    with _PLAN_LOCK:
        if _PLAN is None:
            return []
        return [
            {
                "point": r.point,
                "kind": r.kind,
                "trigger": (
                    "always" if r.always
                    else f"n={r.nth}" if r.nth is not None
                    else f"p={r.p},seed={r.seed}"
                ),
                "hits": r.hits,
                "fired": r.fired,
            }
            for r in _PLAN
        ]


# env arming at import, as in the JAX package; in-process callers use
# arm()/disarm()
_env_spec = env.read_raw("HYPERSPACE_FAULTS")
if _env_spec:
    arm(_env_spec)
