"""Memory-adaptive execution of the co-bucketed join: the per-bucket
strategy plan, and the device-memory ledger's admission with park, spill
and resume (counterpart of hyperspace_tpu/plan/join_memory.py).

**Strategy plan** (``plan_join_memory``): every bucket pair picks its
execution strategy from the parquet footer statistics of its files
(``columnar.io.read_rowgroup_stats``: rows and bytes per row group, cached
by the file's version, so planning costs footer reads at most once):

    broadcast   both sides at most ``HYPERSPACE_JOIN_BROADCAST_ROWS`` (4096)
                rows: one band item, never split
    banded      a power-of-2 band item, unsplit
    split       the left side's estimated rows exceed the split row count:
                the bucket probes in left chunks whose results fold exactly

The split row count derives from the device-memory grant
(``HYPERSPACE_DEVICE_BUDGET_MB``, default 4096): one band wave of left
chunks should fit in a quarter of the grant (``derive_split_rows``,
clamped to 2^12..2^22 rows). An explicitly set ``HYPERSPACE_JOIN_SPLIT_ROWS``
overrides the derived value. A grant of 0 disables the plan, and the
executors split at the fixed ``plan/device_join.join_split_rows()``.
The plan runs in a ``join:plan`` span and counts ``join.strategy.*``, as
the reference's does, and on ``session.device_stats`` (``join_strategies``,
``join_plans``). Each bucket's decoded left bytes meet their footer
estimate in the accuracy ledger (``join_build_bytes``); under
``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` the plan scales the estimate by the
ledger's observed correction.

**Ledger admission** (``DeviceLedger``): the band scheduler
(plan/device_join._BandScheduler) reserves each wave's padded device
footprint on the device-byte accountant (serve/budget.device_budget)
before it dispatches. A reservation that does not fit PARKS the wave
instead of declining the join to the host: the scheduler spills its own
oldest in-flight waves (fetching their results to the host releases their
reservations) until the wave fits; when nothing of its own is left, it
waits a bounded time (``HYPERSPACE_PARK_WAIT_MS``, read when the wave
parks) for other joins' releases and
then takes the zero-holder grant. Spilling changes when a wave's results
come back, never what they are. A park counts ``join.spill.parks`` and
runs in a ``join:park`` span; its wait lands in ``join.spill.park_ms``, and
a granted resume counts ``join.spill.resumes`` with a ``join:resume``
marker.

Under ``HYPERSPACE_ADAPTIVE`` a bucket's split row count is re-derived
from the actuals of the pairs already loaded (``JoinMemoryPlan.split_rows``,
plan/adaptive.py), with an ``adapt.join_bytes`` observation. Each mesh
device ordinal has its own ledger (``DeviceLedger.admit(..., device=)``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

from ..serve import budget as serve_budget
from ..serve.context import check_cancelled
from ..staticcheck.lifecycle import release_resource, tracked_resource
from ..telemetry import attribution as _attr
from ..telemetry import plan_stats, trace
from ..telemetry.metrics import REGISTRY
from ..utils import env

# fraction of the grant one band wave of left-chunk slabs should fit in: 4
# keeps a spilling join about two waves in flight, with room for the right
# sides and the outputs, which the wave estimate prices separately
_WAVE_GRANT_FRACTION = 4

# derived split row counts clamp into this band: below the floor the
# dispatch overhead dwarfs the chunk, above the ceiling one slab upload
# stalls the pipeline whatever the grant
_SPLIT_ROWS_FLOOR = 1 << 12
_SPLIT_ROWS_CEIL = 1 << 22

_BROADCAST_ROWS_DEFAULT = 4096  # HYPERSPACE_JOIN_BROADCAST_ROWS

_PARK_POLL_S = 0.02  # release-condition wait quantum


def park_wait_ms() -> float:
    """``HYPERSPACE_PARK_WAIT_MS``: how long a parked wave waits for other
    joins' releases before its zero-holder grant (50; an unparseable value
    means the default)."""
    try:
        return env.env_float("HYPERSPACE_PARK_WAIT_MS")
    except ValueError:
        return env.knob("HYPERSPACE_PARK_WAIT_MS").default


def grant_bytes() -> int:
    """The device-memory grant the ledger enforces (0: the ledger and the
    plan are off), read from the live accountant so planning and admission
    agree."""
    return serve_budget.device_budget().max_bytes


def derive_split_rows(grant: int, row_bytes: float, wave: int = 8) -> int:
    """The largest power of two of rows such that one band wave of ``wave``
    left-chunk slabs fits in ``grant / _WAVE_GRANT_FRACTION`` bytes,
    clamped to [2^12, 2^22]; 0 when there is no grant. Powers of two keep
    nearby grants on the same pads."""
    if grant <= 0:
        return 0
    target = grant // _WAVE_GRANT_FRACTION
    rows = int(target / max(1.0, row_bytes) / max(1, wave))
    if rows < _SPLIT_ROWS_FLOOR:
        return _SPLIT_ROWS_FLOOR
    return min(_SPLIT_ROWS_CEIL, 1 << rows.bit_length() - 1)


def classify_bucket(est_l: int, est_r: int, split_rows: int, broadcast_rows: int) -> str:
    """One bucket pair's strategy from its estimated row counts."""
    if max(est_l, est_r) <= broadcast_rows:
        return "broadcast"
    if split_rows and est_l > split_rows:
        return "split"
    return "banded"


def _bucket_estimates(side, b: int) -> tuple[int, float]:
    """(estimated rows, estimated bytes) of one side's bucket, summed over
    its files' footer row groups (every run of a refreshed bucket counts);
    16 bytes a row of the file size when a footer cannot be read."""
    from ..columnar import io as cio

    rows = 0
    nbytes = 0
    for f in side.files_for_bucket(b):
        stats = cio.read_rowgroup_stats(f.name, [])
        if stats is None:
            rows += max(1, f.size // 16)
            nbytes += f.size
            continue
        for g in stats:
            rows += int(g.get("num_rows") or 0)
            nbytes += int(g.get("nbytes") or 0)
    return rows, float(nbytes)


class JoinMemoryPlan:
    """The per-bucket strategy decisions of one bucketed-join execution."""

    __slots__ = ("strategies", "split_rows_by_bucket", "grant", "derived_split_rows",
                 "override_split_rows", "estimates", "observed", "index_name",
                 "_log_rows", "_log_bytes", "_n_valid", "_switched")

    def __init__(self, strategies: dict, split_rows_by_bucket: dict, grant: int,
                 derived: int, override: Optional[int], estimates: Optional[dict] = None,
                 index_name: str = ""):
        self.strategies = strategies  # bucket -> "broadcast" | "banded" | "split"
        self.split_rows_by_bucket = split_rows_by_bucket  # bucket -> rows (0: never)
        self.grant = grant
        self.derived_split_rows = derived
        self.override_split_rows = override
        # bucket -> (estimated left rows, estimated left bytes), read-only
        self.estimates = dict(estimates or {})
        # bucket -> (decoded rows, decoded bytes), filled as pairs load
        self.observed: dict[int, tuple] = {}
        self.index_name = index_name
        # running sums of log(observed / estimated) rows and bytes: the
        # geometric-mean correction later pairs re-derive with under
        # HYPERSPACE_ADAPTIVE
        self._log_rows = 0.0
        self._log_bytes = 0.0
        self._n_valid = 0
        self._switched: set = set()  # buckets with a recorded replan

    def observe_actual(self, b: int, rows: int, nbytes: int) -> None:
        """Record one planned bucket's decoded left rows and bytes beside its
        footer estimate (once per bucket), add them to the running
        correction, and feed the accuracy ledger's ``join_build_bytes``
        estimator the decoded truth."""
        if b in self.observed:
            return
        est = self.estimates.get(b)
        if est is None:
            return
        self.observed[b] = (int(rows), int(nbytes))
        est_rows, est_bytes = est
        if est_bytes <= 0 or nbytes <= 0:
            return
        if est_rows > 0 and rows > 0:
            self._log_rows += math.log(rows / est_rows)
            self._log_bytes += math.log(nbytes / est_bytes)
            self._n_valid += 1
        plan_stats.ACCURACY.observe("join_build_bytes", est_bytes, nbytes,
                                    index=self.index_name)

    def strategy(self, b: int) -> str:
        return self.strategies.get(b, "banded")

    def split_rows(self, b: int, splittable: bool = True) -> int:
        """Bucket ``b``'s split row count; 0 never splits. A bucket the plan
        never saw (rows only in a hybrid scan's appended part) keeps the
        override or the derived count.

        With ``HYPERSPACE_ADAPTIVE`` on and the warmup pairs observed, the
        count is re-derived from the bucket's own decoded actuals
        (``observe_actual`` runs before the split decision) or, for a
        bucket not yet observed, from the geometric-mean correction of the
        pairs retired so far. A re-derivation that flips the planned
        strategy records one ``replan`` switch for the bucket when the
        caller can act on it (``splittable``); partials fold exactly either
        way, so a flip changes how the pair is dispatched, never values."""
        fallback = (self.override_split_rows if self.override_split_rows is not None
                    else self.derived_split_rows)
        base = self.split_rows_by_bucket.get(b, fallback)
        if base == 0:
            return base  # a broadcast pair never splits
        est = self.estimates.get(b)
        if est is None:
            return base
        from . import adaptive

        if not adaptive.active() or self._n_valid < adaptive.join_warmup_pairs():
            return base
        est_rows, est_bytes = est
        obs = self.observed.get(b)
        if obs is not None and obs[0] > 0 and obs[1] > 0:
            act_rows, act_bytes = obs
            row_bytes = act_bytes / act_rows
            ratio = act_bytes / max(est_bytes, 1.0)
        elif est_rows > 0 and est_bytes > 0:
            rows_corr = math.exp(self._log_rows / self._n_valid)
            bytes_corr = math.exp(self._log_bytes / self._n_valid)
            act_rows = est_rows * rows_corr
            act_bytes = est_bytes * bytes_corr
            row_bytes = act_bytes / max(act_rows, 1.0)
            ratio = bytes_corr
        else:
            return base
        derived = derive_split_rows(self.grant, row_bytes)
        adapted = self.override_split_rows if self.override_split_rows is not None else derived
        if adapted <= 0:
            return base
        old = self.strategies.get(b, "banded")
        new = "split" if act_rows > adapted else "banded"
        if new != old and splittable and b not in self._switched:
            self._switched.add(b)
            adaptive.record_switch("replan", old, new, index=self.index_name,
                                   ratio=ratio, at=len(self.observed))
            plan_stats.observe("adapt.join_bytes", max(est_bytes, 1.0),
                               max(act_bytes, 1.0), index=self.index_name)
        return adapted

    def counts(self) -> dict:
        out = {"broadcast": 0, "banded": 0, "split": 0}
        for s in self.strategies.values():
            out[s] = out.get(s, 0) + 1
        return out

    def summary(self) -> dict:
        """What the reference's ``join:plan`` span carries."""
        return {"buckets": len(self.strategies), "grant_bytes": self.grant,
                "split_rows": (self.override_split_rows if self.override_split_rows
                               is not None else self.derived_split_rows),
                "derived_split_rows": self.derived_split_rows,
                "override_split_rows": self.override_split_rows, **self.counts()}


def split_rows_override() -> Optional[int]:
    """An explicitly set ``HYPERSPACE_JOIN_SPLIT_ROWS``; None when unset or
    unparseable."""
    raw = env.read_raw("HYPERSPACE_JOIN_SPLIT_ROWS")
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _broadcast_rows() -> int:
    try:
        return int(env.read_raw("HYPERSPACE_JOIN_BROADCAST_ROWS",
                                str(_BROADCAST_ROWS_DEFAULT)))
    except ValueError:
        return _BROADCAST_ROWS_DEFAULT


def plan_join_memory(left, right, session) -> Optional[JoinMemoryPlan]:
    """Per-bucket-pair strategies of one bucketed join from the footer
    statistics of both sides; None when the device ledger is off
    (``HYPERSPACE_DEVICE_BUDGET_MB=0``). In a ``join:plan`` span, counting
    the decisions as ``join.strategy.*`` and noting the mix on the
    plan-statistics collector, and on ``session.device_stats`` when a
    session is given. Under ``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` the footer
    byte estimate is scaled by the ledger's observed ``join_build_bytes``
    correction for the index."""
    grant = grant_bytes()
    if grant <= 0:
        return None
    override = split_rows_override()
    broadcast_rows = _broadcast_rows()
    index_info = getattr(getattr(left, "scan", None), "index_info", None)
    index_name = index_info.index_name if index_info is not None else ""
    corr = (plan_stats.ACCURACY.correction("join_build_bytes", index_name)
            if plan_stats.feedback_enabled() else 1.0)
    n = left.spec.num_buckets
    strategies: dict[int, str] = {}
    split_by_bucket: dict[int, int] = {}
    estimates: dict[int, tuple] = {}
    derived = 0
    with trace.span("join:plan", buckets=n, grant_bytes=grant) as sp:
        for b in range(n):
            est_l, bytes_l = _bucket_estimates(left, b)
            est_r, _bytes_r = _bucket_estimates(right, b)
            if est_l == 0 or est_r == 0:
                continue  # an empty pair: nothing runs
            estimates[b] = (est_l, bytes_l)
            derived = derive_split_rows(grant, bytes_l * corr / est_l)
            split_rows = override if override is not None else derived
            strat = classify_bucket(est_l, est_r, split_rows, broadcast_rows)
            strategies[b] = strat
            # broadcast pairs never split; banded ones keep the count, so an
            # estimate below the decoded rows still splits
            split_by_bucket[b] = 0 if strat == "broadcast" else split_rows
        plan = JoinMemoryPlan(strategies, split_by_bucket, grant, derived, override,
                              estimates=estimates, index_name=index_name)
        counts = plan.counts()
        for strat, c in counts.items():
            if c:
                REGISTRY.counter(f"join.strategy.{strat}").inc(c)
        for strat in ("broadcast", "banded", "split"):
            sp.set_attr(strat, counts[strat])
        col = plan_stats.current()
        if col is not None:
            col.note_join_plan({"buckets": len(strategies), "grant_bytes": grant,
                                "split_rows": override if override is not None else derived,
                                **{k: v for k, v in counts.items() if v}})
    if session is not None:
        stats = session.device_stats
        for strat, c in plan.counts().items():
            if c:
                stats.join_strategies[strat] = stats.join_strategies.get(strat, 0) + c
        stats.join_plans.append(plan.summary())
    return plan


class DeviceLedger:
    """One join execution's handle on the device-byte accountants, and the
    park/spill/resume admission loop the band scheduler drives. Each mesh
    device ordinal has its own accountant (serve/budget.device_budget); a
    wave reserves through the ordinal it is placed on, so a full device
    parks its own waves and never its neighbours'. ``parks`` counts the
    admissions that did not fit at once (the reference's
    ``join.spill.parks``). ``close()`` (the caller's ``finally``) returns
    every outstanding byte on every ordinal."""

    __slots__ = ("_label", "_acct", "_stream", "_streams", "enabled", "parks", "_waves")

    def __init__(self, label: str = "join"):
        self._label = label
        self._acct = serve_budget.device_budget()
        self.enabled = self._acct.max_bytes > 0
        self._stream = self._acct.stream(label) if self.enabled else None
        # mesh ordinals join as the placement first targets them
        self._streams = {0: (self._acct, self._stream)}
        self.parks = 0
        # lifecycle-audit handles of the granted waves, newest last, by ordinal
        self._waves: dict = {}

    def _for(self, device: int) -> tuple:
        """(accountant, stream) of one mesh device ordinal."""
        pair = self._streams.get(device)
        if pair is None:
            acct = serve_budget.device_budget(device)
            pair = self._streams[device] = (
                acct, acct.stream(self._label) if self.enabled else None)
        return pair

    def admit(self, nbytes: int, spill_one: Callable[[], bool], device: int = 0) -> None:
        """Reserve ``nbytes`` on ordinal ``device`` for one band wave before
        it dispatches. When that ledger is full, ``spill_one()`` retires
        this join's oldest in-flight wave until the wave fits or nothing of
        ours is left; then a bounded wait for other joins' releases; then
        the zero-holder grant admits it."""
        if self._stream is None or nbytes <= 0:
            return
        acct, stream = self._for(device)
        deadline = None
        parked_at = None
        park_span = None
        granted = False
        try:
            while True:
                if acct.held_bytes() + nbytes <= acct.max_bytes:
                    if stream.try_reserve(nbytes):
                        granted = True
                        self._note_wave(device, nbytes)
                        return
                    continue  # lost a race with another reservation: re-check
                if parked_at is None:
                    parked_at = time.perf_counter()
                    self.parks += 1
                    REGISTRY.counter("join.spill.parks").inc()
                    plan_stats.note_flag("parked_waves")
                    park_span = trace.span("join:park", bytes=nbytes)
                    park_span.__enter__()
                # a cancelled query unwinds out of the park (its finally
                # returns the join's reservations)
                check_cancelled()
                if spill_one():
                    continue  # freed some of our own bytes: retry
                if deadline is None:
                    deadline = time.perf_counter() + park_wait_ms() / 1000.0
                if time.perf_counter() >= deadline and stream.try_reserve(nbytes):
                    granted = True
                    self._note_wave(device, nbytes)
                    return  # zero-holder grant past the limit
                acct.wait_for_release(_PARK_POLL_S)
        finally:
            if park_span is not None:
                park_span.__exit__(None, None, None)
            if parked_at is not None:
                # the parked wall charges even on a cancel's unwind
                waited = time.perf_counter() - parked_at
                _attr.charge_phase("park", waited)
                REGISTRY.histogram("join.spill.park_ms").observe(waited * 1000)
                if granted:
                    REGISTRY.counter("join.spill.resumes").inc()
                    # a zero-width marker of when the parked wave re-admitted
                    with trace.span("join:resume", bytes=nbytes,
                                    parked_ms=round(waited * 1000, 3)):
                        pass

    def _note_wave(self, device: int, nbytes: int) -> None:
        lc = tracked_resource("ledger.wave", f"{self._label}/d{device}:{nbytes}b")
        if lc:
            self._waves.setdefault(device, []).append(lc)

    def release(self, nbytes: int, device: int = 0) -> None:
        if self._stream is None or nbytes <= 0:
            return
        _acct, stream = self._for(device)
        stream.release(nbytes)
        waves = self._waves.get(device)
        if waves:
            release_resource(waves.pop())

    def close(self) -> None:
        # waves still noted here were reclaimed wholesale by the stream
        # closes below (the cancellation unwind), not leaked
        for waves in self._waves.values():
            while waves:
                release_resource(waves.pop())
        for _acct, stream in self._streams.values():
            if stream is not None:
                stream.close()
