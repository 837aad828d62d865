"""Multi-tenant QoS, the port against the JAX package on the same inputs
(the counterpart of tests/test_qos.py).

- Weighted-fair queueing: the same pushes and charges, driven through each
  package's ``TenantQueues`` with one worker slot, give the same dispatch
  order, clocks and delivered shares: weights 1:3 converge to a 3:1
  dispatch mix, unequal costs are equalised by cost and not by count, an
  idle tenant earns no credit, a reweight takes effect at the next charge,
  one tenant is plain priority+FIFO, stale entries are skipped and
  ``max_active`` holds a tenant back; aging reorders past static priority
  and is capped.
- Tenants: token buckets on one fixed clock grant the same sequence; spec
  parsing gives equal dicts and the same typed errors with the same
  messages; ``query_cost``, ``deadline_verdict`` and ``choose_degrade_tier``
  equal the JAX package's on the same cost-model history.
- The scheduler: single-tenant dispatch order under priorities, and the
  quota, rate and deadline rejections, typed as in the JAX package with
  the same ``serve.tenant.rejected.*`` counter moves; a degraded query
  that runs exact feeds the exact label, and its record says the sampled
  tier did not engage; the tenant rides the record and the rollups.
- The budget's per-tenant partition (tests/test_qos.py
  ``TestBudgetPartition``) gives each package the same grants, stalls and
  tenant views.
"""

import threading
import time

import pytest

import hyperspace_tpu as J
import hyperspace_tpu_torch as T
from hyperspace_tpu import serve as jserve
from hyperspace_tpu.serve import qos as jqos
from hyperspace_tpu.serve import tenant as jtenant
from hyperspace_tpu.serve.budget import BudgetAccountant as JBudget
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu_torch import serve as tserve
from hyperspace_tpu_torch.serve import qos as tqos
from hyperspace_tpu_torch.serve import tenant as ttenant
from hyperspace_tpu_torch.serve.budget import BudgetAccountant as TBudget
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG

PKGS = {
    "jax": {"mod": J, "serve": jserve, "qos": jqos, "tenant": jtenant, "budget": JBudget,
            "reg": JREG},
    "torch": {"mod": T, "serve": tserve, "qos": tqos, "tenant": ttenant, "budget": TBudget,
              "reg": TREG},
}


def _reset_planes() -> None:
    for p in PKGS.values():
        mod = p["mod"]
        p["tenant"].TENANTS.reset_for_testing()
        p["qos"].COST_MODEL.reset_for_testing()
        mod.telemetry.attribution.LEDGER.reset_for_testing()
        mod.telemetry.workload.reset_for_testing()
        mod.telemetry.plan_stats.ACCURACY.reset_for_testing()
        p["serve"].reset_global_budget()


@pytest.fixture(autouse=True)
def _pristine_qos_state():
    """Tenants, the cost model, the ledgers and the accuracy ledger are
    process-wide in each package: every test starts and ends from the
    zero-config state, and the module leaves both packages so."""
    _reset_planes()
    yield
    _reset_planes()


class _FakeHandle:
    """Minimal stand-in for QueryHandle in TenantQueues unit tests."""

    __slots__ = ("status", "_submit_t", "tag")

    def __init__(self, tag=None, submit_t=0.0):
        self.status = "queued"
        self._submit_t = submit_t
        self.tag = tag


def _drive(queues, charges, pops, cost=1.0, aging_ms=0.0, aging_cap=0, now=None):
    """The scheduler's dispatch, run and charge cycle with one worker slot;
    the tenant dispatch order."""
    order = []
    for _ in range(pops):
        popped = queues.pop_locked(aging_ms, aging_cap, now=now)
        if popped is None:
            break
        name, h = popped
        queues.on_dequeue(name)
        queues.on_activate(name)
        h.status = "done"
        queues.on_deactivate(name)
        queues.note_outcome(name, "done")
        queues.charge(name, charges(name) if callable(charges) else cost)
        order.append(name)
    return order


# --- weighted-fair queueing scenarios: (pkg) -> observation -----------------


def _weights_1_to_3(pkg):
    t = PKGS[pkg]["tenant"].TENANTS
    t.configure("a", weight=1.0)
    t.configure("b", weight=3.0)
    q = PKGS[pkg]["qos"].TenantQueues()
    for i in range(40):
        q.push("a", (0, i, _FakeHandle()))
        q.push("b", (0, 1000 + i, _FakeHandle()))
    order = _drive(q, None, pops=40)
    return {"order": order, "state": q.state()}


def _unequal_costs(pkg):
    t = PKGS[pkg]["tenant"].TENANTS
    t.configure("cheap", weight=1.0)
    t.configure("heavy", weight=1.0)
    q = PKGS[pkg]["qos"].TenantQueues()
    for i in range(64):
        q.push("cheap", (0, i, _FakeHandle()))
        q.push("heavy", (0, 1000 + i, _FakeHandle()))
    order = _drive(q, lambda name: 4.0 if name == "heavy" else 1.0, pops=50)
    return {"order": order, "state": q.state()}


def _idle_wake(pkg):
    t = PKGS[pkg]["tenant"].TENANTS
    t.configure("a", weight=1.0)
    t.configure("b", weight=1.0)
    q = PKGS[pkg]["qos"].TenantQueues()
    for i in range(60):
        q.push("a", (0, i, _FakeHandle()))
    first = _drive(q, None, pops=30)
    for i in range(20):
        q.push("b", (0, 1000 + i, _FakeHandle()))
    return {"first": first, "order": _drive(q, None, pops=10), "state": q.state()}


def _reweight(pkg):
    t = PKGS[pkg]["tenant"].TENANTS
    t.configure("a", weight=1.0)
    t.configure("b", weight=1.0)
    q = PKGS[pkg]["qos"].TenantQueues()
    for i in range(80):
        q.push("a", (0, i, _FakeHandle()))
        q.push("b", (0, 1000 + i, _FakeHandle()))
    first = _drive(q, None, pops=20)
    t.configure("b", weight=3.0)
    return {"first": first, "order": _drive(q, None, pops=40)}


def _single_tenant(pkg):
    q = PKGS[pkg]["qos"].TenantQueues()
    entries = [(-1, 0), (0, 1), (-5, 2), (0, 3), (-1, 4), (-5, 5)]
    for pri_neg, seq in entries:
        q.push("default", (pri_neg, seq, _FakeHandle(tag=(pri_neg, seq))))
    got = []
    for _ in entries:
        name, h = q.pop_locked()
        q.on_dequeue(name)
        h.status = "done"
        got.append(h.tag)
    return {"order": got}


def _stale(pkg):
    q = PKGS[pkg]["qos"].TenantQueues()
    h_dead, h_live = _FakeHandle("dead"), _FakeHandle("live")
    q.push("t", (0, 0, h_dead))
    q.push("t", (0, 1, h_live))
    h_dead.status = "cancelled"  # lazily removed: its count was released
    q.on_dequeue("t")
    name, h = q.pop_locked()
    q.on_dequeue(name)
    return {"order": [h.tag], "after": q.pop_locked()}


def _max_active(pkg):
    PKGS[pkg]["tenant"].TENANTS.configure("capped", max_active=1)
    q = PKGS[pkg]["qos"].TenantQueues()
    q.push("capped", (0, 0, _FakeHandle()))
    q.push("capped", (0, 1, _FakeHandle()))
    q.push("free", (0, 2, _FakeHandle()))
    order = []
    for _ in range(2):
        name, _h = q.pop_locked()
        q.on_dequeue(name)
        q.on_activate(name)
        order.append(name)
    blocked = q.pop_locked()
    q.on_deactivate("capped")
    order.append(q.pop_locked()[0])
    return {"order": order, "blocked": blocked}


def _aging(pkg, aging_ms, cap):
    q = PKGS[pkg]["qos"].TenantQueues()
    q.push("t", (0, 0, _FakeHandle("old_low", submit_t=0.0)))
    q.push("t", (-10, 1, _FakeHandle("fresh_high", submit_t=9.99)))
    _name, h = q.pop_locked(aging_ms=aging_ms, aging_cap=cap, now=10.0)
    return {"order": [h.tag], "boosts": q.state()["t"]["aging_boosts"]}


SCENARIOS = {
    "weights_1_to_3": _weights_1_to_3,
    "unequal_costs": _unequal_costs,
    "idle_wake": _idle_wake,
    "reweight": _reweight,
    "single_tenant": _single_tenant,
    "stale_entries": _stale,
    "max_active": _max_active,
    "aging_off": lambda pkg: _aging(pkg, 0, 100),
    "aging_on": lambda pkg: _aging(pkg, 100, 100),
    "aging_capped": lambda pkg: _aging(pkg, 100, 5),
}


def _strip_tokens(obs: dict) -> dict:
    # the registry's rate_tokens read the wall clock: left out
    state = obs.get("state")
    if state is not None:
        obs = dict(obs, state={k: {f: v for f, v in row.items() if f != "rate_tokens"}
                               for k, row in state.items()})
    return obs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_wfq_scenario_matches_the_jax_package(scenario):
    fn = SCENARIOS[scenario]
    got = {}
    for pkg in PKGS:
        got[pkg] = _strip_tokens(fn(pkg))
        _reset_planes()
    assert got["torch"] == got["jax"]
    obs = got["torch"]
    # the reference's own bounds, held on the port's observation
    if scenario == "weights_1_to_3":
        nb = obs["order"].count("b")
        assert 28 <= nb <= 32 and 8 <= obs["order"].count("a") <= 12
        assert obs["state"]["b"]["delivered_share"] == pytest.approx(0.75, abs=0.05)
        assert obs["state"]["b"]["cost_s"] == pytest.approx(
            3 * obs["state"]["a"]["cost_s"], rel=0.15)
    elif scenario == "unequal_costs":
        st = obs["state"]
        assert st["cheap"]["cost_s"] == pytest.approx(st["heavy"]["cost_s"], rel=0.25)
        assert obs["order"].count("cheap") > 2.5 * obs["order"].count("heavy")
    elif scenario == "idle_wake":
        assert obs["first"] == ["a"] * 30
        assert 4 <= obs["order"].count("b") <= 6
        assert obs["state"]["b"]["vclock"] >= 25.0
    elif scenario == "reweight":
        assert 8 <= obs["first"].count("b") <= 12
        assert obs["order"].count("b") >= 26
    elif scenario == "single_tenant":
        assert obs["order"] == sorted(obs["order"])
    elif scenario == "stale_entries":
        assert obs == {"order": ["live"], "after": None}
    elif scenario == "max_active":
        assert obs == {"order": ["capped", "free", "capped"], "blocked": None}
    elif scenario == "aging_off":
        assert obs == {"order": ["fresh_high"], "boosts": 0}
    elif scenario == "aging_on":
        assert obs == {"order": ["old_low"], "boosts": 1}
    elif scenario == "aging_capped":
        assert obs == {"order": ["fresh_high"], "boosts": 0}


# --- tenants, cost model, verdicts -------------------------------------------


def test_token_bucket_on_a_fixed_clock_matches():
    seqs = {}
    for pkg in PKGS:
        clock = {"t": 0.0}
        b = PKGS[pkg]["tenant"].TokenBucket(rate_qps=1.0, burst=2.0, clock=lambda: clock["t"])
        seq = [b.try_acquire(), b.try_acquire(), b.try_acquire()]
        clock["t"] = 1.0
        seq += [b.try_acquire(), b.try_acquire()]
        clock["t"] = 100.0
        seq.append(b.tokens())
        seqs[pkg] = seq
    assert seqs["torch"] == seqs["jax"] == [True, True, False, True, False, 2.0]


def test_spec_parsing_matches(monkeypatch):
    spec = "gold:weight=4,rate_qps=50;bulk:weight=1,max_active=1;plain"
    assert ttenant.parse_tenant_spec(spec) == jtenant.parse_tenant_spec(spec) == {
        "gold": {"weight": 4.0, "rate_qps": 50.0},
        "bulk": {"weight": 1.0, "max_active": 1}, "plain": {}}
    monkeypatch.setenv("HYPERSPACE_TENANTS", spec)
    for p in PKGS.values():
        p["tenant"].TENANTS.reset_for_testing()  # re-bootstraps from the env spec
    assert ttenant.TENANTS.known() == jtenant.TENANTS.known()
    strip = lambda st: {k: {f: v for f, v in c.items() if f != "rate_tokens"}  # noqa: E731
                        for k, c in st.items()}
    assert strip(ttenant.TENANTS.state()) == strip(jtenant.TENANTS.state())
    assert ttenant.TENANTS.get("bulk").max_active == 1


@pytest.mark.parametrize("bad", ["gold:wieght=4", "gold:weight=heavy", ":weight=1"])
def test_bad_spec_raises_the_same_typed_error(bad):
    msgs = {}
    for pkg in PKGS:
        with pytest.raises(PKGS[pkg]["tenant"].TenantSpecError) as ei:
            PKGS[pkg]["tenant"].parse_tenant_spec(bad)
        msgs[pkg] = str(ei.value)
    assert msgs["torch"] == msgs["jax"]
    with pytest.raises(ttenant.TenantSpecError):
        ttenant.TENANTS.configure("x", not_a_field=1)


def test_query_cost_normalization_matches(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_QOS_COST_MBPS", "100")
    record = {"total_ms": 500.0, "bytes_read": 50_000_000,
              "upload_bytes": 25_000_000, "fetch_bytes": 25_000_000}
    assert tqos.query_cost(record) == jqos.query_cost(record) == pytest.approx(1.5)


_HISTORY = (("known", 0.5), ("known", 0.4), ("other", 0.05), ("known", 0.45),
            ("other", 0.07))
_VERDICTS = (("novel", 0.001, 0, 4), ("known", 0.01, 0, 4), ("known", 60.0, 8, 4),
             ("known", 0.5, 2, 1), ("other", 0.2, 16, 4), ("novel", 0.3, 4, 2))


def test_deadline_verdict_and_degrade_tier_match(monkeypatch):
    def observe(pkg):
        cm = PKGS[pkg]["qos"]
        out = [cm.deadline_verdict("novel", 0.001, queued=0, max_concurrent=4)]
        for label, run_s in _HISTORY:
            cm.COST_MODEL.update(label, run_s)
        out += [cm.deadline_verdict(*v) for v in _VERDICTS]
        out += [cm.choose_degrade_tier(*v) for v in _VERDICTS]
        return out

    assert observe("torch") == observe("jax")
    monkeypatch.setenv("HYPERSPACE_APPROX", "1")
    monkeypatch.setenv("HYPERSPACE_APPROX_FRACTIONS", "0.05,0.2,bad,1.5")
    _reset_planes()
    got = {pkg: observe(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    verdicts, tiers = got["torch"][1:len(_VERDICTS) + 1], got["torch"][len(_VERDICTS) + 1:]
    assert [v["admit"] for v in verdicts] == [False, False, True, False, False, False]
    # every case has evidence (a label's own EWMA or the global mean), so
    # each gets a tier of the valid configured fractions: the largest that
    # fits, else the smallest
    assert [t["fraction"] for t in tiers] == [0.05, 0.05, 0.2, 0.05, 0.05, 0.05]


# --- the scheduler ------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_single_tenant_dispatch_order_is_priority_fifo(pkg):
    serve = PKGS[pkg]["serve"]
    sched = serve.QueryScheduler(max_concurrent=1, queue_depth=16)
    order: list = []
    gate = threading.Event()
    try:
        blocker = sched.submit(lambda: gate.wait(30), label="blocker")
        hs = [sched.submit(lambda t=tag: order.append(t), priority=pri, label=str(tag))
              for tag, pri in [("l0", 0), ("h0", 5), ("l1", 0), ("m0", 3), ("h1", 5)]]
        gate.set()
        blocker.result(30)
        for h in hs:
            h.result(30)
        assert order == ["h0", "h1", "m0", "l0", "l1"]
    finally:
        sched.shutdown()


def _rejections(pkg) -> dict:
    """The quota, rate and deadline doors of one package: the exception
    types (by name), their AdmissionRejected kinship, the counter moves."""
    serve, tenant, reg = PKGS[pkg]["serve"], PKGS[pkg]["tenant"], PKGS[pkg]["reg"]
    names = ("serve.tenant.rejected.quota", "serve.tenant.rejected.rate",
             "serve.tenant.rejected.deadline", "serve.rejected")
    before = {n: reg.counter(n).value for n in names}
    tenant.TENANTS.configure("capped", max_in_flight=1)
    tenant.TENANTS.configure("bursty", rate_qps=0.001, burst=1)
    PKGS[pkg]["qos"].COST_MODEL.update("slow_label", 0.5)
    out = {}
    sched = serve.QueryScheduler(max_concurrent=1, queue_depth=16)
    gate = threading.Event()
    try:
        running = sched.submit(lambda: gate.wait(30), tenant="capped")
        for kind, call in (
            ("quota", lambda: sched.submit(lambda: 2, tenant="capped")),
            ("deadline", lambda: sched.submit(lambda: 1, label="slow_label",
                                              deadline_s=0.01)),
        ):
            with pytest.raises(Exception) as ei:  # raised by submit(): the door
                call()
            out[kind] = (type(ei.value).__name__,
                         isinstance(ei.value, serve.AdmissionRejected))
        ok = sched.submit(lambda: 3, tenant="other")
        gate.set()
        running.result(30)
        out["other"] = ok.result(30)
        assert sched.submit(lambda: 1, tenant="bursty").result(30) == 1
        with pytest.raises(Exception) as ei:
            sched.submit(lambda: 2, tenant="bursty")  # the bucket is drained
        out["rate"] = (type(ei.value).__name__,
                       isinstance(ei.value, serve.AdmissionRejected))
        st = sched.state()["tenants"]
        out["state"] = {t: (st[t]["rejected_quota"], st[t]["rejected_rate"],
                            st[t]["rejected_deadline"]) for t in sorted(st)}
        h = sched.submit(lambda: 7, label="slow_label", deadline_s=60.0)
        out["generous"] = h.result(30)
    finally:
        gate.set()
        sched.shutdown()
    out["counters"] = {n: reg.counter(n).value - before[n] for n in names}
    return out


def test_rejections_are_typed_as_in_the_jax_package():
    got = {pkg: _rejections(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["quota"] == ("TenantQuotaExceeded", False)
    assert t["rate"] == ("TenantQuotaExceeded", False)
    assert t["deadline"] == ("DeadlineUnmeetable", True)
    assert t["other"] == 3 and t["generous"] == 7
    assert t["counters"] == {"serve.tenant.rejected.quota": 1,
                             "serve.tenant.rejected.rate": 1,
                             "serve.tenant.rejected.deadline": 1, "serve.rejected": 3}
    assert TREG.histogram("estimator.qerror.serve.wall").value["count"] >= 1


def test_declined_degrade_feeds_the_exact_label(monkeypatch):
    """A degraded admit whose function is no collect never reaches the
    sampled tier: its record holds the admission's degrade decision alone,
    as the JAX package's does, and its wall feeds the exact label's EWMA,
    never the tier label's."""
    monkeypatch.setenv("HYPERSPACE_APPROX", "1")
    got = {}
    for pkg in PKGS:
        qos, serve = PKGS[pkg]["qos"], PKGS[pkg]["serve"]
        qos.COST_MODEL.update("deg_label", 0.5)  # a slow exact wall learned
        sched = serve.QueryScheduler(max_concurrent=1, queue_depth=16)
        try:
            h = sched.submit(lambda: 11, label="deg_label", deadline_s=0.01)
            assert h.result(30) == 11
        finally:
            sched.shutdown()
        f = h.ctx.approx_fraction
        assert f is not None  # degraded at the door, not rejected
        assert qos.COST_MODEL.predict(qos.tier_label("deg_label", f)) is None
        assert qos.COST_MODEL.predict("deg_label") < 0.5
        got[pkg] = (f, sched.state()["tenants"]["default"]["degraded"])
    assert got["torch"] == got["jax"]
    rec = T.telemetry.attribution.LEDGER.recent_records()[-1]
    jrec = J.telemetry.attribution.LEDGER.recent_records()[-1]
    assert rec["label"] == jrec["label"] == "deg_label"
    assert rec["approx"] == jrec["approx"]
    assert rec["approx"]["degraded"] and "engaged" not in rec["approx"]


def test_deadline_without_history_admits():
    sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=4)
    try:
        assert sched.submit(lambda: 5, label="never_seen", deadline_s=1e-6).result(30) == 5
    finally:
        sched.shutdown()


def test_aging_unstarves_low_priority_under_flood(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_SERVE_AGING_MS", "5")
    sched = tserve.QueryScheduler(max_concurrent=1, queue_depth=256)
    stop, low_done = threading.Event(), threading.Event()
    flooded = {"n": 0}

    def flood():
        while not stop.is_set() and not low_done.is_set():
            try:
                sched.submit(lambda: time.sleep(0.002), priority=10, label="flood")
                flooded["n"] += 1
            except tserve.AdmissionRejected:
                pass
            time.sleep(0.001)

    t = threading.Thread(target=flood, name="qos-flood")
    try:
        t.start()
        time.sleep(0.05)
        sched.submit(lambda: low_done.set(), priority=0, label="low").result(30)
        assert low_done.is_set() and flooded["n"] > 10
    finally:
        stop.set()
        t.join(timeout=30)
        sched.shutdown(wait=True, cancel=True)


def test_tenant_rides_the_record_and_the_rollups():
    from hyperspace_tpu_torch.telemetry.attribution import LEDGER

    sched = tserve.QueryScheduler(max_concurrent=2, queue_depth=8)
    try:
        sched.submit(lambda: 1, tenant="acme", label="tagged").result(30)
    finally:
        sched.shutdown()
    mine = [r for r in LEDGER.recent_records() if r["label"] == "tagged"]
    assert mine and mine[-1]["tenant"] == "acme"
    rollups = LEDGER.tenant_rollups()
    assert rollups["acme"]["queries"] == 1 and rollups["acme"]["outcomes"] == {"done": 1}
    summed: dict = {}
    for counters in LEDGER.aggregate_counters_by_tenant().values():
        for k, v in counters.items():
            summed[k] = summed.get(k, 0) + v
    assert summed == LEDGER.aggregate_counters()


# --- the budget's per-tenant partition ----------------------------------------


def _partition(pkg) -> dict:
    reg, budget, tenants = PKGS[pkg]["reg"], PKGS[pkg]["budget"], PKGS[pkg]["tenant"].TENANTS
    stalls0 = reg.counter("serve.budget.tenant_stalls").value
    out = {}
    acct = budget(1000)
    hog = acct.stream("scan", query=1, tenant="hog")
    light = acct.stream("scan", query=2, tenant="light")
    out["hog"] = [hog.try_reserve(450), light.try_reserve(100), hog.try_reserve(200),
                  light.try_reserve(200), acct.held_bytes()]
    out["hog_state"] = acct.state()
    hog.close()
    light.close()
    out["hog_drained"] = acct.held_bytes()
    tenants.configure("vip", budget_fraction=0.9)
    tenants.configure("bulk", weight=100.0)
    acct = budget(1000)
    vip, bulk = acct.stream("scan", tenant="vip"), acct.stream("scan", tenant="bulk")
    out["fraction"] = [bulk.try_reserve(100), vip.try_reserve(500), vip.try_reserve(300),
                       vip.try_reserve(150)]
    vip.close()
    bulk.close()
    acct = budget(1000)
    s1, s2 = acct.stream("scan", tenant="only"), acct.stream("join", tenant="only")
    out["single"] = [s1.try_reserve(600), s2.try_reserve(300), s2.try_reserve(200)]
    s1.close()
    s2.close()
    acct = budget(100)
    a, b = acct.stream("scan", tenant="a"), acct.stream("scan", tenant="b")
    out["zero_holder"] = [a.try_reserve(100), b.try_reserve(60), acct.held_bytes(),
                          acct.check_consistency()]
    a.close()
    b.close()
    out["closed"] = (acct.held_bytes(), acct.state()["streams"])
    out["tenant_stalls"] = reg.counter("serve.budget.tenant_stalls").value - stalls0
    return out


def test_budget_partition_matches_the_jax_package():
    got = {pkg: _partition(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["hog"] == [True, True, False, True, 750]
    assert t["hog_state"]["tenants"] == {"hog": 450, "light": 300}
    assert t["hog_drained"] == 0
    assert t["fraction"] == [True, True, True, False]
    assert t["single"] == [True, True, False]
    assert t["zero_holder"] == [True, True, 160, True]
    assert t["closed"] == (0, [])
    assert t["tenant_stalls"] == 1


def test_surfaces_carry_tenants():
    from hyperspace_tpu_torch.analysis.explain import tenant_state_string
    from hyperspace_tpu_torch.telemetry import exporter

    ttenant.TENANTS.configure("gold", weight=4.0)
    sched = tserve.QueryScheduler(max_concurrent=2, queue_depth=8)
    try:
        sched.submit(lambda: 1, tenant="gold").result(30)
        sched.submit(lambda: 2).result(30)
        st = sched.state()["tenants"]
    finally:
        sched.shutdown()
    assert st["gold"]["weight"] == 4.0
    assert st["gold"]["done"] == 1 and st["default"]["done"] == 1
    assert st["gold"]["cost_s"] > 0 and 0 < st["gold"]["delivered_share"] < 1
    assert sorted(st["gold"]) == sorted(_jax_tenant_row_keys())
    s = tenant_state_string()
    assert "Tenants (weighted-fair QoS):" in s and "gold" in s
    assert "gold" in exporter.snapshot_dict()["tenants"]["rollups"]
    assert 'hyperspace_serve_tenant_queries{tenant="gold"}' in exporter.prometheus_text()


def _jax_tenant_row_keys() -> list:
    sched = jserve.QueryScheduler(max_concurrent=1, queue_depth=4)
    try:
        sched.submit(lambda: 1, tenant="gold").result(30)
        return list(sched.state()["tenants"]["gold"])
    finally:
        sched.shutdown()
