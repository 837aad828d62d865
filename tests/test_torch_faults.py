"""The fault and retry layer, the port against the JAX package.

- the ``HYPERSPACE_FAULTS`` grammar: the same rules from the same specs,
  the same FaultSpecError for the same malformed ones, the same firing
  pattern of a seeded probabilistic rule, the typed errors;
- the retry policy: the same backoff schedule and classifier, transient
  errors absorbed, permanent ones and exhaustion raised, counted;
- the IO points: ``io.read_file:ioerror:n=1`` and ``io.footer:ioerror:n=1``
  under an index query are absorbed by the retry in both packages with the
  same ``io.retry.*`` and ``faults.*`` counter deltas and the same result;
  with ``HYPERSPACE_IO_RETRIES=1`` the typed error surfaces;
- the device and compile points: the port has no breaker, so an injected
  device fault fails the query with its typed error (the JAX package
  absorbs it on the host), and the next, disarmed, run is right;
- the log and publish points: the crash matrix of create and refresh, in
  both packages from the same inputs, recovers to the same warehouse;
- the disarmed path adds no counter and no span event; ``BoundedLRU``;
  the ``HYPERSPACE_STALE_TX_S`` and ``HYPERSPACE_ACTION_RETRIES`` knobs.
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu.utils import faults as JF
from hyperspace_tpu.utils import retry as JR
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.telemetry import trace
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils import faults as TF
from hyperspace_tpu_torch.utils import retry as TR
from hyperspace_tpu_torch.utils.lru import BoundedLRU

PKGS = {
    "jax": {"mod": J, "C": JC, "X": JX, "reg": JREG, "faults": JF},
    "torch": {"mod": T, "C": TC, "X": TX, "reg": TREG, "faults": TF},
}
NAME = "cidx"
FAULT_COUNTERS = ("faults.injected", "faults.injected.io.read_file",
                  "faults.injected.io.footer", "io.retry.attempts", "io.retry.gave_up")


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both packages disarmed."""
    TF.disarm()
    JF.disarm()
    yield
    TF.disarm()
    JF.disarm()


def _val(pkg: str, name: str) -> int:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else int(m.value)


def _snap(pkg: str, names=FAULT_COUNTERS) -> dict:
    return {n: _val(pkg, n) for n in names}


def _deltas(pkg: str, before: dict) -> dict:
    return {n: _val(pkg, n) - v for n, v in before.items()}


# ---------------------------------------------------------------------------
# the spec grammar
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    "io.read_file:ioerror:n=3",
    "device.dispatch:oom:p=0.25,seed=9",
    "io.read_file:ioerror:always;log.write:crash_after:n=2",
    "device.*:ioerror:n=1",
    " ingest.append : crash_before : n=1 ; ",
    "ingest.*:crash_after:p=1",
    "data.publish:crash_before:n=1;kernel.compile:oom:always",
    "",
]
BAD_SPECS = [
    "nope.unknown:ioerror:n=1",
    "io.read_file:frob:n=1",
    "io.read_file:ioerror",
    "io.read_file:ioerror:n=1,p=0.5",
    "io.read_file:ioerror:n=0",
    "io.read_file:ioerror:p=1.5",
    "io.read_file:ioerror:k=2",
    "io.read_file:ioerror:n=x",
    "nope.*:ioerror:n=1",
    "io.read_file:ioerror:seed=3",
]


def _rules(f, spec: str) -> list:
    return [(r.point, r.kind, r.nth, r.p, r.always, r.seed) for r in f.parse_spec(spec)]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_good_specs_parse_as_the_reference(spec):
    assert _rules(TF, spec) == _rules(JF, spec)
    assert TF.POINTS == JF.POINTS and TF.KINDS == JF.KINDS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_fail_as_the_reference(spec):
    with pytest.raises(JF.FaultSpecError):
        JF.parse_spec(spec)
    with pytest.raises(TF.FaultSpecError) as e:
        TF.parse_spec(spec)
    assert isinstance(e.value, HyperspaceError)


def test_wildcard_matches():
    (r,) = TF.parse_spec("device.*:ioerror:n=1")
    assert r.matches("device.upload") and r.matches("device.fetch")
    assert not r.matches("io.read_file")


def _pattern(f, spec: str, hits: int = 60) -> list:
    f.arm(spec)
    out = []
    for _ in range(hits):
        try:
            f.fire("io.read_file")
            out.append(0)
        except f.InjectedIOError:
            out.append(1)
    snap = f.snapshot()
    f.disarm()
    return [out, snap]


@pytest.mark.parametrize("spec", ["io.read_file:ioerror:p=0.5,seed=1",
                                  "io.read_file:ioerror:p=0.3,seed=7",
                                  "io.read_file:ioerror:n=2", "io.read_file:ioerror:always"])
def test_firing_pattern_matches_the_reference(spec):
    got, want = _pattern(TF, spec), _pattern(JF, spec)
    assert got == want
    if spec.endswith("n=2"):
        assert got[0] == [0, 1] + [0] * 58


def test_typed_errors():
    assert issubclass(TF.InjectedIOError, IOError)
    assert issubclass(TF.InjectedIOError, HyperspaceError)
    assert issubclass(TF.InjectedOOMError, MemoryError)
    assert issubclass(TF.InjectedCrash, BaseException)
    assert not issubclass(TF.InjectedCrash, Exception)
    for kind, err in (("ioerror", TF.InjectedIOError), ("oom", TF.InjectedOOMError),
                      ("crash_before", TF.InjectedCrash)):
        TF.arm(f"log.write:{kind}:n=1")
        with pytest.raises(err, match=f"injected {kind} at log.write"):
            TF.fire("log.write", id=3)
        TF.disarm()


def test_crash_before_and_after_bracket_a_log_write(tmp_path):
    from hyperspace_tpu_torch.meta.entry import LogEntry
    from hyperspace_tpu_torch.meta.log_manager import IndexLogManager

    lm = IndexLogManager(str(tmp_path / "idx"))
    TF.arm("log.write:crash_before:n=1")
    with pytest.raises(TF.InjectedCrash):
        lm.write_log(0, LogEntry(state="ACTIVE"))
    assert lm.get_latest_id() is None and lm.stale_temp_files(0.0) == []
    TF.arm("log.write:crash_after:n=1")
    with pytest.raises(TF.InjectedCrash):
        lm.write_log(0, LogEntry(state="ACTIVE"))
    assert lm.get_latest_id() == 0  # the commit took effect first


def test_injection_is_counted_and_traced():
    before = _snap("torch", ("faults.injected", "faults.injected.io.footer"))
    TF.arm("io.footer:ioerror:n=1")
    with trace.capture() as cap:
        with trace.span("probe"):
            with pytest.raises(TF.InjectedIOError):
                TF.fire("io.footer", path="f.parquet")
    assert _deltas("torch", before) == {"faults.injected": 1, "faults.injected.io.footer": 1}
    (probe,) = [s for s in cap.sink.spans if s.name == "probe"]
    assert probe.attrs["events"] == [
        {"event": "fault:io.footer", "kind": "ioerror", "hit": 1, "path": "f.parquet"}]


def test_env_spec_arms_at_import():
    """HYPERSPACE_FAULTS arms the module when it is imported, as in the
    JAX package (a subprocess: the module is imported once per process)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from hyperspace_tpu_torch.utils import faults\n"
            "print(faults.armed(), faults.snapshot()[0]['trigger'])" % repo)
    env = {**os.environ, "HYPERSPACE_FAULTS": "device.fetch:oom:n=4"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout.split()
    assert out == ["True", "n=4"]


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------


def test_backoff_and_classifier_match_the_reference():
    for what in ("io.read_file", "io.footer", "x"):
        for attempt in range(1, 9):
            assert TR.backoff_delay(what, attempt) == JR.backoff_delay(what, attempt)
    errors = [OSError("x"), ConnectionError(), TimeoutError(), FileNotFoundError(),
              PermissionError(), IsADirectoryError(), NotADirectoryError(), ValueError(),
              MemoryError(), TF.InjectedIOError("x"), TF.InjectedOOMError("x"),
              HyperspaceError("x")]
    assert [TR.is_transient(e) for e in errors] == [JR.is_transient(e) for e in errors]


def _flaky(failures: int, err=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise err("transient")
        return "ok"

    return fn, calls


def test_retry_absorbs_a_transient_error():
    before = _snap("torch")
    slept = []
    fn, calls = _flaky(2)
    assert TR.retry_call(fn, "unit", attempts=3, clock=slept.append) == "ok"
    assert calls["n"] == 3
    assert slept == [TR.backoff_delay("unit", 1), TR.backoff_delay("unit", 2)]
    d = _deltas("torch", before)
    assert (d["io.retry.attempts"], d["io.retry.gave_up"]) == (2, 0)


def test_retry_raises_permanent_errors_at_once_and_exhaustion_counted():
    slept = []
    fn, calls = _flaky(5, ValueError)
    with pytest.raises(ValueError):
        TR.retry_call(fn, "unit", attempts=3, clock=slept.append)
    assert calls["n"] == 1 and slept == []
    before = _snap("torch")
    fn, calls = _flaky(5)
    with pytest.raises(OSError):
        TR.retry_call(fn, "unit", attempts=3, clock=slept.append)
    assert calls["n"] == 3
    d = _deltas("torch", before)
    assert (d["io.retry.attempts"], d["io.retry.gave_up"]) == (2, 1)


def test_retries_knob_is_read_at_every_call(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "1")
    fn, calls = _flaky(1)
    with pytest.raises(OSError):
        TR.retry_call(fn, "unit", clock=lambda s: None)
    assert calls["n"] == 1
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "4")
    fn, calls = _flaky(3)
    assert TR.retry_call(fn, "unit", clock=lambda s: None) == "ok"
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "junk")
    assert TR.retry_attempts() == JR.retry_attempts() == 3


# ---------------------------------------------------------------------------
# the IO points under a query, in both packages
# ---------------------------------------------------------------------------


def _lake(root) -> str:
    src = os.path.join(str(root), "src")
    os.makedirs(src, exist_ok=True)
    for part in range(3):
        r = np.random.default_rng(100 + part)
        pq.write_table(pa.table({"k": r.integers(0, 300, 4000), "v": r.integers(0, 1000, 4000),
                                 "w": r.uniform(0, 1, 4000)}),
                       os.path.join(src, f"p{part}.parquet"))
        os.utime(os.path.join(src, f"p{part}.parquet"), ns=(1_700_000_000 * 10**9,) * 2)
    return src


def _session(pkg: str, warehouse: str):
    mod, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
    conf = {C.INDEX_NUM_BUCKETS: 4}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


def _indexed(pkg: str, root):
    src = _lake(root)
    s = _session(pkg, str(root / "wh"))
    hs = PKGS[pkg]["mod"].Hyperspace(s)
    hs.create_index(s.read.parquet(src), PKGS[pkg]["mod"].CoveringIndexConfig(NAME, ["k"], ["v"]))
    s.enable_hyperspace()
    return s, src


def _lookup(pkg: str, s, src: str) -> dict:
    X = PKGS[pkg]["X"]
    df = s.read.parquet(src)
    out = df.filter(X.col("k") == 7).agg(X.Count(X.lit(1)).alias("n"),
                                         X.Sum(X.col("v")).alias("sv")).collect().to_pydict()
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in out.items()}


@pytest.mark.parametrize("point", ["io.read_file", "io.footer"])
def test_io_fault_absorbed_by_the_retry_as_in_the_reference(tmp_path, point):
    out = {}
    for pkg in PKGS:
        s, src = _indexed(pkg, tmp_path / pkg)
        clean = _lookup(pkg, s, src)
        s2, _src = _indexed(pkg, tmp_path / f"{pkg}_faulted")  # cold caches
        f = PKGS[pkg]["faults"]
        before = _snap(pkg)
        f.arm(f"{point}:ioerror:n=1")
        got = _lookup(pkg, s2, _src)
        fired = sum(r["fired"] for r in f.snapshot())
        f.disarm()
        out[pkg] = {"same": got == clean, "fired": fired, "counters": _deltas(pkg, before)}
    assert out["torch"] == out["jax"]
    assert out["torch"]["same"] and out["torch"]["fired"] == 1
    c = out["torch"]["counters"]
    assert c["faults.injected"] == c[f"faults.injected.{point}"] == 1
    assert (c["io.retry.attempts"], c["io.retry.gave_up"]) == (1, 0)


def test_read_fault_surfaces_typed_without_retries(tmp_path, monkeypatch):
    """With HYPERSPACE_IO_RETRIES=1 the injected read error is not
    absorbed: the port's query fails with it (or a typed error whose cause
    chain holds it)."""
    monkeypatch.setenv("HYPERSPACE_IO_RETRIES", "1")
    s, src = _indexed("torch", tmp_path)
    TF.arm("io.read_file:ioerror:n=1")
    with pytest.raises(HyperspaceError) as e:
        _lookup("torch", s, src)
    TF.disarm()
    chain, err = [], e.value
    while err is not None:
        chain.append(type(err))
        err = err.__cause__ or err.__context__
    assert TF.InjectedIOError in chain


@pytest.mark.parametrize("spec,err", [
    ("device.dispatch:ioerror:n=1", TF.InjectedIOError),
    ("device.upload:ioerror:n=1", TF.InjectedIOError),
    ("device.fetch:oom:n=1", TF.InjectedOOMError),
    ("kernel.compile:oom:n=1", TF.InjectedOOMError),
])
def test_device_faults_raise_in_the_port(tmp_path, spec, err):
    """No breaker absorbs an injected device fault: the query raises its
    typed error; disarmed, the same query is right. (The JAX package's
    ``kernel.compile`` hook raises TypeError instead: its context key
    ``kind`` collides with the span event's; the port's says ``kernel``.)"""
    s, src = _indexed("torch", tmp_path)
    TF.arm(spec)
    with pytest.raises(err):
        _lookup("torch", s, src)
    fired = sum(r["fired"] for r in TF.snapshot())
    TF.disarm()
    assert fired == 1
    s.disable_hyperspace()
    raw = _lookup("torch", s, src)
    s.enable_hyperspace()
    assert _lookup("torch", s, src) == raw


def test_disarmed_path_adds_no_counters_or_events(tmp_path):
    s, src = _indexed("torch", tmp_path)
    names = ["faults.injected"] + [f"faults.injected.{p}" for p in TF.POINTS] + [
        "io.retry.attempts", "io.retry.gave_up"]
    before = _snap("torch", names)
    with trace.capture() as cap:
        _lookup("torch", s, src)
    assert _deltas("torch", before) == dict.fromkeys(names, 0)
    events = [e["event"] for sp in cap.sink.spans for e in sp.attrs.get("events", [])]
    assert not [n for n in events if n.startswith(("fault:", "retry:"))]


# ---------------------------------------------------------------------------
# the log and publish points: the crash matrix, in both packages
# ---------------------------------------------------------------------------


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("timestamp", "modifiedTime")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _capture(warehouse: str) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(warehouse):
        for fn in names:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                raw = f.read()
            rel = os.path.relpath(p, warehouse)
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


CRASH_MATRIX = [(action, spec) for action in ("create", "refresh")
                for spec in ("log.write:crash_before:n=1", "log.write:crash_after:n=1",
                             "log.write:crash_before:n=2", "log.write:crash_after:n=2",
                             "data.publish:crash_before:n=1", "data.publish:crash_after:n=1")]


def _act(pkg, warehouse, src, action):
    s = _session(pkg, warehouse)
    hs = PKGS[pkg]["mod"].Hyperspace(s)
    if action == "create":
        hs.create_index(s.read.parquet(src),
                        PKGS[pkg]["mod"].CoveringIndexConfig(NAME, ["k"], ["v"]))
    else:
        hs.refresh_index(NAME, "full")


@pytest.mark.parametrize("action,spec", CRASH_MATRIX, ids=[f"{a}-{s}" for a, s in CRASH_MATRIX])
def test_crash_matrix_recovers_as_the_reference(tmp_path, monkeypatch, action, spec):
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "1")
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    os.makedirs(warehouse)
    if action == "refresh":
        _act("jax", warehouse, src, "create")
        r = np.random.default_rng(9)
        pq.write_table(pa.table({"k": r.integers(0, 300, 500), "v": r.integers(0, 1000, 500),
                                 "w": r.uniform(0, 1, 500)}), os.path.join(src, "p9.parquet"))
        os.utime(os.path.join(src, "p9.parquet"), ns=(1_700_000_000 * 10**9,) * 2)
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)
    out = {}
    for pkg in PKGS:
        shutil.rmtree(warehouse)
        shutil.copytree(snapshot, warehouse)
        f = PKGS[pkg]["faults"]
        f.arm(spec)
        try:
            _act(pkg, warehouse, src, action)
            crashed = False
        except f.InjectedCrash:
            crashed = True
        finally:
            f.disarm()
        s = _session(pkg, warehouse)
        hs = PKGS[pkg]["mod"].Hyperspace(s)
        report = hs.recover(force=True)
        recovered = _capture(warehouse)
        try:
            _act(pkg, warehouse, src, action)
        except Exception as e:  # the crash landed after the final commit
            assert "HyperspaceError" in type(e).__name__ or isinstance(e, HyperspaceError)
        s.enable_hyperspace()
        out[pkg] = {"crashed": crashed, "repaired": report["repaired"],
                    "per_index": report["per_index"], "recovered": recovered,
                    "converged": _capture(warehouse), "result": _lookup(pkg, s, src),
                    "again": hs.recover(force=True)["repaired"]}
    for key in ("crashed", "repaired", "per_index", "result", "again"):
        assert out["torch"][key] == out["jax"][key], key
    for key in ("recovered", "converged"):
        assert sorted(out["torch"][key]) == sorted(out["jax"][key]), key
        for k in out["jax"][key]:
            assert out["torch"][key][k] == out["jax"][key][k], (key, k)
    assert out["torch"]["crashed"] and not out["torch"]["again"]


def test_stale_transaction_age_knob_is_read_at_every_pass(tmp_path, monkeypatch):
    """``HYPERSPACE_STALE_TX_S`` gates recovery's roll-back of another
    process's transient entry, as in the JAX package; the port read a
    constant before and ignored the knob."""
    s, src = _indexed("torch", tmp_path)
    TF.arm("log.write:crash_after:n=1")  # the transient entry commits, then "dies"
    with pytest.raises(TF.InjectedCrash):
        T.Hyperspace(s).delete_index(NAME)
    TF.disarm()
    hs = T.Hyperspace(_session("torch", str(tmp_path / "wh")))
    monkeypatch.setenv("HYPERSPACE_STALE_TX_S", "3600")
    assert hs.recover()["per_index"][NAME]["skipped"] == "fresh-transient:DELETING"
    monkeypatch.setenv("HYPERSPACE_STALE_TX_S", "0")
    report = hs.recover()
    assert report["per_index"][NAME]["rolled_back"] == "DELETING"
    assert hs.get_index(NAME).state == "ACTIVE"


# ---------------------------------------------------------------------------
# BoundedLRU
# ---------------------------------------------------------------------------


def test_bounded_lru_recency_and_bound():
    lru = BoundedLRU(2)
    lru.set("a", 1)
    lru.set("b", 2)
    assert lru.get("a") == 1  # a is now the most recent
    lru.set("c", 3)
    assert "b" not in lru and lru.get("a") == 1 and lru.get("c") == 3
    assert len(lru) == 2 and lru.pop("a") == 1 and lru.get("a", "gone") == "gone"


def test_entry_tags_are_a_bounded_lru():
    from hyperspace_tpu_torch.meta.entry import IndexLogEntry

    assert IndexLogEntry._MAX_TAGS == 65536
    e = IndexLogEntry.__new__(IndexLogEntry)
    e._tags = BoundedLRU(2)
    e.set_tag(1, "a", "x")
    e.set_tag(2, "a", "y")
    assert e.get_tag(1, "a") == "x"  # touched on get
    e.set_tag(3, "a", "z")
    assert e.get_tag(2, "a") is None and e.get_tag(1, "a") == "x"


@pytest.mark.parametrize("retries", ["1", "2", "4"])
def test_action_retries_knob_matches_the_reference(tmp_path, monkeypatch, retries):
    """``HYPERSPACE_ACTION_RETRIES`` bounds the attempts of an action that
    keeps losing the optimistic-concurrency race, read at every run (the
    port read a constant before and ignored the knob): the same
    ``action.retry.*`` deltas and the same error in both packages."""
    monkeypatch.setenv("HYPERSPACE_ACTION_RETRIES", retries)
    out = {}
    for pkg in PKGS:
        if pkg == "torch":
            from hyperspace_tpu_torch.actions.lifecycle import DeleteAction
            from hyperspace_tpu_torch.meta.log_manager import IndexLogManager
        else:
            from hyperspace_tpu.actions.lifecycle import DeleteAction
            from hyperspace_tpu.meta.log_manager import IndexLogManager
        _indexed(pkg, tmp_path / pkg)
        lm = IndexLogManager(str(tmp_path / pkg / "wh" / "indexes" / NAME))
        monkeypatch.setattr(lm, "write_log", lambda log_id, entry: False)
        names = ("action.retry.attempts", "action.retry.gave_up")
        before = _snap(pkg, names)
        with pytest.raises(Exception) as e:
            DeleteAction(lm).run()
        out[pkg] = (type(e.value).__name__, _deltas(pkg, before))
    assert out["torch"] == out["jax"]
    assert out["torch"] == ("ConcurrentWriteError",
                            {"action.retry.attempts": int(retries) - 1,
                             "action.retry.gave_up": 1})
