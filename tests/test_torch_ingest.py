"""The ingest plane, the port against the JAX package on the same inputs.

A small lake (one parquet file of 1200 rows and appended batches, numpy
seed per batch, one fixed mtime) and a covering index of 4 buckets:

- appends: the same append sequence, run by each package from the same
  snapshot of an index either package built, writes the same index files
  byte for byte and the same log entries (less the wall-clock fields
  ``timestamp`` and ``modifiedTime``, as tests/test_torch_lifecycle.py
  compares them); each package then reads the other's result;
- compaction and vacuum under pins and under the grace period (the JAX
  package's tests/test_ingest.py cases), each run in both packages with
  the same observations and ``ingest.*`` counter deltas;
- the crash cells of the ``ingest.append`` and ``ingest.compact`` fault
  points, ``crash_before`` and ``crash_after``: after ``recover()`` both
  packages hold the same warehouse, and after the operation runs again
  the same one as a twin that never crashed;
- the append counters, and the disarmed fault points (no counter moves).

The cancellation of a pinned query through the scheduler
(tests/test_ingest.py ``test_cancelled_query_releases_its_pin``) waits for
the port's ``serve/`` and is not written here.
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
from hyperspace_tpu import ingest as JI
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu.utils import faults as JF
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import ingest as TI
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils import faults as TF

PKGS = {
    "jax": {"mod": J, "C": JC, "X": JX, "ingest": JI, "reg": JREG, "faults": JF},
    "torch": {"mod": T, "C": TC, "X": TX, "ingest": TI, "reg": TREG, "faults": TF},
}
ROWS = 1200
NAME = "ev"
MTIME_NS = 1_700_000_000 * 10**9  # one fixed mtime: signatures hash it


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger of 256
    entries; the module empties it when it is done, so that later files of
    the worker find room in it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture(autouse=True)
def _no_background_refresh(monkeypatch):
    """Result caching is off in this module, so no refresh wave runs; the
    knob is pinned off whatever the environment says."""
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "0")


def _batch(seed: int, n: int = ROWS) -> dict:
    r = np.random.default_rng(seed)
    return {
        "k": r.integers(0, 40, n),
        "v": r.integers(0, 1000, n),
        "w": r.integers(0, 50, n),
    }


def _write(path: str, seed: int, n: int = ROWS) -> str:
    pq.write_table(pa.table(_batch(seed, n)), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))
    return path


def _lake(root) -> str:
    src = os.path.join(str(root), "events")
    os.makedirs(src, exist_ok=True)
    _write(os.path.join(src, "part0.parquet"), 0)
    return src


def _session(pkg: str, warehouse: str, lineage: bool = False):
    p = PKGS[pkg]
    conf = {p["C"].INDEX_NUM_BUCKETS: 4, p["C"].INDEX_LINEAGE_ENABLED: lineage}
    if pkg == "torch":
        return p["mod"].HyperspaceSession(warehouse, conf=conf, device="cpu")
    return p["mod"].HyperspaceSession(warehouse, conf=conf)


def _create(pkg: str, warehouse: str, src: str, lineage: bool = False):
    s = _session(pkg, warehouse, lineage)
    hs = PKGS[pkg]["mod"].Hyperspace(s)
    hs.create_index(s.read.parquet(src),
                    PKGS[pkg]["mod"].CoveringIndexConfig(NAME, ["k"], ["v", "w"]))
    s.enable_hyperspace()
    return s, hs


def _open(pkg: str, warehouse: str, lineage: bool = False):
    s = _session(pkg, warehouse, lineage)
    s.enable_hyperspace()
    return s, PKGS[pkg]["mod"].Hyperspace(s)


def _plain(d: dict) -> dict:
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in d.items()}


def _df(pkg: str, session, src: str):
    """An order-insensitive query of integer aggregates (sorted groups)."""
    X = PKGS[pkg]["X"]
    df = session.read.parquet(src)
    return df.filter(X.col("k") < 30).group_by("k").agg(
        X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"),
        X.Min(X.col("w")).alias("mn"), X.Max(X.col("w")).alias("mx"),
    ).sort("k")


def _q(pkg: str, session, src: str) -> dict:
    return _plain(_df(pkg, session, src).collect().to_pydict())


def _raw(pkg: str, session, src: str) -> dict:
    session.disable_hyperspace()
    try:
        return _q(pkg, session, src)
    finally:
        session.enable_hyperspace()


def _used(pkg: str, session, src: str) -> set:
    plan = _df(pkg, session, src).optimized_plan()
    return {n.index_info.index_name for n in plan.preorder()
            if getattr(n, "index_info", None) is not None}


def _index_path(warehouse: str) -> str:
    return os.path.join(warehouse, "indexes", NAME)


def _strip(x):
    """A log entry less its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("timestamp", "modifiedTime")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _capture(warehouse: str) -> dict:
    """Every file under the warehouse: data files as bytes, log entries and
    the latestStable pointer as JSON less the wall-clock fields."""
    out = {}
    for dirpath, _dirs, names in os.walk(warehouse):
        for fn in names:
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, warehouse)
            with open(p, "rb") as f:
                raw = f.read()
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in sorted(a):
        assert a[k] == b[k], k


def _val(pkg: str, name: str) -> int:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else int(m.value)


def _deltas(pkg: str, names, before: dict) -> dict:
    return {n: _val(pkg, n) - before[n] for n in names}


INGEST_COUNTERS = ("ingest.appends", "ingest.rows_appended", "ingest.files_appended",
                   "ingest.compact.runs", "ingest.compact.buckets",
                   "ingest.compact.files_in", "ingest.vacuum.deferred",
                   "ingest.vacuum.versions_removed", "faults.injected")


# ---------------------------------------------------------------------------
# appends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lineage", [False, True], ids=["no_lineage", "lineage"])
@pytest.mark.parametrize("creator", ["jax", "torch"])
def test_append_sequence_matches_across_packages(tmp_path, creator, lineage):
    """Three appends, one file each, from the same snapshot: the same
    index files and log entries, the same ingest counters, the delta runs
    in versions 1-3, and each package reads the other's index."""
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create(creator, warehouse, src, lineage)
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)
    appended = [_write(os.path.join(src, f"p{i}.parquet"), i) for i in (1, 2, 3)]

    captured, counters = {}, {}
    for pkg in ("jax", "torch"):
        shutil.rmtree(warehouse)
        shutil.copytree(snapshot, warehouse)
        s, hs = _open(pkg, warehouse, lineage)
        before = {n: _val(pkg, n) for n in INGEST_COUNTERS}
        for p in appended:
            hs.append(NAME, s.read.parquet(p))
        counters[pkg] = _deltas(pkg, INGEST_COUNTERS, before)
        entry = hs.get_index(NAME)
        assert entry.index_version_dirs() == ["v__=0", "v__=1", "v__=2", "v__=3"]
        assert max(PKGS[pkg]["ingest"].runs_per_bucket(entry).values()) == 4
        captured[pkg] = _capture(warehouse)
    _assert_same(captured["jax"], captured["torch"])
    assert counters["torch"] == counters["jax"]
    assert counters["torch"]["ingest.appends"] == 3
    assert counters["torch"]["ingest.rows_appended"] == 3 * ROWS

    # the warehouse holds the port's result: both packages read it and
    # exact-match the grown source through the index
    want = None
    for pkg in ("jax", "torch"):
        s, _hs = _open(pkg, warehouse, lineage)
        assert _used(pkg, s, src) == {NAME}
        got = _q(pkg, s, src)
        want = want or _raw(pkg, s, src)
        assert got == want


def test_append_batch_matches_across_packages(tmp_path):
    """``append_batch`` writes the batch as a new source file under the
    index's root and appends it: the same file name scheme, the same rows
    and the same index data in both packages."""
    out = {}
    for pkg in ("jax", "torch"):
        src = _lake(tmp_path / pkg)
        warehouse = str(tmp_path / pkg / "wh")
        s, hs = _create(pkg, warehouse, src)
        data = {k: v.tolist() for k, v in _batch(5).items()}
        path = PKGS[pkg]["ingest"].append_batch(s, NAME, data, filename="late.parquet")
        entry = hs.get_index(NAME)
        files = sorted(f.name for f in entry.index_data_files())
        out[pkg] = {
            "path": os.path.relpath(path, src),
            "rows": pq.read_table(path).to_pydict(),
            "dirs": entry.index_version_dirs(),
            "data": [pq.read_table(f).to_pydict() for f in files],
            "names": [os.path.relpath(f, warehouse) for f in files],
            "result": _q(pkg, s, src),
            "raw": _raw(pkg, s, src),
        }
        assert out[pkg]["result"] == out[pkg]["raw"]
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("case", ["no_new_files", "bad_columns", "quick_refresh_pending",
                                  "zorder"])
def test_append_refusals_match(tmp_path, case):
    """The same no-op or the same exception class in both packages."""
    outcomes = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        src = _lake(root)
        warehouse = str(root / "wh")
        mod = PKGS[pkg]["mod"]
        if case == "zorder":
            s = _session(pkg, warehouse)
            hs = mod.Hyperspace(s)
            hs.create_index(s.read.parquet(src),
                            mod.ZOrderCoveringIndexConfig(NAME, ["k"], ["v"]))
        else:
            s, hs = _create(pkg, warehouse, src, lineage=case == "quick_refresh_pending")
        before = max(hs.get_index_versions(NAME))
        try:
            if case == "no_new_files":
                hs.append(NAME, s.read.parquet(src))
            elif case == "bad_columns":
                bad = os.path.join(str(root), "bad")
                os.makedirs(bad)
                pq.write_table(pa.table({"x": [1, 2, 3]}), os.path.join(bad, "b.parquet"))
                hs.append(NAME, s.read.parquet(bad))
            elif case == "quick_refresh_pending":
                _write(os.path.join(src, "late.parquet"), 9)
                hs.refresh_index(NAME, "quick")
                before = max(hs.get_index_versions(NAME))
                later = _write(os.path.join(src, "later.parquet"), 10)
                hs.append(NAME, s.read.parquet(later))
            else:
                hs.append(NAME, s.read.parquet(_write(os.path.join(src, "p1.parquet"), 1)))
            outcomes[pkg] = ("ok", max(hs.get_index_versions(NAME)) - before)
        except Exception as e:  # the class name is what the packages share
            outcomes[pkg] = ("raised", type(e).__name__,
                             max(hs.get_index_versions(NAME)) - before)
    assert outcomes["torch"] == outcomes["jax"]
    if case == "no_new_files":
        assert outcomes["torch"] == ("ok", 0)
    else:
        assert outcomes["torch"][0] == "raised"


def test_appended_entry_signature_matches_the_query_leaf(tmp_path):
    """The entry's fingerprint over the extended file set is what signing
    the query-time leaf over the grown source gives, so queries
    exact-match the appended entry (no hybrid scan)."""
    from hyperspace_tpu_torch.meta.signatures import get_provider
    from hyperspace_tpu_torch.models.covering import _single_file_scan
    from hyperspace_tpu_torch.rules.collector import _LeafPlan

    src = _lake(tmp_path)
    s, hs = _create("torch", str(tmp_path / "wh"), src)
    TI.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(2).items()})
    sig = hs.get_index(NAME).signature.signatures[0]
    leaf = _single_file_scan(s.read.parquet(src))
    assert get_provider(sig.provider).sign(_LeafPlan(leaf)) == sig.value


# ---------------------------------------------------------------------------
# compaction and vacuum, under pins and under grace
# ---------------------------------------------------------------------------


def _versions(warehouse: str) -> list:
    d = _index_path(warehouse)
    return sorted(int(n.split("=")[1]) for n in os.listdir(d) if n.startswith("v__="))


def _compact_and_vacuum(pkg, tmp_path, monkeypatch):
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create(pkg, warehouse, src)
    ing = PKGS[pkg]["ingest"]
    obs = {}
    for i in (1, 2, 3):
        ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(i).items()},
                         filename=f"p{i}.parquet")
    ref = _raw(pkg, s, src)
    hs.compact_index(NAME, min_runs=2)
    entry = hs.get_index(NAME)
    obs["runs_after_compact"] = ing.runs_per_bucket(entry)
    obs["dirs_after_compact"] = entry.index_version_dirs()
    obs["sorted"] = all(
        bool((np.diff(pq.read_table(f.name).column("k").to_numpy()) >= 0).all())
        for f in entry.index_data_files())
    obs["same_result"] = _q(pkg, s, src) == ref
    monkeypatch.setenv("HYPERSPACE_VACUUM_GRACE_S", "3600")
    hs.vacuum_outdated_index(NAME)
    obs["after_grace_vacuum"] = _versions(warehouse)
    monkeypatch.setenv("HYPERSPACE_VACUUM_GRACE_S", "0")
    hs.vacuum_outdated_index(NAME)
    obs["after_vacuum"] = _versions(warehouse)
    obs["result_after"] = _q(pkg, s, src) == ref
    return obs


def test_compaction_and_grace_vacuum_match(tmp_path, monkeypatch):
    before = {pkg: {n: _val(pkg, n) for n in INGEST_COUNTERS} for pkg in PKGS}
    obs = {pkg: _compact_and_vacuum(pkg, tmp_path / pkg, monkeypatch) for pkg in PKGS}
    assert obs["torch"] == obs["jax"]
    assert obs["torch"]["runs_after_compact"] == {0: 1, 1: 1, 2: 1, 3: 1}
    assert obs["torch"]["dirs_after_compact"] == ["v__=4"]
    assert obs["torch"]["after_grace_vacuum"] == [0, 1, 2, 3, 4]
    assert obs["torch"]["after_vacuum"] == [4]
    assert obs["torch"]["sorted"] and obs["torch"]["result_after"]
    deltas = {pkg: _deltas(pkg, INGEST_COUNTERS, before[pkg]) for pkg in PKGS}
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"]["ingest.vacuum.deferred"] == 4
    assert deltas["torch"]["ingest.vacuum.versions_removed"] == 4


def _pinned_scenario(pkg, tmp_path):
    """A registry pin on version 0-1 survives an append, a compaction and
    a vacuum; release lets the next vacuum retire them."""
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create(pkg, warehouse, src)
    ing = PKGS[pkg]["ingest"]
    ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(1).items()},
                     filename="p1.parquet")
    snap = ing.REGISTRY.pin(_index_path(warehouse), hs.get_index(NAME))
    ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(2).items()},
                     filename="p2.parquet")
    hs.compact_index(NAME, min_runs=2)
    hs.vacuum_outdated_index(NAME)
    obs = {"pinned": sorted(snap.versions), "kept": _versions(warehouse),
           "files_exist": all(os.path.exists(f) for f in snap.files)}
    ing.REGISTRY.release(snap)
    hs.vacuum_outdated_index(NAME)
    obs["after_release"] = _versions(warehouse)
    obs["active_pins"] = ing.REGISTRY.active_pins()
    return obs


def test_pinned_version_survives_compaction_and_vacuum(tmp_path):
    before = {pkg: {n: _val(pkg, n) for n in INGEST_COUNTERS} for pkg in PKGS}
    obs = {pkg: _pinned_scenario(pkg, tmp_path / pkg) for pkg in PKGS}
    assert obs["torch"] == obs["jax"]
    assert obs["torch"]["pinned"] == [0, 1] and obs["torch"]["files_exist"]
    assert obs["torch"]["kept"] == [0, 1, 3]
    assert obs["torch"]["after_release"] == [3]
    deltas = {pkg: _deltas(pkg, INGEST_COUNTERS, before[pkg]) for pkg in PKGS}
    assert deltas["torch"] == deltas["jax"]


def _planned_before_append(pkg, tmp_path):
    """A plan resolved (and pinned) before an append, a compaction and a
    vacuum still runs against its pinned files and returns the old
    answer."""
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create(pkg, warehouse, src)
    ing = PKGS[pkg]["ingest"]
    if pkg == "torch":
        from hyperspace_tpu_torch.plan.executor import execute_plan
    else:
        from hyperspace_tpu.plan.executor import execute_plan
    ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(1).items()},
                     filename="p1.parquet")
    old = _q(pkg, s, src)
    shaped = _df(pkg, s, src)
    with ing.observe_pins() as seen, ing.pin_scope():
        plan = shaped.optimized_plan()
        ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(2).items()},
                         filename="p2.parquet")
        hs.compact_index(NAME, min_runs=2)
        hs.vacuum_outdated_index(NAME)
        kept = _versions(warehouse)
        got = _plain(execute_plan(plan, s).to_pydict())
    obs = {"same_as_old": got == old, "kept": kept,
           "pins": [(p.index_name, tuple(sorted(p.versions))) for p in seen.pins],
           "active_after": ing.REGISTRY.active_pins()}
    hs.vacuum_outdated_index(NAME)
    obs["after"] = _versions(warehouse)
    obs["new_result"] = _q(pkg, s, src) == _raw(pkg, s, src)
    return obs


def test_query_planned_before_append_reads_its_snapshot(tmp_path):
    obs = {pkg: _planned_before_append(pkg, tmp_path / pkg) for pkg in PKGS}
    assert obs["torch"] == obs["jax"]
    assert obs["torch"]["same_as_old"] and obs["torch"]["new_result"]
    assert set(obs["torch"]["pins"]) == {(NAME, (0, 1))}
    assert obs["torch"]["kept"] == [0, 1, 3] and obs["torch"]["after"] == [3]
    assert obs["torch"]["active_after"] == 0


def test_collect_pins_and_releases(tmp_path):
    """collect() pins the index it reads for the query's life and releases
    the pins on exit, and on an exception inside a scope."""
    pins = {}
    for pkg in PKGS:
        src = _lake(tmp_path / pkg)
        s, hs = _create(pkg, str(tmp_path / pkg / "wh"), src)
        with PKGS[pkg]["ingest"].observe_pins() as seen:
            _q(pkg, s, src)
        pins[pkg] = [(p.index_name, sorted(p.versions)) for p in seen.pins]
        assert PKGS[pkg]["ingest"].REGISTRY.active_pins() == 0
    # the rewrite resolves the index scan as often in both packages
    assert pins["torch"] == pins["jax"]
    assert set(map(str, pins["torch"])) == {str((NAME, [0]))}
    with pytest.raises(RuntimeError):
        with TI.pin_scope():
            TI.pin_current(s, hs.get_index(NAME))
            assert TI.REGISTRY.active_pins() > 0
            raise RuntimeError("query died")
    assert TI.REGISTRY.active_pins() == 0
    # outside a scope (explain, whyNot) nothing is pinned
    assert TI.pin_current(s, hs.get_index(NAME)) is None


def _recover_spares_pinned(pkg, tmp_path):
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create(pkg, warehouse, src)
    ing = PKGS[pkg]["ingest"]
    ing.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(1).items()},
                     filename="p1.parquet")
    ip = _index_path(warehouse)
    snap = ing.REGISTRY.pin(ip, hs.get_index(NAME))
    hs.compact_index(NAME, min_runs=2)
    latest_id = hs.get_index(NAME).id
    log_dir = os.path.join(ip, "_hyperspace_log")
    for n in os.listdir(log_dir):
        if n.isdigit() and int(n) < latest_id:
            os.unlink(os.path.join(log_dir, n))
    hs.recover(force=True)
    obs = {"kept": _versions(warehouse)}
    ing.REGISTRY.release(snap)
    report = hs.recover(force=True)
    obs["removed"] = sorted(report["per_index"][NAME]["orphan_versions"])
    return obs


def test_recover_never_deletes_a_pinned_version(tmp_path):
    obs = {pkg: _recover_spares_pinned(pkg, tmp_path / pkg) for pkg in PKGS}
    assert obs["torch"] == obs["jax"] == {"kept": [0, 1, 2], "removed": [0, 1]}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sweeps_spare_protected_and_pinned_versions(tmp_path, pkg):
    """clear_staging spares a protected staged build; orphan_version_dirs
    spares protected and pinned versions (the same answers in both
    packages, parametrized)."""
    if pkg == "torch":
        from hyperspace_tpu_torch.meta.data_manager import IndexDataManager
    else:
        from hyperspace_tpu.meta.data_manager import IndexDataManager
    ing = PKGS[pkg]["ingest"]
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create(pkg, warehouse, src)
    ip = _index_path(warehouse)
    dm = IndexDataManager(ip)
    dm.stage_version(7)
    dm.stage_version(8)
    with ing.protected_version(ip, 7):
        assert dm.clear_staging() == 1
        assert dm.staged_versions() == [7]
    assert dm.clear_staging() == 1
    assert dm.staged_versions() == []
    os.makedirs(dm.version_path(5))
    os.makedirs(dm.version_path(6))
    with ing.protected_version(ip, 5):
        orphans = dm.orphan_version_dirs({0})
        assert 5 not in orphans and 6 in orphans
    ing.REGISTRY.protect_version(ip, 6)
    try:
        assert 6 not in dm.orphan_version_dirs({0})
    finally:
        ing.REGISTRY.unprotect_version(ip, 6)
    assert dm.orphan_version_dirs({0}) == [5, 6]


def test_background_compaction_past_the_threshold(tmp_path, monkeypatch):
    """HYPERSPACE_COMPACT_RUNS=3: the third append schedules a compaction
    on the shared IO pool, which runs, vacuums and leaves every bucket
    under the threshold (counted as in the JAX package)."""
    import time

    monkeypatch.setenv("HYPERSPACE_COMPACT_RUNS", "3")
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create("torch", warehouse, src)
    runs0, sched0 = _val("torch", "ingest.compact.runs"), _val("torch", "ingest.compact.scheduled")
    for i in (1, 2, 3):
        TI.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(i).items()},
                        filename=f"p{i}.parquet")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not (
            TI.maintenance_idle() and _val("torch", "ingest.compact.runs") > runs0):
        time.sleep(0.05)
    assert TI.maintenance_idle()
    assert _val("torch", "ingest.compact.runs") > runs0
    assert _val("torch", "ingest.compact.scheduled") > sched0
    assert max(TI.runs_per_bucket(hs.get_index(NAME)).values()) < 3
    assert _q("torch", s, src) == _raw("torch", s, src)


# ---------------------------------------------------------------------------
# crash cells at the ingest fault points
# ---------------------------------------------------------------------------


CRASH_SPECS = [
    "ingest.append:crash_before:n=1",
    "ingest.append:crash_after:n=1",
    "ingest.compact:crash_before:n=1",
    "ingest.compact:crash_after:n=1",
]


def _debris(pkg: str, ip: str) -> list:
    if pkg == "torch":
        from hyperspace_tpu_torch.index_manager import IndexCollectionManager
        from hyperspace_tpu_torch.meta.data_manager import IndexDataManager
        from hyperspace_tpu_torch.meta.log_manager import STABLE_STATES, IndexLogManager
    else:
        from hyperspace_tpu.index_manager import IndexCollectionManager
        from hyperspace_tpu.meta.data_manager import IndexDataManager
        from hyperspace_tpu.meta.log_manager import STABLE_STATES, IndexLogManager
    lm, dm = IndexLogManager(ip), IndexDataManager(ip)
    bad = []
    latest = lm.get_latest_log()
    if latest is not None and latest.state not in STABLE_STATES:
        bad.append(f"unstable:{latest.state}")
    if dm.staged_versions():
        bad.append(f"staging:{dm.staged_versions()}")
    refs = IndexCollectionManager._referenced_versions(lm)
    orphans = [v for v in dm.get_all_versions() if v not in refs]
    if orphans:
        bad.append(f"orphans:{orphans}")
    return bad


def _crash_cell(pkg, warehouse, spec, snapshot, src, p1):
    shutil.rmtree(warehouse)
    shutil.copytree(snapshot, warehouse)
    s, hs = _open(pkg, warehouse)
    f = PKGS[pkg]["faults"]
    point = spec.split(":")[0]
    before = {n: _val(pkg, n) for n in INGEST_COUNTERS}
    injected0 = _val(pkg, f"faults.injected.{point}")
    f.arm(spec)
    crashed = False
    try:
        if point == "ingest.compact":
            hs.compact_index(NAME, min_runs=2)
        else:
            hs.append(NAME, s.read.parquet(p1))
    except f.InjectedCrash:
        crashed = True
    finally:
        f.disarm()
    out = {"crashed": crashed, "injected": _val(pkg, f"faults.injected.{point}") - injected0}
    # a restarted process: a new session, a forced recovery
    s2, h2 = _open(pkg, warehouse)
    report = h2.recover(force=True)
    out["report"] = report["per_index"].get(NAME, {})
    out["debris"] = _debris(pkg, _index_path(warehouse))
    out["recovered"] = _capture(warehouse)
    if point == "ingest.compact":
        h2.compact_index(NAME, min_runs=2)
    else:
        h2.append(NAME, s2.read.parquet(p1))
    out["converged"] = _capture(warehouse)
    out["result"] = _q(pkg, s2, src)
    out["counters"] = _deltas(pkg, INGEST_COUNTERS, before)
    return out


@pytest.mark.parametrize("spec", CRASH_SPECS)
def test_crash_at_ingest_fault_points_recovers_as_the_reference(tmp_path, monkeypatch, spec):
    """Both packages crash at the point from the same snapshot, recover to
    the same warehouse (stable, no staging, no orphan), and converge on
    running the operation again to the same warehouse as a twin that never
    crashed. HYPERSPACE_IO_THREADS=1 in both packages for every cell (the
    JAX package's thread race of a crash_after:n=1 cell, ROADMAP Queue 3)."""
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "1")
    src = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s, hs = _create("jax", warehouse, src)
    p1 = _write(os.path.join(src, "p1.parquet"), 1)
    if spec.startswith("ingest.compact"):
        hs.append(NAME, s.read.parquet(p1))
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)
    # the twin: the operation run once, uninterrupted
    ts, th = _open("jax", warehouse)
    if spec.startswith("ingest.compact"):
        th.compact_index(NAME, min_runs=2)
    else:
        th.append(NAME, ts.read.parquet(p1))
    twin = _capture(warehouse)
    twin_result = _q("jax", ts, src)
    out = {pkg: _crash_cell(pkg, warehouse, spec, snapshot, src, p1) for pkg in PKGS}
    for key in ("crashed", "injected", "report", "debris", "counters", "result"):
        assert out["torch"][key] == out["jax"][key], key
    _assert_same(out["jax"]["recovered"], out["torch"]["recovered"])
    _assert_same(out["jax"]["converged"], out["torch"]["converged"])
    assert out["torch"]["crashed"] and out["torch"]["injected"] == 1
    assert out["torch"]["debris"] == []
    assert out["torch"]["result"] == twin_result
    # the converged index holds the twin's data files (its log holds the
    # crashed transaction and its rollback besides)
    data = {k: v for k, v in twin.items() if "_hyperspace_log" not in k}
    assert {k: v for k, v in out["torch"]["converged"].items()
            if "_hyperspace_log" not in k} == data


# ---------------------------------------------------------------------------
# counters and the disarmed path
# ---------------------------------------------------------------------------


def test_disarmed_fault_points_add_no_counters(tmp_path):
    src = _lake(tmp_path)
    s, hs = _create("torch", str(tmp_path / "wh"), src)
    assert not TF.armed()
    names = ["faults.injected"] + [f"faults.injected.{p}" for p in TF.POINTS]
    before = {n: _val("torch", n) for n in names}
    TI.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(1).items()})
    hs.compact_index(NAME, min_runs=2)
    hs.vacuum_outdated_index(NAME)
    _q("torch", s, src)
    assert _deltas("torch", names, before) == dict.fromkeys(names, 0)


def test_states_and_events_of_the_ingest_actions(tmp_path):
    """The ingest transients are the JAX package's, and each action logs
    its CRUD event (started, succeeded) to the session's event logger."""
    from hyperspace_tpu.actions import states as JS
    from hyperspace_tpu_torch.actions import states as TS
    from hyperspace_tpu_torch.telemetry import events as TE

    assert (TS.INGESTING, TS.COMPACTING) == (JS.INGESTING, JS.COMPACTING)
    seen = []

    class Logger:
        def log_event(self, ev):
            seen.append((type(ev).__name__, ev.message))

    src = _lake(tmp_path)
    s, hs = _create("torch", str(tmp_path / "wh"), src)
    from hyperspace_tpu_torch.telemetry import logger as tlogger

    original = tlogger.event_logger_for
    tlogger.event_logger_for = lambda session: Logger()
    try:
        TI.append_batch(s, NAME, {k: v.tolist() for k, v in _batch(1).items()})
        hs.compact_index(NAME, min_runs=2)
    finally:
        tlogger.event_logger_for = original
    assert seen == [("IngestAppendActionEvent", "started"),
                    ("IngestAppendActionEvent", "succeeded"),
                    ("IngestCompactActionEvent", "started"),
                    ("IngestCompactActionEvent", "succeeded")]
    assert issubclass(TE.IngestAppendActionEvent, TE.HyperspaceIndexCRUDEvent)


# ---------------------------------------------------------------------------
# the smoke's ingest phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_smoke_ingest_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.ingest_phase over a 200k-row lake and li_orderkey, with
    the device tier on the CPU and a kernels shim whose launches are the
    plain versions' calls: every check of the phase holds, the two
    filter kernels' plain versions run on its path, and the phase leaves
    HYPERSPACE_RESULT_CACHE as it found it."""
    import importlib.util
    import types

    import torch

    from hyperspace_tpu_torch.benchmark import tpch
    from hyperspace_tpu_torch.ops import cuda_kernels

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(T.HyperspaceSession, "device",
                        property(lambda self: torch.device("cpu")))
    monkeypatch.delenv("HYPERSPACE_RESULT_CACHE", raising=False)
    shim = types.SimpleNamespace(LAUNCHES=cuda_kernels.PLAIN_CALLS,
                                 PLAIN_CALLS=dict.fromkeys(cuda_kernels.PLAIN_CALLS, 0))
    rows = 200_000
    lake, warehouse = str(tmp_path / "data" / "lake"), str(tmp_path / "data" / "wh")
    tpch.generate_tpch(lake, rows_lineitem=rows, seed=42)
    s = T.HyperspaceSession(warehouse)
    tpch.build_index(s, T.Hyperspace(s), lake, "lineitem", "CI", tpch.LI_ORDERKEY)
    out = smoke.ingest_phase(torch, shim, {"lake": lake, "warehouse": warehouse}, rows,
                             "cpu rehearsal")
    assert "HYPERSPACE_RESULT_CACHE" not in os.environ
    assert [a["api"] for a in out["appends"]] == ["append"] * 3 + ["append_batch"]
    assert [a["runs_per_bucket"] for a in out["appends"]] == [[2], [3], [4], [5]]
    assert all(a["rows"] == out["batch_rows"] for a in out["appends"])
    assert out["compaction"]["runs_per_bucket"] == [1]
    assert out["compaction"]["deferred"] >= 1 and out["compaction"]["versions_removed"] >= 1
    assert out["verified"] == 3
    # populate 1, four appends, the held plan, the recompute, the verify pass
    assert out["launches"]["filter_weighted_sum"] == 8
    assert out["launches"]["filter_sum"] == 7
