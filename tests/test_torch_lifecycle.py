"""The index lifecycle, the port against the JAX package on the same lake.

A small lake (six parquet files of 400 rows, numpy seed per file) gets an
index built by one package; then each package, in turn, runs the same
action from that same state (the warehouse is restored between them):
refresh (full, incremental, quick), optimize (quick, full), delete,
restore, vacuum and vacuum-outdated, for the covering and the z-order
kind, with lineage on and off. The index files the two write must be byte
for byte the same and their log entries equal once the wall-clock fields
(``timestamp``, ``modifiedTime``) are dropped; each package then queries
the index the other left and gets the same answer as the raw source
(counts exact, float sums within relative 1e-4).

Then: a table of illegal steps, each raising the same exception class and
message in both packages; recovery and cancel of a crashed transient
state; and a name reused after delete + vacuum serving the new data.
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
from hyperspace_tpu.meta.entry import LogEntry as JLogEntry
from hyperspace_tpu.meta.log_manager import IndexLogManager as JLogManager
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": (J, JC, JX), "torch": (T, TC, TX)}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger of 256
    entries; this module's hundreds of queries would leave it full for the
    files a test worker runs after it (tests/test_attribution.py needs room
    in it), so the module empties it when it is done."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()
ROWS = 400
FILES = 6
REL = 1e-4
NAME = "idx"
INDEXED, INCLUDED = ["k"], ["v", "s"]


def _write(lake: str, i: int, n: int = ROWS, salt: int = 0) -> None:
    rng = np.random.default_rng(1000 * salt + i)
    pq.write_table(pa.table({
        "k": rng.integers(0, 300, n),
        "v": rng.uniform(0, 100, n),
        "s": rng.choice(["a", "bb", "ccc", "dddd"], n),
        "d": rng.integers(0, 50, n).astype(np.int32),
    }), os.path.join(lake, f"f{i:03d}.parquet"))


def _lake(root, salt: int = 0) -> str:
    lake = os.path.join(str(root), "lake", "t")
    os.makedirs(lake, exist_ok=True)
    for i in range(FILES):
        _write(lake, i, salt=salt)
    return lake


def _session(pkg: str, warehouse: str, lineage: bool = True, **conf):
    mod, C, _X = PKGS[pkg]
    conf = {C.INDEX_LINEAGE_ENABLED: lineage, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


def _hs(pkg: str, session):
    return PKGS[pkg][0].Hyperspace(session)


def _config(pkg: str, kind: str):
    mod = PKGS[pkg][0]
    cls = mod.CoveringIndexConfig if kind == "ci" else mod.ZOrderCoveringIndexConfig
    return cls(NAME, INDEXED, INCLUDED)


def _create(pkg, warehouse, lake, kind, lineage=True):
    s = _session(pkg, warehouse, lineage)
    _hs(pkg, s).create_index(s.read.parquet(lake), _config(pkg, kind))


def _strip(x):
    """A log entry less its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("timestamp", "modifiedTime")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _capture(warehouse: str) -> dict:
    """Every file under the warehouse: data files as bytes, log entries
    and the latestStable pointer as JSON less the wall-clock fields."""
    out = {}
    for dirpath, _dirs, names in os.walk(warehouse):
        for fn in names:
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, warehouse)
            with open(p, "rb") as f:
                raw = f.read()
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


def _assert_same_warehouse(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in sorted(a):
        assert a[k] == b[k], k


def _queries(X, lake):
    def base(s):
        return s.read.parquet(lake)

    return {
        "range": lambda s: base(s).filter((X.col("k") >= 40) & (X.col("k") < 160)).agg(
            X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n")),
        "point": lambda s: base(s).filter(X.col("k") == 7).agg(
            X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n")),
    }


def _results(pkg, session, lake) -> dict:
    return {q: fn(session).to_pydict() for q, fn in _queries(PKGS[pkg][2], lake).items()}


def _indexes_used(pkg, session, lake) -> set:
    used = set()
    for fn in _queries(PKGS[pkg][2], lake).values():
        used |= {n.index_info.index_name for n in fn(session).optimized_plan().preorder()
                 if getattr(n, "index_info", None) is not None}
    return used


def _assert_results_match(got: dict, want: dict) -> None:
    for q in want:
        assert got[q]["n"] == want[q]["n"], q
        for g, w in zip(got[q]["sv"], want[q]["sv"]):
            assert g == pytest.approx(w, rel=REL), q


def _raw(lake) -> dict:
    s = _session("jax", os.path.join(os.path.dirname(lake), "raw_wh"))
    s.disable_hyperspace()
    return _results("jax", s, lake)


def _change_lake(lake: str, deletes: bool) -> None:
    """Two appended files (new names), and one deleted file if asked."""
    _write(lake, FILES, salt=7)
    _write(lake, FILES + 1, salt=7)
    if deletes:
        os.unlink(os.path.join(lake, "f001.parquet"))


# action: (the builder's setup step, the action on a package's Hyperspace)
def _refresh(mode):
    return lambda hs: hs.refresh_index(NAME, mode)


_ACTIONS = {
    "refresh_full": ("change", _refresh("full")),
    "refresh_incremental": ("change", _refresh("incremental")),
    "refresh_quick": ("change", _refresh("quick")),
    "optimize_quick": ("append_refreshed", lambda hs: hs.optimize_index(NAME, "quick")),
    "optimize_full": ("append_refreshed", lambda hs: hs.optimize_index(NAME, "full")),
    "delete": (None, lambda hs: hs.delete_index(NAME)),
    "restore": ("deleted", lambda hs: hs.restore_index(NAME)),
    "vacuum": ("deleted", lambda hs: hs.vacuum_index(NAME)),
    "vacuum_outdated": ("full_refreshed", lambda hs: hs.vacuum_outdated_index(NAME)),
}


def _setup(step, builder, warehouse, lake, lineage):
    hs = _hs(builder, _session(builder, warehouse, lineage))
    if step == "change":
        _change_lake(lake, deletes=lineage)
    elif step == "append_refreshed":
        _change_lake(lake, deletes=False)
        hs.refresh_index(NAME, "incremental")
    elif step == "deleted":
        hs.delete_index(NAME)
    elif step == "full_refreshed":
        _change_lake(lake, deletes=True)
        hs.refresh_index(NAME, "full")


@pytest.mark.parametrize("action", sorted(_ACTIONS))
@pytest.mark.parametrize("lineage", [True, False], ids=["lineage", "no_lineage"])
@pytest.mark.parametrize("kind", ["ci", "zci"])
@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_action_matches_across_packages(tmp_path, builder, kind, lineage, action):
    """Both packages run the action on the index ``builder`` built: the
    same files, the same log entries, and each reads the other's result."""
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create(builder, warehouse, lake, kind, lineage)
    step, act = _ACTIONS[action]
    _setup(step, builder, warehouse, lake, lineage)
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)

    captured, sessions = {}, {}
    for pkg in ("jax", "torch"):
        shutil.rmtree(warehouse)
        shutil.copytree(snapshot, warehouse)
        act(_hs(pkg, _session(pkg, warehouse, lineage)))
        captured[pkg] = _capture(warehouse)
    # the warehouse now holds the port's result, byte for byte the JAX one's
    _assert_same_warehouse(captured["jax"], captured["torch"])
    data = [k for k in captured["torch"] if "_hyperspace_log" not in k]
    if action == "vacuum":
        assert data == []
    elif action.startswith("optimize") and kind == "ci":
        assert any("v__=2" in k for k in data)  # the compacted version
    elif action == "vacuum_outdated":
        assert not any("v__=0" in k for k in data)

    want = _raw(lake)
    stats = {}
    for pkg in ("jax", "torch"):
        hs = _hs(pkg, _session(pkg, warehouse, lineage))
        stats[pkg] = (hs.indexes().to_pydict(), hs.get_index_versions(NAME),
                      None if action == "vacuum" else hs.index(NAME).to_pydict())
    assert stats["torch"] == stats["jax"]
    for pkg in ("jax", "torch"):
        s = _session(pkg, warehouse, lineage)
        s.enable_hyperspace()
        used = _indexes_used(pkg, s, lake)
        assert used == (set() if action in ("delete", "vacuum") else {NAME}), pkg
        _assert_results_match(_results(pkg, s, lake), want)


def test_optimize_compacts_each_bucket_into_one_sorted_file(tmp_path):
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("torch", warehouse, lake, "ci")
    _change_lake(lake, deletes=False)
    hs = _hs("torch", _session("torch", warehouse))
    hs.refresh_index(NAME, "incremental")
    files = hs.get_index(NAME).content.files()
    assert len(files) == 16  # two runs per bucket
    hs.optimize_index(NAME)
    files = hs.get_index(NAME).content.files()
    assert len(files) == 8 and all("v__=2" in f for f in files)
    for f in files:
        k = pq.read_table(f, columns=["k"]).column("k").to_numpy()
        assert (np.diff(k) >= 0).all()
    # nothing left to compact: a no-op, no new log entry
    versions = hs.get_index_versions(NAME)
    hs.optimize_index(NAME, "full")
    assert hs.get_index_versions(NAME) == versions


def test_quick_refresh_records_the_delta_and_hybrid_scan_serves_it(tmp_path):
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("jax", warehouse, lake, "ci")
    _change_lake(lake, deletes=True)
    hs = _hs("torch", _session("torch", warehouse))
    hs.refresh_index(NAME, "quick")
    e = hs.get_index(NAME)
    assert [os.path.basename(f.name) for f in sorted(e.appended_files(), key=lambda f: f.name)] \
        == ["f006.parquet", "f007.parquet"]
    assert [os.path.basename(f.name) for f in e.deleted_files()] == ["f001.parquet"]
    assert [f.id for f in e.deleted_files()] == [1]
    stats = hs.index(NAME).to_pydict()
    assert stats["numAppendedFiles"] == [2] and stats["numDeletedFiles"] == [1]
    assert stats["logVersion"] == [e.id] and stats["state"] == ["ACTIVE"]


def test_file_ids_survive_refreshes(tmp_path):
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("torch", warehouse, lake, "ci")
    hs = _hs("torch", _session("torch", warehouse))
    before = {f.name: f.id for f in hs.get_index(NAME).relation.content.file_infos()}
    _change_lake(lake, deletes=True)
    hs.refresh_index(NAME, "incremental")
    after = {f.name: f.id for f in hs.get_index(NAME).relation.content.file_infos()}
    assert all(after[n] == before[n] for n in after if n in before)
    assert sorted(i for n, i in after.items() if n not in before) == [6, 7]
    ids = np.concatenate([pq.read_table(f, columns=["_data_file_id"]).column(0).to_numpy()
                          for f in hs.get_index(NAME).content.files()])
    assert set(ids.tolist()) == {0, 2, 3, 4, 5, 6, 7}


# ---------------------------------------------------------------------------
# illegal steps
# ---------------------------------------------------------------------------

def _prep(state):
    """Bring the index to ``state`` with the JAX package."""

    def run(hs, lake):
        if state in ("deleted", "vacuumed"):
            hs.delete_index(NAME)
        if state == "vacuumed":
            hs.vacuum_index(NAME)
        if state == "source_deleted":
            os.unlink(os.path.join(lake, "f002.parquet"))

    return run


_ILLEGAL = {
    # name: (lineage, preparation, the step)
    "refresh_deleted": (True, "deleted", lambda hs, pkg: hs.refresh_index(NAME)),
    "refresh_quick_deleted": (True, "deleted", lambda hs, pkg: hs.refresh_index(NAME, "quick")),
    "restore_active": (True, None, lambda hs, pkg: hs.restore_index(NAME)),
    "vacuum_active": (True, None, lambda hs, pkg: hs.vacuum_index(NAME)),
    "delete_deleted": (True, "deleted", lambda hs, pkg: hs.delete_index(NAME)),
    "delete_vacuumed": (True, "vacuumed", lambda hs, pkg: hs.delete_index(NAME)),
    "restore_vacuumed": (True, "vacuumed", lambda hs, pkg: hs.restore_index(NAME)),
    "optimize_deleted": (True, "deleted", lambda hs, pkg: hs.optimize_index(NAME)),
    "vacuum_outdated_deleted": (True, "deleted", lambda hs, pkg: hs.vacuum_outdated_index(NAME)),
    "incremental_deletes_without_lineage": (
        False, "source_deleted", lambda hs, pkg: hs.refresh_index(NAME, "incremental")),
    "quick_deletes_without_lineage": (
        False, "source_deleted", lambda hs, pkg: hs.refresh_index(NAME, "quick")),
    "invalid_refresh_mode": (True, None, lambda hs, pkg: hs.refresh_index(NAME, "fast")),
    "invalid_optimize_mode": (True, None, lambda hs, pkg: hs.optimize_index(NAME, "all")),
    "unknown_index": (True, None, lambda hs, pkg: hs.delete_index("nope")),
    "cancel_active": (True, None, lambda hs, pkg: hs.cancel(NAME)),
    "create_existing": (True, None, lambda hs, pkg: hs.create_index(
        hs.session.read.parquet(hs._lake), _config(pkg, "ci"))),
    "index_unknown": (True, None, lambda hs, pkg: hs.index("nope")),
    "refresh_vacuumed": (True, "vacuumed", lambda hs, pkg: hs.refresh_index(NAME)),
}


@pytest.mark.parametrize("case", sorted(_ILLEGAL))
def test_illegal_steps_raise_the_same_error(tmp_path, case):
    lineage, prep, step = _ILLEGAL[case]
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("jax", warehouse, lake, "ci", lineage)
    if prep is not None:
        _prep(prep)(_hs("jax", _session("jax", warehouse, lineage)), lake)
    snapshot = _capture(warehouse)
    errors = {}
    for pkg in ("jax", "torch"):
        hs = _hs(pkg, _session(pkg, warehouse, lineage))
        hs._lake = lake
        with pytest.raises(Exception) as info:
            step(hs, pkg)
        errors[pkg] = (type(info.value).__name__, str(info.value))
        assert _capture(warehouse) == snapshot, "a refused step changed the warehouse"
    assert errors["torch"] == errors["jax"]
    assert errors["torch"][0] == "HyperspaceError"


@pytest.mark.parametrize("mode", ["full", "incremental", "quick"])
def test_refresh_without_changes_is_a_no_op_in_both(tmp_path, mode):
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("torch", warehouse, lake, "ci")
    snapshot = _capture(warehouse)
    for pkg in ("jax", "torch"):
        _hs(pkg, _session(pkg, warehouse)).refresh_index(NAME, mode)
        assert _capture(warehouse) == snapshot


# ---------------------------------------------------------------------------
# recovery and cancel
# ---------------------------------------------------------------------------

def _crash(warehouse: str, state: str, stale: bool) -> None:
    """What a process that died mid-action leaves: a transient entry (old
    or fresh), a staged build, an unreferenced data version and a spool
    file."""
    path = os.path.join(warehouse, "indexes", NAME)
    lm = JLogManager(path)
    entry = JLogEntry(state=state)
    entry.stamp()
    if stale:
        entry.timestamp -= 2 * 3600 * 1000
    latest = lm.get_latest_id()
    lm.write_log(0 if latest is None else latest + 1, entry)
    os.makedirs(os.path.join(path, "_staging", "1"))
    with open(os.path.join(path, "_staging", "1", "part-0-b00000.parquet"), "wb") as f:
        f.write(b"half")
    os.makedirs(os.path.join(path, "v__=5"))
    with open(os.path.join(path, "v__=5", "part-0-b00001.parquet"), "wb") as f:
        f.write(b"orphan")
    spool = os.path.join(lm.log_dir, ".tmp-dead")
    with open(spool, "w") as f:
        f.write("{}")
    os.utime(spool, (0, 0))


_RECOVERY = {
    # name: (transient state, stale, the step)
    "recover_stale_refresh": ("REFRESHING", True, lambda hs: hs.recover()),
    "recover_fresh_refresh": ("REFRESHING", False, lambda hs: hs.recover()),
    "recover_forced_fresh": ("OPTIMIZING", False, lambda hs: hs.recover(NAME, force=True)),
    # a crash in the index's first create: no stable state to return to
    "recover_stale_create": ("CREATING", True, lambda hs: hs.recover(NAME)),
    "cancel_create": ("CREATING", False, lambda hs: hs.cancel(NAME)),
    "recover_stale_vacuum": ("VACUUMING", True, lambda hs: hs.recover()),
    "cancel_refresh": ("REFRESHING", False, lambda hs: hs.cancel(NAME)),
    "cancel_vacuum": ("VACUUMING", False, lambda hs: hs.cancel(NAME)),
}


@pytest.mark.parametrize("case", sorted(_RECOVERY))
def test_recovery_matches_across_packages(tmp_path, case):
    state, stale, step = _RECOVERY[case]
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    if state != "CREATING":
        _create("torch", warehouse, lake, "ci")
    if state == "VACUUMING":
        _hs("torch", _session("torch", warehouse)).delete_index(NAME)
    snapshot = str(tmp_path / "snapshot")
    captured, reports = {}, {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            _crash(warehouse, state, stale)
            shutil.copytree(warehouse, snapshot)
        else:
            shutil.rmtree(warehouse)
            shutil.copytree(snapshot, warehouse)
        mod = PKGS[pkg][0]
        # a manager built without the session-start pass, so the step under
        # test does the repair
        session = _session(pkg, warehouse)
        import importlib

        im = importlib.import_module(f"{mod.__name__}.index_manager")
        manager = im.CachingIndexCollectionManager.__new__(im.CachingIndexCollectionManager)
        manager._cache = im.CreationTimeBasedCache(lambda: 300)
        im.IndexCollectionManager.__init__(manager, session, auto_recover=False)
        session._index_manager = manager
        reports[pkg] = step(_hs(pkg, session))
        captured[pkg] = _capture(warehouse)
    assert reports["torch"] == reports["jax"]
    _assert_same_warehouse(captured["jax"], captured["torch"])
    latest = _hs("torch", _session("torch", warehouse)).get_index_versions(NAME)
    entry = json.load(open(os.path.join(warehouse, "indexes", NAME, "_hyperspace_log",
                                        str(latest[0]))))
    if stale or case in ("recover_forced_fresh",) or case.startswith("cancel"):
        # back to the last stable state; a first create has none
        want = {"CREATING": "DOESNOTEXIST", "VACUUMING": "DELETED"}.get(state, "ACTIVE")
        assert entry["state"] == want
        assert not os.path.exists(os.path.join(warehouse, "indexes", NAME, "_staging")) \
            or case.startswith("cancel")
    else:
        assert entry["state"] == state  # a possibly live transaction is left alone


def test_session_start_recovers_a_stale_crash(tmp_path):
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    _create("torch", warehouse, lake, "ci")
    _crash(warehouse, "REFRESHING", stale=True)
    s = _session("torch", warehouse)
    s.enable_hyperspace()
    hs = _hs("torch", s)  # the manager's construction runs the pass
    assert hs.get_index(NAME).state == "ACTIVE"
    assert sorted(os.listdir(os.path.join(warehouse, "indexes", NAME))) == [
        "_hyperspace_log", "v__=0"]
    assert _indexes_used("torch", s, lake) == {NAME}
    _assert_results_match(_results("torch", s, lake), _raw(lake))


# ---------------------------------------------------------------------------
# name reuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_reused_name_serves_the_new_data(tmp_path, pkg):
    """Delete + vacuum + re-create under the same name, over a lake whose
    files were rewritten under the same names: the session that served the
    old index (its entry, chunk and device caches warm) serves the new
    data."""
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    s = _session(pkg, warehouse)
    s.enable_hyperspace()
    hs = _hs(pkg, s)
    hs.create_index(s.read.parquet(lake), _config(pkg, "ci"))
    old = _results(pkg, s, lake)
    _assert_results_match(old, _raw(lake))
    hs.delete_index(NAME)
    hs.vacuum_index(NAME)
    assert _indexes_used(pkg, s, lake) == set()
    shutil.rmtree(lake)
    _lake(tmp_path, salt=3)
    hs.create_index(s.read.parquet(lake), _config(pkg, "ci"))
    assert _indexes_used(pkg, s, lake) == {NAME}
    assert hs.get_index_versions(NAME)[0] == 7  # create, delete, vacuum, create
    new = _results(pkg, s, lake)
    _assert_results_match(new, _raw(lake))
    assert new != old


@pytest.mark.parametrize("kind", ["ci", "zci"])
def test_lineage_of_a_filtered_source_matches_jax(tmp_path, kind):
    """A source plan that is not projections over the scan takes lineage
    file by file (the fast path needs rows in file order): both packages
    write the same files and log entry."""
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    captured = {}
    for pkg in ("jax", "torch"):
        shutil.rmtree(warehouse, ignore_errors=True)
        X = PKGS[pkg][2]
        s = _session(pkg, warehouse)
        df = s.read.parquet(lake).filter(X.col("d") < 25)
        _hs(pkg, s).create_index(df, _config(pkg, kind))
        captured[pkg] = _capture(warehouse)
    _assert_same_warehouse(captured["jax"], captured["torch"])
    files = [k for k in captured["torch"] if k.endswith(".parquet")]
    ids = np.concatenate([pq.read_table(os.path.join(warehouse, f), columns=["_data_file_id"])
                          .column(0).to_numpy() for f in files])
    assert set(ids.tolist()) == set(range(FILES))
