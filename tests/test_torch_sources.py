"""Snapshot (Delta-style) and Iceberg-style tables and the source-provider
manager, the port against the JAX package (a mirror of
tests/test_snapshot_source.py and tests/test_iceberg_source.py).

- SnapshotTable: commits, appends, overwrites, logical deletes and scans
  at a version, each table written by one package scanned by the other.
- IcebergStyleTable: snapshot ancestry, time travel by id and by time,
  manifest rewrites on delete, per-snapshot schemas; a table written by
  one package read by the other; snapshot ids and file names drawn from a
  seeded ``random.Random`` or numpy generator repeat, and differ between
  seeds.
- Indexes over both: the recorded version history, the relation's format,
  the rewrite, refresh over a new snapshot, and time travel: a query over
  an older snapshot reads the index log version recorded for it (by
  version order for the Delta-style table, by ancestry for the Iceberg
  one), also after delete and restore. Each case runs in both packages
  from the same table, and the chosen log versions and results are equal;
  an index built by one package is used, with its history, by the other.
- ``closest_index_version`` and the ancestry walk on a table of histories.
- The manager: the providers named by ``fileBasedBuilders`` (the JAX
  package's class names map to the port's own classes, which import
  nothing of it), two providers answering one relation raise, an unknown
  name under the JAX package raises, an unsupported relation raises at
  create.

Counts and keys exact, float sums within relative 1e-4.
"""

import os
import random

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.sources import delta as jdelta
from hyperspace_tpu.sources import iceberg as jice
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.exceptions import HyperspaceError as TError
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.sources import delta as tdelta
from hyperspace_tpu_torch.sources import iceberg as tice
from hyperspace_tpu_torch.sources.manager import SourceProviderManager

PKGS = {"jax": (J, JC, JX), "torch": (T, TC, TX)}
ERRORS = {"jax": JError, "torch": TError}
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger of 256
    entries; the module empties it when it is done."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _session(pkg: str, warehouse: str, device: bool = False, **conf):
    mod, C, _X = PKGS[pkg]
    conf = {C.EXEC_TPU_ENABLED: device, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


def _batch(pkg: str, seed: int, n: int = 40, k0: int = 0):
    rng = np.random.default_rng(seed)
    return PKGS[pkg][0].columnar.table.ColumnBatch.from_pydict({
        "k": (k0 + rng.integers(0, 30, n)).tolist(),
        "v": rng.uniform(0, 100, n).tolist(),
    })


def _snapshot_table(pkg: str, path: str):
    return (J.SnapshotTable if pkg == "jax" else T.SnapshotTable)(path)


def _iceberg_table(pkg: str, path: str, rng=None):
    if pkg == "jax":
        return J.IcebergStyleTable(path)
    return T.IcebergStyleTable(path, rng=rng)


def _rows(d: dict) -> list:
    return sorted(zip(*d.values()))


def _index_scans(df) -> list:
    return [n for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


def _point(pkg, df, key):
    X = PKGS[pkg][2]
    return df.filter(X.col("k") == key).select("k", "v")


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_snapshot_table_versions_read_by_either_package(tmp_path, writer, reader):
    t = _snapshot_table(writer, str(tmp_path / "tbl"))
    assert t.latest_version() is None
    assert t.commit(_batch(writer, 1)) == 0
    assert t.commit(_batch(writer, 2)) == 1
    assert t.commit(_batch(writer, 3), mode="overwrite") == 2
    assert t.commit(_batch(writer, 4)) == 3
    assert t.delete_files([t.snapshot_files(3)[0]]) == 4
    r = _snapshot_table(reader, str(tmp_path / "tbl"))
    s = _session(reader, str(tmp_path / "wh"))
    got = {v: r.scan(s, version=v).to_pydict() for v in range(5)}
    assert r.snapshot_files(4) == ["part-00003.parquet"]
    assert r.latest_version() == 4
    assert r.scan(s).to_pydict() == got[4]
    assert [len(got[v]["k"]) for v in range(5)] == [40, 80, 40, 80, 40]
    sj = _session("jax", str(tmp_path / "whj"))
    jt = J.SnapshotTable(str(tmp_path / "tbl"))
    for v in range(5):
        assert got[v] == jt.scan(sj, version=v).to_pydict(), v
    with pytest.raises(ERRORS[reader], match="Snapshot version 9 not found"):
        r.scan(s, version=9)


def _fill_iceberg(t, pkg):
    sids = [t.commit(_batch(pkg, 1)), t.commit(_batch(pkg, 2))]
    first_file = t.data_files(sids[0])[0]["path"]
    sids.append(t.delete_files([first_file]))
    sids.append(t.commit(_batch(pkg, 3), mode="overwrite"))
    return sids


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_iceberg_table_read_by_the_other_package(tmp_path, writer, reader):
    t = _iceberg_table(writer, str(tmp_path / "ice"))
    sids = _fill_iceberg(t, writer)
    r = _iceberg_table(reader, str(tmp_path / "ice"))
    assert r.current_snapshot_id() == sids[-1]
    assert [r.parent_of(s) for s in sids] == [None] + sids[:-1]
    s = _session(reader, str(tmp_path / "wh"))
    got = [len(r.scan(s, snapshot_id=sid).to_pydict()["k"]) for sid in sids]
    assert got == [40, 80, 40, 40]
    snaps = r.snapshots()
    assert r.snapshot_as_of(snaps[1]["timestamp-ms"]) in sids
    assert r.snapshot_as_of(snaps[0]["timestamp-ms"] - 1) is None
    with pytest.raises(ERRORS[reader], match="not found"):
        r.scan(s, snapshot_id=12345)
    # the delete rewrote only the manifest that held the file
    assert len(r._manifests(sids[2])) == 1 and r._manifests(sids[2]) != r._manifests(sids[1])


def test_iceberg_time_travel_reads_each_snapshots_schema(tmp_path):
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        B = mod.columnar.table.ColumnBatch
        t = _iceberg_table(pkg, str(tmp_path / pkg))
        s0 = t.commit(B.from_pydict({"k": [1, 2], "v": [1.0, 2.0]}))
        t.commit(B.from_pydict({"k": [3], "v": [3.0], "w": ["x"]}), mode="overwrite")
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        out[pkg] = (t.scan(s, snapshot_id=s0).columns, t.scan(s).columns,
                    t.scan(s, snapshot_id=s0).to_pydict())
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (["k", "v"], ["k", "v", "w"])


@pytest.mark.parametrize("make", [lambda: random.Random(7), lambda: np.random.default_rng(7)])
def test_seeded_iceberg_ids_repeat(tmp_path, make):
    def fill(path):
        t = T.IcebergStyleTable(path, rng=make())
        sids = _fill_iceberg(t, "torch")
        names = sorted(os.listdir(os.path.join(path, "metadata")))
        return sids, names, sorted(n for n in os.listdir(path) if n.endswith(".parquet"))

    a, b = fill(str(tmp_path / "a")), fill(str(tmp_path / "b"))
    assert a == b
    assert all(0 <= s < 2 ** 63 for s in a[0]) and len(set(a[0])) == 4
    other = T.IcebergStyleTable(str(tmp_path / "c"), rng=random.Random(8))
    assert other.commit(_batch("torch", 1)) != a[0][0]


# ---------------------------------------------------------------------------
# indexes and time travel
# ---------------------------------------------------------------------------

def _snapshot_scenario(pkg, tmp_path, restore: bool):
    """Index at v0, (delete and restore), commit v1, full refresh; the
    chosen log versions and results of queries at v0, v1 and latest."""
    mod, C, X = PKGS[pkg]
    t = _snapshot_table(pkg, str(tmp_path / f"tbl_{pkg}"))
    t.commit(_batch(pkg, 1))
    s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
    hs = mod.Hyperspace(s)
    hs.create_index(t.scan(s), mod.CoveringIndexConfig("sidx", ["k"], ["v"]))
    e0 = hs.get_index("sidx")
    out = {"created": (e0.id, dict(e0.properties), e0.relation.file_format,
                       dict(e0.relation.options).get("format"))}
    if restore:
        hs.delete_index("sidx")
        hs.restore_index("sidx")
    t.commit(_batch(pkg, 2, k0=100))
    hs.refresh_index("sidx", "full")
    e1 = hs.get_index("sidx")
    out["refreshed"] = (e1.id, dict(e1.properties))
    s.enable_hyperspace()
    for name, v, key in (("v0", 0, 5), ("v1", 1, 105), ("latest", None, 105)):
        q = _point(pkg, t.scan(s, version=v), key)
        scans = _index_scans(q)
        out[name] = ([n.index_info.log_version for n in scans], _rows(q.to_pydict()))
    return out


@pytest.mark.parametrize("restore", [False, True])
def test_snapshot_indexes_and_time_travel_match_jax(tmp_path, restore):
    got = _snapshot_scenario("torch", tmp_path, restore)
    want = _snapshot_scenario("jax", tmp_path, restore)
    assert got["created"][1:] == want["created"][1:]
    assert got["created"][1] == {**got["created"][1],
                                 tdelta.VERSION_HISTORY_PROPERTY: f"{got['created'][0]}:0"}
    assert got["created"][2] == "snapshot-parquet"
    assert got == want
    assert got["v0"][0] == [got["created"][0]] and got["v1"][0] == [got["refreshed"][0]]


def _iceberg_scenario(pkg, tmp_path):
    mod, C, X = PKGS[pkg]
    t = _iceberg_table(pkg, str(tmp_path / f"ice_{pkg}"), rng=random.Random(3))
    s0 = t.commit(_batch(pkg, 1))
    s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
    hs = mod.Hyperspace(s)
    hs.create_index(t.scan(s), mod.CoveringIndexConfig("iidx", ["k"], ["v"]))
    e0 = hs.get_index("iidx")
    s1 = t.commit(_batch(pkg, 2, k0=100))
    s2 = t.commit(_batch(pkg, 3, k0=200))  # no index version for s1 or s2 yet
    out = {"created": (e0.id, e0.properties[jice.SNAPSHOT_ID_HISTORY_PROPERTY] ==
                       f"{e0.id}:{s0}", e0.relation.file_format)}
    hs.refresh_index("iidx", "full")
    e1 = hs.get_index("iidx")
    out["refreshed"] = e1.properties[jice.SNAPSHOT_ID_HISTORY_PROPERTY] == \
        f"{e0.id}:{s0},{e1.id}:{s2}"
    s.enable_hyperspace()
    stamp = {sn["snapshot-id"]: sn["timestamp-ms"] for sn in t.snapshots()}
    for name, kw, key in (("s0", {"snapshot_id": s0}, 5), ("s1", {"snapshot_id": s1}, 105),
                          ("s2", {"snapshot_id": s2}, 205),
                          ("as_of_s0", {"as_of_ms": stamp[s0]}, 5),
                          ("current", {}, 205)):
        q = _point(pkg, t.scan(s, **kw), key)
        out[name] = ([n.index_info.log_version for n in _index_scans(q)], _rows(q.to_pydict()))
    return out, (e0.id, e1.id)


def test_iceberg_indexes_and_ancestry_time_travel_match_jax(tmp_path):
    got, (c0, c1) = _iceberg_scenario("torch", tmp_path)
    want, _ = _iceberg_scenario("jax", tmp_path)
    assert got == want
    assert got["created"][1:] == (True, "iceberg-parquet") and got["refreshed"]
    # s1 has no record: its nearest recorded ancestor, s0, was built over
    # other files, so the signature check refuses it and s1 reads raw
    assert got["s0"][0] == [c0] and got["s1"][0] == [] and got["s2"][0] == [c1]


HISTORIES = [
    ({"snapshotVersionHistory": "1:0,5:3,9:7"}, [0, 3, 5, 99, -1]),
    ({}, [1]),
    ({"snapshotVersionHistory": "0,3"}, [5]),
    ({"snapshotVersionHistory": "1:0,3:0,x:y,4:2"}, [0, 1, 2, 3]),
]


@pytest.mark.parametrize("props,queries", HISTORIES)
def test_closest_index_version_matches_jax(props, queries):
    for q in queries:
        assert tdelta.closest_index_version(props, q) == jdelta.closest_index_version(props, q)
    assert tdelta.parse_version_history(props) == jdelta.parse_version_history(props)


def test_ancestry_walk_matches_jax(tmp_path):
    t = T.IcebergStyleTable(str(tmp_path / "ice"), rng=random.Random(1))
    sids = [t.commit(_batch("torch", i)) for i in range(4)]
    jt = J.IcebergStyleTable(str(tmp_path / "ice"))
    cases = [f"1:{sids[0]}", f"1:{sids[0]},5:{sids[2]}", f"1:{sids[1]},2:{sids[1]}", "", "7:1"]
    for hist in cases:
        props = {tice.SNAPSHOT_ID_HISTORY_PROPERTY: hist}
        for q in sids + [999]:
            assert tice.closest_index_version_by_ancestry(t, props, q) == \
                jice.closest_index_version_by_ancestry(jt, props, q), (hist, q)


@pytest.mark.parametrize("builder,reader", [("jax", "torch"), ("torch", "jax")])
def test_snapshot_index_built_by_one_package_time_travels_in_the_other(tmp_path, builder,
                                                                       reader):
    bmod = PKGS[builder][0]
    tpath, wh = str(tmp_path / "tbl"), str(tmp_path / "wh")
    t = _snapshot_table(builder, tpath)
    t.commit(_batch(builder, 1))
    s = _session(builder, wh)
    hs = bmod.Hyperspace(s)
    hs.create_index(t.scan(s), bmod.CoveringIndexConfig("sidx", ["k"], ["v"]))
    first = hs.get_index("sidx").id
    t.commit(_batch(builder, 2, k0=100))
    hs.refresh_index("sidx", "incremental")
    r = _session(reader, wh)
    rt = _snapshot_table(reader, tpath)
    raw = {v: _rows(_point(reader, rt.scan(r, version=v), k).to_pydict())
           for v, k in ((0, 5), (1, 105))}
    r.enable_hyperspace()
    for v, k in ((0, 5), (1, 105)):
        q = _point(reader, rt.scan(r, version=v), k)
        assert [n.index_info.log_version for n in _index_scans(q)] == \
            ([first] if v == 0 else [first + 2])
        assert _rows(q.to_pydict()) == raw[v]
    # the reader refreshes what the builder made: the history grows in order
    rt.commit(_batch(reader, 3, k0=200))
    PKGS[reader][0].Hyperspace(r).refresh_index("sidx", "full")
    hist = PKGS[reader][0].Hyperspace(r).get_index("sidx").properties[
        tdelta.VERSION_HISTORY_PROPERTY]
    assert hist == f"{first}:0,{first + 2}:1,{first + 4}:2"


@pytest.mark.parametrize("builder,reader", [("jax", "torch"), ("torch", "jax")])
def test_iceberg_index_built_by_one_package_used_by_the_other(tmp_path, builder, reader):
    bmod = PKGS[builder][0]
    tpath, wh = str(tmp_path / "ice"), str(tmp_path / "wh")
    t = _iceberg_table(builder, tpath)
    s0 = t.commit(_batch(builder, 1))
    s = _session(builder, wh)
    bmod.Hyperspace(s).create_index(t.scan(s), bmod.CoveringIndexConfig("iidx", ["k"], ["v"]))
    t.commit(_batch(builder, 2, k0=100))
    r = _session(reader, wh, device=True)
    rt = _iceberg_table(reader, tpath)
    X = PKGS[reader][2]
    q = lambda **kw: rt.scan(r, **kw).filter(X.col("k") < 20).agg(  # noqa: E731
        X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"))
    raw = q(snapshot_id=s0).to_pydict()
    r.enable_hyperspace()
    assert [n.index_info.index_name for n in _index_scans(q(snapshot_id=s0))] == ["iidx"]
    assert _index_scans(q()) == []  # the current snapshot has no index version
    got = q(snapshot_id=s0).to_pydict()
    assert got["n"] == raw["n"] and got["sv"] == pytest.approx(raw["sv"], rel=REL)


def test_both_snapshot_providers_coexist(tmp_path):
    out = {}
    for pkg in PKGS:
        mod, C, X = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        hs = mod.Hyperspace(s)
        st = _snapshot_table(pkg, str(tmp_path / f"d_{pkg}"))
        st.commit(_batch(pkg, 1))
        it = _iceberg_table(pkg, str(tmp_path / f"i_{pkg}"))
        it.commit(_batch(pkg, 2))
        hs.create_index(st.scan(s), mod.CoveringIndexConfig("didx", ["k"], ["v"]))
        hs.create_index(it.scan(s), mod.CoveringIndexConfig("iidx", ["k"], ["v"]))
        s.enable_hyperspace()
        out[pkg] = ([n.index_info.index_name for n in _index_scans(_point(pkg, st.scan(s), 3))],
                    [n.index_info.index_name for n in _index_scans(_point(pkg, it.scan(s), 3))],
                    sorted(e.relation.file_format for e in
                           [hs.get_index("didx"), hs.get_index("iidx")]))
    assert out["torch"] == out["jax"] == (["didx"], ["iidx"],
                                          ["iceberg-parquet", "snapshot-parquet"])


def test_vacuum_outdated_keeps_the_latest_history_pair(tmp_path):
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        t = _snapshot_table(pkg, str(tmp_path / f"tbl_{pkg}"))
        t.commit(_batch(pkg, 1))
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        hs = mod.Hyperspace(s)
        hs.create_index(t.scan(s), mod.CoveringIndexConfig("sidx", ["k"], ["v"]))
        t.commit(_batch(pkg, 2))
        hs.refresh_index("sidx", "full")
        hs.vacuum_outdated_index("sidx")
        out[pkg] = hs.get_index("sidx").properties[tdelta.VERSION_HISTORY_PROPERTY]
    assert out["torch"] == out["jax"] == "3:1"


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [
    "hyperspace_tpu.sources.default.DefaultFileBasedSource",
    "hyperspace_tpu.sources.default.DefaultFileBasedSource,"
    "hyperspace_tpu.sources.delta.DeltaStyleSource",
    "hyperspace_tpu.sources.default.DefaultFileBasedSource, "
    "hyperspace_tpu.sources.iceberg.IcebergStyleSource",
])
def test_builder_names_map_to_the_ports_providers(tmp_path, names):
    """The JAX package's names select the same providers, which answer the
    same relations; the port's instances are its own classes."""
    from hyperspace_tpu.sources.manager import SourceProviderManager as JManager

    src = tmp_path / "src"
    T.columnar.io.write_parquet(_batch("torch", 1), str(src / "p.parquet"))
    t = _snapshot_table("torch", str(tmp_path / "tbl"))
    t.commit(_batch("torch", 2))
    out = {}
    for pkg, manager in (("jax", JManager), ("torch", SourceProviderManager)):
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"),
                     **{PKGS[pkg][1].FILE_BASED_SOURCE_BUILDERS: names})
        mgr = manager(s)
        table = _snapshot_table(pkg, str(tmp_path / "tbl"))
        out[pkg] = ([type(p).__name__ for p in mgr._providers],
                    mgr.is_supported_relation(s.read.parquet(str(src)).plan),
                    mgr.is_supported_relation(table.scan(s).plan))
        if pkg == "torch":
            assert all(type(p).__module__.startswith("hyperspace_tpu_torch.sources.")
                       for p in mgr._providers)
    assert out["torch"] == out["jax"]


def test_the_ports_own_builder_names(tmp_path):
    names = ",".join(f"hyperspace_tpu_torch.sources.{m}.{c}" for m, c in (
        ("default", "DefaultFileBasedSource"), ("delta", "DeltaStyleSource"),
        ("iceberg", "IcebergStyleSource")))
    s = _session("torch", str(tmp_path / "wh"), **{TC.FILE_BASED_SOURCE_BUILDERS: names})
    default = _session("torch", str(tmp_path / "wh"))
    assert [type(p) for p in SourceProviderManager(s)._providers] == \
        [type(p) for p in SourceProviderManager(default)._providers]


def test_two_answering_providers_raise(tmp_path):
    src = tmp_path / "src"
    T.columnar.io.write_parquet(_batch("torch", 1), str(src / "p.parquet"))
    names = ("hyperspace_tpu.sources.default.DefaultFileBasedSource,"
             "hyperspace_tpu_torch.sources.default.DefaultFileBasedSource")
    for pkg in PKGS:
        mod, C, _X = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), **{C.FILE_BASED_SOURCE_BUILDERS: names})
        if pkg == "jax":  # the JAX package imports the port's class by name
            continue
        with pytest.raises(TError, match="Multiple source providers answered"):
            mod.Hyperspace(s).create_index(s.read.parquet(str(src)),
                                           mod.CoveringIndexConfig("x", ["k"], ["v"]))


def test_unknown_reference_provider_raises(tmp_path):
    s = _session("torch", str(tmp_path / "wh"),
                 **{TC.FILE_BASED_SOURCE_BUILDERS: "hyperspace_tpu.sources.other.Nope"})
    with pytest.raises(TError, match="Unknown source provider"):
        SourceProviderManager(s)


def test_an_index_scan_is_no_source(tmp_path):
    out = {}
    for pkg in PKGS:
        mod, C, X = PKGS[pkg]
        src = tmp_path / pkg
        mod.columnar.io.write_parquet(_batch(pkg, 1), str(src / "p.parquet"))
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        mod.Hyperspace(s).create_index(s.read.parquet(str(src)),
                                       mod.CoveringIndexConfig("x", ["k"], ["v"]))
        s.enable_hyperspace()
        (scan,) = _index_scans(_point(pkg, s.read.parquet(str(src)), 3))
        manager = (SourceProviderManager if pkg == "torch" else
                   __import__("hyperspace_tpu.sources.manager",
                              fromlist=["m"]).SourceProviderManager)
        out[pkg] = (manager(s).is_supported_relation(scan),
                    manager(s).is_supported_relation(scan.copy(index_info=None)))
    assert out["torch"] == out["jax"] == (False, True)
