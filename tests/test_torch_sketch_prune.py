"""The sidecar sketch stage of pruning (hyperspace_tpu_torch/models/
dataskipping/sketch_store.py, plan/pruning.py) held against the JAX
package's on the same seeded lake (tests/test_sketch_prune.py's events
table: a covering index on ev_k over 12,000 rows in 4 files, 2 buckets,
the row-group floor patched to 512 rows in both packages):

- ``HYPERSPACE_SKETCHES`` parses to the same kinds; with it unset nothing
  is written;
- each package builds the index with sketches on: the sidecars equal as
  parsed JSON;
- the kept files and row groups, plans and results per conjunct kind
  (bloom on a high-NDV id, value list on a low-NDV int and a string,
  z-region on a float range, with the sort column's footer stage too),
  and fewer groups than the sketchless read;
- a stale or a malformed sidecar keeps every group in both;
- a tampered sidecar (every bloom bit cleared) raises under verify;
- the filter ranker's estimated scan fraction with sketches on;
- vacuum keeps the sidecars of referenced files and removes the others.

Tolerances: counts and keys exact; f32 sums within relative 1e-4.
"""

import base64
import glob
import json
import os

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.exceptions import HyperspaceError as JHyperspaceError
from hyperspace_tpu.models import covering as jcov
from hyperspace_tpu.models.dataskipping import sketch_store as jss
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import pruning as jpr
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index_manager import index_manager_for
from hyperspace_tpu_torch.models import covering as tcov
from hyperspace_tpu_torch.models.dataskipping import sketch_store as tss
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import pruning as tpr

N = 12_000
N_FILES = 4
BUCKETS = 2
RGS = 512
INDEX = "ev_idx"
PKGS = {"jax": (J, JC, JX), "torch": (T, TC, TX)}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """This module's JAX queries must not leave the JAX package's
    process-wide query ledger full for the modules run after it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _events(i: int, n_per: int, base: int) -> dict:
    rng = np.random.default_rng(100 + i)
    k = np.arange(n_per, dtype=np.int64) + base
    return {
        "ev_k": k.tolist(),
        "ev_id": (k + 10_000_000).tolist(),  # high NDV, clustered: bloom
        "ev_cat": (k // (N // 8)).tolist(),  # low NDV, clustered: value list
        "ev_s": [chr(ord("a") + int(v)) for v in (k // (N // 4))],  # low-NDV strings
        "ev_v": rng.uniform(0, 100, n_per).tolist(),  # the z-region box
    }


def _write_events(src: str) -> None:
    per = N // N_FILES
    for i in range(N_FILES):
        jio.write_parquet(JBatch.from_pydict(_events(i, per, i * per)),
                          os.path.join(src, f"part-{i:02d}.parquet"))


def _session(pkg: str, warehouse: str, **conf):
    mod, C, _X = PKGS[pkg]
    conf = {C.INDEX_NUM_BUCKETS: BUCKETS, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


def _build(pkg: str, warehouse: str, src: str) -> None:
    mod = PKGS[pkg][0]
    s = _session(pkg, warehouse)
    mod.Hyperspace(s).create_index(
        s.read.parquet(src),
        mod.CoveringIndexConfig(INDEX, ["ev_k"], ["ev_id", "ev_cat", "ev_s", "ev_v"]))


def _sidecars(warehouse: str) -> dict:
    root = os.path.join(warehouse, "indexes", INDEX)
    return {os.path.relpath(p, root): p
            for p in glob.glob(os.path.join(root, "**", "_sketch.*.json"), recursive=True)}


@pytest.fixture()
def sketches_on(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_SKETCHES", "1")
    monkeypatch.setattr(jcov, "INDEX_ROW_GROUP_SIZE", RGS)
    monkeypatch.setattr(tcov, "INDEX_ROW_GROUP_SIZE", RGS)


@pytest.fixture()
def lake(tmp_path, sketches_on):
    """The events lake and the index each package built with sketches on."""
    src = str(tmp_path / "events")
    _write_events(src)
    for pkg in PKGS:
        _build(pkg, str(tmp_path / f"wh_{pkg}"), src)
    return str(tmp_path), src


# ---------------------------------------------------------------------------
# the setting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "", "0", "off", "1", "all", "bloom",
                                 "bloom, zregion", "valuelist,typo", "typo"])
def test_enabled_kinds_parse_as_in_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("HYPERSPACE_SKETCHES", raising=False)
    else:
        monkeypatch.setenv("HYPERSPACE_SKETCHES", raw)
    assert tss.enabled_kinds() == jss.enabled_kinds()
    assert tss.sketches_enabled() == jss.sketches_enabled()


def test_nothing_is_written_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("HYPERSPACE_SKETCHES", raising=False)
    src = str(tmp_path / "events")
    _write_events(src)
    for pkg in PKGS:
        _build(pkg, str(tmp_path / f"wh_{pkg}"), src)
        assert _sidecars(str(tmp_path / f"wh_{pkg}")) == {}


def test_sidecars_equal_the_jax_packages(lake):
    root, _src = lake
    jside = _sidecars(os.path.join(root, "wh_jax"))
    tside = _sidecars(os.path.join(root, "wh_torch"))
    assert sorted(tside) == sorted(jside) and len(tside) == BUCKETS
    for rel in jside:
        with open(jside[rel]) as a, open(tside[rel]) as b:
            want, got = json.load(a), json.load(b)
        assert got == want
        assert got["num_row_groups"] > 4


# ---------------------------------------------------------------------------
# kept row groups per conjunct kind
# ---------------------------------------------------------------------------

KEY = 10_000_000 + N // 2 + 17
QUERIES = {
    "bloom_eq": lambda X: X.col("ev_id") == KEY,
    "bloom_in": lambda X: X.col("ev_id").isin([KEY, KEY + 3001]),
    "valuelist_in": lambda X: X.col("ev_cat").isin([1, 6]),
    "string_eq": lambda X: X.col("ev_s") == "c",
    "zregion_range": lambda X: (X.col("ev_v") > 99.5) & (X.col("ev_cat") == 2),
    "with_sort_column": lambda X: (X.col("ev_k") < N // 2) & (X.col("ev_cat") == 5),
}


def _query(X, s, src, cond):
    return s.read.parquet(src).filter(cond(X)).select("ev_k", "ev_id", "ev_cat", "ev_s")


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_kept_row_groups_equal_the_jax_packages(q, lake, monkeypatch):
    root, src = lake
    out = {}
    for pkg, (mod, C, X) in PKGS.items():
        wh = os.path.join(root, f"wh_{pkg}")
        s = _session(pkg, wh).enable_hyperspace()
        df = _query(X, s, src, QUERIES[q])
        plan = df.optimized_plan()
        scan = [n for n in plan.preorder() if n.kind == "FileScan"][0]
        assert scan.index_info.index_name == INDEX
        assert scan.prune_spec.sketch_conjuncts
        pruning = jpr if pkg == "jax" else tpr
        row_groups, kept = pruning.rowgroup_selection(scan)
        groups = {os.path.relpath(p, wh): list(g) for p, g in (row_groups or {}).items()}
        out[pkg] = (plan.pretty().replace(wh, "<wh>"), groups,
                    sorted(os.path.relpath(f.name, wh) for f in kept),
                    sorted(zip(*df.collect().to_pydict().values())))
    assert out["torch"] == out["jax"]
    _plan, groups, kept, rows = out["torch"]
    assert groups or len(kept) < BUCKETS  # the sketch stage skipped something
    monkeypatch.setenv("HYPERSPACE_SKETCHES", "0")  # the minmax-only engine agrees
    s = _session("torch", os.path.join(root, "wh_torch"), **{TC.EXEC_TPU_ENABLED: False})
    assert sorted(zip(*_query(TX, s, src, QUERIES[q]).collect().to_pydict().values())) == rows


# ---------------------------------------------------------------------------
# broken sidecars
# ---------------------------------------------------------------------------

def _edit_sidecars(warehouse: str, edit) -> None:
    for path in _sidecars(warehouse).values():
        with open(path) as f:
            raw = json.load(f)
        text = edit(raw)
        with open(path, "w") as f:
            f.write(text if isinstance(text, str) else json.dumps(raw))


@pytest.mark.parametrize("damage", ["stale", "malformed"])
def test_a_stale_or_malformed_sidecar_keeps_every_group(damage, lake):
    root, src = lake
    kept_groups = {}
    for pkg, (mod, C, X) in PKGS.items():
        wh = os.path.join(root, f"wh_{pkg}")
        if damage == "stale":
            _edit_sidecars(wh, lambda raw: raw.update(data_size=raw["data_size"] + 1))
        else:
            _edit_sidecars(wh, lambda raw: "{not json")
        s = _session(pkg, wh).enable_hyperspace()
        df = _query(X, s, src, QUERIES["bloom_eq"])
        scan = [n for n in df.optimized_plan().preorder() if n.kind == "FileScan"][0]
        row_groups, kept = (jpr if pkg == "jax" else tpr).rowgroup_selection(scan)
        kept_groups[pkg] = (row_groups, len(kept))
        assert df.collect().to_pydict()["ev_id"] == [KEY]
        path = next(iter(_sidecars(wh).values()))
        assert (jss if pkg == "jax" else tss).load_sidecar(
            path.replace("_sketch.", "").replace(".json", "")) is None
    assert kept_groups["torch"] == kept_groups["jax"] == (None, BUCKETS)


def _clear_bloom_bits(raw: dict) -> None:
    for name, col in raw["columns"].items():
        if name.endswith("__bloom"):
            blobs = []
            for blob in col["values"]:
                bf = json.loads(blob)
                bf["bitset"] = base64.b64encode(
                    b"\x00" * len(base64.b64decode(bf["bitset"]))).decode()
                blobs.append(json.dumps(bf))
            col["values"] = blobs


def test_a_tampered_sidecar_raises_under_verify(lake, monkeypatch):
    """Every bloom bit cleared: each probe is a definite miss, a false drop
    that verify mode must catch, in both packages."""
    root, src = lake
    for pkg, (mod, C, X) in PKGS.items():
        wh = os.path.join(root, f"wh_{pkg}")
        _edit_sidecars(wh, _clear_bloom_bits)
        s = _session(pkg, wh).enable_hyperspace()
        df = _query(X, s, src, QUERIES["bloom_eq"])
        if pkg == "jax":
            monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
            with pytest.raises(JHyperspaceError, match="verify mismatch"):
                df.collect()
            monkeypatch.delenv("HYPERSPACE_PRUNE")
        else:
            monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
            with pytest.raises(HyperspaceError, match="verify mismatch"):
                _query(X, s, src, QUERIES["bloom_eq"]).collect()


# ---------------------------------------------------------------------------
# the bloom sizing knobs and the sidecar cache's counters
# ---------------------------------------------------------------------------

def test_the_bloom_knobs_size_the_sidecars_as_in_jax(tmp_path, sketches_on, monkeypatch):
    """``HYPERSPACE_SKETCH_BLOOM_FPP=0.001`` and ``_NDV=64``, read where
    the blooms are sized: both packages write the same sidecar bytes, with
    the knobs' parameters, and keep the same row groups for a point
    predicate (its estimate floored at the knob's rate alike)."""
    monkeypatch.setenv("HYPERSPACE_SKETCH_BLOOM_FPP", "0.001")
    monkeypatch.setenv("HYPERSPACE_SKETCH_BLOOM_NDV", "64")
    src = str(tmp_path / "events")
    _write_events(src)
    for pkg in PKGS:
        _build(pkg, str(tmp_path / f"wh_{pkg}"), src)
    jside = _sidecars(str(tmp_path / "wh_jax"))
    tside = _sidecars(str(tmp_path / "wh_torch"))
    assert sorted(tside) == sorted(jside) and len(tside) == BUCKETS
    for rel in jside:
        with open(jside[rel], "rb") as a, open(tside[rel], "rb") as b:
            want, got = a.read(), b.read()
        assert got == want
        blooms = [d for d in json.loads(got)["sketches"] if d["kind"] == "BloomFilterSketch"]
        assert blooms and all(d["fpp"] == 0.001 and d["expectedDistinctCountPerFile"] == 64
                              for d in blooms)
    out = {}
    for pkg, (mod, C, X) in PKGS.items():
        wh = str(tmp_path / f"wh_{pkg}")
        df = _query(X, _session(pkg, wh).enable_hyperspace(), src, QUERIES["bloom_eq"])
        scan = [n for n in df.optimized_plan().preorder() if n.kind == "FileScan"][0]
        row_groups, kept = (jpr if pkg == "jax" else tpr).rowgroup_selection(scan)
        out[pkg] = ({os.path.relpath(p, wh): list(g) for p, g in (row_groups or {}).items()},
                    sorted(os.path.relpath(f.name, wh) for f in kept),
                    scan.prune_spec.sketch_fraction, df.collect().to_pydict()["ev_id"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] and out["torch"][3] == [KEY]
    # the estimate's floor is the knob's rate: one key of a billion
    stats = ({"ev_id": 10**9}, RGS)
    floors = [pr._ndv_sketch_fraction([QUERIES["bloom_eq"](X)], stats, INDEX)
              for pr, X in ((jpr, JX), (tpr, TX))]
    assert floors == [0.001, 0.001]


SKETCH_COUNTERS = ("hits", "misses", "evictions", "evicted_bytes")


def _sketch_counters(registry) -> dict:
    snap = {n: v for n, _kind, v in registry.export()}
    return {c: snap.get(f"cache.sketch.{c}", 0) for c in SKETCH_COUNTERS}


@pytest.mark.parametrize("budget_mb", [None, "0"])
def test_sketch_cache_counters_equal_the_jax_packages(budget_mb, lake, monkeypatch):
    """The same sequence of sketch-pruned queries (each run twice, so the
    second reads the cache) in each package: the ``cache.sketch.*`` deltas
    of every query are equal, at the default budget and at
    ``HYPERSPACE_SKETCH_CACHE_MB=0`` (the cache bypassed: no counts). Each
    package sizes its cache at import, so the test sets the knob and the
    two caches' budgets together."""
    from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
    from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG

    root, src = lake
    caches = {"jax": jss._SIDECAR_CACHE, "torch": tss._SIDECAR_CACHE}
    if budget_mb is not None:
        monkeypatch.setenv("HYPERSPACE_SKETCH_CACHE_MB", budget_mb)
        for cache in caches.values():
            monkeypatch.setattr(cache, "max_bytes", int(budget_mb) << 20)
    registries = {"jax": JREG, "torch": TREG}
    deltas: dict = {"jax": [], "torch": []}
    for pkg, (mod, C, X) in PKGS.items():
        caches[pkg].clear()
        s = _session(pkg, os.path.join(root, f"wh_{pkg}")).enable_hyperspace()
        for q in ("bloom_eq", "valuelist_in", "bloom_eq", "zregion_range", "valuelist_in"):
            before = _sketch_counters(registries[pkg])
            _query(X, s, src, QUERIES[q]).collect()
            after = _sketch_counters(registries[pkg])
            deltas[pkg].append((q, {c: after[c] - before[c] for c in SKETCH_COUNTERS}))
    assert deltas["torch"] == deltas["jax"]
    total = {c: sum(d[c] for _q, d in deltas["torch"]) for c in SKETCH_COUNTERS}
    if budget_mb is None:
        assert total["misses"] == BUCKETS and total["hits"] > 0
        assert tss._SIDECAR_CACHE.check_consistency()
    else:
        assert not any(total.values())


# ---------------------------------------------------------------------------
# ranking and vacuum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", ["bloom_eq", "valuelist_in", "string_eq", "zregion_range"])
def test_the_rankers_scan_fraction_equals_the_jax_packages(q, lake):
    root, _src = lake
    fractions = {}
    for pkg, (mod, C, X) in PKGS.items():
        s = _session(pkg, os.path.join(root, f"wh_{pkg}"))
        if pkg == "jax":
            from hyperspace_tpu.index_manager import index_manager_for as jimf

            entry = [e for e in jimf(s).get_indexes() if e.name == INDEX][0]
            fractions[pkg] = jpr.estimate_scan_fraction(QUERIES[q](X), entry)
        else:
            entry = [e for e in index_manager_for(s).get_indexes() if e.name == INDEX][0]
            fractions[pkg] = tpr.estimate_scan_fraction(QUERIES[q](X), entry)
    assert fractions["torch"] == fractions["jax"]
    if q == "bloom_eq":  # one id in 512-row groups of a high-NDV column
        assert fractions["torch"] < 1.0


def test_vacuum_keeps_the_sidecars_of_referenced_files(lake):
    """A file appended, a full refresh to a new version, then
    vacuum-outdated: the old version's files and sidecars go, the new ones
    stay, in both."""
    root, src = lake
    jio.write_parquet(JBatch.from_pydict(_events(9, 500, N)),
                      os.path.join(src, "part-09.parquet"))
    left = {}
    for pkg, (mod, C, X) in PKGS.items():
        wh = os.path.join(root, f"wh_{pkg}")
        hs = mod.Hyperspace(_session(pkg, wh))
        hs.refresh_index(INDEX, "full")
        hs.vacuum_outdated_index(INDEX)
        base = os.path.join(wh, "indexes", INDEX)
        left[pkg] = sorted(os.path.relpath(p, base) for p in
                           glob.glob(os.path.join(base, "v__=*", "**"), recursive=True)
                           if os.path.isfile(p))
    assert left["torch"] == left["jax"]
    data = [p for p in left["torch"] if p.endswith(".parquet")]
    assert data and all(p.startswith("v__=1") for p in data)
    for p in data:
        d, f = os.path.split(p)
        assert os.path.join(d, f"_sketch.{f}.json") in left["torch"]
