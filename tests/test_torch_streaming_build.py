"""Out-of-core index builds: the port against the JAX package.

A lake of eight parquet files (500 rows each, numpy seed per file) is
indexed with ``hyperspace.tpu.build.maxBytesInMemory`` set to about three
files' bytes, so each build streams in file groups. Each package in turn
runs the same step from the same state (the warehouse is restored between
them): a covering create (runs ``part-0-b<bucket>-<seq>``), a z-order
create over one and over two indexed columns (two passes; runs
``part-0-z<range>-<group>``), a full refresh, an incremental refresh with
deleted files (lineage: each old file rewritten alone) and one with
appended files only. The files the two write must be byte for byte the
same and the log entries equal less their wall-clock fields; each package
then queries the result and gets the raw source's answer (counts exact,
float sums within relative 1e-4). Optimize compacts a streamed bucket's
runs into one sorted file.
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
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": (J, JC, JX), "torch": (T, TC, TX)}
ROWS = 500
FILES = 8
REL = 1e-4
NAME = "st"
ZTARGET = 16 * 1024  # source bytes per z-order range


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """Keep the JAX package's process-wide query ledger from filling up
    for the test files a worker runs after this one."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _write(lake: str, i: int, salt: int = 0) -> None:
    rng = np.random.default_rng(1000 * salt + i)
    pq.write_table(pa.table({
        "k": rng.integers(0, 400, ROWS),
        "a": rng.integers(-50, 50, ROWS).astype(np.int32),
        "v": rng.uniform(0, 100, ROWS),
        "s": rng.choice(["a", "bb", "ccc", "dddd"], ROWS),
    }), os.path.join(lake, f"f{i:03d}.parquet"))


def _lake(root) -> str:
    lake = os.path.join(str(root), "lake", "t")
    os.makedirs(lake, exist_ok=True)
    for i in range(FILES):
        _write(lake, i)
    return lake


def _limit(lake: str) -> int:
    """About three source files' bytes: every build streams in groups."""
    return 3 * os.path.getsize(os.path.join(lake, "f000.parquet")) + 100


def _session(pkg: str, warehouse: str, limit: int, lineage: bool = True,
             quantile: bool = False):
    mod, C, _X = PKGS[pkg]
    conf = {C.INDEX_LINEAGE_ENABLED: lineage, C.BUILD_MAX_BYTES_IN_MEMORY: limit,
            C.ZORDER_TARGET_SOURCE_BYTES_PER_PARTITION: ZTARGET,
            C.ZORDER_QUANTILE_ENABLED: quantile}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


# kind: (config class name, indexed, included)
KINDS = {
    "ci": ("CoveringIndexConfig", ["k"], ["v", "s"]),
    "zci": ("ZOrderCoveringIndexConfig", ["k"], ["v", "s"]),
    "zci2": ("ZOrderCoveringIndexConfig", ["k", "a"], ["v"]),
}


def _create(pkg, warehouse, lake, kind, limit, lineage=True, quantile=False):
    cls, indexed, included = KINDS[kind]
    s = _session(pkg, warehouse, limit, lineage, quantile)
    PKGS[pkg][0].Hyperspace(s).create_index(
        s.read.parquet(lake), getattr(PKGS[pkg][0], cls)(NAME, indexed, included))


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
            rel = os.path.relpath(p, warehouse)
            with open(p, "rb") as f:
                raw = f.read()
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


def _data_files(captured: dict) -> list:
    return sorted(os.path.basename(k) for k in captured
                  if "_hyperspace_log" not in k and k.endswith(".parquet"))


def _queries(X, lake):
    def base(s):
        return s.read.parquet(lake)

    return {
        "range": lambda s: base(s).filter((X.col("k") >= 40) & (X.col("k") < 160)).agg(
            X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n")),
        "point": lambda s: base(s).filter(X.col("k") == 7).agg(
            X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n")),
    }


def _check_queries(warehouse, lake, limit, lineage=True):
    """Each package reads the index in the warehouse and gets the raw
    source's answer."""
    raw = J.HyperspaceSession(os.path.join(os.path.dirname(lake), "raw_wh"))
    raw.disable_hyperspace()
    want = {q: fn(raw).to_pydict() for q, fn in _queries(JX, lake).items()}
    for pkg in ("jax", "torch"):
        s = _session(pkg, warehouse, limit, lineage)
        s.enable_hyperspace()
        for q, fn in _queries(PKGS[pkg][2], lake).items():
            df = fn(s)
            used = {n.index_info.index_name for n in df.optimized_plan().preorder()
                    if getattr(n, "index_info", None) is not None}
            assert used == {NAME}, (pkg, q)
            got = df.to_pydict()
            assert got["n"] == want[q]["n"], (pkg, q)
            for g, w in zip(got["sv"], want[q]["sv"]):
                assert g == pytest.approx(w, rel=REL), (pkg, q)


def _both(warehouse: str, snapshot: str | None, step) -> dict:
    """Run ``step(pkg)`` once per package from the same warehouse state;
    the captured warehouses, by package (the port's result stays)."""
    captured = {}
    for pkg in ("jax", "torch"):
        if snapshot is None:
            shutil.rmtree(warehouse, ignore_errors=True)
        else:
            shutil.rmtree(warehouse)
            shutil.copytree(snapshot, warehouse)
        step(pkg)
        captured[pkg] = _capture(warehouse)
    assert sorted(captured["jax"]) == sorted(captured["torch"])
    for k in sorted(captured["jax"]):
        assert captured["jax"][k] == captured["torch"][k], k
    return captured


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_streamed_create_writes_the_jax_packages_files(tmp_path, kind):
    lake = _lake(tmp_path)
    limit = _limit(lake)
    warehouse = str(tmp_path / "wh")
    captured = _both(warehouse, None, lambda pkg: _create(pkg, warehouse, lake, kind, limit))
    files = _data_files(captured["torch"])
    # three file groups: runs -0, -1 and -2
    assert {f.rsplit("-", 1)[1].split(".")[0] for f in files} == {"0", "1", "2"}
    if kind != "ci":
        assert len({f.split("-")[2] for f in files}) > 1  # several z ranges
    _check_queries(warehouse, lake, limit)


def test_in_memory_under_the_limit(tmp_path):
    """At the default limit the same lake builds in memory: one file per
    bucket, no run suffix, as before."""
    lake = _lake(tmp_path)
    warehouse = str(tmp_path / "wh")
    captured = _both(warehouse, None, lambda pkg: _create(
        pkg, warehouse, lake, "ci", TC.BUILD_MAX_BYTES_IN_MEMORY_DEFAULT))
    files = _data_files(captured["torch"])
    assert files and all(f.count("-") == 2 for f in files)


def _delete_and_append(lake: str, deletes: bool) -> None:
    _write(lake, FILES, salt=7)
    _write(lake, FILES + 1, salt=7)
    if deletes:
        os.unlink(os.path.join(lake, "f001.parquet"))
        os.unlink(os.path.join(lake, "f005.parquet"))


# step: (lake change, refresh mode)
REFRESHES = {
    "full": (True, "full"),
    "incremental_deletes": (True, "incremental"),
    "incremental_appends": (False, "incremental"),
}


@pytest.mark.parametrize("refresh", sorted(REFRESHES))
def test_streamed_refresh_writes_the_jax_packages_files(tmp_path, refresh):
    lake = _lake(tmp_path)
    limit = _limit(lake)
    warehouse = str(tmp_path / "wh")
    _create("jax", warehouse, lake, "ci", limit)
    deletes, mode = REFRESHES[refresh]
    _delete_and_append(lake, deletes)
    snapshot = str(tmp_path / "snapshot")
    shutil.copytree(warehouse, snapshot)

    def step(pkg):
        PKGS[pkg][0].Hyperspace(_session(pkg, warehouse, limit)).refresh_index(NAME, mode)

    captured = _both(warehouse, snapshot, step)
    new = [k for k in captured["torch"] if "v__=1" in k and k.endswith(".parquet")]
    assert new and all("-b" in k for k in new)
    if refresh == "incremental_deletes":
        # each old file rewritten alone: as many runs as the index had files
        # (three groups' runs per bucket) plus the appended group's
        seqs = {os.path.basename(k).rsplit("-", 1)[1].split(".")[0] for k in new}
        assert len(seqs) > 3
    _check_queries(warehouse, lake, limit)


# a quantile z-order index: (build limit: streamed or in memory, the refresh
# run after a create of JAX's and a lake change, or None)
QUANTILE_STEPS = {
    "in_memory": (False, None),
    "streamed": (True, None),
    "refreshed_incremental": (False, "incremental"),
    "refreshed_full": (False, "full"),
}


@pytest.mark.parametrize("step", sorted(QUANTILE_STEPS))
def test_quantile_zorder_builds_write_the_jax_packages_files(tmp_path, step):
    """``hyperspace.index.zorder.quantile.enabled`` and a small
    ``targetSourceBytesPerPartition`` steer both packages' z-order builds
    alike: percentile fields and several parts, in memory, streamed, and
    through an incremental (deleted and appended files) and a full
    refresh, whose writes read both keys again."""
    lake = _lake(tmp_path)
    streamed, mode = QUANTILE_STEPS[step]
    limit = _limit(lake) if streamed else TC.BUILD_MAX_BYTES_IN_MEMORY_DEFAULT
    warehouse = str(tmp_path / "wh")
    if mode is None:
        captured = _both(warehouse, None, lambda pkg: _create(
            pkg, warehouse, lake, "zci2", limit, quantile=True))
        version = "v__=0"
    else:
        _create("jax", warehouse, lake, "zci2", limit, quantile=True)
        _delete_and_append(lake, deletes=True)
        snapshot = str(tmp_path / "snapshot")
        shutil.copytree(warehouse, snapshot)
        captured = _both(warehouse, snapshot, lambda pkg: PKGS[pkg][0].Hyperspace(
            _session(pkg, warehouse, limit, quantile=True)).refresh_index(NAME, mode))
        version = "v__=1"
    files = [k for k in _data_files(captured["torch"])
             if any(version in p and p.endswith(k) for p in captured["torch"])]
    assert len(files) > 1
    entries = [v for k, v in captured["torch"].items() if "_hyperspace_log" in k
               and k.rsplit(os.sep, 1)[1].isdigit() and v.get("derivedDataset")]
    kinds = {f["kind"] for e in entries
             for f in e["derivedDataset"]["properties"]["zOrderFields"]}
    assert kinds == {"percentile"}
    _check_queries(warehouse, lake, limit)


def test_each_package_reads_the_others_streamed_zorder_index(tmp_path):
    lake = _lake(tmp_path)
    limit = _limit(lake)
    for builder in ("jax", "torch"):
        warehouse = str(tmp_path / f"wh_{builder}")
        _create(builder, warehouse, lake, "zci2", limit)
        _check_queries(warehouse, lake, limit)


def test_optimize_compacts_streamed_runs(tmp_path):
    lake = _lake(tmp_path)
    limit = _limit(lake)
    warehouse = str(tmp_path / "wh")
    _create("torch", warehouse, lake, "ci", limit)
    hs = T.Hyperspace(_session("torch", warehouse, limit))
    files = hs.get_index(NAME).content.files()
    by_bucket: dict = {}
    for f in files:
        by_bucket.setdefault(os.path.basename(f).split("-")[2], []).append(f)
    assert max(len(v) for v in by_bucket.values()) == 3  # one run per group
    hs.optimize_index(NAME)
    files = hs.get_index(NAME).content.files()
    assert len(files) == len(by_bucket) and all("v__=1" in f for f in files)
    for f in files:
        k = pq.read_table(f, columns=["k"]).column("k").to_numpy()
        assert (np.diff(k) >= 0).all()
    _check_queries(warehouse, lake, limit)
