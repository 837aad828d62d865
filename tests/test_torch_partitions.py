"""Hive-partitioned sources, the port against the JAX package on the same
lake (a mirror of tests/test_partitioned_sources.py).

- ``utils/partitions``: the parsed values, the inferred fields (int64 when
  every value is an integer, else string; none when files disagree) and
  the partition keys, on a table of paths and roots.
- Scans of a ``year=/region=`` lake (numpy seed per file): the schema with
  the partition columns after the files' own, grouped and filtered
  results, the files each package's parquet reader is asked for under a
  partition filter (a partition the filter rules out is never read), a
  projection of partition columns alone (footer row counts, no read), and
  the device tier's route over the raw partitioned scan (the fragment on
  the device, not the streamed route: the scan attaches constant columns
  per partition), with the device tiers of both packages on.
- Indexes over it: a covering index with a partition column included and
  a data-skipping index with its automatic PartitionSketch, built by each
  package in the same warehouse: index files byte for byte and log
  entries (less wall-clock fields) equal; the files a disjunction over a
  partition and a data column keeps; a full refresh over a new partition
  directory; each package reading the other's index.

Counts and keys exact, float sums within relative 1e-4.
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
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.utils import partitions as jpart
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.utils import partitions as tpart

PKGS = {"jax": (J, JC, JX, jio), "torch": (T, TC, TX, tio)}
REL = 1e-4
ROWS = 60


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger of 256
    entries; the module empties it when it is done, so the files a test
    worker runs after it find room in it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _session(pkg: str, warehouse: str, device: bool = False, **conf):
    mod, C, _X, _io = PKGS[pkg]
    conf = {C.EXEC_TPU_ENABLED: device, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


MTIME_NS = 1_700_000_000 * 10**9  # one fixed mtime: signatures hash it


def _write_partition(src: str, year: int, region: str, seed: int, n: int = ROWS) -> None:
    rng = np.random.default_rng(seed)
    d = os.path.join(src, f"year={year}", f"region={region}")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "part-0.parquet")
    pq.write_table(pa.table({
        "amount": rng.uniform(0, 100, n),
        "item": rng.choice([f"i{i}" for i in range(12)], n),
        "qty": rng.integers(0, 50, n),
    }), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))


@pytest.fixture()
def lake(tmp_path):
    src = str(tmp_path / "sales")
    seed = 0
    for year in (2020, 2021):
        for region in ("eu", "us"):
            seed += 1
            _write_partition(src, year, region, seed)
    return src


def _sorted_rows(d: dict, keys) -> list:
    cols = list(d)
    rows = list(zip(*(d[c] for c in cols)))
    idx = [cols.index(k) for k in keys]
    return sorted(rows, key=lambda r: tuple(r[i] for i in idx))


def _assert_rows_match(got: dict, want: dict, keys) -> None:
    assert list(got) == list(want)
    g, w = _sorted_rows(got, keys), _sorted_rows(want, keys)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=REL)
            else:
                assert x == y


# ---------------------------------------------------------------------------
# utils/partitions
# ---------------------------------------------------------------------------

PATH_CASES = [
    ("/d/year=2020/region=eu/f.parquet", None),
    ("/d/year=2020/region=eu/f.parquet", ["/d"]),
    ("/run=3/table/f.parquet", ["/run=3/table"]),
    ("/t/date=2024.parquet", ["/t"]),
    ("/d/_tmp=1/k=v/f.parquet", ["/d"]),
    ("/d/=x/k=a=b/f.parquet", ["/d"]),
    ("/d/a/year=1/f.parquet", ["/d", "/d/a"]),
    ("/elsewhere/k=1/f.parquet", ["/d"]),
]


@pytest.mark.parametrize("path,roots", PATH_CASES)
def test_parse_partition_values_match_jax(path, roots):
    assert tpart.parse_partition_values(path, roots) == jpart.parse_partition_values(path, roots)
    keys = ["year", "region", "k"]
    assert tpart.partition_key(path, keys, roots) == jpart.partition_key(path, keys, roots)


FIELD_CASES = [
    ["/d/year=2020/region=eu/a.parquet", "/d/year=2021/region=us/b.parquet"],
    ["/d/year=1/a.parquet", "/d/b.parquet"],
    ["/d/year=1/a.parquet", "/d/year=x/b.parquet"],
    ["/d/a=1/b=2/f.parquet", "/d/b=2/a=1/f.parquet"],
    ["/d/n=-7/f.parquet", "/d/n=+3/g.parquet"],
    [],
]


@pytest.mark.parametrize("paths", FIELD_CASES)
def test_infer_partition_fields_match_jax(paths):
    got = [(f.name, f.dtype) for f in tpart.infer_partition_fields(paths, ["/d"])]
    want = [(f.name, f.dtype) for f in jpart.infer_partition_fields(paths, ["/d"])]
    assert got == want


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _scan_queries(X):
    c = X.col
    return {
        "by_partition": lambda df: df.group_by("year", "region").agg(
            X.Count(X.lit(1)).alias("n"), X.Sum(c("amount")).alias("s")),
        "partition_filter": lambda df: df.filter(
            (c("year") == 2021) & (c("region") == "us")).agg(
            X.Count(X.lit(1)).alias("n"), X.Sum(c("amount")).alias("s")),
        "mixed_filter": lambda df: df.filter(
            (c("year") == 2020) & (c("amount") > 40.0)).select("amount", "region", "qty"),
        "by_item": lambda df: df.filter(c("region") == "eu").group_by("item").agg(
            X.Sum(c("qty")).alias("q"), X.Count(X.lit(1)).alias("n")),
    }


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("q", ["by_partition", "partition_filter", "mixed_filter", "by_item"])
def test_partitioned_scans_match_jax(lake, tmp_path, q, device):
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), device=device)
        df = s.read.parquet(lake)
        out[pkg] = (df.columns, [f.dtype for f in df.schema],
                    _scan_queries(PKGS[pkg][2])[q](df).to_pydict())
    assert out["torch"][:2] == out["jax"][:2]
    assert out["torch"][0] == ["amount", "item", "qty", "year", "region"]
    keys = {"by_partition": ["year", "region"], "partition_filter": ["n"],
            "mixed_filter": ["amount"], "by_item": ["item"]}[q]
    _assert_rows_match(out["torch"][2], out["jax"][2], keys)


def _spy_reads(monkeypatch, io_mod, pkg):
    reads = []
    orig = io_mod.read_parquet

    def spy(paths, *a, **kw):
        reads.extend(paths)
        return orig(paths, *a, **kw)

    monkeypatch.setattr(io_mod, "read_parquet", spy)
    return reads


def test_partition_filter_skips_reads_as_jax(lake, tmp_path, monkeypatch):
    files = {}
    for pkg in PKGS:
        X, io_mod = PKGS[pkg][2], PKGS[pkg][3]
        reads = _spy_reads(monkeypatch, io_mod, pkg)
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        df = s.read.parquet(lake)
        out = df.filter(X.col("year") == 2020).select("amount", "year").collect()
        files[pkg] = (sorted(os.path.relpath(p, lake) for p in reads), out.num_rows)
    assert files["torch"] == files["jax"]
    assert all(p.startswith("year=2020") for p in files["torch"][0])
    assert len(files["torch"][0]) == 2


def test_partition_only_projection_reads_footers_only(lake, tmp_path, monkeypatch):
    out = {}
    for pkg in PKGS:
        X, io_mod = PKGS[pkg][2], PKGS[pkg][3]
        reads = _spy_reads(monkeypatch, io_mod, pkg)
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        res = s.read.parquet(lake).select("year").group_by("year").agg(
            X.Count(X.lit(1)).alias("n")).to_pydict()
        out[pkg] = (sorted(zip(res["year"], res["n"])), list(reads))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == []


def test_device_route_over_a_raw_partitioned_scan(lake, tmp_path):
    """The JAX device tier takes the fragment over the partitioned scan
    (monolithic: no stream attaches partition columns); so does the
    port's, with the same groups."""
    from hyperspace_tpu.telemetry.metrics import REGISTRY

    got = {}
    for pkg in PKGS:
        X = PKGS[pkg][2]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), device=True)
        q = s.read.parquet(lake).filter(X.col("region") == "us").group_by("year").agg(
            X.Sum(X.col("amount")).alias("s"), X.Count(X.lit(1)).alias("n"))
        if pkg == "jax":
            before = REGISTRY.counter("pipeline.queries").value
            got[pkg] = q.to_pydict()
            assert REGISTRY.counter("pipeline.queries").value == before
        else:
            got[pkg] = q.to_pydict()
            assert s.device_stats.device_fragments == 1
            assert s.device_stats.pipelined_queries == 0
            assert not s.device_stats.declines
    _assert_rows_match(got["torch"], got["jax"], ["year"])


def test_partition_scan_is_not_streamable(lake, tmp_path):
    from hyperspace_tpu.plan.executor import scan_streamable as jstream
    from hyperspace_tpu_torch.plan.executor import scan_streamable as tstream

    for pkg, fn in (("jax", jstream), ("torch", tstream)):
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        scan = s.read.parquet(lake).plan
        assert fn(scan) is False
        assert fn(scan.copy(partition_columns=[])) is True


def test_ancestor_and_file_name_equals_make_no_column(tmp_path):
    for pkg in PKGS:
        mod, _C, _X, io_mod = PKGS[pkg]
        root = tmp_path / pkg / "run=3" / "table"
        batch = mod.columnar.table.ColumnBatch.from_pydict({"a": [1, 2]})
        io_mod.write_parquet(batch, str(root / "date=2024.parquet"))
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        assert s.read.parquet(str(root)).columns == ["a"]


# ---------------------------------------------------------------------------
# indexes
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
            rel = os.path.relpath(p, warehouse)
            with open(p, "rb") as f:
                raw = f.read()
            out[rel] = _strip(json.loads(raw)) if "_hyperspace_log" in rel else raw
    return out


def _build(pkg, warehouse, lake, refresh_with=None):
    mod = PKGS[pkg][0]
    s = _session(pkg, warehouse)
    hs = mod.Hyperspace(s)
    df = s.read.parquet(lake)
    hs.create_index(df, mod.CoveringIndexConfig("pidx", ["item"], ["amount", "year"]))
    hs.create_index(df, mod.DataSkippingIndexConfig("ds", [mod.MinMaxSketch("amount")]))
    if refresh_with is not None:
        refresh_with()
        hs.refresh_index("pidx", "full")
        hs.refresh_index("ds", "full")
    return s, hs


@pytest.mark.parametrize("refresh", [False, True])
def test_indexes_over_a_partitioned_lake_are_the_jax_packages(lake, tmp_path, refresh):
    """Both packages build (and refresh, after a new year=2022 partition
    appears) the same index files and log entries in one warehouse."""
    wh = str(tmp_path / "wh")
    captured = {}
    for pkg in PKGS:
        shutil.rmtree(wh, ignore_errors=True)
        extra = os.path.join(lake, "year=2022")
        shutil.rmtree(extra, ignore_errors=True)
        _build(pkg, wh, lake,
               (lambda: _write_partition(lake, 2022, "eu", 99)) if refresh else None)
        captured[pkg] = _capture(wh)
    assert sorted(captured["torch"]) == sorted(captured["jax"])
    for k in captured["jax"]:
        assert captured["torch"][k] == captured["jax"][k], k
    assert any(k.startswith(os.path.join("indexes", "ds", "v__=")) for k in captured["torch"])


def test_partition_sketch_prunes_a_disjunction_as_jax(lake, tmp_path):
    out = {}
    for pkg in PKGS:
        mod, _C, X, _io = PKGS[pkg]
        s, _hs = _build(pkg, str(tmp_path / f"wh_{pkg}"), lake)
        e = _hs.get_index("ds")
        kinds = sorted(type(k).__name__ for k in e.derived_dataset.sketches)
        s.enable_hyperspace()
        q = s.read.parquet(lake).filter((X.col("year") == 2021) | (X.col("amount") < -1.0))
        scans = [n for n in q.optimized_plan().preorder() if type(n).__name__ == "FileScan"]
        out[pkg] = (kinds, [sorted(os.path.relpath(f.name, lake) for f in n.files)
                            for n in scans], q.count())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["MinMaxSketch", "PartitionSketch", "PartitionSketch"]
    assert all(p.startswith("year=2021") for p in out["torch"][1][0])


def test_auto_partition_sketch_can_be_turned_off(lake, tmp_path):
    for pkg in PKGS:
        mod, C, _X, _io = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"),
                     **{C.DATASKIPPING_AUTO_PARTITION_SKETCH: False})
        hs = mod.Hyperspace(s)
        hs.create_index(s.read.parquet(lake),
                        mod.DataSkippingIndexConfig("ds", [mod.MinMaxSketch("amount")]))
        kinds = [type(k).__name__ for k in hs.get_index("ds").derived_dataset.sketches]
        assert kinds == ["MinMaxSketch"], pkg


@pytest.mark.parametrize("builder,reader", [("jax", "torch"), ("torch", "jax")])
def test_each_package_queries_the_others_partitioned_index(lake, tmp_path, builder, reader):
    wh = str(tmp_path / "wh")
    _build(builder, wh, lake)
    want = {}
    for pkg, on in ((reader, True), ("jax", False)):
        X = PKGS[pkg][2]
        s = _session(pkg, wh)
        if on:
            s.enable_hyperspace()
        else:
            s.disable_hyperspace()
        q = s.read.parquet(lake).filter(X.col("item") == "i3").select("item", "amount", "year")
        used = [n.index_info.index_name for n in q.optimized_plan().preorder()
                if getattr(n, "index_info", None) is not None]
        want[on] = (used, q.to_pydict())
    assert want[True][0] == ["pidx"]
    _assert_rows_match(want[True][1], want[False][1], ["amount", "year"])
