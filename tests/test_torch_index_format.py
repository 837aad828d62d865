"""Index conf keys, the port against the JAX package on the same inputs
(the counterparts of tests/test_index_format.py).

- ``hyperspace.tpu.index.format = arrow``: covering and z-order indexes as
  Arrow IPC files, byte for byte the JAX package's; a refresh under the
  parquet setting leaves a mixed layout that still reads; optimize keeps
  the arrow extension; parquet and arrow string files concatenate; an
  integer sum over an arrow index on the port's device tier; an arrow
  index built by each package read by the other, through the same kernels
  (their plain versions, on this CPU) as the parquet index;
- ``hyperspace.index.filterRule.useBucketSpec``: with the key set the
  filter rule's index scan carries the bucket spec, and the optimized
  plans and results equal the JAX package's, for a filtered aggregate and
  for a join on the bucket key (the port once ignored the key).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar import io as JIO
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar import io as TIO
from hyperspace_tpu_torch.columnar.table import ColumnBatch as TBatch
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": {"mod": J, "C": JC, "X": JX, "io": JIO, "Batch": JBatch},
        "torch": {"mod": T, "C": TC, "X": TX, "io": TIO, "Batch": TBatch}}
MTIME_NS = 1_700_000_000 * 10**9


@pytest.fixture(scope="module", autouse=True)
def _empty_the_query_ledgers():
    yield
    for p in PKGS.values():
        p["mod"].telemetry.attribution.LEDGER.reset_for_testing()


def _write(path: str, table: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(table), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))
    return path


def _lake(root) -> str:
    n = 2000
    i = np.arange(n)
    _write(os.path.join(str(root), "t", "part-0.parquet"), {
        "k": i % 40, "v": i.astype(np.float64), "s": [f"tag-{x % 7}" for x in i],
        "d": (i * 13) % 365,
    })
    return os.path.join(str(root), "t")


def _session(pkg: str, ws: str, **conf):
    p = PKGS[pkg]
    full = {p["C"].INDEX_NUM_BUCKETS: 4, **conf}
    if pkg == "torch":
        return p["mod"].HyperspaceSession(ws, conf=full, device="cpu")
    return p["mod"].HyperspaceSession(ws, conf=full)


def _tree(ws: str) -> dict:
    out = {}
    root = os.path.join(ws, "indexes")
    for dirpath, _dirs, names in os.walk(root):
        if "_hyperspace_log" in dirpath:
            continue
        for fn in names:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), root)] = f.read()
    return out


def _plain(d: dict) -> dict:
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in d.items()}


def _index_scans(plan) -> list:
    return [n for n in plan.preorder() if n.kind == "FileScan" and n.index_info is not None]


def _point_q(pkg: str, s, src: str):
    X = PKGS[pkg]["X"]
    return s.read.parquet(src).filter(X.col("k") == 7).group_by("k").agg(
        X.Sum(X.col("v")).alias("sv"))


def _range_q(pkg: str, s, src: str):
    X = PKGS[pkg]["X"]
    return s.read.parquet(src).filter((X.col("d") >= 10) & (X.col("d") < 50)).agg(
        X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"))


def _raw(s, df_fn) -> dict:
    s.disable_hyperspace()
    try:
        return _plain(df_fn().collect().to_pydict())
    finally:
        s.enable_hyperspace()


def test_conf_validation_and_extension():
    s = T.HyperspaceSession("/nonexistent-warehouse", conf={TC.INDEX_FORMAT: "feather"},
                            device="cpu")
    with pytest.raises(HyperspaceError):
        s.conf.index_format
    assert T.HyperspaceSession("/nonexistent-warehouse", conf={TC.INDEX_FORMAT: "ARROW"},
                               device="cpu").conf.index_format == "arrow"
    assert TIO.index_file_ext("arrow") == JIO.index_file_ext("arrow") == ".arrow"
    assert TIO.index_file_ext("parquet") == JIO.index_file_ext("parquet") == ".parquet"


@pytest.mark.parametrize("kind", ["covering", "zorder"])
def test_arrow_index_files_equal_the_jax_packages(tmp_path, kind):
    src = _lake(tmp_path)
    trees, results = {}, {}
    for pkg in PKGS:
        M, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
        ws = str(tmp_path / pkg)
        s = _session(pkg, ws, **{C.INDEX_FORMAT: "arrow"})
        hs = M.Hyperspace(s)
        cfg = (M.CoveringIndexConfig("ix", ["k"], ["v", "s"]) if kind == "covering"
               else M.ZOrderCoveringIndexConfig("ix", ["d"], ["v", "s"]))
        hs.create_index(s.read.parquet(src), cfg)
        files = hs.get_index("ix").content.files()
        assert files and all(f.endswith(".arrow") for f in files)
        s.enable_hyperspace()
        q = _point_q if kind == "covering" else _range_q
        assert _index_scans(q(pkg, s, src).optimized_plan())
        results[pkg] = _plain(q(pkg, s, src).collect().to_pydict())
        assert results[pkg] == _raw(s, lambda: q(pkg, s, src))
        trees[pkg] = _tree(ws)
    assert trees["torch"] == trees["jax"]
    assert results["torch"] == results["jax"]


def test_zorder_mixed_refresh_reads_both_extensions(tmp_path):
    """An arrow z-order index refreshed under the parquet setting holds both
    extensions; its queries still equal the raw scan, in both packages, and
    the files equal the JAX package's."""
    src = _lake(tmp_path)
    extra = {"k": [1, 2], "v": [10.5, 11.5], "s": ["tag-1", "tag-2"], "d": [10, 11]}
    trees = {}
    for pkg in PKGS:
        M, C = PKGS[pkg]["mod"], PKGS[pkg]["C"]
        ws = str(tmp_path / pkg)
        lake = str(tmp_path / f"lake_{pkg}")
        os.makedirs(lake)
        for fn in os.listdir(src):
            os.link(os.path.join(src, fn), os.path.join(lake, fn))
        s = _session(pkg, ws, **{C.INDEX_FORMAT: "arrow"})
        hs = M.Hyperspace(s)
        hs.create_index(s.read.parquet(lake), M.ZOrderCoveringIndexConfig("z", ["d"], ["v", "s"]))
        _write(os.path.join(lake, "part-1.parquet"), extra)
        s.set_conf(C.INDEX_FORMAT, "parquet")
        hs.refresh_index("z", "incremental")
        exts = {os.path.splitext(f)[1] for f in hs.get_index("z").content.files()}
        assert exts == {".arrow", ".parquet"}
        s.enable_hyperspace()
        got = _plain(_range_q(pkg, s, lake).collect().to_pydict())
        assert got == _raw(s, lambda: _range_q(pkg, s, lake))
        trees[pkg] = {os.path.basename(k): v for k, v in _tree(ws).items()}
    assert trees["torch"] == trees["jax"]


def test_optimize_keeps_arrow_buckets(tmp_path):
    src = _lake(tmp_path)
    _write(os.path.join(src, "part-2.parquet"),
           {"k": [3] * 5, "v": [1.0] * 5, "s": ["tag-0"] * 5, "d": [1] * 5})
    for pkg in PKGS:
        M, C, X = PKGS[pkg]["mod"], PKGS[pkg]["C"], PKGS[pkg]["X"]
        s = _session(pkg, str(tmp_path / pkg), **{C.INDEX_FORMAT: "arrow"})
        hs = M.Hyperspace(s)
        s2 = _session(pkg, str(tmp_path / pkg), **{C.INDEX_FORMAT: "arrow"})
        hs.create_index(s.read.parquet(os.path.join(src, "part-0.parquet")),
                        M.CoveringIndexConfig("ci", ["k"], ["v"]))
        hs.append("ci", s2.read.parquet(os.path.join(src, "part-2.parquet")))
        n_before = len(hs.get_index("ci").content.files())
        hs.optimize_index("ci", "full")
        files = hs.get_index("ci").content.files()
        assert len(files) <= n_before and all(f.endswith(".arrow") for f in files)
        s.enable_hyperspace()
        q = lambda: s.read.parquet(src).filter(X.col("k") == 3).agg(X.Sum(X.col("v")).alias("sv"))
        assert _plain(q().collect().to_pydict()) == _raw(s, q)


def test_parquet_and_arrow_string_files_concatenate(tmp_path):
    got = {}
    for pkg in PKGS:
        io, Batch = PKGS[pkg]["io"], PKGS[pkg]["Batch"]
        old = str(tmp_path / f"{pkg}_a.parquet")
        pq.write_table(pa.table({"k": [1], "s": ["x"]}), old)
        new = str(tmp_path / f"{pkg}_b.arrow")
        io.write_index_file(Batch.from_pydict({"k": [2], "s": ["y"]}), new)
        assert io.file_num_rows(new) == 1
        assert io.read_rowgroup_stats(new, ["k"]) is None
        assert io.read_parquet_schema(new).names == ["k", "s"]
        got[pkg] = _plain(io.read_parquet([old, new], ["k", "s"]).to_pydict())
    assert got["torch"] == got["jax"] == {"k": [1, 2], "s": ["x", "y"]}


def test_int_sum_over_an_arrow_index_on_the_device_tier(tmp_path):
    i = np.arange(3000)
    src = os.path.dirname(_write(str(tmp_path / "ti" / "p.parquet"),
                                 {"k": i % 10, "q": i * 1000}))
    s = _session("torch", str(tmp_path / "wh"), **{TC.INDEX_FORMAT: "arrow"})
    T.Hyperspace(s).create_index(s.read.parquet(src), T.CoveringIndexConfig("ci", ["k"], ["q"]))
    s.enable_hyperspace()
    got = s.read.parquet(src).filter(TX.col("k") == 3).agg(
        TX.Sum(TX.col("q")).alias("s")).collect().to_pydict()
    assert _plain(got)["s"] == [int(sum(x * 1000 for x in i if x % 10 == 3))]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_arrow_index_read_across_packages_through_the_same_kernels(tmp_path, writer):
    """One package builds an arrow and a parquet index of the same columns
    in one warehouse; each package answers the lookup and the range sum
    over either with the same results, and the port runs the same kernel
    (its plain version here) over both."""
    src = _lake(tmp_path)
    ws = str(tmp_path / "wh")
    M, C = PKGS[writer]["mod"], PKGS[writer]["C"]
    for fmt in ("arrow", "parquet"):
        s = _session(writer, ws, **{C.INDEX_FORMAT: fmt})
        M.Hyperspace(s).create_index(s.read.parquet(src),
                                     M.CoveringIndexConfig(f"ix_{fmt}", ["k"], ["v", "d"]))
    got = {}
    for pkg in PKGS:
        M, X = PKGS[pkg]["mod"], PKGS[pkg]["X"]
        for fmt, other in (("arrow", "parquet"), ("parquet", "arrow")):
            s = _session(pkg, ws)
            s.enable_hyperspace()
            M.Hyperspace(s).delete_index(f"ix_{other}")
            lookup = s.read.parquet(src).filter(X.col("k") == 7).agg(
                X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"))
            rng = s.read.parquet(src).filter((X.col("k") >= 5) & (X.col("k") < 9)).agg(
                X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"))
            assert {n.index_info.index_name for n in _index_scans(lookup.optimized_plan())} \
                == {f"ix_{fmt}"}
            before = dict(K.PLAIN_CALLS)
            got[(pkg, fmt)] = (_plain(lookup.collect().to_pydict()),
                               _plain(rng.collect().to_pydict()))
            ran = {k: K.PLAIN_CALLS[k] - before[k] for k in K.PLAIN_CALLS
                   if K.PLAIN_CALLS[k] != before[k]}
            if pkg == "torch":
                got[("kernels", fmt)] = ran
            M.Hyperspace(s).restore_index(f"ix_{other}")
    assert got[("torch", "arrow")] == got[("torch", "parquet")] == got[("jax", "arrow")] \
        == got[("jax", "parquet")]
    assert got[("kernels", "arrow")] == got[("kernels", "parquet")] == {"filter_sum": 2}


# --- hyperspace.index.filterRule.useBucketSpec ---------------------------------------


def _bucket_lake(root) -> str:
    rng = np.random.default_rng(5)
    _write(os.path.join(str(root), "li", "p.parquet"),
           {"fk": rng.integers(0, 300, 4000).astype(np.int64), "amt": rng.uniform(0, 10, 4000)})
    _write(os.path.join(str(root), "od", "p.parquet"),
           {"ok": np.arange(300, dtype=np.int64), "dt": rng.integers(0, 100, 300)})
    return str(root)


@pytest.mark.parametrize("use", [False, True])
def test_filter_rule_bucket_spec_key_matches(tmp_path, use):
    """With the key set, the filter rule's index scan carries the index's
    bucket spec (``buckets=4`` in the plan) in both packages; unset, in
    neither. The optimized plans and the results equal the JAX package's,
    for a filtered aggregate and for a join of the filtered index side on
    its bucket key against an unindexed side."""
    root = _bucket_lake(tmp_path)
    plans, results = {}, {}
    for pkg in PKGS:
        M, C, X = PKGS[pkg]["mod"], PKGS[pkg]["C"], PKGS[pkg]["X"]
        s = _session(pkg, str(tmp_path / pkg), **{C.FILTER_RULE_USE_BUCKET_SPEC: use})
        M.Hyperspace(s).create_index(s.read.parquet(os.path.join(root, "li")),
                                     M.CoveringIndexConfig("li_fk", ["fk"], ["amt"]))
        s.enable_hyperspace()
        li = lambda: s.read.parquet(os.path.join(root, "li"))
        agg = li().filter(X.col("fk") < 40).agg(X.Sum(X.col("amt")).alias("s"),
                                                 X.Count(X.lit(1)).alias("n"))
        join = li().filter(X.col("fk") < 40).join(
            s.read.parquet(os.path.join(root, "od")), X.col("fk") == X.col("ok")).group_by(
            "dt").agg(X.Count(X.lit(1)).alias("n")).sort("dt")
        out = []
        for df in (agg, join):
            plan = df.optimized_plan()
            scans = _index_scans(plan)
            assert [n.index_info.index_name for n in scans] == ["li_fk"]
            assert (scans[0].bucket_spec is not None) == use
            out.append(plan.pretty())
        plans[pkg] = out
        results[pkg] = [_plain(agg.collect().to_pydict()), _plain(join.collect().to_pydict())]
    assert plans["torch"] == plans["jax"]
    assert results["torch"][1] == results["jax"][1]
    assert results["torch"][0]["n"] == results["jax"][0]["n"]
    assert abs(results["torch"][0]["s"][0] - results["jax"][0]["s"][0]) <= \
        1e-4 * abs(results["jax"][0]["s"][0])
