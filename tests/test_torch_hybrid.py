"""Hybrid scan, the port against the JAX package on the same inputs.

- Collector: a case table of deleted and appended byte ratios around the
  0.2 and 0.3 limits, with hybrid scan on and off and lineage on and off,
  plus the edge cases (no common file, a schema the index does not cover,
  a quick refresh's recorded delta): the same candidacy, hybrid tags and
  whyNot reason codes as ``hyperspace_tpu/rules/collector.py``.
- Plans and results: a small TPC-H lake (lineitem split into 12 files)
  with the indexes li_shipdate_z (z-order), li_orderkey and od_orderkey,
  lineage on, after a deleted lineitem file, two appended ones, both, an
  incremental refresh (two runs per bucket), one with deletes and an
  optimize. The optimized plans (Union, BucketUnion, lineage filter) of the
  Filter, z-order, Join and Aggregate rules equal the JAX package's, and
  q6_count, q6_sum, lookup_count, range_sum, q3_agg and a grouped
  aggregate give its answers: counts and keys exact, f32 sums within
  relative 1e-4 (tests/test_pallas_and_dist.py:25).
- The fused join+aggregate body over bucket pairs with appended parts
  against the JAX package's ``_build_stacked_kernel``.
- Sortedness: a bucket with appended rows never counts as sorted.
"""

import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.actions.create import compute_fingerprint as jfingerprint
from hyperspace_tpu.meta.entry import FileInfo as JFileInfo
from hyperspace_tpu.plan import device_join as jdj
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.rules import base as jrb
from hyperspace_tpu.rules.collector import CandidateIndexCollector as JCollector
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.actions.create import compute_fingerprint as tfingerprint
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.meta.entry import FileInfo as TFileInfo
from hyperspace_tpu_torch.ops import cuda_kernels as K
from hyperspace_tpu_torch.plan import bucket_join as tbj
from hyperspace_tpu_torch.plan import device_join as tdj
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan.nodes import Join as TJoin
from hyperspace_tpu_torch.rules import base as trb
from hyperspace_tpu_torch.rules.collector import CandidateIndexCollector as TCollector

REL = 1e-4
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

# ---------------------------------------------------------------------------
# collector
# ---------------------------------------------------------------------------

SRC_FILES = 10
TAGS = ("HYBRIDSCAN_REQUIRED", "COMMON_SOURCE_SIZE_IN_BYTES", "HYBRIDSCAN_APPENDED_FILES",
        "HYBRIDSCAN_DELETED_FILES")


@pytest.fixture(scope="module")
def collector_lake(tmp_path_factory):
    """Ten source files of the same byte size (fixed-width, uncompressed),
    so deleting k of them deletes exactly k/10 of the bytes; two indexes
    built by the JAX package, with and without lineage."""
    root = tmp_path_factory.mktemp("collector")
    lake = str(root / "lake")
    os.makedirs(lake)
    rng = np.random.default_rng(11)
    for i in range(SRC_FILES):
        pq.write_table(pa.table({"k": rng.integers(0, 1000, 200), "v": rng.uniform(0, 1, 200)}),
                       os.path.join(lake, f"f{i:02d}.parquet"), compression="none",
                       use_dictionary=False)
    sizes = {os.path.getsize(os.path.join(lake, f)) for f in os.listdir(lake)}
    assert len(sizes) == 1
    warehouse = str(root / "wh")
    for name, lineage in (("lin", True), ("nolin", False)):
        s = J.HyperspaceSession(warehouse, conf={JC.INDEX_LINEAGE_ENABLED: lineage})
        J.Hyperspace(s).create_index(s.read.parquet(lake), J.CoveringIndexConfig(name, ["k"], ["v"]))
    return lake, warehouse, sizes.pop()


def _collect(pkg, warehouse, lake, index, hybrid, deleted, appended_bytes, recorded=False):
    """(candidates, tags, reason codes) of one package's collector over the
    lake less ``deleted`` files plus one synthetic appended file; with
    ``recorded``, the entry records that delta as a quick refresh does."""
    mod, C, _X = PKGS[pkg]
    FileInfo = JFileInfo if pkg == "jax" else TFileInfo
    kwargs = {"device": "cpu"} if pkg == "torch" else {}
    session = mod.HyperspaceSession(warehouse, conf={C.HYBRID_SCAN_ENABLED: hybrid}, **kwargs)
    scan = session.read.parquet(lake).plan
    files = [f for f in scan.files if os.path.basename(f.name) not in deleted]
    if appended_bytes:
        files.append(FileInfo(os.path.join(lake, "new.parquet"), appended_bytes, 1))
    plan = scan.copy(files=files)
    entry = mod.Hyperspace(session).get_index(index)
    if recorded:
        fp = (jfingerprint if pkg == "jax" else tfingerprint)(plan)
        entry = entry.with_update(
            [f for f in files if f.name.endswith("new.parquet")],
            [f for f in entry.source_file_infos() if os.path.basename(f.name) in deleted], fp)
    (jrb if pkg == "jax" else trb).set_analysis_enabled(session, True)
    out = (JCollector if pkg == "jax" else TCollector)(session).apply(plan, [entry])
    cands = [e.name for e in out.get(plan.plan_id, [])]

    def norm(v):
        if isinstance(v, list):
            return [(os.path.basename(f.name), f.size, f.id) for f in v]
        return v

    tags = {t: norm(entry.get_tag(plan.plan_id, t)) for t in TAGS}
    reasons = [(r.code, r.args) for r in entry.get_tag(plan.plan_id, "FILTER_REASONS") or []]
    return cands, tags, reasons


# (files deleted, appended bytes as a fraction of the remaining source
# bytes' share): ratios just under, at and just over the 0.2 / 0.3 limits
_RATIO_CASES = [(d, a) for d in (0, 1, 2, 3) for a in (0.0, 0.29, 0.3, 0.31)]


@pytest.mark.parametrize("lineage", [True, False], ids=["lineage", "no_lineage"])
@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "exact"])
@pytest.mark.parametrize("deleted,appended", _RATIO_CASES)
def test_collector_matches_jax(collector_lake, deleted, appended, hybrid, lineage):
    lake, warehouse, size = collector_lake
    index = "lin" if lineage else "nolin"
    dele = {f"f{i:02d}.parquet" for i in range(1, 1 + deleted)}
    common = (SRC_FILES - deleted) * size
    # appended / (common + appended) = the target ratio
    app_bytes = int(round(appended * common / (1 - appended))) if appended else 0
    got = {pkg: _collect(pkg, warehouse, lake, index, hybrid, dele, app_bytes)
           for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    cands, tags, reasons = got["torch"]
    if not deleted and not appended:
        assert cands == [index] and not reasons  # the exact match
    elif not hybrid:
        assert cands == [] and [c for c, _a in reasons] == ["SOURCE_DATA_CHANGED"]
    else:
        codes = [c for c, _a in reasons]
        if appended > 0.3:
            assert codes == ["TOO_MUCH_APPENDED"]
        elif appended < 0.3 and deleted and not lineage:
            assert codes == ["NO_DELETE_SUPPORT"]
        elif appended < 0.3 and deleted == 3:
            assert codes == ["TOO_MUCH_DELETED"]  # 0.3 of the bytes
        elif appended < 0.3:  # a deleted share of 0.2 is within the limit
            assert cands == [index] and tags["HYBRIDSCAN_REQUIRED"] is True
            assert [n for n, _s, _i in tags["HYBRIDSCAN_DELETED_FILES"]] == sorted(dele)


@pytest.mark.parametrize("case", ["no_common_files", "schema_mismatch", "recorded_delta"])
def test_collector_edge_cases_match_jax(collector_lake, tmp_path, case):
    lake, warehouse, size = collector_lake
    got = {}
    for pkg in ("jax", "torch"):
        if case == "no_common_files":
            dele = {f"f{i:02d}.parquet" for i in range(SRC_FILES)}
            got[pkg] = _collect(pkg, warehouse, lake, "lin", True, dele, size)
        elif case == "schema_mismatch":
            other = str(tmp_path / "other")
            if not os.path.isdir(other):
                os.makedirs(other)
                pq.write_table(pa.table({"x": np.arange(5)}), os.path.join(other, "a.parquet"))
            got[pkg] = _collect(pkg, warehouse, other, "lin", True, set(), 0)
        else:  # a quick refresh's delta: served whatever the hybrid toggle
            got[pkg] = _collect(pkg, warehouse, lake, "lin", False, {"f03.parquet"}, size,
                                recorded=True)
    assert got["torch"] == got["jax"]
    cands, tags, reasons = got["torch"]
    codes = [c for c, _a in reasons]
    assert {"no_common_files": codes == ["NO_COMMON_FILES"],
            "schema_mismatch": codes == ["COL_SCHEMA_MISMATCH"],
            "recorded_delta": cands == ["lin"] and tags["HYBRIDSCAN_REQUIRED"]}[case]


# ---------------------------------------------------------------------------
# plans and results over a changed TPC-H lake
# ---------------------------------------------------------------------------

LI_ROWS = 48_000
LI_FILES = 12
DELETED_FILE = "part-0003.parquet"
SCENARIOS = ("deleted", "appended", "both", "refreshed", "refreshed_deletes", "optimized")


def _split_lineitem(lake: str, names) -> None:
    path = os.path.join(lake, "lineitem", "part-0000.parquet")
    t = pq.read_table(path)
    os.unlink(path)
    per = t.num_rows // len(names)
    for i, name in enumerate(names):
        pq.write_table(t.slice(i * per, per), os.path.join(lake, "lineitem", name))


def _append_lineitem(root: str, lake: str) -> None:
    """Two new lineitem files: another seed's rows, named so no name
    collides."""
    extra = os.path.join(root, "extra")
    ttpch.generate_tpch(extra, rows_lineitem=LI_ROWS // 6, seed=43)
    t = pq.read_table(os.path.join(extra, "lineitem", "part-0000.parquet"))
    half = t.num_rows // 2
    for i, part in enumerate((t.slice(0, half), t.slice(half))):
        pq.write_table(part, os.path.join(lake, "lineitem", f"part-{1000 + i:04d}.parquet"))
    shutil.rmtree(extra)


def _session(pkg, warehouse, **conf):
    mod, C, _X = PKGS[pkg]
    conf = {C.INDEX_LINEAGE_ENABLED: True, C.HYBRID_SCAN_ENABLED: True, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


_INDEXES = (("lineitem", True, ttpch.LI_SHIPDATE_Z), ("lineitem", False, ttpch.LI_ORDERKEY),
            ("orders", False, ttpch.OD_ORDERKEY))


@pytest.fixture(scope="module", params=SCENARIOS)
def scenario(request, tmp_path_factory):
    name = request.param
    root = str(tmp_path_factory.mktemp(name))
    lake, warehouse = os.path.join(root, "lake"), os.path.join(root, "wh")
    ttpch.generate_tpch(lake, rows_lineitem=LI_ROWS, seed=42)
    _split_lineitem(lake, [f"part-{i:04d}.parquet" for i in range(LI_FILES)])
    builder = "jax" if name in ("deleted", "appended", "both") else "torch"
    mod = PKGS[builder][0]
    s = _session(builder, warehouse)
    hs = mod.Hyperspace(s)
    for table, zordered, spec in _INDEXES:
        cfg = mod.ZOrderCoveringIndexConfig if zordered else mod.CoveringIndexConfig
        hs.create_index(s.read.parquet(os.path.join(lake, table)), cfg(*spec))
    key = ttpch.first_orderkey(lake)
    if name in ("deleted", "both", "refreshed_deletes"):
        os.unlink(os.path.join(lake, "lineitem", DELETED_FILE))
    if name != "deleted":
        _append_lineitem(root, lake)
    if name in ("refreshed", "refreshed_deletes", "optimized"):
        for _t, _z, spec in _INDEXES[:2]:
            hs.refresh_index(spec[0], "incremental")
    if name == "optimized":
        hs.optimize_index(ttpch.LI_ORDERKEY[0])
    return name, lake, warehouse, key


def _queries(X, lake, key):
    def li(s):
        return s.read.parquet(os.path.join(lake, "lineitem"))

    pred = ((X.col("l_shipdate") >= 8766) & (X.col("l_shipdate") < 9131)
            & (X.col("l_discount") >= 0.05) & (X.col("l_discount") <= 0.07)
            & (X.col("l_quantity") < 24))
    od = os.path.join(lake, "orders")
    return {
        "q6_count": lambda s: li(s).filter(pred).agg(
            X.Sum(X.col("l_extendedprice") * X.col("l_discount")).alias("revenue"),
            X.Count(X.lit(1)).alias("count")),
        "q6_sum": lambda s: li(s).filter(pred).agg(
            X.Sum(X.col("l_extendedprice")).alias("sum_price"), X.Count(X.lit(1)).alias("count")),
        "lookup_count": lambda s: li(s).filter(X.col("l_orderkey") == key).agg(
            X.Sum(X.col("l_extendedprice") * X.col("l_discount")).alias("revenue"),
            X.Count(X.lit(1)).alias("count")),
        "range_sum": lambda s: li(s).filter(
            (X.col("l_orderkey") >= key) & (X.col("l_orderkey") < key + 2000)).agg(
            X.Sum(X.col("l_extendedprice")).alias("sum_price"), X.Count(X.lit(1)).alias("count")),
        "q3_agg": lambda s: (
            li(s).select("l_orderkey", "l_extendedprice", "l_discount")
            .join(s.read.parquet(od).select("o_orderkey", "o_orderdate"),
                  X.col("l_orderkey") == X.col("o_orderkey"))
            .filter(X.col("o_orderdate") < 9500)
            .group_by("l_orderkey", "o_orderdate")
            .agg(X.Sum(X.col("l_extendedprice") * (X.lit(1.0) - X.col("l_discount")))
                 .alias("revenue"))),
        "agg_by_order": lambda s: li(s).group_by("l_orderkey").agg(
            X.Sum(X.col("l_quantity")).alias("qty"), X.Count(X.lit(1)).alias("n")),
    }


# the rule each query's rewrite goes through, and the index it reads
_RULES = {"q6_count": "li_shipdate_z", "q6_sum": "li_shipdate_z",
          "lookup_count": "li_orderkey", "range_sum": "li_orderkey",
          "q3_agg": "li_orderkey+od_orderkey", "agg_by_order": "li_orderkey"}


def _render(plan) -> list:
    """The plan's rendering, each scan with its files and lineage ids."""
    out = plan.pretty().splitlines()
    for n in plan.preorder():
        if hasattr(n, "files"):
            out.append((sorted(os.path.basename(f.name) for f in n.files),
                        n.lineage_filter_ids))
    return out


def test_plans_match_jax(scenario):
    name, lake, warehouse, key = scenario
    plans = {}
    for pkg in ("jax", "torch"):
        s = _session(pkg, warehouse)
        s.enable_hyperspace()
        plans[pkg] = {q: _render(fn(s).optimized_plan())
                      for q, fn in _queries(PKGS[pkg][2], lake, key).items()}
    assert plans["torch"] == plans["jax"]
    text = {q: "\n".join(str(x) for x in p) for q, p in plans["torch"].items()}
    for q, idx in _RULES.items():
        for i in idx.split("+"):
            assert f"Name: {i}," in text[q], (q, i)
    hybrid_deletes = name in ("deleted", "both")
    hybrid_appends = name in ("appended", "both")
    assert ("Union" in text["q6_count"]) == hybrid_appends
    assert ("BucketUnion" in text["q3_agg"]) == hybrid_appends
    assert ("BucketUnion" in text["agg_by_order"]) == hybrid_appends
    assert ("RepartitionByExpr" in text["q3_agg"]) == hybrid_appends
    for q in ("q6_count", "lookup_count", "q3_agg"):
        # the deleted file's id is the lineage filter of the lineitem scan
        assert ("], [3])" in text[q]) == hybrid_deletes, q


def _sorted_rows(d: dict, keys) -> dict:
    order = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_match(q, got: dict, want: dict) -> None:
    assert list(got) == list(want), q
    if q in ("q3_agg", "agg_by_order"):
        keys = ["l_orderkey", "o_orderdate"] if q == "q3_agg" else ["l_orderkey"]
        got, want = _sorted_rows(got, keys), _sorted_rows(want, keys)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert len(g) == len(w), (q, c)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=REL, err_msg=f"{q}.{c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{q}.{c}")


def test_results_match_jax(scenario):
    name, lake, warehouse, key = scenario
    js = _session("jax", warehouse)
    js.enable_hyperspace()
    ts = _session("torch", warehouse)
    ts.enable_hyperspace()
    raw = _session("jax", warehouse)
    appends = name in ("appended", "both")
    for q, tfn in _queries(TX, lake, key).items():
        jfn = _queries(JX, lake, key)[q]
        K.reset_counts()
        ts.device_stats.device_fragments = 0
        ts.device_stats.join_paths = {}
        got = tfn(ts).to_pydict()
        want = jfn(js).to_pydict()
        _assert_match(q, got, want)
        _assert_match(q, got, jfn(raw).to_pydict())  # Hyperspace off: the raw lake
        stats = ts.device_stats
        if q in ("q6_count", "lookup_count", "q6_sum", "range_sum"):
            # a filter over appended files reads a Union: the host, as in
            # the reference; otherwise the kernel's plain version on the CPU
            kernel = "filter_weighted_sum" if q in ("q6_count", "lookup_count") else "filter_sum"
            ran = not appends
            assert stats.device_fragments == int(ran), q
            assert K.PLAIN_CALLS[kernel] == int(ran), q
        elif q == "q3_agg":
            assert stats.join_paths == {"stacked_agg": 1}
    # agg_by_order counts every row the lake holds now
    deleted = LI_ROWS // LI_FILES if name in ("deleted", "both", "refreshed_deletes") else 0
    appended = LI_ROWS // 6 if name != "deleted" else 0
    assert sum(got["n"]) == LI_ROWS - deleted + appended


# ---------------------------------------------------------------------------
# the fused join body over appended parts, and sortedness
# ---------------------------------------------------------------------------

def _join_sides(lake, warehouse, key):
    ts = _session("torch", warehouse)
    ts.enable_hyperspace()
    plan = _queries(TX, lake, key)["q3_agg"](ts).optimized_plan()
    join = next(n for n in plan.preorder() if isinstance(n, TJoin))
    left, right = tbj._decompose_side(join.left), tbj._decompose_side(join.right)
    n = left.spec.num_buckets
    appended = (tbj._bucketize_appended(left, n, ts), tbj._bucketize_appended(right, n, ts))
    return ts, left, right, appended


@pytest.mark.parametrize("scenario", ["appended", "both"], indirect=True)
def test_stacked_join_body_over_appended_parts_matches_jax(scenario):
    name, lake, warehouse, key = scenario
    ts, left, right, appended = _join_sides(lake, warehouse, key)
    assert left.appended is not None and right.appended is None
    aggs = [("count", None), ("sum", None)]
    checked = 0
    for b, lb, rb, l_sorted, r_sorted in tbj._iter_bucket_pairs(left, right, appended, ts):
        if not lb.num_rows or not rb.num_rows:
            continue
        lk = lb.column("l_orderkey").data.astype(np.int32)
        price = lb.column("l_extendedprice").data.astype(np.float32)
        rorder = np.argsort(rb.column("o_orderkey").data, kind="stable")
        rk = rb.column("o_orderkey").data[rorder].astype(np.int32)
        jaggs = [(k, None if k == "count" else JX.col("price")) for k, _c in aggs]
        taggs = [(k, None if k == "count" else TX.col("price")) for k, _c in aggs]
        pad_l = 1 << max(10, int(np.ceil(np.log2(len(lk)))))
        pad_r = 1 << max(10, int(np.ceil(np.log2(len(rk)))))

        def padded(a, pad, fill=0):
            out = np.full((1, pad), fill, dtype=a.dtype)
            out[0, : len(a)] = a
            return jnp.asarray(out)

        kernel = jdj._build_stacked_kernel(jaggs, [], [], [], [], pad_l, pad_r)
        jc, jo = kernel(padded(lk, pad_l), padded(rk, pad_r, np.iinfo(np.int32).max),
                        jnp.asarray([len(lk)], jnp.int32), jnp.asarray([len(rk)], jnp.int32),
                        {"price": padded(price, pad_l)}, {})
        body = tdj.stacked_join_body(taggs, [], [], [], [])
        # the appended rows make the left keys unsorted: the body sorts them
        tc, to = body(torch.from_numpy(lk), torch.from_numpy(rk),
                      {"price": torch.from_numpy(price)}, {}, l_sorted)
        assert not l_sorted and (np.diff(lk) < 0).any()
        n_r = len(rk)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[0, :n_r])
        keep = tc.numpy() > 0
        for (kind, _c), got, want in zip(aggs, to, jo):
            g, w = got.numpy()[keep], np.asarray(want)[0, :n_r][keep]
            if kind == "count":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=REL)
        checked += 1
    assert checked > 0


def test_a_bucket_with_appended_rows_is_not_sorted(scenario):
    """Every path that trusts the on-disk key order reads these flags: a
    bucket with an appended part, or with a run per data version, must not
    count as sorted, or the merge join and the device probe return wrong
    rows without an error."""
    name, lake, warehouse, key = scenario
    ts, left, right, appended = _join_sides(lake, warehouse, key)
    n = left.spec.num_buckets
    pairs = list(tbj._iter_bucket_pairs(left, right, appended, ts))
    loaded = tbj._load_all_bucket_pairs(left, right, appended, ts)
    for b in range(n):
        has_appended = appended[0] is not None and appended[0][b].num_rows > 0
        runs = len(left.files_for_bucket(b))
        want = not has_appended and runs <= 1
        assert pairs[b][3] is want and loaded[b][2] is want, (b, has_appended, runs)
        assert pairs[b][4] is True  # orders: one file per bucket, nothing appended
    if name in ("appended", "both", "refreshed"):
        assert not any(p[3] for p in pairs)
    # the host merge join trusts the flags: with the device tier off, the
    # plain join's rows equal the raw lake's
    host = _session("torch", warehouse, **{TC.EXEC_TPU_ENABLED: False})
    host.enable_hyperspace()
    li = host.read.parquet(os.path.join(lake, "lineitem"))
    od = host.read.parquet(os.path.join(lake, "orders"))
    q = li.select("l_orderkey", "l_extendedprice").join(
        od.select("o_orderkey", "o_orderdate"), TX.col("l_orderkey") == TX.col("o_orderkey"))
    assert "BucketUnion" in q.optimized_plan().pretty() or name not in ("appended", "both")
    got = q.to_pydict()
    assert host.device_stats.join_paths == {"per_bucket": 1}
    host.disable_hyperspace()
    want = q.to_pydict()
    keys = ["l_orderkey", "l_extendedprice", "o_orderdate"]
    _assert_match("join", _sorted_rows(got, keys), _sorted_rows(want, keys))
