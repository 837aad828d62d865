"""The approximate tier, the port against the JAX package on the same
inputs (the counterparts of tests/test_approx.py).

Small seeded lakes (numpy, one fixed mtime) and covering indexes of 4
buckets, built by each package into its own warehouse:

- sample twins and metas byte for byte the JAX package's at create, after
  two appends and after compaction; the vacuum keeps the twins the JAX
  package wrote beside referenced data (the port's sweep once unlinked
  them); a twin's file name carries its data file's bucket id;
- the eligibility reason of every plan of the reference's cases, in both
  packages alike, with the ``approx.ineligible.<reason>`` counters;
- estimates and half-widths (counts exact, sums within relative 1e-4),
  verify mode, the declared float32 dtype, the hot-key guard and its
  recording floor, EXPLAIN ANALYZE's approx lines;
- the ``approx.sample`` crash cells: at ``HYPERSPACE_IO_THREADS=1`` the
  fault fires in both packages and the recovered warehouses are the same;
  with threaded writers (where the reference's writers race past
  ``crash_after:n=1``) only "ineligible or converged, never wrong" holds;
- cross-package reads of twins both ways, and a served query that QoS
  degrades, engaged on the sampled tier in both packages.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu import ingest as JI
from hyperspace_tpu import serve as JSV
from hyperspace_tpu.models import covering as JCOV
from hyperspace_tpu.models import sample_store as JSS
from hyperspace_tpu.plan import executor as JE
from hyperspace_tpu.plan import expr as JX
from hyperspace_tpu.plan import nodes as JN
from hyperspace_tpu.plan import sampling as JS
from hyperspace_tpu.serve import qos as JQ
from hyperspace_tpu.telemetry import plan_stats as JP
from hyperspace_tpu.telemetry.metrics import REGISTRY as JREG
from hyperspace_tpu.utils import faults as JF
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import ingest as TI
from hyperspace_tpu_torch import serve as TSV
from hyperspace_tpu_torch.models import covering as TCOV
from hyperspace_tpu_torch.models import sample_store as TSS
from hyperspace_tpu_torch.plan import executor as TE
from hyperspace_tpu_torch.plan import expr as TX
from hyperspace_tpu_torch.plan import nodes as TN
from hyperspace_tpu_torch.plan import sampling as TS
from hyperspace_tpu_torch.serve import qos as TQ
from hyperspace_tpu_torch.telemetry import plan_stats as TP
from hyperspace_tpu_torch.telemetry.metrics import REGISTRY as TREG
from hyperspace_tpu_torch.utils import faults as TF

PKGS = {
    "jax": {"mod": J, "C": JC, "X": JX, "N": JN, "S": JS, "SS": JSS, "E": JE, "P": JP,
            "ingest": JI, "faults": JF, "reg": JREG, "serve": JSV, "qos": JQ, "cov": JCOV},
    "torch": {"mod": T, "C": TC, "X": TX, "N": TN, "S": TS, "SS": TSS, "E": TE, "P": TP,
              "ingest": TI, "faults": TF, "reg": TREG, "serve": TSV, "qos": TQ, "cov": TCOV},
}
FR = 0.1
MTIME_NS = 1_700_000_000 * 10**9  # one fixed mtime: signatures hash it


@pytest.fixture(scope="module", autouse=True)
def _reset_process_wide_state():
    """Both packages' query ledgers, cost models and approx telemetry are
    process-wide: emptied when the module ends."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER as JL
    from hyperspace_tpu_torch.telemetry.attribution import LEDGER as TL

    for led in (JL, TL):
        led.reset_for_testing()
    for pkg in PKGS.values():
        pkg["qos"].COST_MODEL.reset_for_testing()
        pkg["S"].APPROX.reset_for_testing()


@pytest.fixture(autouse=True)
def _approx_on(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_APPROX", "1")
    monkeypatch.setenv("HYPERSPACE_RESULT_CACHE", "0")


# --- lakes, sessions, queries --------------------------------------------------


def _write(path: str, table: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(table), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))
    return path


def _ev(seed: int, n: int = 3000) -> dict:
    r = np.random.default_rng(seed)
    return {"k": r.integers(0, 100_000, n), "v": r.integers(0, 1000, n)}


def _session(pkg: str, ws: str, **conf):
    p = PKGS[pkg]
    full = {p["C"].INDEX_NUM_BUCKETS: 4, **conf}
    if pkg == "torch":
        return p["mod"].HyperspaceSession(ws, conf=full, device="cpu")
    return p["mod"].HyperspaceSession(ws, conf=full)


def _mk_ev(pkg: str, ws: str, src: str, **conf):
    s = _session(pkg, ws, **conf)
    hs = PKGS[pkg]["mod"].Hyperspace(s)
    hs.create_index(s.read.parquet(src), PKGS[pkg]["mod"].CoveringIndexConfig("ev", ["k"], ["v"]))
    s.enable_hyperspace()
    return s, hs


def _join_lake(root: str, n: int = 6000, orders: int = 1500, hot_key=None, hot_n: int = 0,
               cov: bool = False) -> str:
    """A fact/dim pair joined on an int64 key; ``cov`` adds a non-key pair
    (g, h) and makes the measure float32."""
    rng = np.random.default_rng(11 if cov else 7)
    fk = rng.integers(0, orders, n).astype(np.int64)
    if hot_n:
        fk[:hot_n] = hot_key
    if cov:
        li = {"fk": fk, "g": rng.integers(0, 40, n).astype(np.int64),
              "amt": rng.uniform(1, 100, n).astype(np.float32)}
        od = {"ok": np.arange(orders, dtype=np.int64),
              "h": rng.integers(0, 40, orders).astype(np.int64),
              "dt": rng.integers(0, 1000, orders).astype(np.int64)}
    else:
        li = {"fk": fk, "amt": rng.uniform(1, 100, n)}
        od = {"ok": np.arange(orders, dtype=np.int64), "dt": rng.integers(0, 1000, orders)}
    _write(os.path.join(root, "li", "part0.parquet"), li)
    _write(os.path.join(root, "od", "part0.parquet"), od)
    return root


def _mk_join(pkg: str, ws: str, src: str, cov: bool = False):
    s = _session(pkg, ws)
    M = PKGS[pkg]["mod"]
    hs = M.Hyperspace(s)
    hs.create_index(s.read.parquet(os.path.join(src, "li")),
                    M.CoveringIndexConfig("li_idx", ["fk"], ["g", "amt"] if cov else ["amt"]))
    hs.create_index(s.read.parquet(os.path.join(src, "od")),
                    M.CoveringIndexConfig("od_idx", ["ok"], ["h", "dt"] if cov else ["dt"]))
    s.enable_hyperspace()
    return s, hs


def _open(pkg: str, ws: str):
    s = _session(pkg, ws)
    s.enable_hyperspace()
    return s, PKGS[pkg]["mod"].Hyperspace(s)


def _join(pkg: str, s, src: str):
    X = PKGS[pkg]["X"]
    li = s.read.parquet(os.path.join(src, "li"))
    od = s.read.parquet(os.path.join(src, "od"))
    return li.select("fk", "amt").join(od.select("ok", "dt"), X.col("fk") == X.col("ok"))


def _qj(pkg: str, s, src: str, cut: int = 500):
    X = PKGS[pkg]["X"]
    return _join(pkg, s, src).filter(X.col("dt") < cut).agg(
        X.Sum(X.col("amt")).alias("s"), X.Count(X.lit(1)).alias("n"))


def _plain(d: dict) -> dict:
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in d.items()}


def _tree(ws: str) -> dict:
    """Every index file under the warehouse, as bytes (logs left out)."""
    out = {}
    root = os.path.join(ws, "indexes")
    for dirpath, _dirs, names in os.walk(root):
        if "_hyperspace_log" in dirpath:
            continue
        for fn in names:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _data_files(hs, name: str) -> list:
    return sorted(f.name for f in hs.get_index(name).index_data_files())


def _val(pkg: str, name: str) -> int:
    m = PKGS[pkg]["reg"].get(name)
    return 0 if m is None else int(m.value)


def _sampled(pkg: str, s, df) -> tuple:
    """(result, the collector's approx block, its summary text) of ``df``
    under ``approx_scope(FR)``."""
    P, S = PKGS[pkg]["P"], PKGS[pkg]["S"]
    with P.collect_scope() as col:
        with S.approx_scope(FR):
            out = _plain(df.collect().to_pydict())
    return out, (col.summary() or {}).get("approx"), P.summary_string(col)


def _approx_lines(text: str) -> list:
    lines = text.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.startswith("approx:")]
    return lines[at[0]:at[0] + 3] if at else []


# --- the write side -----------------------------------------------------------


def test_twins_and_metas_byte_identical_through_append_and_compact(tmp_path):
    """Create, two appends, then compaction: at every stage each package's
    index directory (data files, sample twins, sample metas) holds the same
    bytes, each twin is the universe mask of its data file, and the tier
    writes the same number of twins."""
    src = str(tmp_path / "events")
    _write(os.path.join(src, "part0.parquet"), _ev(0))
    appended = [_write(str(tmp_path / f"add{i}" / f"p{i}.parquet"), _ev(i)) for i in (1, 2)]
    stages, written = {}, {}
    for pkg in PKGS:
        ws = str(tmp_path / pkg)
        before = _val(pkg, "approx.samples.written")
        s, hs = _mk_ev(pkg, ws, src)
        trees = [_tree(ws)]
        for p in appended:
            hs.append("ev", s.read.parquet(p))
            trees.append(_tree(ws))
        hs.compact_index("ev", min_runs=2)
        trees.append(_tree(ws))
        stages[pkg] = trees
        written[pkg] = _val(pkg, "approx.samples.written") - before
        SS = PKGS[pkg]["SS"]
        for path in _data_files(hs, "ev"):
            batch = PKGS[pkg]["mod"].columnar.io.read_parquet([path])
            mask = SS.universe_keep_mask(batch, ["k"], FR)
            meta = SS.load_sample_meta(path)
            assert meta["rows"] == batch.num_rows and "heavy" in meta
            assert meta["kept"][str(SS.fraction_ppm(FR))] == int(mask.sum())
            tw = pq.read_table(SS.sample_path(path, FR))
            assert tw.column("k").to_pylist() == np.asarray(batch.column("k").data)[mask].tolist()
    for a, b in zip(stages["jax"], stages["torch"]):
        assert sorted(a) == sorted(b)
        assert any(k.split(os.sep)[-1].startswith("_sample.meta.") for k in a)
        for k in a:
            assert a[k] == b[k], k
    assert written["torch"] == written["jax"] > 0


def test_approx_off_writes_no_twins_and_the_scope_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_APPROX", "0")
    src = str(tmp_path / "events")
    _write(os.path.join(src, "part0.parquet"), _ev(0))
    for pkg in PKGS:
        X, S = PKGS[pkg]["X"], PKGS[pkg]["S"]
        s, _hs = _mk_ev(pkg, str(tmp_path / pkg), src)
        assert not any("_sample." in k for k in _tree(str(tmp_path / pkg)))

        def q():
            return _plain(s.read.parquet(src).filter(X.col("k") < 50_000).agg(
                X.Sum(X.col("v")).alias("s"), X.Count(X.lit(1)).alias("n")).collect().to_pydict())

        ref = q()
        with S.approx_scope(FR):
            assert q() == ref


def test_port_vacuum_keeps_twins_the_jax_package_wrote(tmp_path):
    """The JAX package builds and appends (twins and metas beside every data
    file) in two warehouses; the port's vacuum of one keeps the twins while
    their data file is referenced and sweeps the planted debris, and leaves
    the files the JAX vacuum leaves in the other."""
    src = str(tmp_path / "events")
    _write(os.path.join(src, "part0.parquet"), _ev(0))
    add = _write(str(tmp_path / "add" / "p1.parquet"), _ev(1))
    trees = {}
    for vacuumer in PKGS:
        ws = str(tmp_path / f"by_{vacuumer}")
        s, hs = _mk_ev("jax", ws, src)
        hs.append("ev", s.read.parquet(add))
        files = _data_files(hs, "ev")
        vdir = os.path.dirname(files[0])
        stray = os.path.join(vdir, "stray.parquet")
        orphan = os.path.join(vdir, "_sample.r100000.ghost.parquet")
        for p in (stray, orphan):
            with open(p, "wb") as f:
                f.write(b"x")
        _open(vacuumer, ws)[1].vacuum_outdated_index("ev")
        for path in files:
            assert os.path.exists(JSS.sample_path(path, FR)), path
            assert os.path.exists(JSS.sample_meta_path(path)), path
        assert not os.path.exists(stray) and not os.path.exists(orphan)
        trees[vacuumer] = _tree(ws)
    assert trees["torch"] == trees["jax"]


def test_twin_file_names_carry_their_bucket_id():
    for pkg in PKGS:
        cov = PKGS[pkg]["cov"]
        assert cov.bucket_id_from_filename("/x/_sample.r100000.part-0-b00003.parquet") == 3
        assert cov.bucket_id_from_filename("_sample.r010000.part-2-b00001-4.parquet") == 1
        assert cov.bucket_id_from_filename("_sample.meta.part-0-b00001.parquet.json") is None


def test_heavy_recording_floor_and_twins_match(tmp_path, monkeypatch):
    """One batch written by each package's ``maybe_write_samples``: the same
    twins and meta bytes, and a key of 0.5% of the rows is recorded under a
    0.4% share guard."""
    monkeypatch.setenv("HYPERSPACE_APPROX_MAX_KEY_SHARE", "0.004")
    rng = np.random.default_rng(13)
    keys = rng.integers(1000, 1_000_000, 10_000).astype(np.int64)
    keys[:50] = 7
    data = {"k": keys, "v": rng.integers(0, 10, 10_000)}
    out = {}
    for pkg in PKGS:
        SS = PKGS[pkg]["SS"]
        batch = PKGS[pkg]["mod"].columnar.table.ColumnBatch.from_pydict(
            {c: a.tolist() for c, a in data.items()})
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "part0.parquet")
        assert SS.maybe_write_samples(batch, path, 4096, ["k"]) == 2
        h7 = int(SS._key_hash(batch.take(np.array([0])), ["k"])[0])
        assert SS.load_sample_meta(path)["heavy"].get(str(h7)) == 50
        out[pkg] = {fn: (d / fn).read_bytes() for fn in sorted(os.listdir(d))}
    assert out["jax"] == out["torch"] and len(out["torch"]) == 3


# --- eligibility ----------------------------------------------------------------


def _case_plan(pkg: str, case: str, s, src: str):
    """The optimized plan of one eligibility case of tests/test_approx.py."""
    X, N = PKGS[pkg]["X"], PKGS[pkg]["N"]
    li = s.read.parquet(os.path.join(src, "li"))
    if case == "eligible":
        return _qj(pkg, s, src).optimized_plan()
    if case == "shape":
        return li.select("fk", "amt").optimized_plan()
    if case == "aggfunc":
        return _join(pkg, s, src).agg(X.Min(X.col("amt")).alias("m")).optimized_plan()
    if case == "group-on-key":
        return _join(pkg, s, src).group_by("fk").agg(X.Sum(X.col("amt")).alias("s")).optimized_plan()
    if case == "key-filtered":
        return _join(pkg, s, src).filter(X.col("fk") < 500).agg(
            X.Sum(X.col("amt")).alias("s")).optimized_plan()
    if case == "not-index":
        return li.filter(X.col("amt") < 50).agg(X.Sum(X.col("amt")).alias("s")).optimized_plan()
    # the join-condition swaps of test_join_on_non_key_column_declines
    base = s.read.parquet(os.path.join(src, "li")).select("fk", "g", "amt").join(
        s.read.parquet(os.path.join(src, "od")).select("ok", "h", "dt"),
        X.col("fk") == X.col("ok")).agg(
        X.Sum(X.col("amt")).alias("s"), X.Count(X.lit(1)).alias("n")).optimized_plan()
    cond = {
        "non-key-join": X.col("g") == X.col("h"),
        "key-residual": (X.col("fk") == X.col("ok")) & (X.col("fk") > X.lit(10)),
        "extra-equi-pair": (X.col("fk") == X.col("ok")) & (X.col("g") == X.col("h")),
        "non-key-residual": (X.col("fk") == X.col("ok")) & (X.col("dt") > X.col("amt")),
    }[case]
    return base.transform_up(
        lambda n: N.Join(n.left, n.right, cond, n.how) if isinstance(n, N.Join) else n)


@pytest.mark.parametrize("case, want", [
    ("eligible", None), ("shape", "shape"), ("aggfunc", "aggfunc"),
    ("group-on-key", "group-on-key"), ("key-filtered", "key-filtered"),
    ("not-index", "not-index"), ("ndv", "ndv"), ("missing-samples", "missing-samples"),
    ("non-key-join", "join-not-on-key"), ("key-residual", "join-not-on-key"),
    ("extra-equi-pair", "join-not-on-key"), ("non-key-residual", None),
])
def test_eligibility_reason_matches(tmp_path, monkeypatch, case, want):
    cov = case in ("non-key-join", "key-residual", "extra-equi-pair", "non-key-residual")
    src = _join_lake(str(tmp_path / "lake"), cov=cov)
    got = {}
    for pkg in PKGS:
        s, hs = _mk_join(pkg, str(tmp_path / pkg), src, cov=cov)
        if case == "ndv":
            monkeypatch.setenv("HYPERSPACE_APPROX_MIN_KEYS", "100000")
        plan = _case_plan(pkg, "eligible" if case in ("ndv", "missing-samples") else case,
                          s, src)
        victim = None
        if case == "missing-samples":
            victim = PKGS[pkg]["SS"].sample_path(_data_files(hs, "li_idx")[0], FR)
            os.rename(victim, victim + ".bak")
        try:
            sp = PKGS[pkg]["S"].build_sampled_plan(s, plan, FR)
        finally:
            monkeypatch.delenv("HYPERSPACE_APPROX_MIN_KEYS", raising=False)
            if victim:
                os.rename(victim + ".bak", victim)
        got[pkg] = sp if isinstance(sp, str) else None
        if not isinstance(sp, str):
            got[pkg + "_plan"] = [n.describe() for n in sp.plan.preorder()]
    assert got["torch"] == got["jax"] == want
    if want is None:
        assert got["torch_plan"] == got["jax_plan"]


def test_declined_collect_is_exact_and_counted(tmp_path):
    """A group-on-key aggregate under the scope runs exact in both packages,
    with one ``approx.ineligible.group-on-key`` each, and the query log says
    why."""
    src = _join_lake(str(tmp_path / "lake"))
    for pkg in PKGS:
        X, S = PKGS[pkg]["X"], PKGS[pkg]["S"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        df = _join(pkg, s, src).group_by("fk").agg(X.Sum(X.col("amt")).alias("s")).sort("fk")
        exact = _plain(df.collect().to_pydict())
        before = _val(pkg, "approx.ineligible.group-on-key")
        with S.approx_scope(FR):
            assert _plain(df.collect().to_pydict()) == exact
        assert _val(pkg, "approx.ineligible.group-on-key") == before + 1


# --- estimates, intervals, verify -------------------------------------------------


def _close(a: float, b: float, rel: float = 1e-4) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)


def test_sampled_join_estimates_and_widths_match(tmp_path):
    """The flagship sampled join: counts and their half-widths equal the JAX
    package's, sums and theirs within relative 1e-4, every interval covers
    the exact answer, and EXPLAIN ANALYZE's approx lines and the sampled
    plan's scans read alike. The twins the sampled join reads group by
    their data files' buckets."""
    src = _join_lake(str(tmp_path / "lake"))
    res = {}
    for pkg in PKGS:
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        exact = _plain(_qj(pkg, s, src).collect().to_pydict())
        approx, info, text = _sampled(pkg, s, _qj(pkg, s, src))
        assert info and info["fraction"] == FR, f"{pkg}: the sampled tier did not engage"
        for name in ("s", "n"):
            assert abs(approx[name][0] - exact[name][0]) <= info["outputs"][name]["ci95_max"]
        sp = PKGS[pkg]["S"].build_sampled_plan(s, _qj(pkg, s, src).optimized_plan(), FR)
        scans = [n for n in sp.plan.preorder() if n.kind == "FileScan"]
        for n in scans:
            for f in n.files:
                base = PKGS[pkg]["SS"].strip_sample_prefix(os.path.basename(f.name))
                cov = PKGS[pkg]["cov"]
                assert cov.bucket_id_from_filename(f.name) == cov.bucket_id_from_filename(base)
        res[pkg] = (approx, info, _approx_lines(text),
                    sorted(n.describe().split(" (")[0] + n.describe().split(")")[-1]
                           for n in scans))
    (ta, ti, tl, tscan), (ja, ji, jl, jscan) = res["torch"], res["jax"]
    assert ta["n"] == ja["n"]
    assert _close(ta["s"][0], ja["s"][0])
    assert ti["outputs"]["n"] == ji["outputs"]["n"]
    for k in ("ci95_mean", "ci95_max"):
        assert _close(ti["outputs"]["s"][k], ji["outputs"]["s"][k])
    assert _close(ti["mean_ci_rel"], ji["mean_ci_rel"])
    assert tl[0] == jl[0] and tl[2] == jl[2]  # the header and the count's line
    assert tscan == jscan and any("sampled[universe f=0.1]" in d for d in tscan)


def test_sampled_join_runs_the_bucketed_join_over_twins(tmp_path):
    """The port's sampled join goes through the bucketed join route, its
    twins grouped under the four bucket ids."""
    src = _join_lake(str(tmp_path / "lake"))
    s, _hs = _mk_join("torch", str(tmp_path / "torch"), src)
    sp = TS.build_sampled_plan(s, _qj("torch", s, src).optimized_plan(), FR)
    from hyperspace_tpu_torch.plan import bucket_join

    joins = [n for n in sp.plan.preorder() if isinstance(n, TN.Join)]
    assert len(joins) == 1
    for side in (joins[0].left, joins[0].right):
        bs = bucket_join._decompose_side(side)
        assert bs is not None and bs.scan.sample_spec is not None
        assert all(bs.files_for_bucket(b) for b in range(4))
        assert sum(len(bs.files_for_bucket(b)) for b in range(4)) == len(bs.scan.files)
    before = s.device_stats.device_join_fragments
    TE.execute_plan(sp.plan, s)
    assert s.device_stats.device_join_fragments == before + 1


def test_verify_mode_passes_and_counts(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_APPROX", "verify")
    src = _join_lake(str(tmp_path / "lake"))
    for pkg in PKGS:
        S = PKGS[pkg]["S"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        before = (S.APPROX.snapshot()["verify_checked"], _val(pkg, "approx.verify.checked"))
        with S.approx_scope(FR):
            _qj(pkg, s, src).collect()
        after = (S.APPROX.snapshot()["verify_checked"], _val(pkg, "approx.verify.checked"))
        assert after == (before[0] + 1, before[1] + 1)


def test_verify_mode_raises_on_a_planted_miss(tmp_path, monkeypatch):
    """A half-width forced to zero cannot cover: both packages raise."""
    monkeypatch.setenv("HYPERSPACE_APPROX", "verify")
    monkeypatch.setenv("HYPERSPACE_APPROX_CI_SAFETY", "1e-12")
    src = _join_lake(str(tmp_path / "lake"))
    for pkg in PKGS:
        S = PKGS[pkg]["S"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        with pytest.raises(S.ApproxVerifyError):
            with S.approx_scope(FR):
                _qj(pkg, s, src).collect()


def test_float32_sum_keeps_its_declared_dtype(tmp_path):
    src = _join_lake(str(tmp_path / "lake"), cov=True)
    got = {}
    for pkg in PKGS:
        S, E = PKGS[pkg]["S"], PKGS[pkg]["E"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src, cov=True)
        plan = _join(pkg, s, src).agg(
            PKGS[pkg]["X"].Sum(PKGS[pkg]["X"].col("amt")).alias("s"),
            PKGS[pkg]["X"].Count(PKGS[pkg]["X"].lit(1)).alias("n")).optimized_plan()
        assert plan.schema.field("s").dtype == "float32"
        sp = S.build_sampled_plan(s, plan, FR)
        out, _est, info = S._finalize(E.execute_plan(sp.plan, s), sp)
        assert out.column("s").dtype == "float32" and out.column("s").data.dtype == np.float32
        assert out.column("n").dtype == "int64" and out.column("n").data.dtype == np.int64
        got[pkg] = (float(out.column("s").data[0]), int(out.column("n").data[0]), info)
    assert got["torch"][1] == got["jax"][1]
    assert _close(got["torch"][0], got["jax"][0])
    assert got["torch"][2]["outputs"]["n"] == got["jax"][2]["outputs"]["n"]


def _dropped_key(SS, fraction: float) -> int:
    """The smallest int64 key the universe hash drops at ``fraction``."""
    from hyperspace_tpu_torch.columnar.table import ColumnBatch

    for k in range(100_000):
        b = ColumnBatch.from_pydict({"fk": [k]})
        if not SS.universe_keep_mask(b, ["fk"], fraction)[0]:
            return k
    raise AssertionError("no dropped key")


def test_hot_key_guard_declines_in_both_packages(tmp_path):
    hot = _dropped_key(TSS, FR)
    src = _join_lake(str(tmp_path / "lake"), hot_key=hot, hot_n=1800)
    for pkg in PKGS:
        S = PKGS[pkg]["S"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        assert S.build_sampled_plan(s, _qj(pkg, s, src).optimized_plan(), FR) == "hot-key"
        exact = _plain(_qj(pkg, s, src).collect().to_pydict())
        before = _val(pkg, "approx.ineligible.hot-key")
        with S.approx_scope(FR):
            assert _plain(_qj(pkg, s, src).collect().to_pydict()) == exact
        assert _val(pkg, "approx.ineligible.hot-key") == before + 1


def test_pinned_snapshot_serves_its_twins(tmp_path):
    """A plan pinned before append, compact and vacuum still finds its twins
    and covers the old exact answer, in both packages; once the pin drains,
    vacuum retires the superseded versions with their twins."""
    src = _join_lake(str(tmp_path / "lake"))
    rng = np.random.default_rng(99)
    add = _write(str(tmp_path / "add" / "part1.parquet"),
                 {"fk": rng.integers(0, 1500, 2000).astype(np.int64),
                  "amt": rng.uniform(1, 100, 2000)})
    widths = {}
    for pkg in PKGS:
        S, E, I = PKGS[pkg]["S"], PKGS[pkg]["E"], PKGS[pkg]["ingest"]
        s, hs = _mk_join(pkg, str(tmp_path / pkg), src)
        old = _plain(_qj(pkg, s, src).collect().to_pydict())
        with I.pin_scope():
            plan = _qj(pkg, s, src).optimized_plan()
            hs.append("li_idx", s.read.parquet(add))
            hs.compact_index("li_idx", min_runs=2)
            hs.vacuum_outdated_index("li_idx")
            sp = S.build_sampled_plan(s, plan, FR)
            assert not isinstance(sp, str), sp
            twins = [f.name for n in sp.plan.preorder()
                     if n.kind == "FileScan" and n.sample_spec is not None for f in n.files]
            assert twins and all(os.path.exists(p) for p in twins)
            out, _est, info = S._finalize(E.execute_plan(sp.plan, s), sp)
            got = _plain(out.to_pydict())
            for name in ("s", "n"):
                assert abs(got[name][0] - old[name][0]) <= info["outputs"][name]["ci95_max"]
        assert I.REGISTRY.active_pins() == 0
        hs.vacuum_outdated_index("li_idx")
        li_twins = [p for p in twins if f"{os.sep}li_idx{os.sep}" in p]
        assert li_twins and not any(os.path.exists(p) for p in li_twins)
        widths[pkg] = (got["n"], info["outputs"]["n"])
    assert widths["torch"] == widths["jax"]


# --- crash cells ---------------------------------------------------------------


@pytest.mark.parametrize("spec", ["approx.sample:crash_before:n=1",
                                  "approx.sample:crash_after:n=1"])
def test_append_crash_cell_single_writer(tmp_path, monkeypatch, spec):
    """One IO thread: the fault fires in both packages, ``recover`` and a
    second append leave the same warehouse in both, every data file has
    its twins and meta back, and the index answers as the raw scan."""
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "1")
    src = str(tmp_path / "events")
    _write(os.path.join(src, "part0.parquet"), _ev(0))
    adds = [_write(str(tmp_path / f"add{i}" / f"p{i}.parquet"), _ev(i)) for i in (1, 2)]
    trees = {}
    for pkg in PKGS:
        F, X = PKGS[pkg]["faults"], PKGS[pkg]["X"]
        ws = str(tmp_path / pkg)
        s, hs = _mk_ev(pkg, ws, src)
        before = _val(pkg, "faults.injected")
        F.arm(spec)
        try:
            with pytest.raises(F.InjectedCrash):
                hs.append("ev", s.read.parquet(adds[0]))
        finally:
            F.disarm()
        assert _val(pkg, "faults.injected") == before + 1
        hs.recover(force=True)
        hs.append("ev", s.read.parquet(adds[1]))
        SS = PKGS[pkg]["SS"]
        for path in _data_files(hs, "ev"):
            for f in SS.sample_fractions():
                assert os.path.exists(SS.sample_path(path, f)), path
            assert SS.load_sample_meta(path) is not None
        q = lambda: _plain(s.read.parquet(src).filter(X.col("k") < 50_000).agg(
            X.Sum(X.col("v")).alias("s")).collect().to_pydict())
        got = q()
        s.disable_hyperspace()
        assert q() == got
        trees[pkg] = _tree(ws)
    assert trees["torch"] == trees["jax"]


def test_threaded_crash_after_is_ineligible_or_converged_never_wrong(tmp_path, monkeypatch):
    """Threaded writers may race past ``crash_after:n=1`` (the reference's
    own test of it races, ROADMAP Queue 3): whether or not the crash lands,
    after ``recover`` and a second append the port's exact answer is the
    raw scan's, and a sampled query either declines or covers the exact
    answer (verify mode raises on a miss)."""
    monkeypatch.setenv("HYPERSPACE_IO_THREADS", "4")
    monkeypatch.setenv("HYPERSPACE_APPROX", "verify")
    src = str(tmp_path / "events")
    _write(os.path.join(src, "part0.parquet"), _ev(0))
    adds = [_write(str(tmp_path / f"add{i}" / f"p{i}.parquet"), _ev(i)) for i in (1, 2)]
    s, hs = _mk_ev("torch", str(tmp_path / "torch"), src,
                   **{TC.FILTER_RULE_USE_BUCKET_SPEC: True})
    TF.arm("approx.sample:crash_after:n=1")
    try:
        hs.append("ev", s.read.parquet(adds[0]))
    except TF.InjectedCrash:
        pass
    finally:
        TF.disarm()
    hs.recover(force=True)
    hs.append("ev", s.read.parquet(adds[1]))
    df = lambda: s.read.parquet(src).filter(TX.col("v") < 500).agg(
        TX.Sum(TX.col("v")).alias("s"), TX.Count(TX.lit(1)).alias("n"))
    exact = _plain(df().collect().to_pydict())
    s.disable_hyperspace()
    assert _plain(df().collect().to_pydict()) == exact
    s.enable_hyperspace()
    before = (_val("torch", "approx.sampled"), _val("torch", "approx.ineligible"))
    with TS.approx_scope(FR):
        got = _plain(df().collect().to_pydict())
    after = (_val("torch", "approx.sampled"), _val("torch", "approx.ineligible"))
    assert after[0] - before[0] + after[1] - before[1] == 1
    if after[1] > before[1]:
        assert got == exact


def test_stripped_twins_leave_the_tier_ineligible(tmp_path):
    src = _join_lake(str(tmp_path / "lake"))
    for pkg in PKGS:
        S, SS = PKGS[pkg]["S"], PKGS[pkg]["SS"]
        s, hs = _mk_join(pkg, str(tmp_path / pkg), src)
        for path in _data_files(hs, "li_idx"):
            for f in SS.sample_fractions():
                os.unlink(SS.sample_path(path, f))
        exact = _plain(_qj(pkg, s, src).collect().to_pydict())
        with S.approx_scope(FR):
            assert _plain(_qj(pkg, s, src).collect().to_pydict()) == exact
        assert S.build_sampled_plan(s, _qj(pkg, s, src).optimized_plan(), FR) == "missing-samples"


# --- cross-package reads and the served degrade ---------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_twins_read_across_packages(tmp_path, writer):
    """One package builds the indexes and their twins; both answer the
    sampled join over that warehouse with the same counts and widths."""
    src = _join_lake(str(tmp_path / "lake"))
    ws = str(tmp_path / "wh")
    _mk_join(writer, ws, src)
    got = {}
    for pkg in PKGS:
        s, _hs = _open(pkg, ws)
        approx, info, _text = _sampled(pkg, s, _qj(pkg, s, src))
        assert info and info["fraction"] == FR
        got[pkg] = (approx, info)
    assert got["torch"][0]["n"] == got["jax"][0]["n"]
    assert _close(got["torch"][0]["s"][0], got["jax"][0]["s"][0])
    assert got["torch"][1]["outputs"]["n"] == got["jax"][1]["outputs"]["n"]


def test_served_degrade_engages_the_sampled_tier(tmp_path):
    """A served collect with an unmeetable deadline comes back degraded and
    engaged on the sampled tier in both packages, its interval covering the
    exact answer; with ``allow_approx=False`` it is rejected with a
    ``rejected`` record."""
    src = _join_lake(str(tmp_path / "lake"))
    recs = {}
    for pkg in PKGS:
        qos, serve = PKGS[pkg]["qos"], PKGS[pkg]["serve"]
        s, _hs = _mk_join(pkg, str(tmp_path / pkg), src)
        exact = _plain(_qj(pkg, s, src).collect().to_pydict())
        qos.COST_MODEL.update("q_rev", 5.0)  # a slow exact wall learned
        degrades = PKGS[pkg]["S"].APPROX.snapshot()["degrades"]
        sched = serve.QueryScheduler(max_concurrent=1, queue_depth=4)
        try:
            # 5 s exact against a 1 s deadline: the 0.1 tier's 0.5 s fits
            h = sched.submit(_qj(pkg, s, src).collect, label="q_rev", deadline_s=1.0)
            out = _plain(h.result(60).to_pydict())
            with pytest.raises(serve.DeadlineUnmeetable):
                sched.submit(_qj(pkg, s, src).collect, label="q_rev", deadline_s=1.0,
                             allow_approx=False)
        finally:
            sched.shutdown()
        assert h.ctx.approx_fraction == FR
        led = PKGS[pkg]["mod"].telemetry.attribution.LEDGER
        rec = next(r for r in reversed(led.recent_records()) if r["query_id"] == h.query_id)
        a = rec["approx"]
        assert a["degraded"] and a["engaged"] is True
        for name in ("s", "n"):
            assert abs(out[name][0] - exact[name][0]) <= a["outputs"][name]["ci95_max"]
        assert led.recent_records()[-1]["outcome"] == "rejected"
        assert PKGS[pkg]["S"].APPROX.snapshot()["degrades"] == degrades + 1
        recs[pkg] = {k: a[k] for k in ("degraded", "engaged", "fraction", "requested_f", "rows")}
        recs[pkg]["n"] = a["outputs"]["n"]
        qos.COST_MODEL.reset_for_testing()
    assert recs["torch"] == recs["jax"]
