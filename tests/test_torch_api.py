"""The DataFrame and session surface, globs, and the reference knobs the
port reads, against the JAX package (a mirror of tests/test_dataframe.py
where it tests the reader, globs and the DataFrame methods).

- DataFrame methods: ``with_column``, ``with_column_renamed``, ``union``,
  ``columns``, ``__getitem__``, ``to_pandas``, ``count`` and
  ``write_parquet``; session ``get_conf``, ``unset_conf``,
  ``is_hyperspace_enabled`` and ``create_dataframe``: the same results,
  schemas and errors.
- Globs: wildcard roots, hidden entries never matched by a wildcard, a
  literal path winning over a glob, the declared ``globbingPattern`` (the
  whole string, then its comma-separated parts; ``*`` within one path
  component) and its error, the recorded ``globPaths`` option, a reused
  reader, and refresh re-expanding the recorded scope (new directories in
  scope taken in, others left out, an empty component tolerated): files,
  options, index contents and error messages equal.
- The knobs: ``HYPERSPACE_INDEX_CACHE_MB`` (a query sequence at a small
  budget and at the default: the chunk cache's hits, misses and evictions
  equal the JAX package's ``cache.*`` counters, and the same queries
  upload column data),
  ``HYPERSPACE_DEVICE_CACHE_MB`` and ``HYPERSPACE_HOST_DERIVED_CACHE_MB``
  (one sequence of puts into both packages' caches),
  ``HYPERSPACE_BUILD_CACHE_MB`` (three index builds over one source),
  ``HYPERSPACE_STATS_CACHE_MB``; ``HYPERSPACE_PRUNE`` 0 (the files the
  JAX package reads with pruning off) and ``verify`` (a tampered index
  file raises in both); ``HYPERSPACE_PARK_WAIT_MS`` (a parked wave waits
  that long before its grant).
- The fragment kernel key holds a raw scan's roots, partition columns and
  options.
"""

import os
import time

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.benchmark import tpch as ttpch
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.exceptions import HyperspaceError as TError
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": (J, JC, JX, jio), "torch": (T, TC, TX, tio)}
ERRORS = {"jax": JError, "torch": TError}
REL = 1e-4
MB = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """The JAX package records every query in a process-wide ledger of 256
    entries; the module empties it when it is done."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _session(pkg: str, warehouse: str, device: bool = False, **conf):
    mod, C, _X, _io = PKGS[pkg]
    conf = {C.EXEC_TPU_ENABLED: device, **conf}
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, conf=conf, device="cpu")
    return mod.HyperspaceSession(warehouse, conf=conf)


def _write(pkg: str, path: str, data: dict) -> None:
    mod, _C, _X, io_mod = PKGS[pkg]
    io_mod.write_parquet(mod.columnar.table.ColumnBatch.from_pydict(data), path)


def _both(fn):
    """``fn(pkg)`` for each package: its value, or ``("raised", message)``
    for a HyperspaceError."""
    out = {}
    for pkg in PKGS:
        try:
            out[pkg] = fn(pkg)
        except (JError, TError) as e:
            out[pkg] = ("raised", str(e).replace(str(os.sep) + pkg, ""))
    return out


# ---------------------------------------------------------------------------
# DataFrame and session
# ---------------------------------------------------------------------------

def _frame(pkg, tmp_path):
    src = str(tmp_path / f"src_{pkg}")
    rng = np.random.default_rng(4)
    _write(pkg, os.path.join(src, "p.parquet"),
           {"k": rng.integers(0, 9, 30).tolist(), "v": rng.uniform(0, 1, 30).tolist(),
            "s": rng.choice(["a", "b", "c"], 30).tolist()})
    s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
    return s, s.read.parquet(src)


DF_CASES = {
    "with_column": lambda X, df: df.with_column("w", X.col("v") * 2).to_pydict(),
    "with_column_replaces": lambda X, df: df.with_column("k", X.col("k") + 1).to_pydict(),
    "renamed": lambda X, df: df.with_column_renamed("v", "value").to_pydict(),
    "renamed_absent": lambda X, df: df.with_column_renamed("zz", "y").columns,
    "union": lambda X, df: df.union(df.filter(X.col("k") < 3)).count(),
    "columns": lambda X, df: (df.columns, df.select("s", "k").columns),
    "getitem": lambda X, df: df.filter(df["k"] == 4).select(df["v"]).to_pydict(),
    "getitem_unknown": lambda X, df: df["nope"],
    "count": lambda X, df: df.filter(X.col("s") == "b").count(),
    "to_pandas": lambda X, df: df.sort("k", "v").to_pandas().to_dict(orient="list"),
    "order_by": lambda X, df: df.order_by("v", ascending=False).limit(3).to_pydict(),
}


@pytest.mark.parametrize("case", sorted(DF_CASES))
def test_dataframe_methods_match_jax(tmp_path, case):
    def run(pkg):
        _s, df = _frame(pkg, tmp_path)
        return DF_CASES[case](PKGS[pkg][2], df)

    out = _both(run)
    assert repr(out["torch"]) == repr(out["jax"])


def test_write_parquet_round_trips_across_packages(tmp_path):
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        _s, df = _frame(writer, tmp_path)
        out = str(tmp_path / f"out_{writer}")
        df.filter(PKGS[writer][2].col("k") > 2).write_parquet(out, "part-7.parquet")
        r = _session(reader, str(tmp_path / f"whr_{reader}"))
        back = r.read.parquet(out)
        assert back.to_pydict() == df.filter(PKGS[writer][2].col("k") > 2).to_pydict()
        assert os.listdir(out) == ["part-7.parquet"]


def test_session_methods_match_jax(tmp_path):
    import datetime

    def run(pkg):
        mod, C, X, _io = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        out = [s.get_conf("x.y"), s.get_conf("x.y", 3), s.is_hyperspace_enabled()]
        s.set_conf("x.y", "1")
        out.append(s.get_conf("x.y"))
        s.unset_conf("x.y")
        s.unset_conf("never.set")
        out.append(s.get_conf("x.y"))
        s.enable_hyperspace()
        out.append(s.is_hyperspace_enabled())
        s.set_conf(C.APPLY_ENABLED, False)
        out.append(s.is_hyperspace_enabled())
        s.disable_hyperspace()
        out.append(s.is_hyperspace_enabled())
        schema = mod.columnar.table.Schema([mod.columnar.table.Field("d", "date32")])
        df = s.create_dataframe({"k": [3, 1, None], "s": ["x", None, "y"],
                                 "d": [datetime.date(2020, 1, 2), None, 5]}, schema)
        out.append([(f.name, f.dtype) for f in df.schema])
        out.append(df.filter(X.col("k") > 1).to_pydict())
        out.append(df.to_pydict())
        return out

    out = _both(run)
    assert repr(out["torch"]) == repr(out["jax"])


# ---------------------------------------------------------------------------
# globs
# ---------------------------------------------------------------------------

def _glob_case(case, pkg, root):
    """One glob scenario in ``root``: its observable outcome."""
    mod, C, X, io_mod = PKGS[pkg]
    w = lambda rel, data: _write(pkg, os.path.join(root, rel), data)  # noqa: E731
    s = _session(pkg, os.path.join(root, "_wh"))
    scan_opts = lambda df: {k: v.replace(root, "<root>")  # noqa: E731
                            for k, v in df.plan.options.items()}
    if case == "expand":
        w("y2020/p.parquet", {"a": [2020]})
        w("y2021/p.parquet", {"a": [2021]})
        df = s.read.parquet(os.path.join(root, "y*"))
        return sorted(df.to_pydict()["a"]), scan_opts(df)
    if case == "no_match":
        return s.read.parquet(os.path.join(root, "nope*")).count()
    if case == "declared_ok":
        w("data/p.parquet", {"a": [1]})
        df = s.read.option("globbingPattern", os.path.join(root, "dat*")).parquet(
            os.path.join(root, "data"))
        return df.count(), scan_opts(df)
    if case == "declared_mismatch":
        w("data/p.parquet", {"a": [1]})
        return s.read.option("globbingPattern", os.path.join(root, "other*")).parquet(
            os.path.join(root, "data")).count()
    if case == "namespaced_key":
        w("d/p.parquet", {"a": [1]})
        return s.read.option(C.GLOBBING_PATTERN_KEY, os.path.join(root, "zzz*")).parquet(
            os.path.join(root, "d")).count()
    if case == "star_in_one_component":
        w("a/b/p.parquet", {"x": [1]})
        return s.read.option("globbingPattern", os.path.join(root, "*")).parquet(
            os.path.join(root, "a", "b")).count()
    if case == "literal_brackets":
        w("data1/p.parquet", {"a": [111]})
        w("data[1]/p.parquet", {"a": [222]})
        return s.read.parquet(os.path.join(root, "data[1]")).to_pydict()
    if case == "hidden_entries":
        w("gd/p.parquet", {"a": [1]})
        w("real/data/p.parquet", {"a": [2]})
        w("_staging/data/p.parquet", {"a": [99]})
        os.makedirs(os.path.join(root, "_hyperspace_log"), exist_ok=True)
        open(os.path.join(root, "_SUCCESS"), "w").close()
        return (sorted(s.read.parquet(os.path.join(root, "*")).to_pydict()["a"]),
                s.read.parquet(os.path.join(root, "*", "data")).to_pydict())
    if case == "comma_patterns":
        w("y2020/p.parquet", {"a": [1]})
        w("y2021/p.parquet", {"a": [2]})
        pat = f"{root}/y2020*,{root}/y2021*"
        df = s.read.option("globbingPattern", pat).parquet(os.path.join(root, "y*"))
        return sorted(df.to_pydict()["a"]), scan_opts(df)
    if case == "comma_in_path":
        w("a,b/y2020/f.parquet", {"x": [1]})
        df = s.read.option("globbingPattern", os.path.join(root, "a,b", "y*")).parquet(
            os.path.join(root, "a,b", "y2020"))
        return df.to_pydict(), scan_opts(df)
    if case == "reader_reuse":
        w("gx/p.parquet", {"a": [1]})
        w("lit/p.parquet", {"a": [2]})
        r = s.read
        r.parquet(os.path.join(root, "g*"))
        return scan_opts(r.parquet(os.path.join(root, "lit")))
    if case == "missing_path":
        return s.read.parquet(os.path.join(root, "absent")).count()
    raise ValueError(case)


GLOB_CASES = ["expand", "no_match", "declared_ok", "declared_mismatch", "namespaced_key",
              "star_in_one_component", "literal_brackets", "hidden_entries",
              "comma_patterns", "comma_in_path", "reader_reuse", "missing_path"]


@pytest.mark.parametrize("case", GLOB_CASES)
def test_globs_match_jax(tmp_path, case):
    out = _both(lambda pkg: _glob_case(case, pkg, str(tmp_path / pkg)))
    assert repr(out["torch"]) == repr(out["jax"])


def _refresh_case(case, pkg, root):
    """An index over a glob scope, a lake change, a full refresh: the
    index's keys after it."""
    mod, C, X, io_mod = PKGS[pkg]
    w = lambda rel, k: _write(pkg, os.path.join(root, rel), {"k": [k], "v": [float(k)]})  # noqa
    s = _session(pkg, os.path.join(root, "_wh"))
    hs = mod.Hyperspace(s)
    w("y2020/f.parquet", 1)
    read = s.read
    if case == "new_glob_dir":
        df = read.parquet(os.path.join(root, "y*"))
    elif case == "declared_literal_root":
        df = read.option("globbingPattern", os.path.join(root, "y*")).parquet(
            os.path.join(root, "y2020"))
    elif case == "declared_scope":
        df = read.option("globbingPattern", os.path.join(root, "y2020*")).parquet(
            os.path.join(root, "y*"))
    else:  # empty_component
        df = read.option("globbingPattern", f"{root}/y2020*,{root}/z*").parquet(
            os.path.join(root, "y*"))
    hs.create_index(df, mod.CoveringIndexConfig("gidx", ["k"], ["v"]))
    if case == "empty_component":
        hs.refresh_index("gidx", "full")  # no change: nothing to do
    w("y2021/f.parquet", 2)
    w("y2020b/f.parquet", 3)
    w("znew/f.parquet", 5)
    hs.refresh_index("gidx", "full")
    e = hs.get_index("gidx")
    keys = sorted(io_mod.read_parquet(e.content.files()).to_pydict()["k"])
    return keys, e.relation.options.get(C.OPT_GLOB_PATHS, "").replace(root, "<root>")


@pytest.mark.parametrize("case", ["new_glob_dir", "declared_literal_root", "declared_scope",
                                  "empty_component"])
def test_refresh_reexpands_the_recorded_glob_scope_as_jax(tmp_path, case):
    out = _both(lambda pkg: _refresh_case(case, pkg, str(tmp_path / pkg)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"new_glob_dir": [1, 2, 3], "declared_literal_root": [1, 2, 3],
                               "declared_scope": [1, 3], "empty_component": [1, 3, 5]}[case]


def test_glob_helpers_match_jax(tmp_path):
    from hyperspace_tpu.sources import interfaces as ji
    from hyperspace_tpu_torch.sources import interfaces as ti

    for enc in (["/a/b", "/c,d/e*"], []):
        assert ti.encode_glob_paths(enc) == ji.encode_glob_paths(enc)
        assert ti.decode_glob_paths(ti.encode_glob_paths(enc)) == enc
    assert ti.decode_glob_paths("/x,/y") == ji.decode_glob_paths("/x,/y")
    for pat, match in (("/r/*/d", "/r/_s/d"), ("/r/_s/*", "/r/_s/d"), ("/r/**", "/r/a/.b/c")):
        assert ti._wildcard_match_is_hidden(pat, match) == ji._wildcard_match_is_hidden(pat, match)
    os.makedirs(tmp_path / "a1")
    with pytest.raises(TError, match="Glob scope matched no paths at all"):
        ti.expand_glob_roots([str(tmp_path / "z*")], allow_empty=True)
    assert ti.expand_glob_roots([str(tmp_path / "a*"), str(tmp_path / "z*")],
                                allow_empty=True) == [str(tmp_path / "a1")]


# ---------------------------------------------------------------------------
# the cache knobs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_lake(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch"))
    ttpch.generate_tpch(root, rows_lineitem=160_000, seed=5)
    return root


def _cache_queries(X, root):
    li = lambda s: s.read.parquet(os.path.join(root, "lineitem"))  # noqa: E731
    c = X.col
    return {
        "by_flag": lambda s: li(s).group_by("l_returnflag", "l_linestatus").agg(
            X.Sum(c("l_quantity")).alias("q"), X.Count(X.lit(1)).alias("n")),
        "ship_range": lambda s: li(s).filter((c("l_shipdate") >= 8766) & (c("l_shipdate") < 9131))
        .agg(X.Sum(c("l_extendedprice") * c("l_discount")).alias("r"),
             X.Count(X.lit(1)).alias("n")),
        "key_range": lambda s: li(s).filter((c("l_orderkey") >= 100) & (c("l_orderkey") < 20000))
        .agg(X.Sum(c("l_extendedprice")).alias("r"), X.Count(X.lit(1)).alias("n")),
    }


CACHE_SEQUENCE = ["by_flag", "ship_range", "key_range", "by_flag", "ship_range", "key_range",
                  "ship_range"]
INDEX_CACHE_NAMES = ("cache.index_chunk.hits", "cache.index_chunk.misses",
                     "cache.index_chunk.evictions")


@pytest.mark.parametrize("index_mb", ["3", "1024"])
def test_index_cache_knob_counts_match_jax(tpch_lake, tmp_path, monkeypatch, index_mb):
    """The same query sequence at HYPERSPACE_INDEX_CACHE_MB=3 (evictions)
    and at the default: the port's chunk-cache hits, misses and evictions
    equal the JAX package's ``cache.index_chunk.*`` counters, and the
    queries that upload column data (device-cache misses, the JAX
    package's ``cache.device.misses`` less its row masks, which the port
    fills on the card) are the same: at the small budget every run, at the
    default only the first run of each query."""
    from hyperspace_tpu.telemetry.metrics import REGISTRY
    from hyperspace_tpu.utils.device_cache import DEVICE_CACHE

    monkeypatch.setenv("HYPERSPACE_INDEX_CACHE_MB", index_mb)
    monkeypatch.setattr(jio._INDEX_CHUNK_CACHE, "max_bytes", int(index_mb) * MB)
    jio._INDEX_CHUNK_CACHE.clear()
    out = {}
    for pkg in PKGS:
        mod, C, X, _io = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), device=True,
                     **{C.INDEX_NUM_BUCKETS: 4})
        hs = mod.Hyperspace(s)
        lineitem = os.path.join(tpch_lake, "lineitem")
        for spec in (ttpch.LI_ORDERKEY, ttpch.LI_FLAGSTATUS):
            hs.create_index(s.read.parquet(lineitem), mod.CoveringIndexConfig(*spec))
        hs.create_index(s.read.parquet(lineitem),
                        mod.ZOrderCoveringIndexConfig(*ttpch.LI_SHIPDATE_Z))
        s.enable_hyperspace()
        queries = _cache_queries(X, tpch_lake)
        uploaded = []
        if pkg == "jax":
            DEVICE_CACHE.clear()
            before = {n: REGISTRY.counter(n).value for n in INDEX_CACHE_NAMES}
            for q in CACHE_SEQUENCE:
                keyed = {k for k in DEVICE_CACHE._d if k[0] == "keyed"}
                misses = REGISTRY.counter("cache.device.misses").value
                queries[q](s).collect()
                masks = len({k for k in DEVICE_CACHE._d if k[0] == "keyed"} - keyed)
                uploaded.append(REGISTRY.counter("cache.device.misses").value - misses
                                - masks > 0)
            counts = [REGISTRY.counter(n).value - before[n] for n in INDEX_CACHE_NAMES]
        else:
            for q in CACHE_SEQUENCE:
                misses = s.device_cache.misses
                queries[q](s).collect()
                uploaded.append(s.device_cache.misses > misses)
            c = s.index_chunk_cache
            assert c.max_bytes == int(index_mb) * MB
            assert c.check_consistency()
            counts = [c.hits, c.misses, c.evictions]
        out[pkg] = (counts, uploaded)
    assert out["torch"] == out["jax"]
    if index_mb == "3":
        assert out["torch"][0][2] > 0 and all(out["torch"][1])
    else:
        assert out["torch"][1] == [True, True, True, False, False, False, False]


def _cache_sequence(get_or_put, arrays):
    """Puts of the same buffers in one order: first uses, repeats, and a
    buffer larger than the budget."""
    for i in (0, 1, 2, 0, 3, 1, 4, 2, 0, 5):
        a = arrays[i]
        get_or_put(a, ("t", i), lambda a=a: a.copy())


@pytest.mark.parametrize("knob,mb", [("HYPERSPACE_DEVICE_CACHE_MB", "0.5"),
                                     ("HYPERSPACE_DEVICE_CACHE_MB", "0"),
                                     ("HYPERSPACE_HOST_DERIVED_CACHE_MB", "0.3")])
def test_device_cache_knobs_count_as_jax(tmp_path, monkeypatch, knob, mb):
    from hyperspace_tpu.utils.device_cache import DeviceArrayCache

    monkeypatch.setenv(knob, mb)
    arrays = [np.arange(n, dtype=np.float64) for n in (20_000, 30_000, 15_000, 25_000,
                                                        40_000, 90_000)]
    jcache = DeviceArrayCache(knob, "6144")
    _cache_sequence(lambda a, tag, b: jcache.get_or_put(a, tag, b), arrays)
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    tcache = s.device_cache if knob == "HYPERSPACE_DEVICE_CACHE_MB" else s.host_derived_cache
    assert tcache.budget_bytes == int(float(mb) * MB)
    _cache_sequence(lambda a, tag, b: tcache.get_or_put((a,), tag, b), arrays)
    got = (tcache.hits, tcache.misses, tcache.evictions, tcache.evicted_bytes)
    assert got == (jcache.hits, jcache.misses, jcache.evictions, jcache.evicted_bytes)
    if mb == "0":
        assert tcache.resident_bytes == 0 and tcache.hits == 0


def test_build_cache_knob_counts_match_jax(tpch_lake, tmp_path, monkeypatch):
    """Three covering builds over one lineitem at HYPERSPACE_BUILD_CACHE_MB=2:
    the source-column cache's counts equal the JAX package's
    ``cache.source_col.*``, and the index files are the same."""
    from hyperspace_tpu.telemetry.metrics import REGISTRY

    names = ("hits", "misses", "evictions", "evicted_bytes")
    monkeypatch.setenv("HYPERSPACE_BUILD_CACHE_MB", "2")
    monkeypatch.setattr(jio._SOURCE_COL_CACHE, "max_bytes", 2 * MB)
    jio._SOURCE_COL_CACHE.clear()
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), **{PKGS[pkg][1].INDEX_NUM_BUCKETS: 4})
        if pkg == "torch":
            c = tio._SOURCE_COL_CACHE
            assert c.max_bytes == 2 * MB
            c.resize(0)
            c.resize(2 * MB)
            base = [getattr(c, n) for n in names]
        else:
            base = [REGISTRY.counter(f"cache.source_col.{n}").value for n in names]
        hs = mod.Hyperspace(s)
        for spec in (ttpch.LI_ORDERKEY, ttpch.LI_FLAGSTATUS, ttpch.LI_PARTKEY):
            hs.create_index(s.read.parquet(os.path.join(tpch_lake, "lineitem")),
                            mod.CoveringIndexConfig(*spec))
        if pkg == "torch":
            now = [getattr(c, n) for n in names]
        else:
            now = [REGISTRY.counter(f"cache.source_col.{n}").value for n in names]
        out[pkg] = ([a - b for a, b in zip(now, base)],
                    {os.path.basename(f): open(f, "rb").read()
                     for f in hs.get_index("li_partkey").content.files()})
    assert out["torch"][0] == out["jax"][0] and out["torch"][0][2] > 0
    assert out["torch"][1] == out["jax"][1]


@pytest.mark.parametrize("mb", ["0", "64"])
def test_stats_cache_knob(tpch_lake, tmp_path, monkeypatch, mb):
    monkeypatch.setenv("HYPERSPACE_STATS_CACHE_MB", mb)
    T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    cache = tio._ROWGROUP_STATS_CACHE
    assert cache.max_bytes == int(mb) * MB
    path = os.path.join(tpch_lake, "lineitem", "part-0000.parquet")
    hits = cache.hits
    got = [tio.read_rowgroup_stats(path, ["l_orderkey"]) for _ in range(2)]
    assert got[0] == got[1] == jio.read_rowgroup_stats(path, ["l_orderkey"])
    assert cache.hits - hits == (0 if mb == "0" else 1)
    monkeypatch.delenv("HYPERSPACE_STATS_CACHE_MB")
    T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    assert cache.max_bytes == 64 * MB


def test_default_cache_budgets_are_the_jax_packages(tmp_path, monkeypatch):
    for knob in ("HYPERSPACE_INDEX_CACHE_MB", "HYPERSPACE_DEVICE_CACHE_MB",
                 "HYPERSPACE_HOST_DERIVED_CACHE_MB", "HYPERSPACE_BUILD_CACHE_MB",
                 "HYPERSPACE_STATS_CACHE_MB"):
        monkeypatch.delenv(knob, raising=False)
    s = T.HyperspaceSession(str(tmp_path / "wh"), device="cpu")
    from hyperspace_tpu.utils import env as jenv

    assert s.index_chunk_cache.max_bytes == jenv.env_int("HYPERSPACE_INDEX_CACHE_MB") * MB
    assert s.device_cache.budget_bytes == int(jenv.env_float("HYPERSPACE_DEVICE_CACHE_MB") * MB)
    assert s.host_derived_cache.budget_bytes == int(
        jenv.env_float("HYPERSPACE_HOST_DERIVED_CACHE_MB") * MB)
    assert tio._SOURCE_COL_CACHE.max_bytes == jenv.env_int("HYPERSPACE_BUILD_CACHE_MB") * MB
    assert tio._ROWGROUP_STATS_CACHE.max_bytes == jenv.env_int("HYPERSPACE_STATS_CACHE_MB") * MB
    assert (s.index_chunk_cache.max_bytes, s.device_cache.budget_bytes) == (1024 * MB, 6144 * MB)


# ---------------------------------------------------------------------------
# HYPERSPACE_PRUNE and HYPERSPACE_PARK_WAIT_MS
# ---------------------------------------------------------------------------

def _lookup(X, root, key):
    return lambda s: s.read.parquet(os.path.join(root, "lineitem")).filter(
        X.col("l_orderkey") == key).agg(X.Sum(X.col("l_extendedprice")).alias("r"),
                                        X.Count(X.lit(1)).alias("n"))


@pytest.mark.parametrize("mode", ["0", "1"])
def test_prune_knob_reads_the_files_the_jax_package_reads(tpch_lake, tmp_path, monkeypatch,
                                                          mode):
    monkeypatch.setenv("HYPERSPACE_PRUNE", mode)
    key = ttpch.first_orderkey(tpch_lake)
    wh = str(tmp_path / "wh")
    s = _session("torch", wh, **{TC.INDEX_NUM_BUCKETS: 4})
    T.Hyperspace(s).create_index(s.read.parquet(os.path.join(tpch_lake, "lineitem")),
                                 T.CoveringIndexConfig(*ttpch.LI_ORDERKEY))
    out = {}
    for pkg in PKGS:
        X, io_mod = PKGS[pkg][2], PKGS[pkg][3]
        reads = []
        orig = io_mod.read_parquet
        monkeypatch.setattr(io_mod, "read_parquet",
                            lambda paths, *a, **k: reads.extend(paths) or orig(paths, *a, **k))
        s = _session(pkg, wh).enable_hyperspace()
        got = _lookup(X, tpch_lake, key)(s).to_pydict()
        out[pkg] = (sorted(os.path.basename(p) for p in reads), got["n"], got["r"])
        monkeypatch.setattr(io_mod, "read_parquet", orig)
    assert out["torch"][:2] == out["jax"][:2]
    assert out["torch"][2] == pytest.approx(out["jax"][2], rel=REL)
    assert len(out["torch"][0]) == (4 if mode == "0" else 1)


def test_prune_verify_raises_on_a_tampered_index_file(tpch_lake, tmp_path, monkeypatch):
    """Two bucket files swap names: pruning keeps the file named for the
    key's bucket, which now holds another bucket's rows. With pruning on,
    both packages miss the key; in verify mode both raise."""
    key = ttpch.first_orderkey(tpch_lake)
    wh = str(tmp_path / "wh")
    s = _session("torch", wh, **{TC.INDEX_NUM_BUCKETS: 4})
    T.Hyperspace(s).create_index(s.read.parquet(os.path.join(tpch_lake, "lineitem")),
                                 T.CoveringIndexConfig(*ttpch.LI_ORDERKEY))
    vdir = os.path.join(wh, "indexes", "li_orderkey", "v__=0")
    files = sorted(f for f in os.listdir(vdir) if f.endswith(".parquet"))
    s.enable_hyperspace()
    (scan,) = [n for n in _lookup(TX, tpch_lake, key)(s).optimized_plan().preorder()
               if getattr(n, "index_info", None) is not None]
    kept = os.path.basename(scan.files[0].name)
    other = next(f for f in files if f != kept)
    tmp = os.path.join(vdir, "swap")
    os.rename(os.path.join(vdir, kept), tmp)
    os.rename(os.path.join(vdir, other), os.path.join(vdir, kept))
    os.rename(tmp, os.path.join(vdir, other))
    out = {}
    for pkg in PKGS:
        X = PKGS[pkg][2]
        monkeypatch.setenv("HYPERSPACE_PRUNE", "1")
        missed = _lookup(X, tpch_lake, key)(_session(pkg, wh).enable_hyperspace()).to_pydict()
        monkeypatch.setenv("HYPERSPACE_PRUNE", "verify")
        with pytest.raises(ERRORS[pkg], match="verify mismatch"):
            _lookup(X, tpch_lake, key)(_session(pkg, wh).enable_hyperspace()).collect()
        out[pkg] = missed["n"]
    assert out["torch"] == out["jax"] == [0]


@pytest.mark.parametrize("wait_ms", ["1", "300"])
def test_park_wait_knob_sets_the_parked_grant_wait(monkeypatch, wait_ms):
    """Another join holds the ledger; ours has nothing of its own to spill,
    so it waits HYPERSPACE_PARK_WAIT_MS for a release, then is granted."""
    from hyperspace_tpu_torch.plan import join_memory as tjm
    from hyperspace_tpu_torch.serve import budget as tbudget

    monkeypatch.setenv("HYPERSPACE_PARK_WAIT_MS", wait_ms)
    monkeypatch.setenv("HYPERSPACE_DEVICE_BUDGET_MB", str(150 / MB))
    acct = tbudget.reset_device_budget()
    try:
        other = acct.stream("other-query")
        assert other.try_reserve(100)
        ledger = tjm.DeviceLedger("join")
        t0 = time.perf_counter()
        ledger.admit(100, lambda: False)
        waited = time.perf_counter() - t0
        assert ledger.parks == 1
        assert float(wait_ms) / 1000 <= waited < float(wait_ms) / 1000 + 1.0
        ledger.close()
        other.close()
    finally:
        monkeypatch.delenv("HYPERSPACE_DEVICE_BUDGET_MB")
        tbudget.reset_device_budget()


# ---------------------------------------------------------------------------
# the fragment kernel key
# ---------------------------------------------------------------------------

def test_kernel_key_holds_the_raw_scans_layout(tmp_path):
    from hyperspace_tpu_torch.columnar.table import Field, Schema
    from hyperspace_tpu_torch.plan.kernel_cache import fused_fingerprint, scan_structure
    from hyperspace_tpu_torch.plan.nodes import FileScan

    schema = Schema([Field("x", "float32"), Field("p", "int64")])
    base = FileScan(["/lake/a"], "parquet", schema, [], partition_columns=["p"])
    variants = [base.copy(root_paths=["/lake/b"]), base.copy(partition_columns=[]),
                base.copy(options={"globPaths": "[\"/lake/*\"]"}), base.copy(fmt="csv")]
    keys = {fused_fingerprint("plain", v, None, (), [("count", None)], {})
            for v in [base] + variants}
    assert len(keys) == 5
    assert scan_structure(base) == scan_structure(base.copy(files=[]))
