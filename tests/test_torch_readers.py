"""The readers and the formats they index, the port against the JAX
package on the same files (a mirror of tests/test_source_formats.py and
tests/test_nested_columns.py).

- Each reader (parquet, CSV with a header, newline-delimited JSON, ORC,
  text) over two files of seeded numpy data: the batch, its schema (dtypes
  included: an ISO date in a CSV reads as date32) and
  ``read_schema`` equal; ``read_files`` dispatches by format and raises on
  an unknown one; avro raises HyperspaceError without ``fastavro``.
  ``write_orc`` and ``write_text`` of one package read by the other.
- String columns that one file stores dictionary-encoded and another
  plain concatenate as in the JAX package.
- Struct columns: the flattened ``__hs_nested.`` schema, dotted references
  in filter, select and group-by, a null parent struct, and a covering
  index on a nested field; results equal.
- Indexes over CSV, JSON, ORC and text sources, lineage on and off:
  built by each package in one warehouse, index files byte for byte and
  log entries (less wall-clock fields) equal; queries through them equal
  the raw source's; the source-format setting gates which formats index.

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
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.exceptions import HyperspaceError as TError
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": (J, JC, JX, jio), "torch": (T, TC, TX, tio)}
ERRORS = {"jax": JError, "torch": TError}
REL = 1e-4
ROWS = 50
MTIME_NS = 1_700_000_000 * 10**9  # one fixed mtime: signatures hash it


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


def _table(seed: int, n: int = ROWS) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 20, n),
        "v": np.round(rng.uniform(0, 100, n), 3),
        "s": rng.choice(["ab", "c", "dd e", "f,g"], n),
        "flag": rng.integers(0, 2, n).astype(bool),
    })


def _write_format(fmt: str, d: str, i: int) -> str:
    """File ``i`` of format ``fmt`` under ``d`` (seeded by ``i``)."""
    os.makedirs(d, exist_ok=True)
    t = _table(i)
    path = os.path.join(d, f"part-{i}.{fmt}")
    if fmt == "csv":
        import pyarrow.csv as pacsv

        dates = pa.array(np.datetime64("2020-01-01") + np.arange(len(t)) * (i + 1),
                         pa.date32())
        pacsv.write_csv(t.append_column("d", dates), path)
    elif fmt == "json":
        with open(path, "w") as f:
            for row in t.to_pylist():
                f.write(json.dumps(row) + "\n")
    elif fmt == "orc":
        from pyarrow import orc

        orc.write_table(t, path)
    elif fmt == "text":
        with open(path, "w", newline="") as f:
            f.write("".join(f"{s} {k}\r\n" if k % 3 == 0 else f"{s} {k}\n"
                            for s, k in zip(t.column("s").to_pylist(),
                                            t.column("k").to_pylist())))
            f.write("line kept")  # no trailing newline, a Unicode break inside
    else:
        pq.write_table(t, path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))
    return path


def _as_lists(batch) -> tuple:
    return ([(f.name, f.dtype) for f in batch.schema],
            {n: list(c.decode()) for n, c in batch.columns.items()})


def _assert_batches_equal(got: tuple, want: tuple) -> None:
    assert got[0] == want[0]
    for name, values in want[1].items():
        g = got[1][name]
        assert len(g) == len(values), name
        for a, b in zip(g, values):
            if isinstance(b, float) and b == b:
                assert a == pytest.approx(b, rel=REL), name
            else:
                assert a == b or (a != a and b != b), name


FORMATS = ["parquet", "csv", "json", "orc", "text"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_readers_match_jax(tmp_path, fmt):
    d = str(tmp_path / fmt)
    paths = [_write_format(fmt, d, i) for i in (1, 2)]
    got = _as_lists(tio.read_files(fmt, paths))
    want = _as_lists(jio.read_files(fmt, paths))
    _assert_batches_equal(got, want)
    assert got[1] and len(next(iter(got[1].values()))) > ROWS
    assert tio.read_schema(fmt, paths[0]).to_list() == jio.read_schema(fmt, paths[0]).to_list()
    cols = ["value"] if fmt == "text" else ["v", "k"]
    _assert_batches_equal(_as_lists(tio.read_files(fmt, paths, cols)),
                          _as_lists(jio.read_files(fmt, paths, cols)))


def test_csv_dates_read_as_the_jax_packages(tmp_path):
    path = _write_format("csv", str(tmp_path / "c"), 3)
    assert dict(tio.read_schema("csv", path).to_list()[-1]) == {"name": "d", "type": "date32"}
    assert tio.read_schema("csv", path).to_list() == jio.read_schema("csv", path).to_list()


@pytest.mark.parametrize("fmt", ["avro", "xml"])
def test_unreadable_formats_raise_as_jax(tmp_path, fmt):
    path = str(tmp_path / f"x.{fmt}")
    open(path, "wb").close()
    with pytest.raises(JError) as je:
        jio.read_files(fmt, [path])
    with pytest.raises(TError) as te:
        tio.read_files(fmt, [path])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("fmt", ["orc", "text"])
def test_written_files_read_by_the_other_package(tmp_path, writer, reader, fmt):
    wmod, _C, _X, wio = PKGS[writer]
    rio = PKGS[reader][3]
    data = {"value": ["hello", "world", "", "a b"]} if fmt == "text" else {
        "k": [3, 1, 2, 1], "v": [1.0, 2.0, 3.0, 4.0], "s": ["a", "b", "c", "d"]}
    batch = wmod.columnar.table.ColumnBatch.from_pydict(data)
    path = str(tmp_path / f"part-0.{fmt}")
    (wio.write_text if fmt == "text" else wio.write_orc)(batch, path)
    got = rio.read_files(fmt, [path]).to_pydict()
    assert got == data


def test_mixed_string_encodings_concatenate_as_jax(tmp_path):
    a = pa.table({"s": pa.array(["x", "y", "x"]).dictionary_encode(), "n": [1, 2, 3]})
    b = pa.table({"s": pa.array(["z", "x"]), "n": [4, 5]})
    paths = [str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")]
    pq.write_table(a, paths[0])
    pq.write_table(b, paths[1], use_dictionary=False)
    got, want = tio.read_parquet(paths), jio.read_parquet(paths)
    assert _as_lists(got) == _as_lists(want)
    assert got.column("s").dictionary == want.column("s").dictionary


# ---------------------------------------------------------------------------
# struct columns
# ---------------------------------------------------------------------------

def _write_nested(d: str, n: int = 400, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 40, n)
    valid = rng.uniform(0, 1, n) > 0.1
    t = pa.table({
        "id": pa.array(np.arange(n)),
        "nested": pa.StructArray.from_arrays(
            [pa.array(cnt), pa.StructArray.from_arrays(
                [pa.array(rng.uniform(0, 1, n))], names=["score"])],
            names=["cnt", "leaf"], mask=pa.array(~valid)),
    })
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "p.parquet")
    pq.write_table(t, path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))


def _nested_queries(X):
    c = X.col
    return {
        "filter_select": lambda df: df.filter(c("nested.cnt") < 10).select("id", "nested.cnt"),
        "not_null": lambda df: df.filter(c("nested.cnt").is_not_null()).agg(
            X.Count(X.lit(1)).alias("n")),
        "grouped": lambda df: df.group_by("nested.cnt").agg(
            X.Sum(c("nested.leaf.score")).alias("s"), X.Count(X.lit(1)).alias("n")),
        "point": lambda df: df.filter(c("nested.cnt") == 7).select("id", "nested.cnt"),
    }


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("q", ["filter_select", "not_null", "grouped", "point"])
def test_nested_columns_match_jax(tmp_path, q, device):
    src = str(tmp_path / "src")
    _write_nested(src)
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"), device=device)
        df = s.read.parquet(src)
        res = _nested_queries(PKGS[pkg][2])[q](df).to_pydict()
        key = sorted(res)[0]
        order = np.argsort(np.asarray(res[key], dtype=np.float64), kind="stable")
        out[pkg] = (df.schema.names, {k: [v[i] for i in order] for k, v in res.items()})
    assert out["torch"][0] == out["jax"][0]
    assert "__hs_nested.nested.leaf.score" in out["torch"][0]
    got, want = out["torch"][1], out["jax"][1]
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL) if k == "s" else got[k] == want[k]


def test_covering_index_on_a_nested_field_is_the_jax_packages(tmp_path):
    src = str(tmp_path / "src")
    _write_nested(src)
    wh = str(tmp_path / "wh")
    captured, results = {}, {}
    for pkg in PKGS:
        mod, _C, X, _io = PKGS[pkg]
        shutil.rmtree(wh, ignore_errors=True)
        s = _session(pkg, wh)
        hs = mod.Hyperspace(s)
        hs.create_index(s.read.parquet(src),
                        mod.CoveringIndexConfig("nidx", ["nested.cnt"], ["id"]))
        assert hs.get_index("nidx").derived_dataset.indexed_columns() == [
            "__hs_nested.nested.cnt"]
        captured[pkg] = _capture(wh)
        s.enable_hyperspace()
        q = _nested_queries(X)["point"](s.read.parquet(src))
        assert _used(q) == ["nidx"]
        results[pkg] = q.to_pydict()
    _assert_same(captured)
    assert sorted(results["torch"]["id"]) == sorted(results["jax"]["id"])


# ---------------------------------------------------------------------------
# indexes over the other formats
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


def _assert_same(captured: dict) -> None:
    assert sorted(captured["torch"]) == sorted(captured["jax"])
    for k in captured["jax"]:
        assert captured["torch"][k] == captured["jax"][k], k


def _used(df) -> list:
    return [n.index_info.index_name for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


def _read(s, fmt, d):
    return getattr(s.read, fmt)(d) if fmt != "parquet" else s.read.parquet(d)


INDEX_FORMATS = ["csv", "json", "orc", "text"]


@pytest.mark.parametrize("lineage", [False, True])
@pytest.mark.parametrize("fmt", INDEX_FORMATS)
def test_indexes_over_other_formats_are_the_jax_packages(tmp_path, fmt, lineage):
    d = str(tmp_path / fmt)
    for i in (1, 2, 3):
        _write_format(fmt, d, i)
    wh = str(tmp_path / "wh")
    indexed, included = (["value"], []) if fmt == "text" else (["k"], ["v", "s"])
    captured, results = {}, {}
    for pkg in PKGS:
        mod, C, X, _io = PKGS[pkg]
        shutil.rmtree(wh, ignore_errors=True)
        s = _session(pkg, wh, **{C.INDEX_LINEAGE_ENABLED: lineage})
        hs = mod.Hyperspace(s)
        hs.create_index(_read(s, fmt, d), mod.CoveringIndexConfig("fidx", indexed, included))
        assert hs.get_index("fidx").relation.file_format == fmt
        captured[pkg] = _capture(wh)
        cond = (X.col("value") == "c 4") if fmt == "text" else (X.col("k") == 7)
        q = lambda s: _read(s, fmt, d).filter(cond).select(*(indexed + included))  # noqa: E731
        raw = q(s).to_pydict()
        s.enable_hyperspace()
        assert _used(q(s)) == ["fidx"]
        results[pkg] = (q(s).to_pydict(), raw)
    _assert_same(captured)
    for pkg in PKGS:
        got, raw = results[pkg]
        assert sorted(zip(*got.values())) == sorted(zip(*raw.values())), pkg
    assert results["torch"][0] == results["jax"][0]


@pytest.mark.parametrize("builder,reader", [("jax", "torch"), ("torch", "jax")])
def test_csv_index_cross_reads(tmp_path, builder, reader):
    d = str(tmp_path / "csv")
    for i in (1, 2):
        _write_format("csv", d, i)
    wh = str(tmp_path / "wh")
    bmod = PKGS[builder][0]
    s = _session(builder, wh)
    bmod.Hyperspace(s).create_index(s.read.csv(d), bmod.CoveringIndexConfig("cidx", ["k"], ["v"]))
    X = PKGS[reader][2]
    r = _session(reader, wh, device=True)
    q = lambda: r.read.csv(d).filter(X.col("k") < 5).agg(  # noqa: E731
        X.Sum(X.col("v")).alias("sv"), X.Count(X.lit(1)).alias("n"))
    raw = q().to_pydict()
    r.enable_hyperspace()
    assert _used(q()) == ["cidx"]
    got = q().to_pydict()
    assert got["n"] == raw["n"]
    assert got["sv"] == pytest.approx(raw["sv"], rel=REL)


def test_source_formats_setting_gates_indexing(tmp_path):
    d = str(tmp_path / "orc")
    _write_format("orc", d, 1)
    for pkg in PKGS:
        mod, C, _X, _io = PKGS[pkg]
        s = _session(pkg, str(tmp_path / f"wh_{pkg}"))
        assert s.conf.default_source_formats == ("avro", "csv", "json", "orc", "parquet",
                                                 "text")
        s.set_conf(C.DEFAULT_SOURCE_FORMATS, "parquet,csv")
        with pytest.raises(ERRORS[pkg], match="not supported for indexing"):
            mod.Hyperspace(s).create_index(s.read.orc(d),
                                           mod.CoveringIndexConfig("o", ["k"], ["v"]))
        s.unset_conf(C.DEFAULT_SOURCE_FORMATS)
        mod.Hyperspace(s).create_index(s.read.orc(d), mod.CoveringIndexConfig("o", ["k"], ["v"]))
