"""The reference's NULL and three-valued-logic cases
(tests/test_null_semantics.py) on the port, each on the host and on the
device tier (``device="cpu"``), each answer equal to the JAX package's.

The expression cases compare the evaluated masks, then the rows a filter
keeps over the same nullable columns read back from parquet (so the
device tier's fragment meets them); the join and aggregation cases run
over parquet files too, with null keys, null groups and all-null groups;
the raising cases raise the typed error in both. A nullable measure
declines to the host (``nullable_or_out_of_range``) in both packages; a
null group key runs on the device tier."""

import datetime
import os

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar import table as jtable
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.columnar import table as ttable
from hyperspace_tpu_torch.exceptions import HyperspaceError as TError
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {
    "jax": {"mod": J, "C": JC, "io": jio, "table": jtable, "X": JX, "error": JError},
    "torch": {"mod": T, "C": TC, "io": tio, "table": ttable, "X": TX, "error": TError},
}
TIERS = ("host", "device")


def _session(pkg: str, root, tier: str):
    p = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    s = p["mod"].HyperspaceSession(str(root / pkg), **kw)
    s.set_conf(p["C"].EXEC_TPU_ENABLED, tier == "device")
    return s


def _nullable_int(pkg: str, values):
    data = np.array([0 if v is None else v for v in values], dtype=np.int64)
    validity = np.array([v is not None for v in values], dtype=bool)
    return PKGS[pkg]["table"].Column(data, "int64", validity)


def _frame(pkg: str, session, root, name: str, columns: dict):
    """``columns`` (name -> values, None for NULL, ints nullable) written
    to parquet by ``pkg`` and read back through ``session``."""
    t = PKGS[pkg]["table"]
    cols = {}
    for c, values in columns.items():
        if all(v is None or isinstance(v, int) for v in values):
            cols[c] = _nullable_int(pkg, values)
        else:
            cols[c] = t.Column.from_values(values)
    path = os.path.join(str(root), pkg, "src", name)
    PKGS[pkg]["io"].write_parquet(t.ColumnBatch(cols), os.path.join(path, "p.parquet"))
    return session.read.parquet(path)


def _plain(d: dict) -> dict:
    return {k: [v.item() if hasattr(v, "item") else v for v in vals] for k, vals in d.items()}


NB = {"a": [5, None, 7], "k": [1, None, 0]}

PREDICATES = {
    "not_of_null_comparison": lambda X: X.Not(X.col("a") == 5),
    "nnf_rewrite": lambda X: X.to_nnf(X.Not(X.col("a") == 5)),
    "kleene_or_with_known_true": lambda X: (X.col("a") == 999) | (X.col("k").is_null()),
    "kleene_and_with_known_false": lambda X: (X.col("a") == 5) & (X.col("k") == 1),
    "in_with_null": lambda X: X.col("a").isin([5, 7]),
    "not_in_with_null": lambda X: X.Not(X.col("a").isin([5])),
}
MASKS = {
    "not_of_null_comparison": [False, False, True],
    "nnf_rewrite": [False, False, True],
    "kleene_or_with_known_true": [False, True, False],
    "kleene_and_with_known_false": [True, False, False],
    "in_with_null": [True, False, True],
    "not_in_with_null": [False, False, True],
}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", sorted(PREDICATES))
def test_three_valued_logic_as_the_jax_package(tmp_path, case, tier):
    out = {}
    for pkg, p in PKGS.items():
        nb = p["table"].ColumnBatch({c: _nullable_int(pkg, v) for c, v in NB.items()})
        pred = PREDICATES[case](p["X"])
        mask = [bool(v) for v in pred.eval(nb).data]
        df = _frame(pkg, _session(pkg, tmp_path, tier), tmp_path, "nb", NB)
        rows = df.filter(pred).agg(p["X"].Count(p["X"].lit(1)).alias("n"),
                                   p["X"].Sum(p["X"].col("a")).alias("s")).to_pydict()
        out[pkg] = {"mask": mask, "rows": _plain(rows)}
    assert out["torch"] == out["jax"]
    assert out["torch"]["mask"] == MASKS[case]


@pytest.mark.parametrize("tier", TIERS)
def test_null_join_keys_never_match(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        s = _session(pkg, tmp_path, tier)
        left = _frame(pkg, s, tmp_path, "l", {"k": [1, None, 0], "lv": [10, 20, 30]})
        right = _frame(pkg, s, tmp_path, "r", {"rk": [0, None], "rv": [100, 200]})
        out[pkg] = _plain(left.join(right, left["k"] == right["rk"]).to_pydict())
    assert out["torch"] == out["jax"]
    assert out["torch"]["k"] == [0] and out["torch"]["rv"] == [100]


@pytest.mark.parametrize("tier", TIERS)
def test_null_group_key_is_a_distinct_group(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        X = p["X"]
        s = _session(pkg, tmp_path, tier)
        df = _frame(pkg, s, tmp_path, "g", {"g": [0, None, 0, None], "x": [1, 2, 3, 4]})
        r = _plain(df.group_by("g").agg(X.Sum(X.col("x")).alias("s"),
                                        X.Count(X.lit(1)).alias("n")).to_pydict())
        out[pkg] = sorted(zip(r["g"], r["s"], r["n"]), key=repr)
    # the null key is a group of the device tier's fragment (a nullable
    # measure declines to the host, in both packages)
    assert s.device_stats.device_fragments == (tier == "device")
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"], key=repr) == sorted([(0, 4, 2), (None, 6, 2)], key=repr)


@pytest.mark.parametrize("tier", TIERS)
def test_all_null_group_aggregates_to_null(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        X = p["X"]
        df = _frame(pkg, _session(pkg, tmp_path, tier), tmp_path, "an",
                    {"g": [1, 1, 2], "x": [None, None, 9]})
        out[pkg] = _plain(df.group_by("g").agg(
            X.Min(X.col("x")).alias("mn"), X.Sum(X.col("x")).alias("s"),
            X.Count(X.col("x")).alias("n")).sort("g").to_pydict())
    assert out["torch"] == out["jax"]
    assert (out["torch"]["mn"], out["torch"]["s"], out["torch"]["n"]) == (
        [None, 9], [None, 9], [0, 1])


@pytest.mark.parametrize("tier", TIERS)
def test_string_min_max(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        X = p["X"]
        df = _frame(pkg, _session(pkg, tmp_path, tier), tmp_path, "sm",
                    {"g": [1, 1, 2], "s": ["banana", "apple", "cherry"]})
        out[pkg] = _plain(df.group_by("g").agg(X.Min(X.col("s")).alias("mn"),
                                               X.Max(X.col("s")).alias("mx"))
                          .sort("g").to_pydict())
    assert out["torch"] == out["jax"]
    assert out["torch"]["mn"] == ["apple", "cherry"]
    assert out["torch"]["mx"] == ["banana", "cherry"]


@pytest.mark.parametrize("tier", TIERS)
def test_global_string_min(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        X = p["X"]
        df = _frame(pkg, _session(pkg, tmp_path, tier), tmp_path, "gs",
                    {"s": ["zebra", "apple", "mango"]})
        out[pkg] = _plain(df.agg(X.Min(X.col("s")).alias("mn"),
                                 X.Max(X.col("s")).alias("mx")).to_pydict())
    assert out["torch"] == out["jax"] == {"mn": ["apple"], "mx": ["zebra"]}


@pytest.mark.parametrize("tier", TIERS)
def test_sum_on_string_raises(tmp_path, tier):
    for pkg, p in PKGS.items():
        X = p["X"]
        df = _frame(pkg, _session(pkg, tmp_path, tier), tmp_path, "ss", {"s": ["a"]})
        with pytest.raises(p["error"]):
            df.agg(X.Sum(X.col("s"))).collect()


@pytest.mark.parametrize("tier", TIERS)
def test_date32_with_none(tmp_path, tier):
    out = {}
    for pkg, p in PKGS.items():
        t = p["table"]
        b = t.ColumnBatch.from_pydict({"d": [datetime.date(1994, 1, 1), None, 19000]},
                                      t.Schema([t.Field("d", "date32")]))
        path = os.path.join(str(tmp_path), pkg, "src", "dates")
        p["io"].write_parquet(b, os.path.join(path, "p.parquet"))
        s = _session(pkg, tmp_path, tier)
        X = p["X"]
        back = s.read.parquet(path).filter(X.col("d") > 9000).agg(
            X.Count(X.lit(1)).alias("n")).to_pydict()
        out[pkg] = {"dtype": b.schema.field("d").dtype, "data": [int(b.column("d").data[i])
                                                                  for i in (0, 2)],
                    "validity": [bool(v) for v in b.column("d").validity],
                    "later": _plain(back)}
    assert out["torch"] == out["jax"]
    assert out["torch"]["data"] == [8766, 19000]
    assert out["torch"]["validity"] == [True, False, True]


@pytest.mark.parametrize("tier", TIERS)
def test_ambiguous_join_columns_raise(tmp_path, tier):
    for pkg, p in PKGS.items():
        s = _session(pkg, tmp_path, tier)
        left = s.create_dataframe({"k": [1], "v": [2]})
        right = s.create_dataframe({"k2": [1], "v": [99]})
        with pytest.raises(p["error"]):
            left.join(right, left["k"] == right["k2"]).collect()
