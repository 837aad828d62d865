"""TPC-DS q1 through both packages: the port's benchmark/tpcds.py against
the JAX package's on the same seeds.

- ``generate_tpcds`` writes the JAX package's files byte for byte.
- ``tpcds_indexes`` (sr_datekey, dd_datekey, sr_cust_bloom) built by each
  package over the same lake gives the same index files byte for byte and
  the same log entries, less their wall-clock fields.
- ``q1_customer_total_return`` and ``q1_store_avg`` read the same indexes
  in both packages' optimized plans and give the same results: keys exact,
  sums within relative 1e-4, whichever package built the indexes.
- Over the fixture of tests/test_plan_stability.py (5,000 store_returns
  rows, seed 3, the warehouse at the lake's root), the port's optimized
  plans equal the approved plans tests/approved_plans/tpcds_q1_*.txt
  after the same normalization. The files are read, never written.
"""

import json
import os
import re

import numpy as np
import pytest

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.benchmark import tpcds as jtpcds
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.benchmark import tpcds as ttpcds

REL = 1e-4
ROWS, SEED = 5_000, 3
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "approved_plans")
QUERIES = ("q1_customer_total_return", "q1_store_avg")
KEYS = {"q1_customer_total_return": ("sr_customer_sk", "sr_store_sk"),
        "q1_store_avg": ("sr_store_sk",)}


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """This module's JAX queries must not leave the JAX package's
    process-wide query ledger full for the modules run after it."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


def _session(pkg: str, warehouse: str):
    if pkg == "torch":
        return T.HyperspaceSession(warehouse, device="cpu")
    return J.HyperspaceSession(warehouse, conf={JC.EXEC_TPU_ENABLED: True})


def _files(root: str) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for fn in names:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("rows,seed", [(ROWS, SEED), (200_000, 0), (1_003, 11), (7, 1)])
def test_generate_tpcds_writes_the_jax_packages_files(tmp_path, rows, seed):
    jsizes = jtpcds.generate_tpcds(str(tmp_path / "jax"), rows_store_returns=rows, seed=seed)
    tsizes = ttpcds.generate_tpcds(str(tmp_path / "torch"), rows_store_returns=rows, seed=seed)
    assert tsizes == jsizes
    want, got = _files(str(tmp_path / "jax")), _files(str(tmp_path / "torch"))
    assert sorted(got) == sorted(want) and len(want) == 11
    assert got == want


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A JAX-written lake and the q1 index set built over it by each package
    into a warehouse of its own."""
    root = str(tmp_path_factory.mktemp("tpcds"))
    lake = os.path.join(root, "lake")
    jtpcds.generate_tpcds(lake, rows_store_returns=ROWS, seed=SEED)
    warehouses = {}
    for pkg, mod, top in (("jax", jtpcds, J), ("torch", ttpcds, T)):
        warehouses[pkg] = os.path.join(root, f"wh_{pkg}")
        s = _session(pkg, warehouses[pkg])
        mod.tpcds_indexes(s, top.Hyperspace(s), lake)
    return lake, warehouses


def _strip(x):
    """A log entry less its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("timestamp", "modifiedTime")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _content_files(node: dict, prefix: str) -> list:
    """A log entry's content tree as (path, size, id) rows."""
    path = os.path.join(prefix, node["name"])
    out = [(os.path.join(path, f["name"]), f["size"], f["id"]) for f in node["files"]]
    for sub in node["subDirs"]:
        out += _content_files(sub, path)
    return out


def _entry(raw: bytes, wh: str) -> dict:
    """A log entry less its wall-clock fields, its content tree as sorted
    (path under the warehouse, size, id) rows."""
    d = json.loads(raw)
    if "content" in d:
        d["content"] = sorted((os.path.relpath(p, wh), size, fid)
                              for p, size, fid in _content_files(d["content"]["root"], ""))
    return _strip(d)


def test_the_index_files_and_log_entries_equal_the_jax_packages(built):
    _lake, warehouses = built
    captured = {}
    for pkg, wh in warehouses.items():
        captured[pkg] = {rel: _entry(raw, wh) if "_hyperspace_log" in rel else raw
                         for rel, raw in _files(wh).items()}
    names = {rel.split(os.sep)[1] for rel in captured["torch"]}
    assert names == {"sr_datekey", "dd_datekey", "sr_cust_bloom"}
    assert sorted(captured["torch"]) == sorted(captured["jax"])
    for rel in captured["jax"]:
        assert captured["torch"][rel] == captured["jax"][rel], rel


def _indexes(df) -> list:
    return [n.index_info.index_name for n in df.optimized_plan().preorder()
            if getattr(n, "index_info", None) is not None]


def _sorted_rows(q: str, d: dict) -> dict:
    keys = KEYS[q]
    order = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def assert_same_result(q: str, got: dict, want: dict) -> None:
    """Keys exact, sums within REL, rows matched by the group keys."""
    assert list(got) == list(want)
    got, want = _sorted_rows(q, got), _sorted_rows(q, want)
    assert len(want[KEYS[q][0]]) > 0
    for name in want:
        if name in KEYS[q]:
            assert np.array_equal(got[name], want[name]), name
        else:
            g, w = got[name].astype(np.float64), want[name].astype(np.float64)
            assert np.all(np.abs(g - w) <= REL * np.abs(w)), name


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("q", QUERIES)
def test_plans_and_results_equal_the_jax_packages(built, built_by, q):
    """Both packages query the warehouse ``built_by`` built, so one side
    always reads the other package's indexes."""
    lake, warehouses = built
    js = _session("jax", warehouses[built_by]).enable_hyperspace()
    ts = _session("torch", warehouses[built_by]).enable_hyperspace()
    jdf, tdf = getattr(jtpcds, q)(js, lake), getattr(ttpcds, q)(ts, lake)
    assert _indexes(tdf) == _indexes(jdf) == ["sr_datekey", "dd_datekey"]
    got = tdf.to_pydict()
    assert ts.device_stats.join_paths  # the join ran on the device tier
    assert_same_result(q, got, jdf.to_pydict())
    # and the port's host executor over the raw source agrees
    raw = _session("torch", warehouses[built_by])
    assert_same_result(q, got, getattr(ttpcds, q)(raw, lake).to_pydict())


def normalize(plan_str: str, root: str) -> str:
    """tests/test_plan_stability.normalize."""
    s = plan_str.replace(root, "<ROOT>")
    s = re.sub(r"/tmp/[^/ ]+", "<TMP>", s)
    return s + "\n"


@pytest.mark.parametrize("q,golden", [("q1_customer_total_return", "tpcds_q1_ctr"),
                                      ("q1_store_avg", "tpcds_q1_store_avg")])
def test_the_ports_plans_equal_the_approved_plans(tmp_path, q, golden):
    """tests/test_plan_stability.tpcds_golden_env, built by the port."""
    root = str(tmp_path)
    session = T.HyperspaceSession(root, device="cpu")
    ttpcds.generate_tpcds(root, rows_store_returns=ROWS, seed=SEED)
    ttpcds.tpcds_indexes(session, T.Hyperspace(session), root)
    session.enable_hyperspace()
    plan = getattr(ttpcds, q)(session, root).optimized_plan().pretty()
    with open(os.path.join(GOLDEN_DIR, f"{golden}.txt")) as f:
        approved = f.read()
    assert normalize(plan, root) == approved
