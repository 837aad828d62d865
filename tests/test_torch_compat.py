"""The camelCase surface (hyperspace_tpu_torch/compat.py) against the JAX
package's ``compat`` module: the same calls over the same lake write the
same index files and log entries (less their wall-clock fields), answer
whyNot with the same text and switch the session alike. Each package runs
in turn at one warehouse path (log entries hold absolute paths), removed
between them."""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu import compat as jcompat
from hyperspace_tpu.plan import expr as JX
import hyperspace_tpu as J
from hyperspace_tpu_torch import compat as tcompat
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.plan import expr as TX

PKGS = {"jax": (J, jcompat, JX), "torch": (T, tcompat, TX)}
MTIME_NS = 1_700_000_000 * 10**9  # one fixed mtime: signatures hash it


def _write(path: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    n = 300
    pq.write_table(pa.table({"k": rng.integers(0, 200, n), "v": rng.uniform(0, 100, n),
                             "s": rng.choice(["a", "bb", "ccc"], n)}), path)
    os.utime(path, ns=(MTIME_NS, MTIME_NS))


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


def test_camel_case_calls_write_what_the_reference_writes(tmp_path):
    lake = tmp_path / "lake"
    lake.mkdir()
    for i in range(4):
        _write(str(lake / f"f{i}.parquet"), i)
    extra = tmp_path / "extra.parquet"
    _write(str(extra), 9)
    wh = str(tmp_path / "wh")
    got = {}
    for pkg, (M, compat, X) in PKGS.items():
        shutil.rmtree(wh, ignore_errors=True)
        (lake / "f9.parquet").unlink(missing_ok=True)
        session = M.HyperspaceSession(wh, device="cpu") if pkg == "torch" \
            else M.HyperspaceSession(wh)
        hs = compat.Hyperspace(session)
        assert compat.IndexConfig is M.CoveringIndexConfig
        assert compat.ZOrderIndexConfig is M.ZOrderCoveringIndexConfig
        df = session.read.parquet(str(lake))
        hs.createIndex(df, compat.IndexConfig("idx", ["k"], ["v", "s"]))
        hs.createIndex(df, compat.ZOrderIndexConfig("zidx", ["v"], ["k"]))
        shutil.copy2(extra, lake / "f9.parquet")
        hs.refreshIndex("idx", "incremental")
        hs.optimizeIndex("idx", "quick")
        hs.refreshIndex("zidx")
        hs.deleteIndex("zidx")
        hs.restoreIndex("zidx")
        hs.deleteIndex("zidx")
        hs.vacuumIndex("zidx")
        states = [compat.isHyperspaceEnabled(session)]
        assert compat.enableHyperspace(session) is session
        states.append(compat.isHyperspaceEnabled(session))
        q = session.read.parquet(str(lake)).filter(X.col("k") == 3).select("k", "v")
        why = hs.whyNot(q, indexName="idx", extended=True)
        rows = sorted(q.collect().to_pydict()["v"])
        compat.disableHyperspace(session)
        states.append(compat.isHyperspaceEnabled(session))
        got[pkg] = {"files": _capture(wh), "states": states, "why": why, "rows": rows}
    t, j = got["torch"], got["jax"]
    assert sorted(t["files"]) == sorted(j["files"])
    for k in sorted(j["files"]):
        assert t["files"][k] == j["files"][k], k
    assert t["states"] == j["states"] == [False, True, False]
    assert t["why"] == j["why"] and "idx" in t["why"]
    assert np.asarray(t["rows"]).tobytes() == np.asarray(j["rows"]).tobytes()
    assert any("zidx" in k for k in j["files"]) and any("v__=" in k for k in j["files"])
