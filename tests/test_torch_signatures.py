"""Calls written for the JAX package bind and behave the same in the port:
the repairs the signature gate of tests/test_torch_surface.py asked for,
each held to the JAX package on the same seeded input.

- Every lifecycle action built positionally, as the JAX package's index
  manager builds them, with a recording event logger as the last
  argument: create, refresh (full, incremental, quick, each after an
  appended file), optimize, delete, restore, cancel of a crashed refresh
  and vacuum log the same event classes, messages and index names.
- ``retry_call`` with a positional ``classify`` (and ``clock`` after it):
  one that rejects every error makes one attempt, one that accepts every
  error makes them all.
- ``write_index_file(..., compression=None)`` writes the JAX package's
  codec, read from the parquet metadata of both files.
- ``read_parquet`` binds ``arrow_filter`` third and ``cache`` fourth, as
  the JAX package does; ``cache=False`` reads without a cache and
  ``cache=True``, which names the JAX package's process-wide chunk cache,
  raises TypeError (the port's chunk caches belong to the session).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu as J
from hyperspace_tpu.actions import create as jcreate
from hyperspace_tpu.actions import lifecycle as jlife
from hyperspace_tpu.actions import optimize as jopt
from hyperspace_tpu.actions import refresh as jrefresh
from hyperspace_tpu.columnar import io as jio
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.exceptions import HyperspaceError as JError
from hyperspace_tpu.index_manager import index_manager_for as jimf
from hyperspace_tpu.utils import retry as jretry
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch.actions import create as tcreate
from hyperspace_tpu_torch.actions import lifecycle as tlife
from hyperspace_tpu_torch.actions import optimize as topt
from hyperspace_tpu_torch.actions import refresh as trefresh
from hyperspace_tpu_torch.columnar import io as tio
from hyperspace_tpu_torch.columnar.table import ColumnBatch as TBatch
from hyperspace_tpu_torch.exceptions import HyperspaceError as TError
from hyperspace_tpu_torch.index_manager import index_manager_for as timf
from hyperspace_tpu_torch.utils import retry as tretry

PKGS = {
    "jax": dict(mod=J, create=jcreate, life=jlife, opt=jopt, refresh=jrefresh, imf=jimf,
                error=JError),
    "torch": dict(mod=T, create=tcreate, life=tlife, opt=topt, refresh=trefresh, imf=timf,
                  error=TError),
}
MTIME = 1_700_000_000


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


class Recorder:
    def __init__(self):
        self.events = []

    def log_event(self, event) -> None:
        self.events.append((type(event).__name__, event.message, event.index_name))


def _write(src: str, i: int) -> None:
    rng = np.random.default_rng(50 + i)
    path = os.path.join(src, f"f{i}.parquet")
    pq.write_table(pa.table({"k": rng.integers(0, 100, 300), "v": rng.uniform(0, 1, 300)}),
                   path)
    os.utime(path, (MTIME, MTIME))


def _session(pkg: str, warehouse: str):
    mod = PKGS[pkg]["mod"]
    if pkg == "torch":
        return mod.HyperspaceSession(warehouse, device="cpu")
    return mod.HyperspaceSession(warehouse)


def _lifecycle_events(pkg: str, root: str) -> list:
    """The JAX index manager's calls, made by hand with one logger."""
    p = PKGS[pkg]
    src = os.path.join(root, f"src_{pkg}")
    os.makedirs(src)
    for i in range(2):
        _write(src, i)
    s = _session(pkg, os.path.join(root, f"wh_{pkg}"))
    log = Recorder()
    im = p["imf"](s)
    path, lm, dm = im._managers("ix")
    config = p["mod"].CoveringIndexConfig("ix", ["k"], ["v"])
    p["create"].CreateAction(s, s.read.parquet(src), config, path, lm, dm, log).run()
    for i, cls in ((2, "RefreshAction"), (3, "RefreshIncrementalAction"),
                   (4, "RefreshQuickAction")):
        _write(src, i)
        path, lm, dm = im._managers("ix")
        getattr(p["refresh"], cls)(s, path, lm, dm, log).run()
    path, lm, dm = im._managers("ix")
    p["opt"].OptimizeAction(s, path, lm, dm, "full", log).run()
    for cls in ("DeleteAction", "RestoreAction"):
        _path, lm, _dm = im._managers("ix")
        getattr(p["life"], cls)(lm, log).run()
    # a refresh that crashed after its transient entry, rolled back by cancel
    _write(src, 5)
    path, lm, dm = im._managers("ix")
    crashed = p["refresh"].RefreshAction(s, path, lm, dm, log)
    crashed.validate()
    crashed.begin()
    _path, lm, _dm = im._managers("ix")
    p["life"].CancelAction(lm, log).run()
    _path, lm, _dm = im._managers("ix")
    with pytest.raises(p["error"], match="Cancel is only supported"):
        p["life"].CancelAction(lm, log).run()
    _path, lm, _dm = im._managers("ix")
    p["life"].DeleteAction(lm, log).run()
    path, lm, _dm = im._managers("ix")
    p["life"].VacuumAction(path, lm, log).run()
    return log.events


def test_positional_actions_log_the_jax_packages_events(tmp_path):
    got = _lifecycle_events("torch", str(tmp_path))
    want = _lifecycle_events("jax", str(tmp_path))
    assert got == want
    names = [e[0] for e in got]
    for cls in ("CreateActionEvent", "RefreshActionEvent", "RefreshIncrementalActionEvent",
                "RefreshQuickActionEvent", "OptimizeActionEvent", "DeleteActionEvent",
                "RestoreActionEvent", "CancelActionEvent", "VacuumActionEvent"):
        assert (cls, "succeeded") in [(n, m) for n, m, _i in got], cls
    assert names.count("CancelActionEvent") == 4  # one rollback, one refused
    assert all(index == "ix" for _n, _m, index in got)


# ---------------------------------------------------------------------------
# retry_call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accept,attempts", [(False, 1), (True, 3)])
def test_retry_call_honours_a_positional_classify(accept, attempts):
    made = {}
    for pkg, retry in (("jax", jretry), ("torch", tretry)):
        calls, slept = [], []

        def fn():
            calls.append(1)
            raise OSError("transient by its type")

        with pytest.raises(OSError):
            retry.retry_call(fn, "unit", 3, lambda e: accept, slept.append)
        made[pkg] = (len(calls), len(slept))
    assert made["torch"] == made["jax"] == (attempts, attempts - 1)


# ---------------------------------------------------------------------------
# write_index_file and read_parquet
# ---------------------------------------------------------------------------

def _codecs(path: str) -> list:
    md = pq.ParquetFile(path).metadata
    return [md.row_group(g).column(c).compression
            for g in range(md.num_row_groups) for c in range(md.num_columns)]


@pytest.mark.parametrize("compression", [None, "zstd", "snappy"])
def test_write_index_file_writes_the_jax_packages_codec(tmp_path, compression):
    rng = np.random.default_rng(9)
    data = {"k": rng.integers(0, 1000, 5000).tolist(), "v": rng.uniform(0, 1, 5000).tolist()}
    out = {}
    for pkg, io, batch in (("jax", jio, JBatch), ("torch", tio, TBatch)):
        path = str(tmp_path / pkg / "part-0.parquet")
        io.write_index_file(batch.from_pydict(data), path, 1024, ["k"], compression)
        out[pkg] = _codecs(path)
    assert out["torch"] == out["jax"]
    assert set(out["torch"]) == {(compression or "lz4").upper()}


@pytest.fixture()
def two_files(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.parquet")
        rng = np.random.default_rng(70 + i)
        pq.write_table(pa.table({"k": np.arange(1000) + 1000 * i,
                                 "v": rng.uniform(0, 1, 1000)}), p, row_group_size=250)
        paths.append(p)
    return paths


def test_read_parquet_binds_the_filter_third(two_files):
    filt = pc.field("k") >= 1500
    got = tio.read_parquet(two_files, ["k", "v"], filt).to_pydict()
    want = jio.read_parquet(two_files, ["k", "v"], filt).to_pydict()
    assert got == want and min(got["k"]) == 1500 and len(got["k"]) == 500
    sel = {two_files[0]: [1]}
    got = tio.read_parquet(two_files, ["k"], None, False, sel).to_pydict()
    assert got == jio.read_parquet(two_files, ["k"], None, False, sel).to_pydict()
    assert len(got["k"]) == 250 + 1000


def test_read_parquet_takes_a_session_cache_not_true(two_files):
    cache = tio.IndexChunkCache(1 << 30)
    first = tio.read_parquet(two_files, ["k"], None, cache)
    assert tio.read_parquet(two_files, ["k"], None, cache).column("k") is first.column("k")
    with pytest.raises(TypeError, match="index_chunk_cache"):
        tio.read_parquet(two_files, ["k"], None, True)
    with pytest.raises(TypeError, match="index_chunk_cache"):
        list(tio.iter_chunks(two_files, ["k"], True))
    plain = [c.batch.to_pydict() for c in tio.iter_chunks(two_files, ["k"], False)]
    assert plain == [c.batch.to_pydict() for c in jio.iter_chunks(two_files, ["k"], False)]
