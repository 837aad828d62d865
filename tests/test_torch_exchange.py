"""The mesh bucket exchange and mesh-partitioned builds against the JAX
package's.

The JAX side runs on the 8 host devices tests/conftest.py makes XLA fake,
the port's on ``virtual_devices(8, "cpu")`` (or a 2 x 4 hierarchical mesh).

- The device bucket hash (``hash32_torch``, ``bucket_ids_torch``) gives
  ``bucket_ids_np``'s bits and the JAX ``bucket_ids_jnp``'s, for int32,
  int64 and float64 keys (split into two words), strings (hashed by value)
  and negative values, one key column or several.
- ``bucket_exchange`` lands every row on its destination shard and gives
  the JAX package's slots, validity and overflow bit for bit at the same
  capacity; ``exchange_with_retry`` grows the capacity through the JAX
  package's sequence under skew (both loops driven by a stand-in exchange
  that reports the true overflow). A JAX exchange call costs seconds on
  the forced host devices, so the JAX exchange and partition compared are
  the ones the JAX package's flat mesh build makes (recorded).
- ``partition_batch_mesh`` equals the JAX package's and the host
  partition, declines as it does (fewer rows than shards, a hierarchical
  mesh).
- A covering index built with ``meshDevices`` = 8 writes the JAX
  package's mesh-built data files byte for byte (and the port's host-built
  ones); with ``meshSlices`` = 2, the per-slice runs ``-0s<slice>`` of the
  JAX package's hierarchical build, byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import hyperspace_tpu as J
from hyperspace_tpu import constants as JC
from hyperspace_tpu.columnar.table import ColumnBatch as JBatch
from hyperspace_tpu.ops import bucketize as jbucket
from hyperspace_tpu.ops import hashing as jhash
from hyperspace_tpu.parallel import exchange as jx
from hyperspace_tpu.parallel import mesh as jmesh
import hyperspace_tpu_torch as T
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch.columnar.table import ColumnBatch as TBatch
from hyperspace_tpu_torch.ops import bucketize as tbucket
from hyperspace_tpu_torch.ops import hashing as thash
from hyperspace_tpu_torch.parallel import exchange as tx
from hyperspace_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def _empty_the_jax_query_ledger():
    """Keep the JAX package's process-wide query ledger from filling up
    for the test files a worker runs after this one."""
    yield
    from hyperspace_tpu.telemetry.attribution import LEDGER

    LEDGER.reset_for_testing()


@pytest.fixture
def vdev():
    with tmesh.virtual_devices(8, "cpu") as devices:
        yield devices


def _keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-2**62, 2**62, n)
    if kind == "small_negative":
        return rng.integers(-40, 40, n)
    if kind == "float64":
        return rng.normal(scale=1e6, size=n)
    if kind == "float32":
        return rng.normal(size=n).astype(np.float32)
    if kind == "int16":
        return rng.integers(-300, 300, n).astype(np.int16)
    # strings hash by value: the crc32 words of the dictionary
    vocab = ["", "a", "bb", "ünï", "TPC-H", "x" * 40]
    codes = rng.integers(0, len(vocab), n).astype(np.int32)
    return thash.string_key_words(codes, vocab)


KINDS = ("int32", "int64", "small_negative", "float64", "float32", "int16", "string")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("num_buckets", [8, 7, 200])
def test_device_bucket_hash_equals_the_host_and_jax_hashes(kind, num_buckets):
    keys = _keys(kind, 3000)
    want = thash.bucket_ids_np([keys], num_buckets)
    assert (want == jhash.bucket_ids_np([keys], num_buckets)).all()
    # the key itself on the device (int64 and float64 split there)
    assert (thash.bucket_ids_torch([torch.from_numpy(keys)], num_buckets).numpy()
            == want).all()
    # the mesh build's form: the host words, shipped as int32 columns
    words = [w.view(np.int32) for w in thash._words_np(keys)]
    got = thash.bucket_ids_torch([torch.from_numpy(w) for w in words], num_buckets).numpy()
    jgot = np.asarray(jhash.bucket_ids_jnp([jnp.asarray(w) for w in words], num_buckets))
    assert (got == want).all() and (jgot == want).all()


def test_multi_column_device_hash_equals_the_host_hash():
    cols = [_keys("int64", 2000, 1), _keys("string", 2000, 2), _keys("float64", 2000, 3)]
    want = thash.hash32_plain(cols).astype(np.int64)
    words = [torch.from_numpy(w.view(np.int32)) for c in cols for w in thash._words_np(c)]
    assert (thash.hash32_torch(words).numpy() == want).all()
    assert (thash.hash32_torch([torch.from_numpy(c) for c in cols[:1]]).numpy()
            == thash.hash32_plain(cols[:1]).astype(np.int64)).all()


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _jax_sharded(mesh, arr):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("shards")))


def _torch_exchange(keys, payload, dest, capacity):
    tm = tmesh.device_mesh(8)
    tout, tvalid, tovf = tx.bucket_exchange(
        tm, {"k": tmesh.shard_rows(tm, keys), "p": tmesh.shard_rows(tm, payload)},
        tmesh.shard_rows(tm, dest), capacity)
    cat = lambda parts: np.concatenate([p.numpy() for p in parts])  # noqa: E731
    return cat(tout["k"]), cat(tout["p"]), cat(tvalid), int(tovf)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("capacity", [64, 128])
def test_bucket_exchange_lands_rows_on_their_shards(vdev, skew, capacity):
    n = 8 * 64
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1000, n).astype(np.int32)
    payload = rng.uniform(size=n).astype(np.float32)
    dest = (np.zeros(n, np.int32) if skew
            else thash.bucket_ids_np([keys], 8).astype(np.int32))
    k, p, valid, overflow = _torch_exchange(keys, payload, dest, capacity)
    # the true largest per-(source, destination) count
    assert overflow == max(np.bincount(dest[s * 64:(s + 1) * 64], minlength=8).max()
                           for s in range(8))
    per = len(k) // 8
    assert per == 8 * capacity
    if overflow > capacity:
        assert valid.sum() == 8 * capacity  # truncated: the caller retries
        return
    assert valid.sum() == n
    for s in range(8):
        kept = k[s * per:(s + 1) * per][valid[s * per:(s + 1) * per]]
        assert (dest_of := thash.bucket_ids_np([kept], 8)).size == 0 or skew or \
            (dest_of == s).all()
    assert sorted(zip(k[valid].tolist(), p[valid].tolist())) == \
        sorted(zip(keys.tolist(), payload.tolist()))


def _spy_capacities(monkeypatch, module, dest_parts) -> list:
    """Replace a package's bucket_exchange by one that only reports the
    true overflow of ``dest_parts`` (host arrays per shard): the capacity
    sequence of its exchange_with_retry, with no device work."""
    seen = []

    def spy(mesh, cols, dest, capacity, *a, **kw):
        seen.append(capacity)
        overflow = max(int(np.bincount(d, minlength=8).max()) for d in dest_parts)
        return {}, [], np.int32(overflow)

    monkeypatch.setattr(module, "bucket_exchange", spy)
    return seen


@pytest.mark.parametrize("hot_share", [0.0, 0.3, 1.0])
def test_exchange_retry_grows_capacity_as_the_jax_package(vdev, monkeypatch, hot_share):
    n = 8 * 500
    rng = np.random.default_rng(11)
    dest = rng.integers(0, 8, n).astype(np.int32)
    dest[: int(n * hot_share)] = 3
    rows = np.arange(n, dtype=np.int32)
    tm = tmesh.device_mesh(8)
    # the port's exchange for real: every row lands once
    tout, tvalid = tx.exchange_with_retry(tm, {"r": tmesh.shard_rows(tm, rows)},
                                          tmesh.shard_rows(tm, dest), n // 8)
    tr = np.concatenate([p.numpy() for p in tout["r"]])
    tv = np.concatenate([p.numpy() for p in tvalid])
    assert sorted(tr[tv].tolist()) == list(range(n))
    # and the capacity sequence of both packages' retry loops
    parts = [dest[s * 500:(s + 1) * 500] for s in range(8)]
    jcaps = _spy_capacities(monkeypatch, jx, parts)
    jx.exchange_with_retry(jmesh.device_mesh(8), {}, None, n // 8)
    tcaps = _spy_capacities(monkeypatch, tx, parts)
    tx.exchange_with_retry(tm, {}, None, n // 8)
    assert tcaps == jcaps and len(tcaps) == (1 if hot_share == 0 else 2)


def _batches(kind: str, n: int):
    rng = np.random.default_rng(9)
    data = {"k": rng.integers(-500, 500, n), "v": rng.uniform(size=n),
            "s": rng.choice(["a", "bb", "ccc", "ünï"], n).tolist(),
            "f": rng.normal(size=n)}
    return JBatch.from_pydict(data), TBatch.from_pydict(data)


@pytest.mark.parametrize("columns", [["k"], ["s"], ["f"], ["k", "s"]])
@pytest.mark.parametrize("num_buckets", [8, 5, 16])
def test_partition_batch_mesh_equals_the_host_partitions(vdev, columns, num_buckets):
    jb, tb = _batches("mixed", 2003)  # ragged: not a multiple of the shards
    got = tx.partition_batch_mesh(tb, columns, num_buckets, tmesh.device_mesh(8))
    for parts in (tbucket.partition_batch(tb, columns, num_buckets),
                  jbucket.partition_batch(jb, columns, num_buckets)):
        assert [b for b, _ in got] == [b for b, _ in parts]
        for (_b, g), (_b2, w) in zip(got, parts):
            assert (np.asarray(g) == np.asarray(w)).all()


def test_partition_batch_mesh_declines_as_the_jax_package(vdev):
    jb, tb = _batches("mixed", 5)
    assert jx.partition_batch_mesh(jb, ["k"], 8, jmesh.device_mesh(8)) is None
    assert tx.partition_batch_mesh(tb, ["k"], 8, tmesh.device_mesh(8)) is None
    jb, tb = _batches("mixed", 100)
    assert jx.partition_batch_mesh(jb, ["k"], 8, jmesh.hierarchical_mesh(2, 4)) is None
    assert tx.partition_batch_mesh(tb, ["k"], 8, tmesh.hierarchical_mesh(2, 4)) is None


# ---------------------------------------------------------------------------
# mesh-built indexes
# ---------------------------------------------------------------------------

def _lake(root) -> str:
    lake = os.path.join(str(root), "lake", "t")
    os.makedirs(lake, exist_ok=True)
    rng = np.random.default_rng(21)
    for i in range(3):
        n = 1500 + 7 * i
        pq.write_table(pa.table({
            "k": rng.integers(-400, 400, n),
            "v": rng.uniform(0, 100, n),
            "s": rng.choice(["a", "bb", "ccc", "dddd"], n),
        }), os.path.join(lake, f"f{i}.parquet"))
        os.utime(os.path.join(lake, f"f{i}.parquet"), (1_700_000_000, 1_700_000_000))
    return lake


def _build(pkg: str, root, lake: str, devices: int, slices: int, indexed) -> dict:
    wh = os.path.join(str(root), f"wh_{pkg}_{devices}_{slices}")
    if pkg == "jax":
        s = J.HyperspaceSession(wh, conf={JC.EXEC_MESH_DEVICES: devices,
                                          JC.EXEC_MESH_SLICES: slices,
                                          JC.INDEX_NUM_BUCKETS: 8})
        J.Hyperspace(s).create_index(s.read.parquet(lake),
                                     J.CoveringIndexConfig("mx", indexed, ["v"]))
    else:
        s = T.HyperspaceSession(wh, device="cpu", conf={TC.EXEC_MESH_DEVICES: devices,
                                                        TC.EXEC_MESH_SLICES: slices,
                                                        TC.INDEX_NUM_BUCKETS: 8})
        T.Hyperspace(s).create_index(s.read.parquet(lake),
                                     T.CoveringIndexConfig("mx", indexed, ["v"]))
        assert not s.device_stats.declines.get("mesh_partition")
    out = {}
    for dirpath, _dirs, names in os.walk(wh):
        for fn in names:
            if fn.startswith("part-"):
                with open(os.path.join(dirpath, fn), "rb") as f:
                    out[os.path.relpath(os.path.join(dirpath, fn), wh)] = f.read()
    return out


# (meshSlices, indexed columns) of the two builds each package makes
BUILDS = {1: ["k", "s"], 2: ["s"]}


@pytest.fixture(scope="module")
def jax_builds(tmp_path_factory):
    """The JAX package's flat and hierarchical mesh builds over one lake
    (each JAX exchange call costs seconds on the forced host devices, so
    they run once per module). The flat build's partition and exchange
    calls are recorded, inputs and outputs, for the port to repeat."""
    root = tmp_path_factory.mktemp("mesh_builds")
    lake = _lake(root)
    calls: dict = {"exchange": [], "partition": []}
    real_x, real_p = jx.bucket_exchange, jx.partition_batch_mesh

    def exchange_spy(mesh, cols, dest, capacity, *a, **kw):
        out, valid, overflow = real_x(mesh, cols, dest, capacity, *a, **kw)
        calls["exchange"].append((
            {k: np.asarray(v) for k, v in cols.items()}, np.asarray(dest), capacity,
            ({k: np.asarray(v) for k, v in out.items()}, np.asarray(valid), int(overflow))))
        return out, valid, overflow

    def partition_spy(batch, columns, num_buckets, mesh, *a, **kw):
        parts = real_p(batch, columns, num_buckets, mesh, *a, **kw)
        calls["partition"].append((batch.to_pydict(), list(columns), num_buckets, parts))
        return parts

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx, "bucket_exchange", exchange_spy)
        mp.setattr(jx, "partition_batch_mesh", partition_spy)
        flat = _build("jax", root, lake, 8, 1, BUILDS[1])
    hier = _build("jax", root, lake, 8, 2, BUILDS[2])
    assert len(calls["partition"]) == 1 and calls["exchange"]
    return {"lake": lake, "root": root, 1: flat, 2: hier, **calls}


def test_bucket_exchange_equals_the_jax_packages(vdev, jax_builds):
    """The port's exchange over the JAX build's exchange inputs gives its
    slots, validity and overflow bit for bit."""
    tm = tmesh.device_mesh(8)
    for cols, dest, capacity, (jout, jvalid, jovf) in jax_builds["exchange"]:
        tout, tvalid, tovf = tx.bucket_exchange(
            tm, {k: tmesh.shard_rows(tm, v) for k, v in cols.items()},
            tmesh.shard_rows(tm, dest), capacity)
        for k in cols:
            assert (np.concatenate([p.numpy() for p in tout[k]]) == jout[k]).all(), k
        assert (np.concatenate([p.numpy() for p in tvalid]) == jvalid).all()
        assert int(tovf) == jovf


def test_partition_batch_mesh_equals_the_jax_packages(vdev, jax_builds):
    (data, columns, num_buckets, want), = jax_builds["partition"]
    got = tx.partition_batch_mesh(TBatch.from_pydict(data), columns, num_buckets,
                                  tmesh.device_mesh(8))
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_b, g), (_b2, w) in zip(got, want):
        assert (np.asarray(g) == np.asarray(w)).all()


@pytest.mark.parametrize("slices", [1, 2])
def test_mesh_built_index_is_the_jax_packages_byte_for_byte(vdev, jax_builds, slices):
    root, lake = jax_builds["root"], jax_builds["lake"]
    got = _build("torch", root, lake, 8, slices, BUILDS[slices])
    want = jax_builds[slices]
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] == want[name], name
    names = [os.path.basename(n) for n in got]
    if slices == 2:
        assert {n.split("-")[3].split(".")[0] for n in names} == {"0s0", "0s1"}
    else:
        # a flat mesh writes the host path's files, byte for byte
        assert _build("torch", root, lake, 0, 1, BUILDS[1]) == got
