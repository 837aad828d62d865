"""ctypes bindings of the native host kernels, hs_native.cpp beside this
file (counterpart of hyperspace_tpu/native/__init__.py, at the same ABI).

| entry point       | C symbol                         | called from                               |
|-------------------|----------------------------------|-------------------------------------------|
| hash32            | hs_hash32_i64 / hs_hash32_i32    | ops/hashing.hash32_np (one int key)       |
| hash32_words      | hs_hash32_words                  | ops/hashing.hash32_np (other keys)        |
| bucket_partition  | hs_bucket_partition              | ops/bucketize.partition_batch             |
| radix_argsort     | hs_radix_argsort_i64 / _i32      | ops/bucketize.stable_argsort              |
| join_i64          | hs_join_i64                      | plan/executor.join_indices                |
| probe_agg_i64     | hs_probe_agg_i64                 | plan/device_join._native_probe_agg        |

The library compiles at first use (never at import) with ``g++ -O3
-std=c++17 -shared -fPIC`` into ``build/native/`` beside the package (a
directory git ignores). The file name carries a hash of the source and
the flags, so an edited source rebuilds; each build writes a file of its
own and renames it into place, so processes that race for the same
library (test workers) never load a half-written one. A failed build or
load raises NativeError: unlike the JAX package, which falls back to numpy
there, the port does not fail open. The callers keep the reference's size
gates and their numpy forms, which the tests hold the kernels against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..exceptions import NativeError
from ..staticcheck.concurrency import TrackedLock, guarded_by

ABI_VERSION = 4
COMPILER = "g++"
BUILD_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
SOURCE = Path(__file__).resolve().with_name("hs_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# calls of each entry point (tests and the smoke read them); reset_counts()
# zeroes them
CALLS = guarded_by(
    {"hash32": 0, "hash32_words": 0, "bucket_partition": 0, "radix_argsort": 0,
     "join_i64": 0, "probe_agg_i64": 0},
    "<unlocked>", name="native.CALLS",
    note="call counts, bumped without a lock; read at quiescence",
)

# named so the one-time compile/load critical section takes part in the
# lock-order graph (it runs the compiler while held: nothing else may nest
# inside it)
_lock = TrackedLock("native.load")
# the loaded library, once built
_lib: list = guarded_by([], _lock, name="native._lib")


def reset_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def lib_path() -> Path:
    text = SOURCE.read_bytes() + " ".join((COMPILER,) + BUILD_FLAGS).encode()
    return BUILD_DIR / f"libhs_native-{hashlib.sha1(text).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    NativeError with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [COMPILER, *BUILD_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeError(f"cannot run {COMPILER} for {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeError(f"{COMPILER} failed for {SOURCE.name} (exit {proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a racing process loads either file whole
    return out


def _load() -> ctypes.CDLL:
    if _lib:
        return _lib[0]
    with _lock:
        if not _lib:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeError(f"cannot load {path}: {e}") from e
            if lib.hs_native_abi_version() != ABI_VERSION:
                raise NativeError(f"{path}: ABI {lib.hs_native_abi_version()}, "
                                  f"expected {ABI_VERSION}")
            _declare(lib)
            _lib.append(lib)
    return _lib[0]


def _declare(lib: ctypes.CDLL) -> None:
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.hs_hash32_i64.argtypes = [i64p, i64, u32p]
    lib.hs_hash32_i32.argtypes = [i32p, i64, u32p]
    lib.hs_hash32_words.argtypes = [u32p, i64, i32, u32p]
    lib.hs_bucket_partition.argtypes = [u32p, i64, i32, i32p, i64p, i64p]
    lib.hs_join_i64.argtypes = [i64p, i64, i64p, i64, i64p, i64p, i64]
    lib.hs_join_i64.restype = i64
    lib.hs_probe_agg_i64.argtypes = [i64p, i64, i64p, i64, f64p, i32, i64p, f64p]
    lib.hs_probe_agg_i64.restype = i64
    lib.hs_radix_argsort_i64.argtypes = [i64p, i64, i64p]
    lib.hs_radix_argsort_i32.argtypes = [i32p, i64, i64p]


def hash32(keys: np.ndarray) -> np.ndarray:
    """uint32 hash of one int64 or int32 key column (ops/hashing.hash32_np's
    value)."""
    keys = np.ascontiguousarray(keys)
    out = np.empty(len(keys), dtype=np.uint32)
    if keys.dtype == np.int64:
        _load().hs_hash32_i64(keys, len(keys), out)
    elif keys.dtype == np.int32:
        _load().hs_hash32_i32(keys, len(keys), out)
    else:
        raise TypeError(f"hash32 takes int64 or int32 keys, not {keys.dtype}")
    CALLS["hash32"] += 1
    return out


def hash32_words(words: list[np.ndarray]) -> np.ndarray:
    """uint32 hash of rows given as their uint32 key words, in order."""
    n = len(words[0])
    if any(len(w) != n for w in words):
        raise ValueError("hash32_words: the word arrays differ in length")
    stacked = np.concatenate([np.ascontiguousarray(w, dtype=np.uint32) for w in words])
    out = np.empty(n, dtype=np.uint32)
    _load().hs_hash32_words(stacked, n, len(words), out)
    CALLS["hash32_words"] += 1
    return out


def bucket_partition(hashes: np.ndarray, num_buckets: int):
    """(bucket ids int32, row order int64 grouped by bucket and stable
    within one, bucket offsets int64[num_buckets + 1]) of ``hashes %
    num_buckets``, by one counting sort."""
    if num_buckets < 1:
        raise ValueError(f"bucket_partition: {num_buckets} buckets")
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    n = len(hashes)
    ids = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    offsets = np.empty(num_buckets + 1, dtype=np.int64)
    _load().hs_bucket_partition(hashes, n, num_buckets, ids, order, offsets)
    CALLS["bucket_partition"] += 1
    return ids, order, offsets


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of int64 or int32 keys (numpy's ``kind="stable"``
    order), by LSD radix passes that skip uniform digits."""
    keys = np.ascontiguousarray(keys)
    out = np.empty(len(keys), dtype=np.int64)
    if keys.dtype == np.int64:
        _load().hs_radix_argsort_i64(keys, len(keys), out)
    elif keys.dtype == np.int32:
        _load().hs_radix_argsort_i32(keys, len(keys), out)
    else:
        raise TypeError(f"radix_argsort takes int64 or int32 keys, not {keys.dtype}")
    CALLS["radix_argsort"] += 1
    return out


def join_i64(lcodes: np.ndarray, rcodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inner join of int64 codes (negative codes never match): (left rows,
    right rows), left-major with ascending right rows within a key, the
    order of the numpy sort-and-search join."""
    lcodes = np.ascontiguousarray(lcodes, dtype=np.int64)
    rcodes = np.ascontiguousarray(rcodes, dtype=np.int64)
    lib = _load()
    cap = max(len(lcodes), len(rcodes), 1)
    while True:
        li = np.empty(cap, dtype=np.int64)
        ri = np.empty(cap, dtype=np.int64)
        total = lib.hs_join_i64(lcodes, len(lcodes), rcodes, len(rcodes), li, ri, cap)
        if total <= cap:
            CALLS["join_i64"] += 1
            return li[:total], ri[:total]
        cap = int(total)  # the table rebuild of a retry is O(right rows)


def probe_agg_i64(lk: np.ndarray, rk_sorted: np.ndarray, weights: list[np.ndarray]):
    """(counts int64[n_r], one float64[n_r] sum per weight array): each left
    key's row adds 1 and its weights to the slot of its equal key in the
    sorted unique right keys, in left-row order (np.bincount's order)."""
    lk = np.ascontiguousarray(lk, dtype=np.int64)
    rk = np.ascontiguousarray(rk_sorted, dtype=np.int64)
    w = len(weights)
    if any(len(x) != len(lk) for x in weights):
        raise ValueError("probe_agg_i64: a weight array's length is not the left keys'")
    stacked = (np.concatenate([np.ascontiguousarray(x, dtype=np.float64) for x in weights])
               if w else np.zeros(0, dtype=np.float64))
    counts = np.empty(len(rk), dtype=np.int64)
    sums = np.empty((w, len(rk)), dtype=np.float64)
    _load().hs_probe_agg_i64(lk, len(lk), rk, len(rk), stacked, w, counts, sums.reshape(-1))
    CALLS["probe_agg_i64"] += 1
    return counts, [sums[i] for i in range(w)]
