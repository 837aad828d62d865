"""Deterministic 32-bit key hashing for bucket placement (counterpart of
hyperspace_tpu/ops/hashing.py, host path).

Bucket ids are part of the on-disk index contract: they must equal the JAX
package's ``hash32_np`` bit for bit, whichever package built the index. The
arithmetic is murmur3-style uint32 mixing over the keys' 32-bit words; an
int64 or float64 key contributes its low then high word, a string its crc32.
Index builds hash on the host: from 1024 rows up through the native
library (native/hs_native.cpp, one pass), below that and in the tests
through the numpy form ``hash32_plain``. A mesh build hashes on the devices
(``hash32_torch``, ``bucket_ids_torch``; parallel/exchange.py), with the
same bits: torch has no full uint32 arithmetic, so the words live in int64
masked to 32 bits, and each 32-bit product is formed from two 16-bit
halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import zlib

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 42  # fixed seed: bucket layout is part of the on-disk index contract


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_round(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    k = k * np.uint32(_C1)
    k = _rotl32(k, 15)
    k = k * np.uint32(_C2)
    h = h ^ k
    h = _rotl32(h, 13)
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _words_np(arr: np.ndarray) -> list[np.ndarray]:
    """Decompose an array into uint32 words (1 or 2 per element)."""
    if arr.dtype == np.float64 or arr.dtype in (np.int64, np.uint64):
        bits = arr.view(np.uint64) if arr.dtype == np.float64 else (
            arr.astype(np.int64, copy=False).view(np.uint64)
        )
        return [
            (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (bits >> np.uint64(32)).astype(np.uint32),
        ]
    if arr.dtype == np.float32:
        return [arr.view(np.uint32)]
    if arr.dtype == np.bool_:
        return [arr.astype(np.uint32)]
    # int8/16/32, date32, dictionary codes
    if arr.dtype.kind == "i":
        return [arr.astype(np.int64).astype(np.uint32)]
    return [arr.astype(np.uint32)]


_NATIVE_MIN_ROWS = 1024  # below this the ctypes call costs more than numpy


def hash32_np(columns: list[np.ndarray]) -> np.ndarray:
    """Hash rows of one or more key columns to uint32: the native kernel
    from 1024 rows up (one int key hashes without splitting its words on
    the host), the numpy form below."""
    from .. import native

    if len(columns[0]) < _NATIVE_MIN_ROWS:
        return hash32_plain(columns)
    if len(columns) == 1:
        a = np.asarray(columns[0])
        if a.dtype in (np.int64, np.int32):
            return native.hash32(a)
    words = [w for col in columns for w in _words_np(np.asarray(col))]
    return native.hash32_words(words)


def hash32_plain(columns: list[np.ndarray]) -> np.ndarray:
    """The numpy form of ``hash32_np`` (multi-pass over the key words)."""
    h = np.full(len(columns[0]), _SEED, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for col in columns:
            for w in _words_np(np.asarray(col)):
                h = _mix_round(h, w)
        return _fmix32(h)


def string_key_words(codes: np.ndarray, dictionary: list[str]) -> np.ndarray:
    """Per-value hash words for a dictionary-encoded string column: crc32 of
    each vocabulary entry's utf-8, gathered by code (independent of the
    vocabulary's order)."""
    vocab_hash = np.array(
        [zlib.crc32(s.encode("utf-8")) & 0xFFFFFFFF for s in dictionary],
        dtype=np.uint32,
    )
    return vocab_hash[codes]


def bucket_ids_np(columns: list[np.ndarray], num_buckets: int) -> np.ndarray:
    return (hash32_np(columns) % np.uint32(num_buckets)).astype(np.int32)


_M32 = 0xFFFFFFFF


def _mul32_torch(a, c: int):
    """(a * c) mod 2^32 for int64 words a in [0, 2^32) and a constant c:
    a's low and high 16-bit halves times c stay below 2^48."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _rotl32_torch(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _words_torch(t) -> list:
    """A device key tensor's 32-bit words as int64 in [0, 2^32), in
    ``_words_np``'s order: an int64 or float64 key gives its low then high
    word, a float32 its bits, a narrower int its sign-extended value."""
    import torch

    if t.dtype in (torch.int64, torch.float64):
        bits = t.view(torch.int64) if t.dtype == torch.float64 else t
        return [bits & _M32, (bits >> 32) & _M32]
    if t.dtype == torch.float32:
        return [t.view(torch.int32).to(torch.int64) & _M32]
    return [t.to(torch.int64) & _M32]


def words_tensor(a, device):
    """A host array (or a tensor) on ``device`` in a dtype torch holds, with
    the 32-bit words ``_words_np`` takes from the array: an unsigned array
    of 4 or 8 bytes as the signed int of its width (the same bits), a
    uint16 one widened to int32; uint8 and the rest as they are."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.kind == "u" and a.itemsize >= 4:
        a = a.view(f"i{a.itemsize}")
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def hash32_torch(columns: list):
    """Hash rows of device key columns (int32 word columns as the mesh
    build ships them, or any key dtype ``_words_torch`` splits) to the
    bits of ``hash32_np``, as int64 in [0, 2^32). Counterpart of
    ``hash32_jnp``."""
    import torch

    h = torch.full(columns[0].shape, _SEED, dtype=torch.int64, device=columns[0].device)
    for col in columns:
        for k in _words_torch(col):
            k = _rotl32_torch(_mul32_torch(k, _C1), 15)
            k = _mul32_torch(k, _C2)
            h = _rotl32_torch(h ^ k, 13)
            h = (_mul32_torch(h, 5) + 0xE6546B64) & _M32
    return _fmix32_torch(h)


def _fmix32_torch(h):
    """``_fmix32`` over int64 words in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32_torch(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32_torch(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bucket_ids_torch(columns: list, num_buckets: int):
    """``bucket_ids_np`` on the device, int32. Counterpart of
    ``bucket_ids_jnp``."""
    import torch

    return (hash32_torch(columns) % num_buckets).to(torch.int32)
