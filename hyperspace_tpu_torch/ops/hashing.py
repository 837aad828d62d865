"""Deterministic 32-bit key hashing for bucket placement (counterpart of
hyperspace_tpu/ops/hashing.py, host path).

Bucket ids are part of the on-disk index contract: they must equal the JAX
package's ``hash32_np`` bit for bit, whichever package built the index. The
arithmetic is murmur3-style uint32 mixing over the keys' 32-bit words; an
int64 or float64 key contributes its low then high word, a string its crc32.
Index builds hash on the host, so numpy is the only implementation here.
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


def hash32_np(columns: list[np.ndarray]) -> np.ndarray:
    """Hash rows of one or more key columns to uint32."""
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
