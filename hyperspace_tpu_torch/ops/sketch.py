"""Sketch arithmetic: segmented min/max and bloom filters (counterpart of
the numpy forms of hyperspace_tpu/ops/sketch.py).

A data-skipping index summarizes each source file (a segment of rows) by
its min and max or by a bloom filter of its values; the sidecar sketch
store does the same per row group. Sketches are built on the host and
stored on disk, so the bloom bit positions are part of the on-disk
contract: they equal the JAX package's for every dtype. The device forms
of the reference (``segment_min_max_jnp``, ``bloom_build_bits_jnp``,
``bloom_probe_bits_jnp``) are called by its tests only and are not ported.
"""

from __future__ import annotations

import base64
import math

import numpy as np

from .hashing import _fmix32, hash32_np
from ..exceptions import HyperspaceError


def segment_min_max_np(values: np.ndarray, segment_ids: np.ndarray, num_segments: int):
    """Per-segment min and max. NaN rows are masked out, so a NaN cannot
    poison a file's bounds (a NaN bound would make every predicate false and
    skip the file for good); an empty segment keeps the dtype's extremes."""
    if values.dtype.kind == "f":
        init_min, init_max = np.inf, -np.inf
        vmin = np.where(np.isnan(values), np.inf, values)
        vmax = np.where(np.isnan(values), -np.inf, values)
    else:
        info = np.iinfo(values.dtype)
        init_min, init_max = info.max, info.min
        vmin = vmax = values
    mins = np.full(num_segments, init_min, dtype=values.dtype)
    maxs = np.full(num_segments, init_max, dtype=values.dtype)
    np.minimum.at(mins, segment_ids, vmin)
    np.maximum.at(maxs, segment_ids, vmax)
    return mins, maxs


def bloom_params(expected_items: int, fpp: float) -> tuple[int, int]:
    """(num_bits, num_hashes) by the standard optimal sizing; the bit count
    rounds up to a power of two."""
    if not 0 < fpp < 1:
        raise HyperspaceError(f"fpp must be in (0,1): {fpp}")
    n = max(1, expected_items)
    m = max(64, int(math.ceil(-n * math.log(fpp) / (math.log(2) ** 2))))
    m = int(2 ** math.ceil(math.log2(m)))
    k = max(1, round(m / n * math.log(2)))
    return m, min(k, 16)


def _bloom_positions_np(words: list[np.ndarray], num_bits: int, num_hashes: int) -> np.ndarray:
    """[N, k] bit positions by double hashing of the rows' 32-bit words."""
    h1 = hash32_np(words)
    with np.errstate(over="ignore"):
        h2 = _fmix32(h1 ^ np.uint32(0x9E3779B9)) | np.uint32(1)
        i = np.arange(num_hashes, dtype=np.uint32)[None, :]
        pos = (h1[:, None] + i * h2[:, None]) % np.uint32(num_bits)
    return pos.astype(np.int64)


class BloomFilter:
    """Host bloom filter: LSB-first packed bits, serialized as base64."""

    def __init__(self, num_bits: int, num_hashes: int, bits: np.ndarray | None = None):
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.bits = (
            bits if bits is not None
            else np.zeros(num_bits // 8 + (num_bits % 8 > 0), np.uint8)
        )

    @staticmethod
    def create(expected_items: int, fpp: float) -> "BloomFilter":
        m, k = bloom_params(expected_items, fpp)
        return BloomFilter(m, k)

    def add_words(self, words: list[np.ndarray]) -> None:
        pos = _bloom_positions_np(words, self.num_bits, self.num_hashes).ravel()
        np.bitwise_or.at(self.bits, pos >> 3, np.uint8(1) << (pos & 7).astype(np.uint8))

    def might_contain_words(self, words: list[np.ndarray]) -> np.ndarray:
        pos = _bloom_positions_np(words, self.num_bits, self.num_hashes)
        hit = (self.bits[pos >> 3] >> (pos & 7).astype(np.uint8)) & 1
        return hit.all(axis=1)

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        if (self.num_bits, self.num_hashes) != (other.num_bits, other.num_hashes):
            raise HyperspaceError("Incompatible bloom filters")
        return BloomFilter(self.num_bits, self.num_hashes, self.bits | other.bits)

    def to_dict(self) -> dict:
        return {
            "numBits": self.num_bits,
            "numHashFunctions": self.num_hashes,
            "bitset": base64.b64encode(self.bits.tobytes()).decode("ascii"),
        }

    @staticmethod
    def from_dict(d: dict) -> "BloomFilter":
        bits = np.frombuffer(base64.b64decode(d["bitset"]), dtype=np.uint8).copy()
        return BloomFilter(d["numBits"], d["numHashFunctions"], bits)

    def __eq__(self, other):
        return (
            isinstance(other, BloomFilter)
            and self.num_bits == other.num_bits
            and self.num_hashes == other.num_hashes
            and np.array_equal(self.bits, other.bits)
        )


def pack_bits(unpacked: np.ndarray) -> np.ndarray:
    """uint8 0/1 [num_bits] -> packed uint8 [num_bits / 8], LSB first, the
    BloomFilter layout."""
    return np.packbits(np.asarray(unpacked, dtype=np.uint8), bitorder="little")
