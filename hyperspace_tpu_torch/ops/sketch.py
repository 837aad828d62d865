"""Sketch arithmetic: segmented min/max and bloom filters (counterpart of
the numpy forms of hyperspace_tpu/ops/sketch.py).

A data-skipping index summarizes each source file (a segment of rows) by
its min and max or by a bloom filter of its values; the sidecar sketch
store does the same per row group. Sketches are built on the host and
stored on disk, so the bloom bit positions are part of the on-disk
contract: they equal the JAX package's for every dtype.

The device forms (``segment_min_max_torch``, ``bloom_build_bits_torch``,
``bloom_probe_bits_torch``; the reference's ``*_jnp``) are torch code that
runs on the device it is given and gives the numpy forms' results bit for
bit. No index path calls them, in either package: builds sketch on the
host. The tests and the on-card smoke hold them to the numpy forms.
"""

from __future__ import annotations

import base64
import math

import numpy as np

from .hashing import _M32, _fmix32, _fmix32_torch, hash32_np, hash32_torch, words_tensor
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


def segment_min_max_torch(values, segment_ids, num_segments: int, device):
    """``segment_min_max_np`` on ``device``: (mins, maxs) tensors of
    ``values``' dtype, NaN rows masked out, an empty or all-NaN segment
    keeping the dtype's extremes. ``values`` and ``segment_ids`` are host
    arrays or tensors. Counterpart of ``segment_min_max_jnp``."""
    import torch

    v = torch.as_tensor(values, device=device)
    if v.dtype not in (torch.float16, torch.float32, torch.float64, torch.uint8, torch.int8,
                       torch.int16, torch.int32, torch.int64):
        raise HyperspaceError(f"segment_min_max_torch: no device form for {v.dtype}")
    ids = torch.as_tensor(segment_ids, device=device).to(torch.int64)
    if v.is_floating_point():
        lo, hi = float("inf"), float("-inf")
        vmin = torch.where(torch.isnan(v), lo, v)
        vmax = torch.where(torch.isnan(v), hi, v)
    else:
        info = torch.iinfo(v.dtype)
        lo, hi = info.max, info.min
        vmin = vmax = v
    mins = torch.full((num_segments,), lo, dtype=v.dtype, device=device)
    maxs = torch.full((num_segments,), hi, dtype=v.dtype, device=device)
    mins.scatter_reduce_(0, ids, vmin, "amin")
    maxs.scatter_reduce_(0, ids, vmax, "amax")
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


def _bloom_positions_torch(words: list, num_bits: int, num_hashes: int, device):
    """``_bloom_positions_np`` on ``device``, int64 [N, k]: the 32-bit sums
    are masked to 32 bits before the modulus, as uint32 arithmetic wraps."""
    import torch

    h1 = hash32_torch([words_tensor(w, device) for w in words])
    h2 = _fmix32_torch(h1 ^ 0x9E3779B9) | 1
    i = torch.arange(num_hashes, dtype=torch.int64, device=device)[None, :]
    return ((h1[:, None] + i * h2[:, None]) & _M32) % num_bits


def bloom_build_bits_torch(words: list, num_bits: int, num_hashes: int, device):
    """A bloom build on ``device``: uint8 [num_bits], 1 where a row of
    ``words`` sets the bit; ``pack_bits`` of it is ``BloomFilter.add_words``'
    bit array. Merging partial builds is an elementwise max (a bitwise or of
    0/1). Counterpart of ``bloom_build_bits_jnp``."""
    import torch

    pos = _bloom_positions_torch(words, num_bits, num_hashes, device)
    bits = torch.zeros(num_bits, dtype=torch.uint8, device=device)
    bits[pos.reshape(-1)] = 1
    return bits


def bloom_probe_bits_torch(bits, words: list, num_hashes: int, device):
    """Probe an unpacked bit array (``bloom_build_bits_torch``'s) on
    ``device``: bool [N], ``BloomFilter.might_contain_words`` of the same
    filter. Counterpart of ``bloom_probe_bits_jnp``."""
    import torch

    bits = torch.as_tensor(bits, device=device)
    pos = _bloom_positions_torch(words, bits.shape[0], num_hashes, device)
    return bits[pos].bool().all(dim=1)


def pack_bits(unpacked: np.ndarray) -> np.ndarray:
    """uint8 0/1 [num_bits] -> packed uint8 [num_bits / 8], LSB first, the
    BloomFilter layout."""
    return np.packbits(np.asarray(unpacked, dtype=np.uint8), bitorder="little")
