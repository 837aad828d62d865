"""Sample twins of index data files for the approximate tier (counterpart
of hyperspace_tpu/models/sample_store.py; names, metas and parquet
contents equal the JAX package's for the same batch, path and knobs).

With ``HYPERSPACE_APPROX`` on, every index data file gets one *sample
twin* per configured fraction, written beside it in the same version
directory:

    part-3-b00007.parquet
    _sample.r010000.part-3-b00007.parquet      (fraction 0.01: 10000 ppm)
    _sample.r100000.part-3-b00007.parquet      (fraction 0.1: 100000 ppm)

and one meta, ``_sample.meta.<data file>.json``: the file's rows, the
distinct key hashes (an NDV lower bound) and the kept rows per tier, and
the *heavy* keys, by salted hash, that own an outsized share of its rows.
The underscore prefix hides twins and metas from every content listing;
vacuum keeps them exactly as long as their data file is referenced
(``derived_base``).

Sampling is *universe* sampling on the index's bucket-key columns: a row
is kept iff a salted remix of its key hash falls under ``fraction *
2^32``. Keep or drop is a pure function of the key value, so appended rows
decide as created ones did, two indexes bucketed by the same join key keep
the same keys (a sampled join keeps matching pairs, and its rows scale by
1/p), and the salt makes the decision independent of the bucket id. The
mask keeps row order, so a twin inherits its data file's sort order and
footer statistics.

``approx.sample`` brackets the writes: a crash between a data file and its
twins leaves files without twins, which the planner reads as "tier
ineligible" (exact execution, never a wrong answer).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import numpy as np

from ..columnar import io as cio
from ..columnar.table import ColumnBatch
from ..ops.bucketize import key_hash_words
from ..ops.hashing import _fmix32, hash32_np
from ..utils import env, faults

SAMPLE_PREFIX = "_sample."
_SAMPLE_NAME_RE = re.compile(r"^_sample\.r(\d{1,7})\.(?P<base>.+)$")
SAMPLE_META_PREFIX = "_sample.meta."

# decorrelates the keep decision from the bucket id (the unsalted hash)
_UNIVERSE_SALT = np.uint32(0x9E3779B1)


def approx_mode() -> str:
    """``HYPERSPACE_APPROX``: "0" (default, off) / "1" / "verify"."""
    v = env.env_str("HYPERSPACE_APPROX").strip().lower()
    if v == "verify":
        return "verify"
    if v in ("1", "true", "on"):
        return "1"
    return "0"


def approx_enabled() -> bool:
    return approx_mode() != "0"


def sample_fractions() -> tuple[float, ...]:
    """Configured sampling tiers, ascending, each in (0, 1)."""
    raw = env.env_str("HYPERSPACE_APPROX_FRACTIONS") or "0.01,0.1"
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            f = float(part)
        except ValueError:
            continue
        if 0.0 < f < 1.0:
            out.append(f)
    return tuple(sorted(set(out)))


def fraction_ppm(fraction: float) -> int:
    return int(round(fraction * 1_000_000))


def sample_file_name(base_name: str, fraction: float) -> str:
    return f"{SAMPLE_PREFIX}r{fraction_ppm(fraction):06d}.{base_name}"


def sample_path(data_path: str, fraction: float) -> str:
    d, base = os.path.split(data_path)
    return os.path.join(d, sample_file_name(base, fraction))


def parse_sample_name(name: str) -> Optional[tuple[float, str]]:
    """``(fraction, base data file name)`` if ``name`` is a sample twin."""
    m = _SAMPLE_NAME_RE.match(name)
    if m is None:
        return None
    return int(m.group(1)) / 1_000_000, m.group("base")


def strip_sample_prefix(name: str) -> str:
    """The data file name of a twin; any other name passes through."""
    parsed = parse_sample_name(name)
    return parsed[1] if parsed is not None else name


def derived_base(name: str) -> Optional[str]:
    """The data file name a twin or a sample meta belongs to; None for any
    other file."""
    if name.startswith(SAMPLE_META_PREFIX) and name.endswith(".json"):
        return name[len(SAMPLE_META_PREFIX):-len(".json")]
    parsed = parse_sample_name(name)
    return parsed[1] if parsed is not None else None


def sample_meta_path(data_path: str) -> str:
    d, base = os.path.split(data_path)
    return os.path.join(d, f"{SAMPLE_META_PREFIX}{base}.json")


def load_sample_meta(data_path: str) -> Optional[dict]:
    """The data file's sample meta, or None when it is absent or
    unreadable (no NDV evidence from this file, never an error)."""
    try:
        with open(sample_meta_path(data_path), encoding="utf-8") as f:
            return json.load(f)
    except Exception:
        return None


def _key_hash(batch: ColumnBatch, key_columns: Sequence[str]) -> np.ndarray:
    """The salted per-row key hash the keep decision thresholds."""
    h = hash32_np([key_hash_words(batch.column(c)) for c in key_columns])
    with np.errstate(over="ignore"):
        return _fmix32(h.astype(np.uint32) ^ _UNIVERSE_SALT).astype(np.uint64)


def keep_threshold(fraction: float) -> int:
    """A key survives tier ``fraction`` iff its salted hash is below this."""
    return int(round(fraction * float(2**32)))


def universe_keep_mask(batch: ColumnBatch, key_columns: Sequence[str],
                       fraction: float) -> np.ndarray:
    """The rows of ``batch`` that tier ``fraction`` keeps: a pure function
    of the ``key_columns`` values."""
    return _key_hash(batch, key_columns) < np.uint64(keep_threshold(fraction))


def maybe_write_samples(batch: ColumnBatch, data_path: str, row_group_size: int,
                        key_columns: Sequence[str]) -> int:
    """Write the sample twins and the meta of a just-written index data
    file; returns the twins written. Nothing (one knob read) with the tier
    off, for a file that is not parquet, or for an index without key
    columns. Every configured tier is written: which tier a query may use
    is decided on the read side."""
    if not approx_enabled() or not data_path.endswith(".parquet"):
        return 0
    if not key_columns:
        return 0
    fractions = sample_fractions()
    if not fractions:
        return 0
    faults.fire("approx.sample")
    h = _key_hash(batch, key_columns)
    written = 0
    kept_rows: dict[str, int] = {}
    for fraction in fractions:
        keep = h < np.uint64(keep_threshold(fraction))
        cio.write_index_file(batch.filter(keep), sample_path(data_path, fraction),
                             row_group_size=row_group_size)
        kept_rows[str(fraction_ppm(fraction))] = int(np.count_nonzero(keep))
        written += 1
    # the meta comes last, inside the bracket: a crash mid-set leaves twins
    # without a meta, which the NDV floor reads as "no evidence". Heavy
    # keys are recorded at half the read side's share guard (at most 1% of
    # the file's rows, at least 8 rows), as many as can reach that floor.
    uniq, counts = np.unique(h, return_counts=True)
    max_share = env.env_float("HYPERSPACE_APPROX_MAX_KEY_SHARE")
    share_floor = min(0.01, max_share / 2.0) if max_share > 0 else 0.01
    floor = max(8, int(share_floor * batch.num_rows))
    cap = int(1.0 / share_floor) + 1
    big = counts >= floor
    order = np.argsort(counts[big])[::-1][:cap]
    heavy = {str(int(uniq[big][i])): int(counts[big][i]) for i in order}
    meta = {
        "rows": int(batch.num_rows),
        "key_ndv": int(uniq.size),
        "kept": kept_rows,
        "heavy": heavy,
    }
    tmp = sample_meta_path(data_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, sample_meta_path(data_path))
    faults.fire_after("approx.sample")
    from ..telemetry.metrics import REGISTRY

    REGISTRY.counter("approx.samples.written").inc(written)
    return written
