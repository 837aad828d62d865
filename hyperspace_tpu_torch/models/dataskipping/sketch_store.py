"""Per-row-group sketch sidecars of covering indexes (counterpart of
hyperspace_tpu/models/dataskipping/sketch_store.py).

Row-group skipping over footer statistics bounds predicates on a bucket's
sort columns only. The sidecar store extends it to the other columns:
next to each parquet index data file an index build writes

    v__=3/part-0-b00001.parquet
    v__=3/_sketch.part-0-b00001.parquet.json

holding one sketch table per file, a row per row group: a bloom filter
(high-NDV columns) or an exact value list (low-NDV columns) per column,
and one z-region box over the numeric columns. The underscore keeps the
sidecar out of every content listing; vacuum keeps it while its data file
is referenced (actions/lifecycle.py). The sidecar's JSON equals the JAX
package's, so either package reads the other's.

A sketch may only vote "definite miss": a file with no sidecar, a
sidecar without the needed sketch, a stale one (its recorded data size no
longer matches the file) or an unreadable one keeps every group.

Everything is off unless ``HYPERSPACE_SKETCHES`` enables it ("1"/"all",
or a comma list of bloom, valuelist, zregion), read at every call, as the
JAX package reads it (a benchmark toggles it between runs), as are
``HYPERSPACE_SKETCH_BLOOM_FPP`` and ``HYPERSPACE_SKETCH_BLOOM_NDV``, which
size the bloom filters (``bloom_fpp``, ``bloom_ndv_cap``). Decoded
sidecars are kept in a byte-bounded cache keyed by the sidecar file's
identity, as the footer statistics are: ``columnar/io.BytesBoundedLRU``
under the ``cache.sketch.*`` counters, within ``HYPERSPACE_SKETCH_CACHE_MB``
(read at import; 0 parses every read).
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from ... import constants as C
from ...columnar import io as cio
from ...columnar.table import Column, ColumnBatch, STRING, numpy_dtype
from ...utils import env
from .sketches import (
    BloomFilterSketch,
    Sketch,
    ValueListSketch,
    ZRegionSketch,
    sketch_from_dict,
)

if TYPE_CHECKING:
    from ...columnar.table import Schema

SIDECAR_PREFIX = "_sketch."
SIDECAR_SUFFIX = ".json"
SIDECAR_VERSION = 1

# per-file NDV at or below which the exact value list replaces the bloom
# filter (ValueListSketch.MAX_VALUES is the per-group bound it degrades at)
VALUELIST_NDV_MAX = 256
# files probed for NDV statistics before an estimate gives up
_NDV_PROBE_FILES = 8

_ALL_KINDS = ("bloom", "valuelist", "zregion")


def enabled_kinds() -> frozenset:
    """The kinds ``HYPERSPACE_SKETCHES`` enables: none when unset, "0" or
    "off"; every kind for "1" or "all"; else the known names of a comma
    list (an unknown name is ignored)."""
    raw = (env.env_str("HYPERSPACE_SKETCHES") or "").strip().lower()
    if raw in ("", "0", "false", "off"):
        return frozenset()
    if raw in ("1", "all", "true", "on"):
        return frozenset(_ALL_KINDS)
    return frozenset(k.strip() for k in raw.split(",")) & frozenset(_ALL_KINDS)


def sketches_enabled() -> bool:
    return bool(enabled_kinds())


def bloom_fpp() -> float:
    """``HYPERSPACE_SKETCH_BLOOM_FPP``: a sidecar bloom filter's target
    false-positive rate (0.01)."""
    return env.env_float("HYPERSPACE_SKETCH_BLOOM_FPP")


def bloom_ndv_cap() -> int:
    """``HYPERSPACE_SKETCH_BLOOM_NDV``: the cap on the distinct count a
    sidecar bloom filter is sized for (8192)."""
    return env.env_int("HYPERSPACE_SKETCH_BLOOM_NDV")


def sidecar_path(data_path: str) -> str:
    d, base = os.path.split(data_path)
    return os.path.join(d, f"{SIDECAR_PREFIX}{base}{SIDECAR_SUFFIX}")


def derived_base(file_name: str) -> Optional[str]:
    """The data file name a sidecar's file name derives from; None for a
    file that is no sidecar."""
    if file_name.startswith(SIDECAR_PREFIX) and file_name.endswith(SIDECAR_SUFFIX):
        return file_name[len(SIDECAR_PREFIX):-len(SIDECAR_SUFFIX)]
    return None


def eligible_columns(schema: "Schema", key_columns: Sequence[str]) -> list[str]:
    """Columns a sketch may summarize: all but the bucket and sort columns
    (footer statistics bound those) and the lineage id."""
    keys = {c.lower() for c in key_columns}
    return [f.name for f in schema
            if f.name.lower() not in keys and f.name != C.DATA_FILE_NAME_ID]


def declared_capability(schema: "Schema", key_columns: Sequence[str]) -> tuple:
    """The (kind, columns) pairs a layout may carry sketches for under the
    current setting: the bound the planner routes conjuncts by. A file's
    sidecar holds a subset (bloom or value list is chosen per file by its
    NDV); a file without a declared sketch keeps its groups."""
    kinds = enabled_kinds()
    cols = eligible_columns(schema, key_columns) if kinds else []
    cap = []
    for c in cols:
        if "bloom" in kinds:
            cap.append(("bloom", (c,)))
        if "valuelist" in kinds:
            cap.append(("valuelist", (c,)))
    if "zregion" in kinds:
        numeric = [c for c in cols if schema.field(c).dtype != STRING]
        if numeric:
            cap.append(("zregion", tuple(numeric)))
    return tuple(cap)


def capability_sketches(capability: Sequence) -> list[Sketch]:
    """Sketches of a declared capability, for convertibility checks (bloom
    parameters do not change what converts)."""
    out: list[Sketch] = []
    for kind, cols in capability:
        if kind == "bloom":
            out.append(BloomFilterSketch(cols[0]))
        elif kind == "valuelist":
            out.append(ValueListSketch(cols[0]))
        elif kind == "zregion":
            out.append(ZRegionSketch(list(cols)))
    return out


def convertible(sketches: Sequence[Sketch], pred) -> bool:
    """True when any of ``sketches`` can bound ``pred``."""
    for s in sketches:
        try:
            if s.convert_predicate(pred) is not None:
                return True
        except Exception:  # e.g. an IN of mixed types: the sketch cannot bound it
            continue
    return False


def condition_sketchable(condition, schema: "Schema", key_columns: Sequence[str]) -> bool:
    """True when a declared sketch can bound some conjunct of
    ``condition``: then a covering index serves a filter that leaves its
    first indexed column alone (FilterIndexRule's admission), since the
    sidecars skip row groups on the other columns."""
    if condition is None:
        return False
    capability = declared_capability(schema, key_columns)
    if not capability:
        return False
    from ...plan.expr import split_conjunction

    sketches = capability_sketches(capability)
    return any(convertible(sketches, c) for c in split_conjunction(condition))


# ---------------------------------------------------------------------------
# build and write (the index writers' hook)
# ---------------------------------------------------------------------------

def _column_ndv(col: Column) -> int:
    """Exact distinct count (dictionary codes for strings: the writers'
    vocabularies are unique, so codes map one to one onto values)."""
    return int(len(np.unique(col.data))) if len(col) else 0


def _column_to_json(col: Column) -> dict:
    if col.dtype == STRING:
        return {"dtype": STRING,
                "values": [str(v) for v in np.asarray(col.decode(), dtype=object)]}
    return {"dtype": col.dtype, "values": col.data.tolist()}


def _column_from_json(d: dict) -> Column:
    if d["dtype"] == STRING:
        return Column.from_values([str(v) for v in d["values"]])
    return Column(np.asarray(d["values"], dtype=numpy_dtype(d["dtype"])), d["dtype"])


def plan_sketches(batch: ColumnBatch, key_columns: Sequence[str],
                  row_group_size: int = 1 << 30) -> list[Sketch]:
    """One data file's sketch set: the exact value list for a low-NDV
    column, a bloom filter (sized for a group's distinct values, capped)
    for a high-NDV one, and one z-region box over the numeric columns."""
    kinds = enabled_kinds()
    if not kinds:
        return []
    out: list[Sketch] = []
    zregion_cols: list[str] = []
    for c in eligible_columns(batch.schema, key_columns):
        col = batch.column(c)
        ndv = _column_ndv(col)
        if "valuelist" in kinds and 0 < ndv <= VALUELIST_NDV_MAX:
            out.append(ValueListSketch(c))
        elif "bloom" in kinds and ndv > 0:
            expected = max(16, min(ndv, row_group_size, bloom_ndv_cap()))
            out.append(BloomFilterSketch(c, expected, bloom_fpp()))
        if "zregion" in kinds and col.dtype != STRING:
            zregion_cols.append(c)
    if zregion_cols:
        out.append(ZRegionSketch(zregion_cols))
    return out


def build_sidecar(batch: ColumnBatch, row_group_size: int,
                  key_columns: Sequence[str]) -> Optional[dict]:
    """The sidecar of a data file about to be written with
    ``row_group_size`` (the writer cuts consecutive groups of exactly that
    many rows, so a row's group is ``row // row_group_size``). None when
    nothing is enabled or eligible."""
    n = batch.num_rows
    if n == 0 or row_group_size <= 0:
        return None
    sketches = plan_sketches(batch, key_columns, row_group_size)
    if not sketches:
        return None
    num_groups = (n + row_group_size - 1) // row_group_size
    segment_ids = np.arange(n, dtype=np.int64) // row_group_size
    columns: dict[str, dict] = {}
    built: list[dict] = []
    for s in sketches:
        try:
            aggs = s.aggregate_batch(batch, segment_ids, num_groups)
        except Exception:  # an unbuildable sketch costs coverage, never the write
            continue
        for name, col in aggs.items():
            columns[name] = _column_to_json(col)
        built.append(s.to_dict())
    if not built:
        return None
    ndv = {c: _column_ndv(batch.column(c)) for c in eligible_columns(batch.schema, key_columns)}
    return {
        "version": SIDECAR_VERSION,
        "num_row_groups": int(num_groups),
        "row_group_size": int(row_group_size),
        "data_rows": int(n),
        "ndv": ndv,
        "sketches": built,
        "columns": columns,
    }


def maybe_write_sidecar(batch: ColumnBatch, data_path: str, row_group_size: int,
                        key_columns: Sequence[str]) -> bool:
    """Write the sidecar of a just-written parquet index data file; nothing
    when sketches are off or nothing is eligible. The data file's size is
    stamped in it, so a rewrite without its sidecar is never read through
    stale sketches. True when a sidecar was written."""
    if not sketches_enabled() or not data_path.endswith(".parquet"):
        return False
    side = build_sidecar(batch, row_group_size, key_columns)
    if side is None:
        return False
    side["data_size"] = os.path.getsize(data_path)
    with open(sidecar_path(data_path), "w", encoding="utf-8") as f:
        json.dump(side, f)
    from ...telemetry import workload

    # a maintenance charge against the index under maintenance (a no-op
    # with the workload plane off)
    workload.charge_sketch_write()
    return True


# ---------------------------------------------------------------------------
# load and evaluate (the execution-time prune path)
# ---------------------------------------------------------------------------

class Sidecar:
    """One decoded sidecar: its sketches and their per-group table."""

    __slots__ = ("sketches", "batch", "num_row_groups", "ndv", "row_group_size",
                 "data_size", "nbytes")

    def __init__(self, sketches: list[Sketch], batch: ColumnBatch, num_row_groups: int,
                 ndv: dict, row_group_size: int, data_size: int, nbytes: int):
        self.sketches = sketches
        self.batch = batch
        self.num_row_groups = num_row_groups
        self.ndv = ndv
        self.row_group_size = row_group_size
        self.data_size = data_size  # the data file's size when written
        self.nbytes = nbytes

    def keep_mask(self, conjuncts: Sequence) -> Optional[np.ndarray]:
        """The AND of every conjunct's vote over this file's groups; None
        when no conjunct is evaluable here (the caller keeps the file). A
        conjunct no sketch converts, or whose vote fails, keeps all."""
        mask = None
        for pred in conjuncts:
            fn = None
            for s in self.sketches:
                try:
                    fn = s.convert_predicate(pred)
                except Exception:
                    fn = None
                if fn is not None:
                    break
            if fn is None:
                continue
            try:
                vote = np.asarray(fn(self.batch), dtype=bool)
            except Exception:  # an unevaluable sketch keeps every group
                continue
            if vote.shape != (self.num_row_groups,):
                continue
            mask = vote if mask is None else (mask & vote)
        return mask


# decoded sidecars by the sidecar file's (path, mtime_ns, inode, size), so a
# rewrite is never served stale; the lock is ``io.cache.sketch``
_SIDECAR_CACHE = cio.BytesBoundedLRU(
    env.env_int("HYPERSPACE_SKETCH_CACHE_MB") * 1024 * 1024, metric_name="sketch")


def _decode_sidecar(raw: dict, nbytes: int) -> Optional[Sidecar]:
    """None for a malformed sidecar (which then keeps everything)."""
    try:
        if raw.get("version") != SIDECAR_VERSION:
            return None
        sketches = [sketch_from_dict(d) for d in raw["sketches"]]
        batch = ColumnBatch({name: _column_from_json(d) for name, d in raw["columns"].items()})
        n = int(raw["num_row_groups"])
        if batch.num_rows != n:
            return None
        return Sidecar(sketches, batch, n, dict(raw.get("ndv", {})),
                       int(raw.get("row_group_size", 0)), int(raw.get("data_size", -1)),
                       nbytes)
    except Exception:
        return None


def load_sidecar(data_path: str) -> Optional[Sidecar]:
    """The decoded sidecar of an index data file; None when it is absent,
    unreadable, malformed or stale (its recorded data size differs from
    the file's: ``pruning.sketch.stale``). A budget of 0 bypasses the
    cache, as the JAX package's does."""
    spath = sidecar_path(data_path)
    try:
        st = os.stat(spath)
    except OSError:
        return None
    key = (spath, st.st_mtime_ns, st.st_ino, st.st_size)

    def parse() -> tuple:
        with open(spath, encoding="utf-8") as f:
            text = f.read()
        sc = _decode_sidecar(json.loads(text), len(text))
        if sc is None:
            raise _BadSidecar  # never cached as good
        return sc, len(text)

    try:
        if _SIDECAR_CACHE.max_bytes > 0:
            sc = _SIDECAR_CACHE.get_or_put(key, parse)
        else:
            sc = parse()[0]
    except (_BadSidecar, OSError, ValueError):
        return None
    try:
        data_size = os.path.getsize(data_path)
    except OSError:
        return None
    if sc.data_size >= 0 and sc.data_size != data_size:
        from ...telemetry.metrics import REGISTRY

        REGISTRY.counter("pruning.sketch.stale").inc()
        return None  # the data was rewritten without its sketches
    return sc


class _BadSidecar(Exception):
    """A sidecar that parsed but failed validation."""


# ---------------------------------------------------------------------------
# planner and ranker support
# ---------------------------------------------------------------------------

def ndv_stats(files) -> Optional[tuple[dict, int]]:
    """(NDV by column, rows per row group) of the first of ``files`` that
    carries a sidecar; at most _NDV_PROBE_FILES parquet files are
    probed."""
    probed = 0
    for f in files:
        if not f.name.endswith(".parquet"):
            continue
        sc = load_sidecar(f.name)
        if sc is not None and sc.ndv:
            return dict(sc.ndv), max(1, sc.row_group_size)
        probed += 1
        if probed >= _NDV_PROBE_FILES:
            break
    return None


def index_ndv_stats(entry) -> Optional[tuple[dict, int]]:
    """The NDV statistics of an index's content files (the filter ranker's
    sketch-stage estimate reads them)."""
    return ndv_stats(entry.content.file_infos())
