"""Predicate-driven pruning of covering-index scans (counterpart of
hyperspace_tpu/plan/pruning.py, without the sidecar sketch stage, which is
off by default there, and without its telemetry and estimator feedback).

A covering index's layout is a promise: rows are hash-bucketed by the
indexed columns (models/covering.write_bucketed), sorted by them within
each bucket, and the files carry row-group statistics for exactly those
columns. Pruning cashes it in, in two stages:

- bucket pruning, at plan time: equality, IN and IS NULL conjuncts of the
  scan's pushed filter that pin every bucket column hash their literals
  with the write-side hash (ops/hashing.hash32_np over the words
  ops/bucketize.key_hash_words gives) and keep only the files of the
  matching buckets. A point lookup reads one bucket of num_buckets;
- row-group skipping, at execution: range and equality conjuncts on the
  sort columns are evaluated by the min-max sketch converters over each
  file's row-group statistics (footer-only reads, cached in columnar/io).
  A sorted bucket then reads only the runs that can match, and a file
  whose every group is skipped is not read at all.

Soundness: pruning may only drop rows that cannot satisfy the conjuncts
it used; the plan's own Filter still applies the whole condition, so
keeping too much is slow and keeping too little would be a wrong answer.
``_PRUNE_MODE`` is "1" (on, the reference's default), "0" (off) or
"verify" (read pruned and full, compare after the prune predicate, raise
on any difference).
"""

from __future__ import annotations

import datetime
import zlib
from dataclasses import dataclass, replace
from itertools import product
from typing import Optional, Sequence

import numpy as np

from . import expr as X
from .expr import Expr, split_conjunction
from .nodes import FileScan, LogicalPlan
from ..columnar.table import Column, ColumnBatch, DATE32, STRING, Schema, numpy_dtype
from ..exceptions import HyperspaceError

_PRUNE_MODE = "1"

# cross-product cap of multi-column or IN bucket candidates: past it the
# predicate is no point lookup and bucket pruning declines
_MAX_BUCKET_CANDIDATES = 64

_NULL = object()  # the IS NULL candidate value
_NO_MATCH = object()  # the literal equals no stored value (e.g. out of range)
_UNSUPPORTED = object()  # the write-side hash of the value cannot be reproduced

_EPOCH = datetime.date(1970, 1, 1)


@dataclass(frozen=True)
class PruneSpec:
    """Layout contract of a bucketed index scan, carried on FileScan so
    pruning runs without the index log entry. The rules fill the layout
    half; apply_pruning fills the derived half from the pushed filter."""

    index_name: str
    num_buckets: int
    key_columns: tuple[str, ...]  # bucket-hash columns (the indexed columns)
    sort_columns: tuple[str, ...]  # within-bucket sort order
    # --- filled by apply_pruning ---
    bucket_keep: Optional[frozenset] = None  # kept bucket ids (None: all)
    rowgroup_conjuncts: tuple = ()  # conjuncts bounded by row-group stats
    pred: Optional[Expr] = None  # conjunction of every conjunct pruning used
    verify_files: tuple = ()  # the file list before pruning (verify mode)

    @property
    def active(self) -> bool:
        return self.bucket_keep is not None or bool(self.rowgroup_conjuncts)

    def describe(self) -> str:
        parts = []
        if self.bucket_keep is not None:
            parts.append(f"buckets={len(self.bucket_keep)}/{self.num_buckets}")
        if self.rowgroup_conjuncts:
            parts.append(f"rowgroup_conjuncts={len(self.rowgroup_conjuncts)}")
        return ",".join(parts)


def prune_spec_for(entry) -> Optional[PruneSpec]:
    """The layout contract of a covering index's entry: bucket-hashed and
    sorted by its indexed columns. None for an index without buckets."""
    dd = entry.derived_dataset
    if not getattr(dd, "num_buckets", None):
        return None
    cols = tuple(dd.indexed_columns())
    return PruneSpec(entry.name, dd.num_buckets, cols, cols)


def is_verify(scan: FileScan) -> bool:
    spec = scan.prune_spec
    return (spec is not None and spec.active and bool(spec.verify_files)
            and _PRUNE_MODE == "verify")


# ---------------------------------------------------------------------------
# literal hashing: the read-side half of the write-side bucket contract
# ---------------------------------------------------------------------------

def literal_key_array(value, dtype: str):
    """A length-1 array that hashes as a stored value of ``dtype`` hashes at
    index-write time: a string its crc32 word, anything else its storage
    array. ``_NO_MATCH`` when no stored value can equal ``value``,
    ``_UNSUPPORTED`` when the write-side hash cannot be reproduced."""
    if value is _NULL:
        if dtype == STRING:
            # a NULL string row hashes through its batch's code-0 vocabulary
            # entry, which depends on the data
            return _UNSUPPORTED
        return np.zeros(1, dtype=numpy_dtype(dtype))  # NULLs store the fill 0
    if dtype == STRING:
        if not isinstance(value, str):
            return _NO_MATCH
        return np.array([zlib.crc32(value.encode("utf-8")) & 0xFFFFFFFF], dtype=np.uint32)
    if isinstance(value, str):
        return _NO_MATCH
    try:
        arr = np.array([value], dtype=numpy_dtype(dtype))
    except (OverflowError, ValueError, TypeError):
        return _NO_MATCH
    # the literal must round-trip exactly: a wrapped or truncated cast
    # equals no row
    back = arr[0].item()
    if back != value and not (
        isinstance(value, (int, float))
        and isinstance(back, (int, float, bool))
        and float(back) == float(value)
    ):
        return _NO_MATCH
    return arr


def bucket_of_literals(values: Sequence, dtypes: Sequence[str], num_buckets: int) -> Optional[int]:
    """Bucket id of one candidate key tuple; None when a component matches
    no stored value (the tuple selects no rows)."""
    from ..ops.hashing import hash32_np

    cols = []
    for v, dt in zip(values, dtypes):
        arr = literal_key_array(v, dt)
        if arr is _NO_MATCH:
            return None
        if arr is _UNSUPPORTED:
            raise HyperspaceError(f"unhashable prune literal {v!r} ({dt})")
        cols.append(arr)
    return int(hash32_np(cols)[0] % np.uint32(num_buckets))


def _column_candidates(conjuncts: Sequence[Expr], cname: str) -> Optional[set]:
    """Candidate stored values of ``cname`` that the Eq, In and IsNull
    conjuncts allow (intersected); None when none constrains it."""
    from ..models.dataskipping.sketches import _is_col_lit

    sets: list[set] = []
    low = cname.lower()
    for c in conjuncts:
        m = _is_col_lit(c, cname)
        if m is not None and m[0] is X.Eq:
            sets.append({m[1]})
        elif isinstance(c, X.In) and isinstance(c.child, X.Col) and c.child.name.lower() == low:
            sets.append(set(c.values))
        elif isinstance(c, X.IsNull) and isinstance(c.child, X.Col) and c.child.name.lower() == low:
            sets.append({_NULL})
    if not sets:
        return None
    out = sets[0]
    for s in sets[1:]:
        out &= s
    return out


def candidate_buckets(conjuncts: Sequence[Expr], spec: PruneSpec, schema: Schema) -> Optional[frozenset]:
    """Kept bucket ids, or None when bucket pruning cannot apply: a key
    column unconstrained, a hash that cannot be reproduced, or more
    candidate tuples than the point-lookup cap."""
    per_col: list[set] = []
    dtypes: list[str] = []
    for cname in spec.key_columns:
        cands = _column_candidates(conjuncts, cname)
        if cands is None or cname not in schema:
            return None
        dt = schema.field(cname).dtype
        if any(literal_key_array(v, dt) is _UNSUPPORTED for v in cands):
            return None
        per_col.append(cands)
        dtypes.append(dt)
    n_combos = 1
    for s in per_col:
        n_combos *= len(s)
        if n_combos > _MAX_BUCKET_CANDIDATES:
            return None
    keep = set()
    for tup in product(*per_col):
        b = bucket_of_literals(tup, dtypes, spec.num_buckets)
        if b is not None:
            keep.add(b)
    return frozenset(keep)


# ---------------------------------------------------------------------------
# plan-time pass
# ---------------------------------------------------------------------------

def _rowgroup_conjuncts(conjuncts: Sequence[Expr], spec: PruneSpec) -> tuple[Expr, ...]:
    """Conjuncts on one sort column that the min-max converters can bound."""
    from ..models.dataskipping.sketches import MinMaxSketch

    out = []
    for cname in spec.sort_columns:
        sk = MinMaxSketch(cname)
        for c in conjuncts:
            if c.references() != {cname}:
                continue
            try:
                convertible = sk.convert_predicate(c) is not None
            except Exception:  # e.g. an IN of mixed types: cannot bound
                convertible = False
            if convertible:
                out.append(c)
    return tuple(out)


def _bucket_conjuncts(conjuncts: Sequence[Expr], spec: PruneSpec) -> list[Expr]:
    """The equality-shaped conjuncts bucket pruning used."""
    from ..models.dataskipping.sketches import _is_col_lit

    keys = {c.lower() for c in spec.key_columns}
    out = []
    for c in conjuncts:
        if isinstance(c, (X.In, X.IsNull)) and isinstance(c.child, X.Col):
            if c.child.name.lower() in keys:
                out.append(c)
            continue
        if any((m := _is_col_lit(c, k)) is not None and m[0] is X.Eq
               for k in spec.key_columns):
            out.append(c)
    return out


def apply_pruning(plan: LogicalPlan) -> LogicalPlan:
    """The last optimizer pass: derive the pruning of every index scan that
    carries a PruneSpec and a pushed filter. Bucket pruning shrinks the
    file list here; the row-group conjuncts ride on the spec to the
    executor."""
    if _PRUNE_MODE == "0":
        return plan
    replacements: dict[int, FileScan] = {}
    for node in plan.preorder():
        if (isinstance(node, FileScan) and node.prune_spec is not None
                and not node.prune_spec.active and node.pushed_filter is not None
                and node.fmt == "parquet"):
            pruned = _derive_scan_pruning(node)
            if pruned is not None:
                replacements[node.plan_id] = pruned
    if not replacements:
        return plan
    return plan.transform_up(
        lambda n: replacements.get(n.plan_id, n) if isinstance(n, FileScan) else n
    )


def _derive_scan_pruning(scan: FileScan) -> Optional[FileScan]:
    from ..models.covering import bucket_id_from_filename

    spec = scan.prune_spec
    conjuncts = split_conjunction(scan.pushed_filter)
    buckets = candidate_buckets(conjuncts, spec, scan.full_schema)
    rg_conjs = _rowgroup_conjuncts(conjuncts, spec)
    if buckets is None and not rg_conjs:
        return None
    files = list(scan.files)
    kept = files
    if buckets is not None:
        kept = [f for f in files
                if (b := bucket_id_from_filename(f.name)) is None or b in buckets]
    used = ([] if buckets is None else _bucket_conjuncts(conjuncts, spec)) + list(rg_conjs)
    pred = None
    for c in used:
        pred = c if pred is None else X.And(pred, c)
    new_spec = replace(
        spec, bucket_keep=buckets, rowgroup_conjuncts=rg_conjs, pred=pred,
        verify_files=tuple(files) if _PRUNE_MODE == "verify" else (),
    )
    return scan.copy(files=kept, prune_spec=new_spec)


# ---------------------------------------------------------------------------
# execution-time row-group selection
# ---------------------------------------------------------------------------

def _stats_column(dtype: str, values: list) -> Column:
    if dtype == STRING:
        return Column.from_values([str(v) for v in values])
    if dtype == DATE32:  # parquet statistics of a date column are dates
        values = [(v - _EPOCH).days if isinstance(v, datetime.date) else v for v in values]
    return Column(np.array(values, dtype=numpy_dtype(dtype)), dtype)


def rowgroup_selection(scan: FileScan) -> tuple[Optional[dict[str, tuple[int, ...]]], list]:
    """``(selection, kept_files)`` of a pruned scan: ``selection`` maps a
    path to the row groups to read (a path absent from it is read whole),
    and a file whose every group is skipped is left out of ``kept_files``.
    ``(None, scan.files)`` when row-group pruning does not apply. A group
    without usable statistics on a referenced column is kept."""
    from ..columnar import io as cio
    from ..models.dataskipping.sketches import MinMaxSketch

    spec = scan.prune_spec
    if (spec is None or not spec.rowgroup_conjuncts or scan.fmt != "parquet"
            or _PRUNE_MODE == "0"):
        return None, list(scan.files)
    stat_cols: list[str] = []
    converters = []
    for c in spec.rowgroup_conjuncts:
        (cname,) = c.references()
        converters.append(MinMaxSketch(cname).convert_predicate(c))
        if cname not in stat_cols:
            stat_cols.append(cname)
    dtypes = {c: scan.full_schema.field(c).dtype for c in stat_cols}

    def usable(c, mm) -> bool:
        # string statistics must decode to str: bytes would compare wrongly
        return mm is not None and (
            dtypes[c] != STRING or (isinstance(mm[0], str) and isinstance(mm[1], str))
        )

    selection: dict[str, tuple[int, ...]] = {}
    kept_files = []
    for f in scan.files:
        stats = cio.read_rowgroup_stats(f.name, stat_cols)
        if not stats:
            kept_files.append(f)
            continue
        n = len(stats)
        keep = np.ones(n, dtype=bool)
        valid_idx = [g for g in range(n)
                     if all(usable(c, stats[g]["cols"].get(c)) for c in stat_cols)]
        if valid_idx:
            table = {}
            for c in stat_cols:
                table[f"{c}__min"] = _stats_column(
                    dtypes[c], [stats[g]["cols"][c][0] for g in valid_idx])
                table[f"{c}__max"] = _stats_column(
                    dtypes[c], [stats[g]["cols"][c][1] for g in valid_idx])
            batch = ColumnBatch(table)
            mask = np.ones(len(valid_idx), dtype=bool)
            for fn in converters:
                mask &= np.asarray(fn(batch), dtype=bool)
            keep[np.asarray(valid_idx)] = mask
        kept_groups = tuple(int(g) for g in np.flatnonzero(keep))
        if len(kept_groups) == n:
            kept_files.append(f)
        elif kept_groups:
            selection[f.name] = kept_groups
            kept_files.append(f)
    return (selection or None), kept_files


# ---------------------------------------------------------------------------
# verify mode
# ---------------------------------------------------------------------------

def _comparable(batch: ColumnBatch) -> list:
    return [
        (name, col.dtype,
         [v.hex() if isinstance(v, float) else v for v in col.decode().tolist()])
        for name, col in batch.columns.items()
    ]


def verify_against_full(scan: FileScan, pruned_batch: ColumnBatch, session=None) -> None:
    """Verify mode: read the file list from before pruning, apply the prune
    predicate to both reads, and raise unless they hold the same values
    (floats compared bit for bit). A difference means the hash or the
    statistics contract broke."""
    from .executor import _exec_file_scan

    spec = scan.prune_spec
    if spec is None or spec.pred is None or not spec.verify_files:
        return
    full = _exec_file_scan(scan.copy(files=list(spec.verify_files), prune_spec=None), session)

    def masked(batch: ColumnBatch) -> ColumnBatch:
        if not spec.pred.references() <= set(batch.schema.names):
            return batch  # predicate columns projected away: compare raw
        res = spec.pred.eval(batch)
        mask = np.asarray(res.data, dtype=bool)
        if res.validity is not None:
            mask = mask & res.validity
        return batch.filter(mask)

    if _comparable(masked(pruned_batch)) != _comparable(masked(full)):
        raise HyperspaceError(
            f"prune verify mismatch on index {spec.index_name!r}: the pruned scan "
            f"differs from the full read under predicate {spec.pred!r}"
        )


# ---------------------------------------------------------------------------
# ranking support
# ---------------------------------------------------------------------------

def estimate_scan_fraction(condition: Optional[Expr], entry) -> float:
    """Estimated fraction of a covering index that ``condition`` reads after
    bucket pruning (1.0 when none can be derived). Feeds the filter rule's
    ranking and score, so a layout whose bucket key the predicate pins wins
    over a slightly smaller index that must be read whole."""
    spec = None if condition is None else prune_spec_for(entry)
    if spec is None:
        return 1.0
    try:
        buckets = candidate_buckets(split_conjunction(condition), spec,
                                    entry.derived_dataset.schema())
    except Exception:
        return 1.0
    return 1.0 if buckets is None else max(len(buckets), 1) / spec.num_buckets
