"""Predicate-driven pruning of covering-index scans (counterpart of
hyperspace_tpu/plan/pruning.py).

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
  whose every group is skipped is not read at all;
- the sketch stage, at execution, with ``HYPERSPACE_SKETCHES`` on: Eq, IN
  and range conjuncts on the other columns are evaluated by each data
  file's sidecar sketches (bloom, value list, z-region box;
  models/dataskipping/sketch_store.py), and the two stages' votes
  intersect.

Soundness: pruning may only drop rows that cannot satisfy the conjuncts
it used; the plan's own Filter still applies the whole condition, so
keeping too much is slow and keeping too little would be a wrong answer.
``HYPERSPACE_PRUNE`` (``prune_mode``, read on every call as the JAX
package reads it) is "1" (on, the default), "0" (off) or "verify" (read
pruned and full, compare after the prune predicate, raise on any
difference).

Telemetry, at the JAX package's sites and under its names: the
``prune:plan``, ``prune:bucket``, ``prune:sketch`` and ``prune:rowgroup``
spans, the ``pruning.*`` counters, the ``IndexPruning`` usage event, and
the estimator-accuracy observations ``scan_fraction``, ``prune_files`` and
``sketch_rowgroups`` (telemetry/plan_stats.py). Under
``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` the ranker's scan fraction and the NDV
model's sketch fraction are multiplied by the ledger's observed
corrections; off (the default) they are the raw estimates.
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
from ..telemetry import trace
from ..telemetry.metrics import REGISTRY
from ..utils import env

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
    # the (kind, columns) sketches the layout's sidecars may carry under the
    # current setting (sketch_store.declared_capability); () with sketches off
    sketch_capability: tuple = ()
    # --- filled by apply_pruning ---
    bucket_keep: Optional[frozenset] = None  # kept bucket ids (None: all)
    rowgroup_conjuncts: tuple = ()  # conjuncts bounded by row-group stats
    sketch_conjuncts: tuple = ()  # conjuncts on other columns, for the sidecars
    pred: Optional[Expr] = None  # conjunction of every conjunct pruning used
    verify_files: tuple = ()  # the file list before pruning (verify mode)
    # the uniform-bucket model's predicted kept file count (-1: none)
    predicted_kept: int = -1
    # the NDV model's predicted kept fraction of row groups of the sketch
    # stage (-1: no prediction)
    sketch_fraction: float = -1.0

    @property
    def active(self) -> bool:
        return (self.bucket_keep is not None or bool(self.rowgroup_conjuncts)
                or bool(self.sketch_conjuncts))

    def describe(self) -> str:
        parts = []
        if self.bucket_keep is not None:
            parts.append(f"buckets={len(self.bucket_keep)}/{self.num_buckets}")
        if self.rowgroup_conjuncts:
            parts.append(f"rowgroup_conjuncts={len(self.rowgroup_conjuncts)}")
        if self.sketch_conjuncts:
            parts.append(f"sketch_conjuncts={len(self.sketch_conjuncts)}")
        return ",".join(parts)


def prune_spec_for(entry) -> Optional[PruneSpec]:
    """The layout contract of a covering index's entry: bucket-hashed and
    sorted by its indexed columns, with the sketch capability the current
    setting declares. None for an index without buckets."""
    from ..models.dataskipping import sketch_store

    dd = entry.derived_dataset
    if not getattr(dd, "num_buckets", None):
        return None
    cols = tuple(dd.indexed_columns())
    return PruneSpec(entry.name, dd.num_buckets, cols, cols,
                     sketch_capability=sketch_store.declared_capability(dd.schema(), cols))


def prune_mode() -> str:
    """``HYPERSPACE_PRUNE``: "1" (on), "0" (off: "0", "false", "off") or
    "verify"; anything else means on."""
    v = env.env_str("HYPERSPACE_PRUNE").strip().lower()
    if v in ("0", "false", "off"):
        return "0"
    return "verify" if v == "verify" else "1"


def is_verify(scan: FileScan) -> bool:
    spec = scan.prune_spec
    return (spec is not None and spec.active and bool(spec.verify_files)
            and prune_mode() == "verify")


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


def _sketch_conjuncts(conjuncts: Sequence[Expr], spec: PruneSpec) -> tuple[Expr, ...]:
    """Conjuncts on columns other than the sort columns that a declared
    sketch can bound (Eq and IN by bloom or value list, ranges by the
    z-region box): the sketch stage's work. None derive without a
    capability (sketches off)."""
    if not spec.sketch_capability:
        return ()
    from ..models.dataskipping.sketch_store import capability_sketches, convertible

    sketches = capability_sketches(spec.sketch_capability)
    sort_cols = {c.lower() for c in spec.sort_columns}
    return tuple(
        c for c in conjuncts
        if (refs := c.references()) and not any(r.lower() in sort_cols for r in refs)
        and convertible(sketches, c)
    )


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


def apply_pruning(plan: LogicalPlan, session=None) -> LogicalPlan:
    """The last optimizer pass: derive the pruning of every index scan that
    carries a PruneSpec and a pushed filter. Bucket pruning shrinks the
    file list here; the row-group conjuncts ride on the spec to the
    executor. With a session, each derived pruning logs its usage event."""
    mode = prune_mode()
    if mode == "0":
        return plan
    replacements: dict[int, FileScan] = {}
    for node in plan.preorder():
        if (isinstance(node, FileScan) and node.prune_spec is not None
                and not node.prune_spec.active and node.pushed_filter is not None
                and node.fmt == "parquet"):
            pruned = _derive_scan_pruning(node, session, mode)
            if pruned is not None:
                replacements[node.plan_id] = pruned
    if not replacements:
        return plan
    return plan.transform_up(
        lambda n: replacements.get(n.plan_id, n) if isinstance(n, FileScan) else n
    )


def _derive_scan_pruning(scan: FileScan, session, mode: str) -> Optional[FileScan]:
    from ..models.covering import bucket_id_from_filename
    from ..telemetry import plan_stats

    spec = scan.prune_spec
    with trace.span("prune:plan", index=spec.index_name) as sp:
        conjuncts = split_conjunction(scan.pushed_filter)
        buckets = candidate_buckets(conjuncts, spec, scan.full_schema)
        rg_conjs = _rowgroup_conjuncts(conjuncts, spec)
        sk_conjs = _sketch_conjuncts(conjuncts, spec)
        if buckets is None and not rg_conjs and not sk_conjs:
            return None
        files = list(scan.files)
        kept = files
        predicted_kept = -1
        pred_fraction = None
        if buckets is not None:
            pred_fraction = max(len(buckets), 1) / spec.num_buckets
            predicted_kept = round(pred_fraction * len(files))
            with trace.span("prune:bucket", index=spec.index_name) as bsp:
                kept = [f for f in files
                        if (b := bucket_id_from_filename(f.name)) is None or b in buckets]
                bucket_bytes_skipped = sum(f.size for f in files) - sum(f.size for f in kept)
                REGISTRY.counter("pruning.files_total").inc(len(files))
                REGISTRY.counter("pruning.files_kept").inc(len(kept))
                REGISTRY.counter("pruning.bytes_skipped").inc(bucket_bytes_skipped)
                from ..telemetry import workload

                workload.note_prune(
                    spec.index_name, "bucket",
                    shape=predicate_shape(scan.pushed_filter, spec.key_columns),
                    bytes_skipped=bucket_bytes_skipped,
                )
                bsp.set_attr("files_total", len(files))
                bsp.set_attr("files_kept", len(kept))
                bsp.set_attr("buckets_kept", len(buckets))
                bsp.set_attr("predicted_kept", predicted_kept)
        used = (([] if buckets is None else _bucket_conjuncts(conjuncts, spec)) + list(rg_conjs)
                + [c for c in sk_conjs if c not in rg_conjs])
        pred = None
        for c in used:
            pred = c if pred is None else X.And(pred, c)
        new_spec = replace(
            spec, bucket_keep=buckets, rowgroup_conjuncts=rg_conjs, sketch_conjuncts=sk_conjs,
            pred=pred, verify_files=tuple(files) if mode == "verify" else (),
            predicted_kept=predicted_kept,
            sketch_fraction=(_sketch_stage_fraction(sk_conjs, scan.files, spec.index_name)
                             if sk_conjs else -1.0),
        )
        sp.set_attr("kind", _prune_kind(new_spec))
        out = scan.copy(files=kept, prune_spec=new_spec)
        # estimator accuracy: the ranker priced the scan at len(buckets)/nb
        # of the index; the truth is the kept byte fraction, which skewed
        # bucket sizes move
        if buckets is not None:
            total_bytes = sum(f.size for f in files)
            if total_bytes > 0:
                plan_stats.observe(
                    "scan_fraction", pred_fraction, sum(f.size for f in kept) / total_bytes,
                    index=spec.index_name,
                    shape=predicate_shape(scan.pushed_filter, spec.key_columns),
                    plan_id=out.plan_id,
                )
            if not rg_conjs:
                # no row-group stage at execution: the kept count is final
                plan_stats.observe(
                    "prune_files", max(predicted_kept, 1), max(len(kept), 1),
                    index=spec.index_name, plan_id=out.plan_id,
                )
        if session is not None:
            from ..rules.rule_utils import log_index_usage

            note = f" (predicted {predicted_kept})" if predicted_kept >= 0 else ""
            log_index_usage(
                session, "IndexPruning", [spec.index_name],
                f"Index pruning planned ({_prune_kind(new_spec)}): "
                f"kept {len(kept)} of {len(files)} files{note}",
            )
        return out


def _prune_kind(spec: PruneSpec) -> str:
    kinds = []
    if spec.bucket_keep is not None:
        kinds.append("bucket")
    if spec.rowgroup_conjuncts:
        kinds.append("rowgroup")
    if spec.sketch_conjuncts:
        kinds.append("sketch")
    return "+".join(kinds) or "none"


def _sketch_shape(conjuncts: Sequence[Expr]) -> str:
    """Canonical shape of the sketch-stage conjuncts (the accuracy
    ledger's correction key): ``v:eq+s:in3``, a range as ``rng``."""
    parts = []
    for c in conjuncts:
        name = ",".join(sorted(r.lower() for r in c.references()))
        if isinstance(c, X.In):
            parts.append(f"{name}:in{len(c.values)}")
        elif isinstance(c, X.Eq):
            parts.append(f"{name}:eq")
        else:
            parts.append(f"{name}:rng")
    return "+".join(sorted(parts))


def _ndv_sketch_fraction(conjuncts: Sequence[Expr], stats, index_name: str) -> float:
    """The NDV model's estimate of the row-group fraction the sketch stage
    keeps for Eq and IN conjuncts: a value spread uniformly appears in a
    group with probability about min(1, group_rows / ndv), an IN of k
    values k times that, and conjuncts intersect (the least). Floored at
    the bloom filter's false-positive rate, and under
    ``HYPERSPACE_ESTIMATOR_FEEDBACK=1`` multiplied by the accuracy ledger's
    observed ``sketch_rowgroups`` correction."""
    if stats is None:
        return 1.0
    ndv_map, group_rows = stats
    low = {k.lower(): v for k, v in ndv_map.items()}
    frac = 1.0
    for c in conjuncts:
        refs = sorted(c.references())
        if len(refs) != 1 or not (n := low.get(refs[0].lower())):
            continue
        if isinstance(c, X.In):
            k = len(c.values)
        elif isinstance(c, X.Eq):
            k = 1
        else:
            continue  # a range: the NDV model says nothing useful
        frac = min(frac, min(1.0, k * group_rows / max(int(n), 1)))
    if frac >= 1.0:
        return 1.0
    from ..models.dataskipping.sketch_store import bloom_fpp
    from ..telemetry import plan_stats

    frac = max(frac, bloom_fpp())
    if plan_stats.feedback_enabled():
        corr = plan_stats.ACCURACY.correction(
            "sketch_rowgroups", index_name, _sketch_shape(conjuncts))
        frac = min(1.0, frac * corr)
    return frac


def _sketch_stage_fraction(conjuncts: Sequence[Expr], files, index_name: str) -> float:
    """The plan-time predicted kept fraction of the sketch stage, from the
    first of the scan's files whose sidecar has NDV statistics."""
    from ..models.dataskipping.sketch_store import ndv_stats

    return _ndv_sketch_fraction(conjuncts, ndv_stats(files), index_name)


# ---------------------------------------------------------------------------
# execution-time row-group selection
# ---------------------------------------------------------------------------

def _stats_value(dtype: str, v):
    """A footer statistic in the column's stored form: parquet gives a
    date column's statistics as dates."""
    if dtype == DATE32 and isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


def _stats_column(dtype: str, values: list) -> Column:
    if dtype == STRING:
        return Column.from_values([str(v) for v in values])
    return Column(np.array([_stats_value(dtype, v) for v in values],
                           dtype=numpy_dtype(dtype)), dtype)


def _sketch_masks(scan: FileScan) -> dict[str, np.ndarray]:
    """The sketch stage, in a ``prune:sketch`` span: each file's keep-mask
    over its row groups from its sidecar. A file without a usable sidecar,
    or whose sidecar bounds no conjunct, is absent (it keeps every
    group)."""
    from ..columnar import io as cio
    from ..models.dataskipping import sketch_store
    from ..telemetry import plan_stats

    spec = scan.prune_spec
    masks = {}
    checked = skipped = nosidecar = 0
    with trace.span("prune:sketch", index=spec.index_name) as sp:
        for f in scan.files:
            if f.name.endswith(cio.ARROW_EXT):
                continue  # an Arrow IPC file has no row groups to sketch
            sc = sketch_store.load_sidecar(f.name)
            if sc is None:
                nosidecar += 1
                continue
            mask = sc.keep_mask(spec.sketch_conjuncts)
            if mask is not None:
                masks[f.name] = mask
                checked += len(mask)
                skipped += int((~mask).sum())
        REGISTRY.counter("pruning.sketch.rowgroups_checked").inc(checked)
        REGISTRY.counter("pruning.sketch.rowgroups_skipped").inc(skipped)
        if nosidecar:
            REGISTRY.counter("pruning.sketch.files_nosidecar").inc(nosidecar)
        sp.set_attr("rowgroups_checked", checked)
        sp.set_attr("rowgroups_skipped", skipped)
        sp.set_attr("files_nosidecar", nosidecar)
        if spec.sketch_fraction >= 0 and checked > 0:
            # the NDV model's prediction meets the groups the sketches kept
            plan_stats.observe(
                "sketch_rowgroups", max(round(spec.sketch_fraction * checked), 1),
                max(checked - skipped, 1), index=spec.index_name,
                shape=_sketch_shape(spec.sketch_conjuncts), plan_id=scan.plan_id,
            )
    return masks


def rowgroup_selection(scan: FileScan) -> tuple[Optional[dict[str, tuple[int, ...]]], list]:
    """``(selection, kept_files)`` of a pruned scan: ``selection`` maps a
    path to the row groups to read (a path absent from it is read whole),
    and a file whose every group is skipped is left out of ``kept_files``.
    ``(None, scan.files)`` when row-group pruning does not apply. Two votes
    intersect: the footer statistics' on the sort-column conjuncts and the
    sidecar sketches' on the others. Each may only vote a definite miss: a
    group without usable statistics on a referenced column, and a file
    without a sidecar (or whose sidecar's group count differs from the
    footer's), keep their groups. The footer stage runs in a
    ``prune:rowgroup`` span and notes the kept files on the plan-statistics
    collector."""
    from ..columnar import io as cio
    from ..models.dataskipping.sketches import MinMaxSketch
    from ..telemetry import plan_stats

    spec = scan.prune_spec
    if (spec is None or not (spec.rowgroup_conjuncts or spec.sketch_conjuncts)
            or scan.fmt != "parquet" or prune_mode() == "0"):
        return None, list(scan.files)
    sketch_masks = _sketch_masks(scan) if spec.sketch_conjuncts else {}
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
    total = kept = bytes_skipped = 0
    with trace.span("prune:rowgroup", index=spec.index_name) as sp:
        for f in scan.files:
            stats = cio.read_rowgroup_stats(f.name, stat_cols)
            if not stats:
                kept_files.append(f)
                continue
            n = len(stats)
            total += n
            keep = np.ones(n, dtype=bool)
            valid_idx = [g for g in range(n)
                         if all(usable(c, stats[g]["cols"].get(c)) for c in stat_cols)]
            if converters and valid_idx:
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
            smask = sketch_masks.get(f.name)
            if smask is not None:
                if len(smask) == n:
                    keep &= smask
                else:  # the sidecar's group count drifted from the footer's
                    REGISTRY.counter("pruning.sketch.stale").inc()
            kept_groups = tuple(int(g) for g in np.flatnonzero(keep))
            kept += len(kept_groups)
            bytes_skipped += sum(stats[g]["nbytes"] for g in range(n) if not keep[g])
            if len(kept_groups) == n:
                kept_files.append(f)
            elif kept_groups:
                selection[f.name] = kept_groups
                kept_files.append(f)
        REGISTRY.counter("pruning.rowgroups_total").inc(total)
        REGISTRY.counter("pruning.rowgroups_kept").inc(kept)
        REGISTRY.counter("pruning.bytes_skipped").inc(bytes_skipped)
        REGISTRY.counter("pruning.files_total").inc(len(scan.files))
        REGISTRY.counter("pruning.files_kept").inc(len(kept_files))
        from ..telemetry import workload

        sk_skipped = sum(int((~np.asarray(m, dtype=bool)).sum()) for m in sketch_masks.values())
        workload.note_prune(
            spec.index_name, "sketch" if sk_skipped else "rowgroup",
            shape=_sketch_shape(spec.sketch_conjuncts) if spec.sketch_conjuncts else "",
            bytes_skipped=bytes_skipped, rowgroups_skipped=total - kept,
        )
        sp.set_attr("rowgroups_total", total)
        sp.set_attr("rowgroups_kept", kept)
        sp.set_attr("bytes_skipped", bytes_skipped)
        sp.set_attr("files_kept", len(kept_files))
        if spec.predicted_kept >= 0:
            # the plan-time prediction meets its final truth: row-group
            # skipping can drop whole files past bucket pruning
            plan_stats.observe(
                "prune_files", max(spec.predicted_kept, 1), max(len(kept_files), 1),
                index=spec.index_name, plan_id=scan.plan_id,
            )
        plan_stats.note_scan(scan.plan_id, len(kept_files), sum(f.size for f in kept_files))
    return (selection or None), kept_files


def prune_underdelivery(scan: FileScan, selection) -> tuple[float, float, float]:
    """``(ratio, predicted, actual)`` of the worst-kept prune prediction of a
    resolved scan: the file stage's uniform-bucket ``predicted_kept`` files
    against the files kept, and the sketch stage's NDV-model
    ``sketch_fraction`` against the fraction of row groups kept (from the
    cached footers). ``ratio`` above 1 means the scan kept more than
    predicted; ``(0.0, 0.0, 0.0)`` without a prediction. The adaptive scan
    monitor aborts at ``HYPERSPACE_ADAPTIVE_ABORT_FACTOR``."""
    from ..columnar import io as cio

    spec = scan.prune_spec
    if spec is None:
        return 0.0, 0.0, 0.0
    row_groups, kept_files = selection
    best = (0.0, 0.0, 0.0)
    if spec.predicted_kept >= 0:
        predicted = max(float(spec.predicted_kept), 1.0)
        actual = float(len(kept_files))
        r = actual / predicted
        if r > best[0]:
            best = (r, predicted, actual)
    if spec.sketch_fraction > 0:
        total = kept = 0
        kept_names = {f.name for f in kept_files}
        for f in scan.files:
            if f.name.endswith(cio.ARROW_EXT):
                continue
            stats = cio.read_rowgroup_stats(f.name, [])
            n = len(stats) if stats else 0
            total += n
            if f.name not in kept_names:
                continue
            sel = (row_groups or {}).get(f.name)
            kept += len(sel) if sel is not None else n
        if total:
            actual_frac = kept / total
            r = actual_frac / spec.sketch_fraction
            if r > best[0]:
                best = (r, spec.sketch_fraction, actual_frac)
    return best


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
    (floats compared bit for bit), counting ``pruning.verified``. A
    difference means the hash or the statistics contract broke."""
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
    REGISTRY.counter("pruning.verified").inc()


# ---------------------------------------------------------------------------
# ranking support
# ---------------------------------------------------------------------------

def estimate_scan_fraction(condition: Optional[Expr], entry) -> float:
    """Estimated fraction of a covering index that ``condition`` reads after
    bucket pruning and, with sketches on, the sketch stage (1.0 when none
    can be derived). Feeds the filter rule's ranking and score, so a layout
    whose bucket key the predicate pins, or whose sidecars will skip most
    row groups, wins over a slightly smaller index that must be read
    whole."""
    spec = None if condition is None else prune_spec_for(entry)
    if spec is None:
        return 1.0
    conjuncts = split_conjunction(condition)
    try:
        buckets = candidate_buckets(conjuncts, spec, entry.derived_dataset.schema())
    except Exception:
        return 1.0
    frac = 1.0 if buckets is None else max(len(buckets), 1) / spec.num_buckets
    return frac * _entry_sketch_fraction(conjuncts, entry, spec)


def predicate_shape(condition: Optional[Expr], key_columns) -> str:
    """Canonical shape of a predicate's constraints on the bucket key
    columns, the accuracy ledger's per-shape correction key: ``ev_k:eq``,
    ``a:eq+b:in3``, ``k:*`` (unconstrained)."""
    if condition is None or not key_columns:
        return ""
    conjuncts = split_conjunction(condition)
    parts = []
    for cname in key_columns:
        cands = _column_candidates(conjuncts, cname)
        low = cname.lower()
        if cands is None:
            parts.append(f"{low}:*")
        elif cands == {_NULL}:
            parts.append(f"{low}:null")
        elif len(cands) <= 1:
            parts.append(f"{low}:eq")
        else:
            parts.append(f"{low}:in{len(cands)}")
    return "+".join(parts)


def corrected_scan_fraction(condition: Optional[Expr], entry) -> float:
    """``estimate_scan_fraction`` times the accuracy ledger's observed
    correction for this (index, predicate shape), only under
    ``HYPERSPACE_ESTIMATOR_FEEDBACK=1``; off, the raw estimate."""
    from ..telemetry import plan_stats

    frac = estimate_scan_fraction(condition, entry)
    if frac >= 1.0 or not plan_stats.feedback_enabled():
        return frac
    keys = tuple(entry.derived_dataset.indexed_columns())
    corr = plan_stats.ACCURACY.correction(
        "scan_fraction", entry.name, predicate_shape(condition, keys))
    return min(1.0, frac * corr)


def _entry_sketch_fraction(conjuncts: Sequence[Expr], entry, spec: PruneSpec) -> float:
    """The sketch stage's estimated kept fraction for a candidate entry:
    1.0 when sketches are off, nothing converts, or no sidecar is there."""
    from ..models.dataskipping import sketch_store

    sk_conjs = _sketch_conjuncts(conjuncts, spec)
    if not sk_conjs:
        return 1.0
    return _ndv_sketch_fraction(sk_conjs, sketch_store.index_ndv_stats(entry), entry.name)
