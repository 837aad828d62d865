"""Device tier: run plan fragments over padded columns resident on the card.

Counterpart of hyperspace_tpu/plan/tpu_exec.py. The supported fragment is
the filter-aggregate pipeline

    Aggregate(no groups | grouped) <- [Project] <- [Filter] <- FileScan

over non-null numeric/date columns. Columns are padded to a power of two
(at least 1024 rows) and masked, f64 narrows to f32 and int64 to int32
after a range check, exactly as the JAX package ships them. Anything else
declines to the host executor, as the reference declines.

Two fragment shapes go through hand-written CUDA kernels
(ops/cuda_kernels.py), where the JAX package routes them to Pallas:

- filter -> sum(a*b) + count and filter -> sum(a) + count, float a and b:
  filter_weighted_sum / filter_sum;
- grouped sums and counts over at most 16 group slots, float sums:
  filter_grouped_multi_sum.

Every other fragment runs the generic body in PyTorch (the jnp/lax code
XLA fused in the reference). Integer sums keep the exact 8-bit chunked
accumulation (ops/intsum.py); float segment sums use a deterministic
formulation, so two runs give identical bits on the card too.

The filter predicate may also compare a string column with string
literals (Eq, Ne, IN): for each batch it is rewritten to compare the
column's dictionary codes, which ship as int32, with the literals' codes
(``_encode_string_predicates``). And it may compare a full-range int64
column with integer literals: such a column ships as two 32-bit words
(``Wide64``), compared lexicographically on the card.

A multi-file scan streams (``HYPERSPACE_PIPELINE``, on by default, as in
the reference): its file groups decode on an IO pool ahead of the
consumer (columnar/io.iter_chunks) and take one of two routes
(``_stream_route``). Fragments whose aggregates fold exactly (counts,
min, max, integer sums and averages) take the partial route: the body
runs per chunk and the host folds the partials, groups in the order of
their first passing row. The others take the concat route: each chunk's
columns upload as they decode and concatenate on the card into the
column the monolithic upload makes, bit for bit, and the fragment's
kernel runs once over it. A chunk whose data the stream cannot take (a
nullable chunk, a dtype that differs between files, an int64 value
outside 32 bits, a string predicate that cannot be rewritten) aborts the
stream, and the monolithic path runs, as in the reference.

Unlike the reference, nothing here catches a device failure: a kernel that
fails to build or launch raises, and the query fails. A fragment declines
only by shape or data (string aggregates, nullable columns, out-of-range
literals, a full-range int64 column that feeds an aggregate).

Over a mesh of devices (parallel/): with ``hyperspace.tpu.exec.meshDevices``
set and that many devices visible, a monolithic fragment runs on the mesh
(``_execute_on_mesh``): its rows shard across the devices, each shard runs
the grouped body, and the per-group partials fold on the first device
(parallel/dist_agg.py); the pipelined route steps aside while a mesh is
active, as in the reference. Under ``HYPERSPACE_MESH`` the partial route's
chunks are placed on the least-loaded device instead
(parallel/placement.chunk_placer): each chunk uploads to its device, under
its ordinal's cache key, and its fragment kernel (the CUDA kernel where the
shape has one) launches there; the host fold is unchanged, so the result
is bit for bit the one-device result.

ORDER BY runs here too: ``try_device_topk`` (Limit over Sort, one exact
32-bit key) and ``try_device_sort`` (any number of keys encoded into
order-preserving 32-bit words), each returning the host's stable
permutation exactly.
"""

from __future__ import annotations

import operator
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import expr as X
from .expr import Alias, Expr
from .kernel_cache import fused_fingerprint, grouped_fingerprint
from .nodes import Aggregate, FileScan, Filter, LogicalPlan, Project
from ..columnar.table import Column, ColumnBatch, STRING
from ..exceptions import HyperspaceError
from ..ops import cuda_kernels as K
from ..ops.intsum import _INT_SUM_ROW_CAP, combine_int_chunks, int_chunk_sums
from ..parallel import placement as mesh_placement
from ..serve.context import check_cancelled
from ..telemetry import attribution as _attr
from ..telemetry import plan_stats, trace
from ..telemetry.metrics import REGISTRY
from ..utils import env
from ..utils.rpc_meter import METER, device_get


class UploadTimer:
    """The host-to-device copy time of one query's uploads, read after the
    query: CUDA events around each copy on the card (read once, with no
    synchronize per copy), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._events: list = []
        self._host_s = 0.0
        self.copies = 0

    @contextmanager
    def copy(self):
        self.copies += 1
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._host_s += time.perf_counter() - t0

    def seconds(self) -> float:
        if self._events:
            self._events[-1][1].synchronize()
        return self._host_s + sum(a.elapsed_time(b) for a, b in self._events) / 1000.0


@dataclass
class ScanTiming:
    """The last filter-aggregate fragment's scan: its route ("pipelined"
    or "device"), the stream route ("concat" or "partial") and its chunks,
    the host decode seconds (summed over chunks) and the upload timer."""

    route: str
    stream: Optional[str]
    chunks: int
    decode_s: float
    upload: UploadTimer


JOIN_PLANS_KEPT = 64  # join plan summaries a session keeps, newest last


@dataclass
class DeviceTierStats:
    """What the device tier did, per session: filter-aggregate fragments
    it ran; fused join+aggregate queries (plan/device_join.py); which
    bucketed-join path each co-bucketed join took (``join_paths``:
    "batched", "per_bucket" or "stacked_agg", and "per_bucket_device", the
    buckets whose fused join+aggregate ran on the device in the per-bucket
    flow); the plain join's blocking fetches, spilled waves and per-bucket
    device probes; the join strategy plans (``join_plans``: a summary of
    each of the last ``JOIN_PLANS_KEPT`` planned joins, the reference's
    ``join:plan`` span; ``join_strategies``: buckets per strategy, its
    ``join.strategy.*`` counters), the band waves
    both stacked joins dispatched, the extra chunks their splits made and
    the admissions that parked (its ``pipeline.join.bands``,
    ``pipeline.join.splits`` and ``join.spill.parks``); device top-k and
    sort runs; and how often each reason declined a fragment or a join
    that matched (``declines``) or a top-k or sort (``order_declines``).
    The mesh tier counts the fragments that ran on a mesh
    (``mesh_fragments``), the bucketed joins whose probe ran on one
    (``mesh_joins``), and the streamed chunks and join band waves placed on
    each device ordinal (``placed_chunks``, ``placed_waves``).
    The pipelined tier counts its queries and chunks, the streams it
    declined by route (``pipeline_declines``) and those a chunk's data
    aborted (``pipeline_aborts``), each by reason: the reference's
    ``pipeline.*`` counters. ``last_scan`` times the last fragment's scan."""

    device_fragments: int = 0
    device_join_fragments: int = 0
    declines: dict = field(default_factory=dict)
    join_paths: dict = field(default_factory=dict)
    plain_join_fetches: int = 0
    join_spills: int = 0
    join_plans: deque = field(default_factory=lambda: deque(maxlen=JOIN_PLANS_KEPT))
    join_strategies: dict = field(default_factory=dict)
    join_waves: int = 0
    join_splits: int = 0
    join_parks: int = 0
    device_plain_probes: int = 0
    device_topk: int = 0
    device_sort: int = 0
    mesh_fragments: int = 0
    mesh_joins: int = 0
    placed_chunks: dict = field(default_factory=dict)
    placed_waves: dict = field(default_factory=dict)
    order_declines: dict = field(default_factory=dict)
    pipelined_queries: int = 0
    pipelined_chunks: int = 0
    pipeline_declines: dict = field(default_factory=dict)
    pipeline_aborts: dict = field(default_factory=dict)
    last_scan: Optional[ScanTiming] = None


# ---------------------------------------------------------------------------
# Expr -> torch
# ---------------------------------------------------------------------------

_CMP = {
    X.Eq: operator.eq,
    X.Ne: operator.ne,
    X.Lt: operator.lt,
    X.Le: operator.le,
    X.Gt: operator.gt,
    X.Ge: operator.ge,
}
_ARITH = {X.Add: operator.add, X.Sub: operator.sub, X.Mul: operator.mul,
          X.Div: operator.truediv}


_SIGN_BIT = 0x80000000
_U32 = 0xFFFFFFFF


def _wide_words(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(high word, low word with its sign bit flipped), both int32, of
    int64 values: the flip turns the low word's unsigned order into int32
    order, which the card compares natively (torch's uint32 compares are
    poorly supported on CUDA)."""
    bits = values.astype(np.int64).view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = ((bits & np.uint64(_U32)).astype(np.uint32) ^ np.uint32(_SIGN_BIT)).view(np.int32)
    return hi, lo


class Wide64:
    """A full-range int64 column on the 32-bit device: the signed high word
    and the sign-flipped low word. Only comparisons with integer literals
    are defined over it (a two-word lexicographic compare)."""

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor):
        self.hi = hi
        self.lo = lo

    def compare(self, kind, value: int) -> torch.Tensor:
        hi_w, lo_w = (int(w[0]) for w in _wide_words(np.array([value], dtype=np.int64)))
        hi_eq = self.hi == hi_w
        if kind is X.Eq:
            return hi_eq & (self.lo == lo_w)
        if kind is X.Ne:
            return ~(hi_eq & (self.lo == lo_w))
        if kind is X.Lt:
            return (self.hi < hi_w) | (hi_eq & (self.lo < lo_w))
        if kind is X.Le:
            return (self.hi < hi_w) | (hi_eq & (self.lo <= lo_w))
        if kind is X.Gt:
            return (self.hi > hi_w) | (hi_eq & (self.lo > lo_w))
        if kind is X.Ge:
            return (self.hi > hi_w) | (hi_eq & (self.lo >= lo_w))
        raise HyperspaceError(f"Wide64 comparison unsupported: {kind}")


_FLIPPED = {X.Lt: X.Gt, X.Le: X.Ge, X.Gt: X.Lt, X.Ge: X.Le, X.Eq: X.Eq, X.Ne: X.Ne}


def _is_int_lit(e: Expr) -> bool:
    return (isinstance(e, X.Lit) and isinstance(e.value, (int, np.integer))
            and not isinstance(e.value, bool))


def _wide_compare(e: Expr, cols: dict):
    """The two-word compare when one side is a Wide64 column and the other
    an integer literal; None when the pattern does not apply."""
    for a, b, kind in ((e.left, e.right, type(e)), (e.right, e.left, _FLIPPED[type(e)])):
        if isinstance(a, X.Col) and isinstance(cols.get(a.name), Wide64) and _is_int_lit(b):
            return cols[a.name].compare(kind, int(b.value))
    return None


def _wrap_wide(cols: dict) -> dict:
    """Uploaded (hi, lo) word pairs as Wide64 columns."""
    return {k: Wide64(*v) if isinstance(v, tuple) else v for k, v in cols.items()}


def compile_expr(e: Expr, cols: dict):
    """Evaluate an expression over device column tensors. Literals stay
    Python scalars, so they take the column's dtype (a f32 column compares
    with a f32 literal), as JAX's weak types do."""
    if isinstance(e, Alias):
        return compile_expr(e.child, cols)
    if isinstance(e, X.Col):
        v = cols[e.name]
        if isinstance(v, Wide64):
            raise HyperspaceError(
                f"Wide int64 column {e.name} only supports literal comparisons")
        return v
    if isinstance(e, X.Lit):
        return e.value
    if type(e) in _CMP:
        wide = _wide_compare(e, cols)
        if wide is not None:
            return wide
    op = _CMP.get(type(e)) or _ARITH.get(type(e))
    if op is not None:
        return op(compile_expr(e.left, cols), compile_expr(e.right, cols))
    if isinstance(e, X.And):
        return compile_expr(e.left, cols) & compile_expr(e.right, cols)
    if isinstance(e, X.Or):
        return compile_expr(e.left, cols) | compile_expr(e.right, cols)
    if isinstance(e, X.Not):
        v = compile_expr(e.child, cols)
        return (not v) if isinstance(v, bool) else ~v  # ~True is -2 in Python
    if isinstance(e, X.In):
        c = compile_expr(e.child, cols)
        out = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
        for v in e.values:
            out = out | (c == v)
        return out
    raise HyperspaceError(f"Expression not supported on device: {e!r}")


def _as_column(v, like: torch.Tensor) -> torch.Tensor:
    """A per-row tensor for a compiled value that may be a Python scalar
    (an aggregate over a literal)."""
    if isinstance(v, torch.Tensor):
        return v if v.shape == like.shape else v.expand(like.shape)
    if isinstance(v, bool):
        dtype = torch.bool
    elif isinstance(v, int):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.full(like.shape, v, dtype=dtype, device=like.device)


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _string_eq_pattern(e: Expr):
    """(column, literal, is_eq) when ``e`` is Eq or Ne of a column and a
    string literal, in either order; None otherwise."""
    if isinstance(e, (X.Eq, X.Ne)):
        for a, b in ((e.left, e.right), (e.right, e.left)):
            if isinstance(a, X.Col) and isinstance(b, X.Lit) and isinstance(b.value, str):
                return a.name, b.value, isinstance(e, X.Eq)
    return None


def _is_string_in(e: Expr, string_ok: frozenset) -> bool:
    return (isinstance(e, X.In) and isinstance(e.child, X.Col) and e.child.name in string_ok
            and all(isinstance(v, str) for v in e.values))


def _check_expr(e: Expr, string_ok: frozenset = frozenset()) -> None:
    """Raises unless ``e`` can run on the device. A comparison of a column
    of ``string_ok`` with string literals can: it is rewritten to
    dictionary codes at execution."""
    if isinstance(e, (X.IsNull, X.IsNotNull)):
        raise HyperspaceError("null tests need host path")
    pat = _string_eq_pattern(e)
    if (pat is not None and pat[0] in string_ok) or _is_string_in(e, string_ok):
        return
    if isinstance(e, X.Lit) and isinstance(e.value, str):
        raise HyperspaceError("string literal needs host path")
    if isinstance(e, X.In) and any(isinstance(v, str) for v in e.values):
        raise HyperspaceError("string IN list needs host path")
    for c in e.children():
        _check_expr(c, string_ok)


def _expr_device_ok(e: Expr, string_ok: frozenset = frozenset()) -> bool:
    try:
        _check_expr(e, string_ok)
        return True
    except HyperspaceError:
        return False


def _encode_string_predicates(e: Expr, batch: ColumnBatch, scols: set[str]):
    """``e`` with its comparisons of string columns against string
    literals rewritten to compare the batch's dictionary codes (int32,
    shipped to the card; the strings never are). A value absent from the
    dictionary folds to a boolean literal: False for Eq and IN, True for
    Ne (the columns hold no NULLs). None when a string column is
    referenced anywhere else. Codes are the batch's own, so the rewrite
    holds for this batch only."""
    pat = _string_eq_pattern(e)
    if pat is not None and pat[0] in scols:
        name, value, is_eq = pat
        code = {s: i for i, s in enumerate(batch.column(name).dictionary or [])}.get(value)
        if code is None:
            return X.Lit(not is_eq)
        return (X.Eq if is_eq else X.Ne)(X.Col(name), X.Lit(int(code)))
    if _is_string_in(e, frozenset(scols)):
        lut = {s: i for i, s in enumerate(batch.column(e.child.name).dictionary or [])}
        codes = [int(lut[v]) for v in e.values if v in lut]
        return X.In(X.Col(e.child.name), codes) if codes else X.Lit(False)
    if isinstance(e, X.Col) and e.name in scols:
        return None  # a bare string reference cannot ship
    if isinstance(e, (X.And, X.Or, *_CMP, *_ARITH)):
        left = _encode_string_predicates(e.left, batch, scols)
        right = _encode_string_predicates(e.right, batch, scols)
        return None if left is None or right is None else type(e)(left, right)
    if isinstance(e, X.Not):
        child = _encode_string_predicates(e.child, batch, scols)
        return None if child is None else X.Not(child)
    if isinstance(e, X.In):
        child = _encode_string_predicates(e.child, batch, scols)
        return None if child is None else X.In(child, e.values)
    return e


def _int_lit_fits(v) -> bool:
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return -(2**31) <= int(v) < 2**31
    return True


def _literals_fit(e: Expr, wide_ok: frozenset = frozenset()) -> bool:
    """False when an integer literal outside the 32-bit device range
    appears, other than in a comparison with a Wide64 column of
    ``wide_ok``: compared against a narrowed column it would overflow."""
    if type(e) in _CMP:
        for a, b in ((e.left, e.right), (e.right, e.left)):
            if isinstance(a, X.Col) and a.name in wide_ok and isinstance(b, X.Lit):
                return True  # the two-word compare takes any int64 literal
    if isinstance(e, X.Lit):
        return _int_lit_fits(e.value)
    if isinstance(e, X.In) and not all(_int_lit_fits(v) for v in e.values):
        return False
    return all(_literals_fit(c, wide_ok) for c in e.children())


# ---------------------------------------------------------------------------
# fragment matching
# ---------------------------------------------------------------------------

class _Fragment:
    def __init__(self, agg: Aggregate, project: Optional[Project],
                 filt: Optional[Filter], scan: FileScan):
        self.agg = agg
        self.project = project
        self.filter = filt
        self.scan = scan
        self.pred: Optional[Expr] = filt.condition if filt is not None else None


def _match_fragment(plan: LogicalPlan) -> Optional[_Fragment]:
    """Aggregate <- [Project] <- [Filter] <- FileScan."""
    if not isinstance(plan, Aggregate):
        return None
    node = plan.child
    project = filt = None
    if isinstance(node, Project):
        project = node
        node = node.child
    if isinstance(node, Filter):
        filt = node
        node = node.child
    if not isinstance(node, FileScan):
        return None
    return _Fragment(plan, project, filt, node)


def _group_key_names(f: _Fragment) -> set[str]:
    return {e.name for e in f.agg.group_exprs if isinstance(e, X.Col)}


def _project_identity(project: Project, name: str) -> bool:
    for e in project.exprs:
        if X.expr_output_name(e) == name:
            inner = e.child if isinstance(e, Alias) else e
            return isinstance(inner, X.Col) and inner.name == name
    return False


def _device_projections(f: _Fragment) -> list[Expr]:
    """Projection outputs the device computes: identity pass-throughs of
    group keys are excluded (keys factorize on the host and never ship)."""
    if f.project is None:
        return []
    keys = _group_key_names(f)
    out = []
    for e in f.project.exprs:
        inner = e.child if isinstance(e, Alias) else e
        name = X.expr_output_name(e)
        if isinstance(inner, X.Col) and name in keys and inner.name == name:
            continue
        out.append(e)
    return out


def _device_exprs(f: _Fragment) -> list[Expr]:
    exprs: list[Expr] = list(f.agg.agg_exprs)
    if f.filter is not None:
        exprs.append(f.filter.condition)
    exprs.extend(_device_projections(f))
    return exprs


def _device_refs(f: _Fragment) -> set[str]:
    refs: set[str] = set()
    for e in _device_exprs(f):
        refs |= e.references()
    return refs


def _fragment_supported(f: _Fragment) -> bool:
    """Structural and dtype screen that needs no data."""
    if f.agg.group_exprs:
        keys = _group_key_names(f)
        if len(keys) != len(f.agg.group_exprs):
            return False
        scan_cols = set(f.scan.schema.names)
        for k in keys:
            if k not in scan_cols:
                return False
            if f.project is not None and not _project_identity(f.project, k):
                return False
    exprs = _device_exprs(f)
    string_cols = frozenset(fld.name for fld in f.scan.schema if fld.dtype == STRING)
    pred = f.filter.condition if f.filter is not None else None
    # the filter predicate may compare string columns with string literals
    # (shipped as dictionary codes); aggregates and projections may not
    # touch strings at all
    if not all(_expr_device_ok(e, string_cols if e is pred else frozenset()) for e in exprs):
        return False
    # string columns may serve as group keys (factorized on the host) or in
    # the predicate's rewritable comparisons, but feed no other expression
    other_refs: set[str] = set()
    for e in exprs:
        if e is not pred:
            other_refs |= e.references()
    return not (string_cols & other_refs)


def _wide_pattern_ok(e: Expr, name: str) -> bool:
    """Every reference to ``name`` in ``e`` is a direct comparison with an
    integer literal (the only operation Wide64 defines)."""
    if isinstance(e, X.Col):
        return e.name != name
    if type(e) in _CMP:
        for a, b in ((e.left, e.right), (e.right, e.left)):
            if isinstance(a, X.Col) and a.name == name:
                return _is_int_lit(b)
    return all(_wide_pattern_ok(c, name) for c in e.children())


def _wide_candidates(frag: _Fragment, int64_cols) -> frozenset:
    """Of ``int64_cols``, those that may ship as Wide64: referenced by the
    filter predicate only, and there only in comparisons with integer
    literals."""
    pred = frag.pred
    if pred is None:
        return frozenset()
    cand = set(int64_cols) & pred.references()
    cond = frag.filter.condition
    for e in _device_exprs(frag):
        if e is not cond:
            cand -= e.references()
    return frozenset(c for c in cand if _wide_pattern_ok(pred, c))


def _wide_predicate_cols(frag: _Fragment, batch: ColumnBatch) -> frozenset:
    """The non-null int64 columns of ``batch`` outside the 32-bit range that
    ship as Wide64 word pairs (a full-range column that feeds an aggregate
    or a projection is not one: its fragment declines)."""
    wide = [name for name in (frag.pred.references() if frag.pred is not None else ())
            if name in batch.columns and batch.column(name).validity is None
            and not _int64_fits(batch.column(name).data)]
    return _wide_candidates(frag, wide)


def _fragment_literals_fit(frag: _Fragment, wide_ok: frozenset = frozenset()) -> bool:
    """The literal range screen over everything the body evaluates; only
    the filter predicate may lean on Wide64 comparisons."""
    exprs = list(_device_projections(frag)) + list(frag.agg.agg_exprs)
    return (all(_literals_fit(e) for e in exprs)
            and (frag.pred is None or _literals_fit(frag.pred, wide_ok)))


def _agg_list_names(frag: _Fragment):
    from .executor import _unwrap_agg

    agg_list, names = [], []
    for e in frag.agg.agg_exprs:
        name, agg = _unwrap_agg(e)
        names.append(name)
        agg_list.append(
            ("count", None) if isinstance(agg, X.Count) else (agg.func, agg.child)
        )
    return agg_list, names


def _fragment_touches_f64(frag: _Fragment) -> bool:
    f64_cols = {fld.name for fld in frag.scan.schema if fld.dtype == "float64"}
    return any(e.references() & f64_cols for e in _device_exprs(frag))


def _maybe_int_expr(e: Expr, frag: _Fragment) -> bool:
    """Conservative integer-dtype inference: False only when ``e`` provably
    evaluates to float (drives the exact int-sum row cap)."""
    if isinstance(e, Alias):
        return _maybe_int_expr(e.child, frag)
    if isinstance(e, X.Div):
        return False
    if isinstance(e, X.Lit):
        return not isinstance(e.value, float)
    if isinstance(e, X.Col):
        sch = frag.scan.schema
        if e.name in sch.names:
            return not sch.field(e.name).dtype.startswith("float")
        if frag.project is not None:
            for p in frag.project.exprs:
                if X.expr_output_name(p) == e.name:
                    return _maybe_int_expr(p, frag)
        return True
    children = e.children()
    if not children:
        return True
    return all(_maybe_int_expr(c, frag) for c in children)


def _has_int_sum(frag: _Fragment, plan) -> bool:
    from .executor import _unwrap_agg

    schema = plan.schema
    for e in frag.agg.agg_exprs:
        nm, agg = _unwrap_agg(e)
        if isinstance(agg, X.Sum) and schema.field(nm).dtype.startswith("int"):
            return True
        if isinstance(agg, X.Avg) and _maybe_int_expr(agg.child, frag):
            return True
    return False


def _parquet_row_count(scan: FileScan) -> Optional[int]:
    """Total rows from file footers (no data pages)."""
    from ..columnar import io as cio

    if scan.fmt != "parquet":
        return None
    return sum(cio.file_num_rows(f.name) for f in scan.files)


# ---------------------------------------------------------------------------
# upload
# ---------------------------------------------------------------------------

def _pad_pow2(n: int) -> int:
    return 1 << max(10, int(np.ceil(np.log2(max(1, n)))))


def _device_dtype(np_dtype) -> np.dtype:
    """The card's columns are at most 32 bits wide, as the reference's:
    int64 narrows to int32 (after a range check), float64 to float32."""
    d = np.dtype(np_dtype)
    if d == np.int64:
        return np.dtype(np.int32)
    if d == np.float64:
        return np.dtype(np.float32)
    return d


def _int64_fits(data: np.ndarray) -> bool:
    return data.dtype != np.int64 or (
        data.min(initial=0) >= -(2**31) and data.max(initial=0) < 2**31
    )


def _to_device(arr: np.ndarray, device, timer: Optional[UploadTimer]) -> torch.Tensor:
    """One host array's copy to the device, timed by ``timer``."""
    if timer is None:
        return torch.from_numpy(arr).to(device)
    with timer.copy():
        return torch.from_numpy(arr).to(device)


def pad_to_device(data: np.ndarray, padded: int, device,
                  timer: Optional[UploadTimer] = None) -> torch.Tensor:
    """Zero-padded device copy of one host column with the device dtype."""
    arr = np.zeros(padded, dtype=_device_dtype(data.dtype))
    arr[: len(data)] = data.astype(arr.dtype)
    return _to_device(arr, device, timer)


def _upload_wide(data: np.ndarray, padded: int, device, timer=None) -> tuple:
    """Zero-padded device copies of an int64 column's Wide64 word pairs."""
    hi, lo = _wide_words(data)
    return (pad_to_device(hi, padded, device, timer),
            pad_to_device(lo, padded, device, timer))


def _upload_columns(batch: ColumnBatch, names, padded: int, session, device,
                    wide_ok: frozenset = frozenset(), timer: Optional[UploadTimer] = None,
                    placed=None):
    """Padded device columns by name, served from the session's device
    cache; None when a column is nullable or exceeds the 32-bit range. A
    column of ``wide_ok`` that exceeds it ships as a (hi, lo) word pair,
    cached apart from a narrowed upload of the same buffer. ``placed`` (a
    parallel/mesh.MeshDevice) uploads to that mesh ordinal's device, under
    its own cache key."""
    from ..utils.device_cache import placed_tag

    if placed is not None:
        device = placed.device
    dev_cols = {}
    for name in sorted(names):
        col = batch.column(name)
        if col.validity is not None:
            return None
        if not _int64_fits(col.data):
            if name not in wide_ok:
                return None
            dev_cols[name] = session.device_cache.get_or_put(
                (col.data,), placed_tag(("wide", padded, str(device)), placed),
                lambda data=col.data: _upload_wide(data, padded, device, timer),
            )
            continue
        dev_cols[name] = session.device_cache.get_or_put(
            (col.data,), placed_tag(("pad", padded, str(device)), placed),
            lambda data=col.data: pad_to_device(data, padded, device, timer),
        )
    return dev_cols


def _padded_mask(padded: int, n: int, device) -> torch.Tensor:
    """The valid-rows mask, filled on the device (nothing to upload)."""
    mask = torch.zeros(padded, dtype=torch.bool, device=device)
    mask[:n] = True
    return mask


def _fetch(tree):
    """Device results to host numpy, preserving the tuple structure: the
    one blocking fetch of a fragment (``utils/rpc_meter.device_get``)."""
    return device_get(tree)


def _observe_dispatch(kernel_name: str, t0: float) -> None:
    """Per-kernel dispatch-latency histograms, in ms: from the launch to
    the fetched result, since a launch returns at once. Doubles as the
    serving query's ``dispatch`` phase chokepoint."""
    dt = time.perf_counter() - t0
    ms = dt * 1000
    REGISTRY.histogram("kernel.dispatch_ms").observe(ms)
    REGISTRY.histogram(f"kernel.{kernel_name}.dispatch_ms").observe(ms)
    _attr.charge_phase("dispatch", dt)


def kernel_route(device: torch.device) -> str:
    """"cuda" where fragment bodies launch the hand-written kernels, "plain"
    where the wrappers run their plain versions (tensors on the CPU)."""
    return "cuda" if device.type == "cuda" else "plain"


# ---------------------------------------------------------------------------
# global fragments
# ---------------------------------------------------------------------------

def _extreme(dtype: torch.dtype, want_max: bool):
    if dtype.is_floating_point:
        return float("inf") if want_max else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if want_max else info.min


def _fused_kernel_shape(pred_expr, proj_exprs, agg_list):
    """(a, b | None, sum_pos) when the fragment is exactly filter -> sum(a*b)
    + count or filter -> sum(a) + count over columns; else None.
    Counterpart of tpu_exec._pallas_shape."""
    if pred_expr is None or proj_exprs or len(agg_list) != 2:
        return None
    kinds = [k for k, _ in agg_list]
    if sorted(kinds) != ["count", "sum"]:
        return None
    sum_pos = kinds.index("sum")
    child = agg_list[sum_pos][1]
    if type(child) is X.Mul and isinstance(child.left, X.Col) and isinstance(child.right, X.Col):
        return child.left, child.right, sum_pos
    if isinstance(child, X.Col):
        return child, None, sum_pos
    return None


def _generic_agg_compute(pred_expr, proj_exprs, agg_list, cols, mask):
    """Body of the generic global kernel (also the CUDA route's body for
    integer sums, which need the exact chunked accumulation)."""
    if pred_expr is not None:
        mask = mask & compile_expr(pred_expr, cols)
    matched = mask.sum(dtype=torch.int32)
    proj_cols = dict(cols)
    for name, e in proj_exprs:
        proj_cols[name] = compile_expr(e, cols)
    out = []
    for kind, child in agg_list:
        if kind == "count":
            out.append(matched)
            continue
        vals = _as_column(compile_expr(child, proj_cols), mask)
        if kind in ("sum", "avg") and _is_int(vals):
            # exact chunked sum; the host divides an int avg by the count
            out.append(int_chunk_sums(torch.where(mask, vals, 0)))
        elif kind == "sum":
            out.append(torch.where(mask, vals, 0).sum())
        elif kind == "min":
            out.append(torch.where(mask, vals, _extreme(vals.dtype, True)).min())
        elif kind == "max":
            out.append(torch.where(mask, vals, _extreme(vals.dtype, False)).max())
        elif kind == "avg":
            s = torch.where(mask, vals, 0).sum()
            out.append(s / torch.clamp(matched, min=1))
    return matched, tuple(out)


def _build_fused_cuda_kernel(pred_expr, proj_exprs, agg_list, a_expr, b_expr, sum_pos):
    """Counterpart of tpu_exec._build_pallas_kernel."""

    def kernel(cols, mask):
        a = compile_expr(a_expr, cols)
        b = None if b_expr is None else compile_expr(b_expr, cols)
        if _is_int(a) or (b is not None and _is_int(b)):
            # integer sums need the exact chunked accumulation
            return _generic_agg_compute(pred_expr, proj_exprs, agg_list, cols, mask)
        pred = (mask & compile_expr(pred_expr, cols)).contiguous()
        a = a.to(torch.float32).contiguous()
        if b is None:
            rev, cnt = K.filter_sum(pred, a)
        else:
            rev, cnt = K.filter_weighted_sum(pred, a, b.to(torch.float32).contiguous())
        out = (rev, cnt) if sum_pos == 0 else (cnt, rev)
        return cnt, out

    return kernel


def _build_kernel(pred_expr, proj_exprs, agg_list):
    """Counterpart of tpu_exec._build_kernel. Every device takes the kernel
    route: on the CPU the wrappers run their plain versions."""
    shape = _fused_kernel_shape(pred_expr, proj_exprs, agg_list)
    if shape is not None:
        a, b, sum_pos = shape
        return _build_fused_cuda_kernel(pred_expr, proj_exprs, agg_list, a, b, sum_pos)

    def kernel(cols, mask):
        return _generic_agg_compute(pred_expr, proj_exprs, agg_list, cols, mask)

    return kernel


def _assemble_global_output(plan, matched, scalar_values, agg_list_spec, names):
    """Zero matches -> SQL NULL for non-count aggregates (host semantics)."""
    out_cols: dict[str, Column] = {}
    schema = plan.schema
    for (name, val), (kind, _c) in zip(zip(names, scalar_values), agg_list_spec):
        f = schema.field(name)
        if kind == "count":
            out_cols[name] = Column(np.array([matched], dtype=np.int64), "int64")
        elif matched == 0:
            out_cols[name] = Column(np.zeros(1, np.float64), "float64", np.array([False]))
        elif f.dtype in ("int64", "int32", "int16", "int8"):
            out_cols[name] = Column(np.array([int(val)], dtype=np.dtype(f.dtype)), f.dtype)
        else:
            out_cols[name] = Column(np.array([float(val)]), "float64")
    return ColumnBatch(out_cols)


def _execute_global(frag, batch, plan, session, device, wide_ok,
                    timer=None) -> Optional[ColumnBatch]:
    n = batch.num_rows
    padded = _pad_pow2(n)
    # the span opens before the upload, so its meter delta carries the
    # fragment's whole device traffic
    with trace.span("kernel:fused_agg", rows=n, padded=padded) as sp:
        dev_cols = _upload_columns(
            batch, _device_refs(frag) & set(batch.columns), padded, session, device, wide_ok,
            timer,
        )
        if dev_cols is None:
            sp.set_attr("declined", "nullable_or_out_of_range")
            return _decline(session, "nullable_or_out_of_range")
        return _run_global(frag, plan, session, device, dev_cols,
                           _padded_mask(padded, n, device))


def _run_global(frag, plan, session, device, dev_cols, mask) -> ColumnBatch:
    """The global fragment's kernel over its device columns, fetched and
    assembled (the monolithic path and the concat route share it)."""
    pred_expr = frag.pred
    proj_exprs = (
        tuple((X.expr_output_name(e), e) for e in frag.project.exprs)
        if frag.project is not None
        else ()
    )
    agg_list, names = _agg_list_names(frag)
    key = fused_fingerprint(kernel_route(device), frag.scan, pred_expr, proj_exprs, agg_list,
                          dev_cols)
    kernel = session.kernel_cache.get_or_build(
        key, lambda: _build_kernel(pred_expr, proj_exprs, agg_list), "fused_agg"
    )
    METER.record_dispatch()
    t0 = time.perf_counter()
    matched, results = _fetch(kernel(_wrap_wide(dev_cols), mask))
    _observe_dispatch("fused_agg", t0)
    matched = int(matched)
    scalar_values = []
    for v, (kind, _c) in zip(results, agg_list):
        if isinstance(v, tuple):  # exact int chunks: recombine on the host
            s = combine_int_chunks(v)
            scalar_values.append(s / max(matched, 1) if kind == "avg" else s)
        else:
            scalar_values.append(v)
    return _assemble_global_output(plan, matched, scalar_values, agg_list, names)


# ---------------------------------------------------------------------------
# grouped fragments
# ---------------------------------------------------------------------------

# group domains up to this many slots sum floats with one masked reduction
# per slot; larger domains sort by group and reduce each segment
_DENSE_SEGMENT_SLOTS = 64


def _segment_sum(vals: torch.Tensor, gids: torch.Tensor, seg_pad: int) -> torch.Tensor:
    """Deterministic per-group float sum: no atomics, so repeat runs give
    identical bits on the card (``index_add_`` would reorder float adds)."""
    if seg_pad <= _DENSE_SEGMENT_SLOTS:
        return torch.stack([torch.where(gids == g, vals, 0).sum() for g in range(seg_pad)])
    order = torch.argsort(gids, stable=True)
    lengths = torch.bincount(gids, minlength=seg_pad)
    return torch.segment_reduce(vals[order], "sum", lengths=lengths)


def _first_masked_rows(mask: torch.Tensor, gids: torch.Tensor, seg_pad: int) -> torch.Tensor:
    """Per-group index of the first row passing the predicate: the host
    tier orders grouped output by first post-filter occurrence, and the
    device assembly reorders by this vector. Small domains take one masked
    min per slot: a scatter-min of every row onto a few slots serializes on
    the card's atomics."""
    big = 2**31 - 1
    idx = torch.where(
        mask, torch.arange(gids.shape[0], dtype=torch.int32, device=gids.device), big
    )
    if seg_pad <= _DENSE_SEGMENT_SLOTS:
        return torch.stack([torch.where(gids == g, idx, big).amin() for g in range(seg_pad)])
    first = torch.full((seg_pad,), big, dtype=torch.int32, device=gids.device)
    return first.scatter_reduce(0, gids.long(), idx, "amin")


def _generic_grouped_compute(pred_expr, proj_exprs, agg_list, seg_pad, cols, gids, mask):
    """Body of the generic grouped kernel: rows failing the mask land in
    the dump segment seg_pad-1."""
    if pred_expr is not None:
        mask = mask & compile_expr(pred_expr, cols)
    gids = torch.where(mask, gids, seg_pad - 1)
    first_masked = _first_masked_rows(mask, gids, seg_pad)
    seg = gids.long()
    proj_cols = dict(cols)
    for name, e in proj_exprs:
        proj_cols[name] = compile_expr(e, cols)
    counts = torch.bincount(seg, minlength=seg_pad).to(torch.int32)
    out = []
    for kind, child in agg_list:
        if kind == "count":
            out.append(counts)
            continue
        vals = _as_column(compile_expr(child, proj_cols), mask)
        if kind in ("sum", "avg") and _is_int(vals):
            out.append(int_chunk_sums(vals, seg, seg_pad))
        elif kind == "sum":
            out.append(_segment_sum(vals, gids, seg_pad))
        elif kind in ("min", "max"):
            init = torch.full((seg_pad,), _extreme(vals.dtype, kind == "min"),
                              dtype=vals.dtype, device=vals.device)
            out.append(init.scatter_reduce(0, seg, vals, "amin" if kind == "min" else "amax"))
        elif kind == "avg":
            s = _segment_sum(vals, gids, seg_pad)
            out.append(s / torch.clamp(counts, min=1))
    return counts, first_masked, tuple(out)


def _grouped_kernel_shape(agg_list, seg_pad) -> bool:
    """Sums and counts over at most 16 group slots go through the grouped
    CUDA kernel. Counterpart of tpu_exec._pallas_grouped_shape."""
    return seg_pad <= K.MAX_GROUPS and all(k in ("sum", "count") for k, _ in agg_list)


def _build_grouped_cuda_kernel(pred_expr, proj_exprs, agg_list, seg_pad):
    """Counterpart of tpu_exec._build_grouped_pallas_kernel."""

    def kernel(cols, gids, mask):
        if pred_expr is not None:
            mask = mask & compile_expr(pred_expr, cols)
        proj_cols = dict(cols)
        for name, e in proj_exprs:
            proj_cols[name] = compile_expr(e, cols)
        sum_vals = []
        for kind, child in agg_list:
            if kind != "sum":
                continue
            vals = _as_column(compile_expr(child, proj_cols), mask)
            if _is_int(vals):
                # exact chunked accumulation owns int sums: generic body
                return _generic_grouped_compute(
                    pred_expr, proj_exprs, agg_list, seg_pad, cols, gids, mask
                )
            sum_vals.append(vals.to(torch.float32).contiguous())
        mask = mask.contiguous()
        # every measure and the count in one pass over pred and gids
        sums, counts = K.filter_grouped_multi_sum(mask, gids, sum_vals, seg_pad)
        first_masked = _first_masked_rows(mask, torch.where(mask, gids, seg_pad - 1), seg_pad)
        out = []
        i = 0
        for kind, _child in agg_list:
            if kind == "count":
                out.append(counts)
            else:
                out.append(sums[i])
                i += 1
        return counts, first_masked, tuple(out)

    return kernel


def _build_grouped_kernel(pred_expr, proj_exprs, agg_list, seg_pad):
    if _grouped_kernel_shape(agg_list, seg_pad):
        return _build_grouped_cuda_kernel(pred_expr, proj_exprs, agg_list, seg_pad)

    def kernel(cols, gids, mask):
        return _generic_grouped_compute(
            pred_expr, proj_exprs, agg_list, seg_pad, cols, gids, mask
        )

    return kernel


def _assemble_grouped_output(plan, frag, key_cols, first_idx, counts, results,
                             agg_list_spec, names, num_groups, first_masked):
    """Drop empty groups, emit key columns from first occurrences, order
    rows by each group's first row passing the predicate (the host tier's
    order), coerce dtypes per the plan schema."""
    keep = counts > 0
    order = None
    if keep.any():
        order = np.argsort(np.asarray(first_masked)[:num_groups][keep], kind="stable")
    out_cols: dict[str, Column] = {}
    for e, kc in zip(frag.agg.group_exprs, key_cols):
        kept = kc.take(first_idx[keep])
        out_cols[X.expr_output_name(e)] = kept if order is None else kept.take(order)
    schema = plan.schema
    for (name, val), (kind, _c) in zip(zip(names, results), agg_list_spec):
        f = schema.field(name)
        np_val = np.asarray(val)[:num_groups][keep]
        if order is not None:
            np_val = np_val[order]
        if kind == "count":
            out_cols[name] = Column(np_val.astype(np.int64), "int64")
        elif f.dtype in ("int64", "int32", "int16", "int8"):
            out_cols[name] = Column(np_val.astype(np.dtype(f.dtype)), f.dtype)
        else:
            out_cols[name] = Column(np_val.astype(np.float64), "float64")
    return ColumnBatch(out_cols)


def _seg_pad(num_groups: int) -> int:
    """Group slots of a grouped body: a power of two of at least 16, with
    room for the dump slot ``seg_pad - 1``."""
    return 1 << max(4, int(np.ceil(np.log2(num_groups + 1))))


def _cached_factorization(session, key_cols: list[Column], bufs: tuple, tag: str, build,
                          stable: bool = True):
    """A group-key factorization, cached on the key buffers under ``tag``
    (one tag per way of factorizing them) when no key column is nullable
    and the buffers are ``stable`` (the chunk cache's): a warm query then
    factorizes nothing."""
    if stable and all(kc.validity is None for kc in key_cols):
        return session.host_derived_cache.get_or_put(bufs, (tag,), build), True
    return build(), False


def _group_ids_to_device(session, device, bufs, cacheable, group_ids, n, padded,
                         seg_pad, tag, timer, placed=None):
    """Padded device group ids (dump slot ``seg_pad - 1`` past ``n``),
    cached on the key buffers when the factorization is (under the placed
    mesh ordinal's key, when ``placed``)."""
    from ..utils.device_cache import placed_tag

    def build():
        arr = np.full(padded, seg_pad - 1, dtype=np.int32)
        arr[:n] = group_ids.astype(np.int32)
        return _to_device(arr, device, timer)

    if cacheable:
        return session.device_cache.get_or_put(
            bufs, placed_tag((tag, padded, seg_pad, str(device)), placed), build)
    gids = build()
    session.device_cache.record_upload(gids.numel() * 4)
    return gids


def _execute_grouped(frag, batch, plan, session, device, wide_ok,
                     timer=None) -> Optional[ColumnBatch]:
    """Keys factorize on the host (string keys never ship); the masked
    segment reductions run on the device. The factorization and the device
    group ids are cached on the key buffers' identity, so a warm query
    uploads nothing."""
    from .executor import factorize_group_keys

    n = batch.num_rows
    key_cols = [batch.column(e.name) for e in frag.agg.group_exprs]
    key_bufs = tuple(kc.data for kc in key_cols)
    (group_ids, num_groups, first_idx), cacheable = _cached_factorization(
        session, key_cols, key_bufs, "factorize", lambda: factorize_group_keys(key_cols))
    seg_pad = _seg_pad(num_groups)
    padded = _pad_pow2(n)
    with trace.span("kernel:grouped_agg", rows=n, padded=padded, groups=num_groups) as sp:
        dev_cols = _upload_columns(
            batch, _device_refs(frag) & set(batch.columns), padded, session, device, wide_ok,
            timer,
        )
        if dev_cols is None:
            sp.set_attr("declined", "nullable_or_out_of_range")
            return _decline(session, "nullable_or_out_of_range")
        gids_d = _group_ids_to_device(session, device, key_bufs, cacheable, group_ids, n,
                                      padded, seg_pad, "gids", timer)
        return _run_grouped(frag, plan, session, device, dev_cols, gids_d,
                            _padded_mask(padded, n, device), key_cols, first_idx, num_groups,
                            seg_pad)


def _run_grouped(frag, plan, session, device, dev_cols, gids_d, mask, key_cols, first_idx,
                 num_groups, seg_pad) -> ColumnBatch:
    """The grouped fragment's kernel over its device columns and group ids,
    fetched and assembled (the monolithic path and the concat route share
    it)."""
    pred_expr = frag.pred
    proj_exprs = tuple((X.expr_output_name(e), e) for e in _device_projections(frag))
    agg_list, names = _agg_list_names(frag)
    key = grouped_fingerprint(
        kernel_route(device), frag.scan, seg_pad, pred_expr, proj_exprs, agg_list, dev_cols
    )
    kernel = session.kernel_cache.get_or_build(
        key, lambda: _build_grouped_kernel(pred_expr, proj_exprs, agg_list, seg_pad),
        "grouped_agg",
    )
    METER.record_dispatch()
    t0 = time.perf_counter()
    counts_full, first_masked, results = _fetch(kernel(_wrap_wide(dev_cols), gids_d, mask))
    _observe_dispatch("grouped_agg", t0)
    results = [
        _combine_chunks_maybe_avg(v, kind, counts_full)
        for v, (kind, _c) in zip(results, agg_list)
    ]
    return _assemble_grouped_output(
        plan, frag, key_cols, first_idx, counts_full[:num_groups], results, agg_list,
        names, num_groups, first_masked,
    )


def _combine_chunks_maybe_avg(v, kind: str, counts_full: np.ndarray):
    if not isinstance(v, tuple):
        return v
    s = combine_int_chunks(v)
    return s / np.maximum(counts_full, 1) if kind == "avg" else s


# ---------------------------------------------------------------------------
# pipelined tier: multi-file scans streamed per file-group chunk
# ---------------------------------------------------------------------------

def _pipeline_enabled() -> bool:
    """``HYPERSPACE_PIPELINE``: any value but ``0`` streams."""
    return env.env_str("HYPERSPACE_PIPELINE") != "0"


def _pipeline_overlap() -> bool:
    """``serial`` streams with every overlap removed (decode on the
    caller's thread, each chunk's result fetched before the next)."""
    return env.env_str("HYPERSPACE_PIPELINE") != "serial"


def _pipeline_depth() -> int:
    """Partial-route chunk results in flight before the consumer fetches
    one (``HYPERSPACE_PIPELINE_DEPTH``, default 2)."""
    try:
        return max(1, env.env_int("HYPERSPACE_PIPELINE_DEPTH"))
    except ValueError:
        return 2


def _provably_int_expr(e: Expr, frag: _Fragment) -> bool:
    """True only when ``e`` certainly evaluates to an integer on the device
    (the strict dual of ``_maybe_int_expr``): the partial route's exact-fold
    screen, where a float taken for an int would break bit identity."""
    if isinstance(e, Alias):
        return _provably_int_expr(e.child, frag)
    if isinstance(e, X.Div):
        return False
    if isinstance(e, X.Lit):
        return isinstance(e.value, (int, np.integer)) and not isinstance(e.value, bool)
    if isinstance(e, X.Col):
        sch = frag.scan.schema
        if e.name in sch.names:
            dt = sch.field(e.name).dtype
            return dt.startswith("int") or dt == "date32"
        if frag.project is not None:
            for p in frag.project.exprs:
                if X.expr_output_name(p) == e.name:
                    return _provably_int_expr(p, frag)
        return False
    children = e.children()
    if not children or not isinstance(e, (X.Add, X.Sub, X.Mul)):
        return False
    return all(_provably_int_expr(c, frag) for c in children)


def _stream_route(frag: _Fragment, plan) -> Optional[str]:
    """"partial" when every aggregate folds exactly across chunks (count,
    min, max, integer sum, integer average); else "concat", unless the
    predicate reads a string column (each chunk has its own dictionary
    codes, and the concatenated column would mix them); None (the
    monolithic path) for a literal outside 32 bits: Wide64 never streams."""
    from .executor import _unwrap_agg

    if not _fragment_literals_fit(frag):
        return None
    schema = plan.schema
    for e in frag.agg.agg_exprs:
        nm, agg = _unwrap_agg(e)
        if isinstance(agg, (X.Count, X.Min, X.Max)):
            continue
        if isinstance(agg, X.Sum) and schema.field(nm).dtype.startswith("int"):
            continue
        if isinstance(agg, X.Avg) and _provably_int_expr(agg.child, frag):
            continue
        break
    else:
        return "partial"
    if frag.pred is not None:
        scols = {f.name for f in frag.scan.schema if f.dtype == STRING}
        if frag.pred.references() & scols:
            return None
    return "concat"


def _pruned_row_count(scan: FileScan, selection) -> Optional[int]:
    """Rows the scan reads after row-group pruning, from footers only: a
    file read whole counts its rows, a file with a selection its kept
    groups' rows."""
    from ..columnar import io as cio

    row_groups, files = selection
    if scan.fmt != "parquet":
        return None
    try:
        total = 0
        for f in files:
            sel = row_groups.get(f.name) if row_groups else None
            if sel is None:
                total += cio.file_num_rows(f.name)
            else:
                stats = cio.read_rowgroup_stats(f.name, [])
                if stats is None:
                    return None
                total += sum(stats[g]["num_rows"] for g in sel)
        return total
    except Exception:  # an unreadable footer leaves the monolithic path to decide
        return None


def _count(counter: dict, reason: str) -> None:
    counter[reason] = counter.get(reason, 0) + 1
    return None


def _observed(chunks, timing: ScanTiming):
    """The chunk stream, with each chunk's decode seconds added to
    ``timing``; closing it closes the stream (its read-ahead stops)."""
    try:
        for chunk in chunks:
            timing.chunks += 1
            timing.decode_s += chunk.decode_s
            yield chunk
    finally:
        chunks.close()


def _execute_streaming(frag: _Fragment, scan: FileScan, plan, session,
                       device) -> Optional[ColumnBatch]:
    """The fragment over a streamable scan, chunk by chunk; None hands the
    query to the monolithic path (a declined route, an empty or over-cap
    scan, or a chunk whose data aborted the stream)."""
    from .executor import iter_scan_chunks, resolve_scan_pruning

    stats = session.device_stats
    route = _stream_route(frag, plan)
    if route is None:
        REGISTRY.counter("pipeline.declined").inc()
        return _count(stats.pipeline_declines,
                      "string_concat" if _fragment_literals_fit(frag) else "wide64")
    # one row-group resolution for the row count and the chunk stream
    selection = resolve_scan_pruning(scan)
    n_total = _pruned_row_count(scan, selection)
    if not n_total:
        return None
    if _has_int_sum(frag, plan) and _pad_pow2(n_total) > _INT_SUM_ROW_CAP:
        return None
    overlap = _pipeline_overlap()
    timing = ScanTiming("pipelined", route, 0, 0.0, UploadTimer(device))
    chunks = _observed(iter_scan_chunks(scan, overlap, selection, session), timing)
    # the abort-and-replan monitor: the stream unchanged unless
    # HYPERSPACE_ADAPTIVE is on and the scan's pruning kept far more than it
    # predicted. Its ScanAbortAndReplan propagates to the collect loop: no
    # handler on this path turns it into a host rerun
    from . import adaptive

    chunks = adaptive.monitor_scan_chunks(chunks, scan, selection)
    t0 = time.perf_counter()
    with trace.span(f"pipeline:{route}", rows=n_total, files=len(scan.files),
                    grouped=bool(frag.agg.group_exprs)) as sp:
        try:
            if route == "concat":
                out = _stream_concat(frag, plan, chunks, session, device, timing.upload,
                                     stable=scan.index_info is not None)
            elif frag.agg.group_exprs:
                out = _stream_grouped_partial(frag, plan, chunks, overlap, session, device,
                                              timing.upload)
            else:
                out = _stream_global_partial(frag, plan, chunks, overlap, session, device,
                                             timing.upload)
        finally:
            chunks.close()
        if out is None:
            sp.set_attr("aborted", True)
            REGISTRY.counter("pipeline.aborted").inc()
        else:
            REGISTRY.counter("pipeline.queries").inc()
            REGISTRY.histogram("pipeline.query_ms").observe((time.perf_counter() - t0) * 1000)
    if out is not None:
        stats.pipelined_queries += 1
        stats.last_scan = timing
    return out


def _chunk_pred(frag: _Fragment, batch: ColumnBatch) -> tuple[Optional[Expr], bool]:
    """(the predicate for this chunk, ok): string comparisons re-encode
    against this chunk's dictionary codes; not ok when a string reference
    cannot be rewritten (the stream aborts)."""
    pred = frag.pred
    if pred is None:
        return None, True
    scols = {f.name for f in frag.scan.schema if f.dtype == STRING} & pred.references()
    if not scols:
        return pred, True
    rewritten = _encode_string_predicates(pred, batch, scols)
    return rewritten, rewritten is not None


def _chunk_dtypes_ok(batch: ColumnBatch, refs, expect: dict) -> bool:
    """The first chunk pins each referenced column's numpy dtype; a later
    chunk with another dtype (the monolithic read would have promoted
    both) aborts the stream."""
    for name in refs:
        if name not in batch.columns:
            continue
        dt = batch.column(name).data.dtype
        if expect.setdefault(name, dt) != dt:
            return False
    return True


def _chunk_abort_reason(batch: ColumnBatch, refs, expect: dict) -> Optional[str]:
    """Why this chunk's data cannot stream, or None."""
    if not _chunk_dtypes_ok(batch, refs, expect):
        return "dtype_drift"
    for name in sorted(refs):
        if name not in batch.columns:
            continue
        col = batch.column(name)
        if col.validity is not None:
            return "nullable"
        if not _int64_fits(col.data):
            return "int64_range"
    return None


def _place_chunk(placer, stats, padded: int, device_refs, n: int):
    """The mesh device (a parallel/mesh.MeshDevice) the next chunk runs on,
    charged its padded bytes; None with no placer. A zero-width
    ``mesh:dispatch`` span marks the placement."""
    if placer is None:
        return None
    ordinal, placed = placer.next(padded * max(len(device_refs), 1) * 8)
    stats.placed_chunks[ordinal] = stats.placed_chunks.get(ordinal, 0) + 1
    with trace.span("mesh:dispatch", device=ordinal, rows=n):
        pass
    return placed


def _stream_global_partial(frag, plan, chunks, overlap, session, device,
                           timer) -> Optional[ColumnBatch]:
    """The global body per chunk, its exact partials folded on the host:
    counts and integer chunk sums add, min and max take theirs."""
    stats = session.device_stats
    agg_list, names = _agg_list_names(frag)
    proj_exprs = (
        tuple((X.expr_output_name(e), e) for e in frag.project.exprs)
        if frag.project is not None
        else ()
    )
    device_refs = _device_refs(frag)
    depth = _pipeline_depth() if overlap else 0
    pending: deque = deque()
    matched_total = 0
    accs: list = [None] * len(agg_list)

    def fold(res) -> None:
        nonlocal matched_total
        with trace.span("pipeline:fetch"), _attr.phase("fold"):
            matched, results = _fetch(res)
        matched_total += int(matched)
        for i, (v, (kind, _c)) in enumerate(zip(results, agg_list)):
            if kind == "count":
                continue
            if isinstance(v, tuple):  # exact int chunk sums
                s = combine_int_chunks(v)
                accs[i] = s if accs[i] is None else accs[i] + s
            elif kind == "min":
                accs[i] = v if accs[i] is None else np.minimum(accs[i], v)
            elif kind == "max":
                accs[i] = v if accs[i] is None else np.maximum(accs[i], v)
            else:  # unreachable: float sums take the concat route
                raise HyperspaceError(f"non-foldable {kind} on the partial route")

    expect: dict = {}
    placer = mesh_placement.chunk_placer()
    for chunk in chunks:
        batch = chunk.batch
        n = batch.num_rows
        if n == 0:
            continue
        with trace.span("pipeline:chunk", index=chunk.index, rows=n,
                        decode_ms=round(chunk.decode_s * 1000, 3)):
            reason = _chunk_abort_reason(batch, device_refs, expect)
            if reason is not None:
                return _count(stats.pipeline_aborts, reason)
            pred, ok = _chunk_pred(frag, batch)
            if not ok:
                return _count(stats.pipeline_aborts, "string_predicate")
            padded = _pad_pow2(n)
            placed = _place_chunk(placer, stats, padded, device_refs, n)
            dev = device if placed is None else placed.device
            dev_cols = _upload_columns(batch, device_refs & set(batch.columns), padded, session,
                                       device, timer=timer, placed=placed)
            mask = _padded_mask(padded, n, dev)
            key = fused_fingerprint(kernel_route(dev), frag.scan, pred, proj_exprs, agg_list,
                                    dev_cols)
            kernel = session.kernel_cache.get_or_build(
                key, lambda: _build_kernel(pred, proj_exprs, agg_list), "fused_agg"
            )
            METER.record_dispatch()
            pending.append(kernel(dev_cols, mask))
            REGISTRY.counter("pipeline.chunks").inc()
            stats.pipelined_chunks += 1
        while len(pending) > depth:
            fold(pending.popleft())
    while pending:
        # a cancel mid-drain stops fetching the remaining in-flight results
        check_cancelled()
        fold(pending.popleft())
    scalar_values = []
    for acc, (kind, _c) in zip(accs, agg_list):
        if kind == "count":
            scalar_values.append(np.int64(matched_total))
        elif kind == "avg":
            scalar_values.append(acc / max(matched_total, 1))
        else:
            scalar_values.append(acc if acc is not None else np.float64(0))
    return _assemble_global_output(plan, matched_total, scalar_values, agg_list, names)


_FIRST_SENTINEL = 2**31 - 1  # a group's first passing row when none passed


def _key_tuple_rows(key_cols: list[Column], idxs: np.ndarray) -> list[tuple]:
    """Hashable group-key tuples of the given rows (NULL as None): the
    identity of a group across chunks."""
    out = []
    for i in idxs:
        t = []
        for kc in key_cols:
            if kc.validity is not None and not kc.validity[i]:
                t.append(None)
            elif kc.dtype == STRING:
                t.append(kc.dictionary[int(kc.data[i])] if kc.dictionary else "")
            else:
                t.append(kc.data[i].item())
        out.append(tuple(t))
    return out


def _grown(arr: Optional[np.ndarray], size: int, fill, dtype) -> np.ndarray:
    """``arr`` extended to ``size`` with ``fill`` (a new one when None)."""
    if arr is None:
        return np.full(size, fill, dtype=dtype)
    if len(arr) >= size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _np_extreme(dtype, want_max: bool):
    d = np.dtype(dtype)
    if np.issubdtype(d, np.integer):
        info = np.iinfo(d)
        return info.max if want_max else info.min
    return np.inf if want_max else -np.inf


def _stream_grouped_partial(frag, plan, chunks, overlap, session, device,
                            timer) -> Optional[ColumnBatch]:
    """The grouped body per chunk over the chunk's own group ids, folded on
    the host into a global group table kept in first-appearance order;
    output rows follow each group's first passing row over the whole
    scan, as the monolithic assembly orders them."""
    from .executor import factorize_group_keys

    stats = session.device_stats
    agg_list, names = _agg_list_names(frag)
    proj_exprs = tuple((X.expr_output_name(e), e) for e in _device_projections(frag))
    key_names = [e.name for e in frag.agg.group_exprs]
    device_refs = _device_refs(frag)
    depth = _pipeline_depth() if overlap else 0
    pending: deque = deque()
    key_index: dict = {}
    key_slices: list[ColumnBatch] = []
    counts_g: Optional[np.ndarray] = None
    first_g: Optional[np.ndarray] = None
    accs: list = [None] * len(agg_list)

    def fold(entry) -> None:
        nonlocal counts_g, first_g
        gmap, num_l, offset, res = entry
        with trace.span("pipeline:fetch"), _attr.phase("fold"):
            counts_l, first_l, results = _fetch(res)
        size = len(key_index)
        counts_g = _grown(counts_g, size, 0, np.int64)
        first_g = _grown(first_g, size, np.iinfo(np.int64).max, np.int64)
        np.add.at(counts_g, gmap, np.asarray(counts_l)[:num_l].astype(np.int64))
        fl = np.asarray(first_l)[:num_l].astype(np.int64)
        valid = fl < _FIRST_SENTINEL
        if valid.any():
            np.minimum.at(first_g, gmap[valid], fl[valid] + offset)
        for i, (v, (kind, _c)) in enumerate(zip(results, agg_list)):
            if kind == "count":
                continue
            if isinstance(v, tuple):  # exact int chunk sums per group
                accs[i] = _grown(accs[i], size, 0, np.int64)
                np.add.at(accs[i], gmap, combine_int_chunks(v)[:num_l])
            else:
                v = np.asarray(v)[:num_l]
                if kind == "min":
                    accs[i] = _grown(accs[i], size, _np_extreme(v.dtype, True), v.dtype)
                    np.minimum.at(accs[i], gmap, v)
                elif kind == "max":
                    accs[i] = _grown(accs[i], size, _np_extreme(v.dtype, False), v.dtype)
                    np.maximum.at(accs[i], gmap, v)
                else:
                    raise HyperspaceError(f"non-foldable {kind} on the partial route")
        # groups found after this chunk dispatched: extend with identities
        for i, (kind, _c) in enumerate(agg_list):
            if accs[i] is not None and len(accs[i]) < size:
                fill = (_np_extreme(accs[i].dtype, kind == "min")
                        if kind in ("min", "max") else 0)
                accs[i] = _grown(accs[i], size, fill, accs[i].dtype)

    expect: dict = {}
    row_offset = 0
    placer = mesh_placement.chunk_placer()
    for chunk in chunks:
        batch = chunk.batch
        n = batch.num_rows
        if n == 0:
            continue
        with trace.span("pipeline:chunk", index=chunk.index, rows=n,
                        decode_ms=round(chunk.decode_s * 1000, 3)):
            reason = _chunk_abort_reason(batch, device_refs, expect)
            if reason is not None:
                return _count(stats.pipeline_aborts, reason)
            pred, ok = _chunk_pred(frag, batch)
            if not ok:
                return _count(stats.pipeline_aborts, "string_predicate")
            key_cols = [batch.column(nm) for nm in key_names]
            bufs = tuple(kc.data for kc in key_cols)
            (gids_l, num_l, first_idx_l), cacheable = _cached_factorization(
                session, key_cols, bufs, "factorize", lambda: factorize_group_keys(key_cols))
            gmap = np.empty(num_l, dtype=np.int64)
            new_rows = []
            for j, t in enumerate(_key_tuple_rows(key_cols, first_idx_l)):
                g = key_index.get(t)
                if g is None:
                    g = key_index[t] = len(key_index)
                    new_rows.append(first_idx_l[j])
                gmap[j] = g
            if new_rows:
                rows = np.asarray(new_rows, dtype=np.int64)
                key_slices.append(ColumnBatch({nm: kc.take(rows)
                                               for nm, kc in zip(key_names, key_cols)}))
            # each chunk's seg_pad is its own, and so is its kernel's key
            seg_pad = _seg_pad(num_l)
            padded = _pad_pow2(n)
            placed = _place_chunk(placer, stats, padded, device_refs, n)
            dev = device if placed is None else placed.device
            dev_cols = _upload_columns(batch, device_refs & set(batch.columns), padded, session,
                                       device, timer=timer, placed=placed)
            gids_d = _group_ids_to_device(session, dev, bufs, cacheable, gids_l, n, padded,
                                          seg_pad, "gids", timer, placed)
            mask = _padded_mask(padded, n, dev)
            key = grouped_fingerprint(kernel_route(dev), frag.scan, seg_pad, pred, proj_exprs,
                                      agg_list, dev_cols)
            kernel = session.kernel_cache.get_or_build(
                key, lambda: _build_grouped_kernel(pred, proj_exprs, agg_list, seg_pad),
                "grouped_agg",
            )
            METER.record_dispatch()
            pending.append((gmap, num_l, row_offset, kernel(dev_cols, gids_d, mask)))
            REGISTRY.counter("pipeline.chunks").inc()
            stats.pipelined_chunks += 1
        row_offset += n
        while len(pending) > depth:
            fold(pending.popleft())
    while pending:
        # a cancel mid-drain stops fetching the remaining in-flight results
        check_cancelled()
        fold(pending.popleft())
    if not key_index:
        return None  # every chunk was empty: the monolithic path decides

    num_groups = len(key_index)
    counts_g = _grown(counts_g, num_groups, 0, np.int64)
    first_g = _grown(first_g, num_groups, np.iinfo(np.int64).max, np.int64)
    keys_batch = ColumnBatch.concat(key_slices)
    keep = counts_g > 0
    idx = np.nonzero(keep)[0]
    order = np.argsort(first_g[keep], kind="stable")
    out_cols: dict[str, Column] = {}
    for e, nm in zip(frag.agg.group_exprs, key_names):
        out_cols[X.expr_output_name(e)] = keys_batch.column(nm).take(idx).take(order)
    schema = plan.schema
    for (name, acc), (kind, _c) in zip(zip(names, accs), agg_list):
        f = schema.field(name)
        if kind == "count":
            vals = counts_g
        elif kind == "avg":
            vals = acc / np.maximum(counts_g, 1)
        else:
            fill = (_np_extreme(acc.dtype, kind == "min")
                    if acc is not None and kind in ("min", "max") else 0)
            vals = _grown(acc, num_groups, fill, np.int64 if acc is None else acc.dtype)
        np_val = np.asarray(vals)[keep][order]
        if kind == "count":
            out_cols[name] = Column(np_val.astype(np.int64), "int64")
        elif f.dtype in ("int64", "int32", "int16", "int8"):
            out_cols[name] = Column(np_val.astype(np.dtype(f.dtype)), f.dtype)
        else:
            out_cols[name] = Column(np_val.astype(np.float64), "float64")
    return ColumnBatch(out_cols)


def _stream_concat(frag, plan, chunks, session, device, timer,
                   stable: bool) -> Optional[ColumnBatch]:
    """Each chunk's columns upload as it decodes (narrowed as
    ``_upload_columns`` narrows them) and concatenate on the card, zero
    padded, into the column the monolithic upload makes, bit for bit; the
    fragment's kernel then runs once over it. When the chunk buffers are
    ``stable`` (an index scan's, from the chunk cache), the parts are
    cached on their buffers and the concatenated column on every chunk
    buffer, so a warm repeat uploads nothing; a source scan's fresh
    buffers are uploaded and dropped. Group keys stay on the host; their
    factorization over the whole scan and the device group ids are cached
    on every key chunk buffer alike."""
    from .executor import factorize_group_keys

    stats = session.device_stats
    cache = session.device_cache
    device_refs = sorted(_device_refs(frag))
    key_names = [e.name for e in frag.agg.group_exprs]
    dev_parts: dict[str, list] = {}
    src_parts: dict[str, list] = {}
    key_parts: list[ColumnBatch] = []
    expect: dict = {}
    n_seen = 0
    for chunk in chunks:
        batch = chunk.batch
        n = batch.num_rows
        if n == 0:
            continue
        with trace.span("pipeline:chunk", index=chunk.index, rows=n,
                        decode_ms=round(chunk.decode_s * 1000, 3)):
            reason = _chunk_abort_reason(batch, device_refs, expect)
            if reason is not None:
                return _count(stats.pipeline_aborts, reason)
            for name in device_refs:
                if name not in batch.columns:
                    continue
                d = batch.column(name).data
                dev_parts.setdefault(name, []).append(cache.get_or_put(
                    (d,), ("chunk", str(device)),
                    lambda data=d: _to_device(data.astype(_device_dtype(data.dtype)), device,
                                              timer),
                    store=stable,
                ))
                src_parts.setdefault(name, []).append(d)
            if key_names:
                key_parts.append(batch.select(key_names))
            REGISTRY.counter("pipeline.chunks").inc()
            stats.pipelined_chunks += 1
        n_seen += n
    if n_seen == 0:
        return None
    padded = _pad_pow2(n_seen)
    dev_cols = {}
    for name, parts in dev_parts.items():
        def cat(parts=parts):
            tail = padded - n_seen
            if tail:
                parts = parts + [torch.zeros(tail, dtype=parts[0].dtype, device=device)]
            return torch.cat(parts)

        dev_cols[name] = cache.get_or_put_multi(tuple(src_parts[name]),
                                                ("cat", padded, str(device)), cat,
                                                meter=False, store=stable)
    mask = _padded_mask(padded, n_seen, device)
    if not key_names:
        with trace.span("kernel:fused_agg", rows=n_seen, padded=padded):
            return _run_global(frag, plan, session, device, dev_cols, mask)

    def factorize():
        """The factorization of the concatenated keys, with each group's
        first row of them (the only key rows the output needs)."""
        keys = ColumnBatch.concat(key_parts)
        group_ids, num_groups, first_idx = factorize_group_keys(
            [keys.column(nm) for nm in key_names])
        return group_ids, num_groups, keys.take(first_idx)

    part_cols = [kp.column(nm) for kp in key_parts for nm in key_names]
    bufs = tuple(c.data for c in part_cols)
    # the concatenation merges the chunks' dictionaries, so its ids are
    # not the per-buffer factorization's: a tag of their own
    (group_ids, num_groups, reps), cacheable = _cached_factorization(
        session, part_cols, bufs, "factorize_cat", factorize, stable)
    seg_pad = _seg_pad(num_groups)
    gids_d = _group_ids_to_device(session, device, bufs, cacheable, group_ids, n_seen, padded,
                                  seg_pad, "cat_gids", timer)
    with trace.span("kernel:grouped_agg", rows=n_seen, padded=padded, groups=num_groups):
        return _run_grouped(frag, plan, session, device, dev_cols, gids_d, mask,
                            [reps.column(nm) for nm in key_names], np.arange(num_groups),
                            num_groups, seg_pad)


# ---------------------------------------------------------------------------
# the mesh route
# ---------------------------------------------------------------------------

def _mesh_for(session):
    """The active execution mesh (parallel/mesh.active_mesh): None unless
    ``meshDevices`` asks for one and that many devices exist."""
    from ..parallel.mesh import active_mesh

    return active_mesh(session)


def _upload_shards(batch: ColumnBatch, names, padded: int, session, devices: list):
    """Each named column's padded row blocks, one per shard on its mesh
    device, from the session's device cache under the shard's ordinal;
    None when a column is nullable or exceeds the 32-bit range (a mesh
    never ships Wide64)."""
    from ..utils.device_cache import placed_tag

    per = padded // len(devices)
    out: dict = {}
    for name in sorted(names):
        col = batch.column(name)
        if col.validity is not None or not _int64_fits(col.data):
            return None

        def build(data=col.data, i=0, dev=None):
            arr = np.zeros(per, dtype=_device_dtype(data.dtype))
            part = data[i * per:(i + 1) * per]
            arr[: len(part)] = part.astype(arr.dtype)
            return torch.from_numpy(arr).to(dev.device)

        out[name] = [
            session.device_cache.get_or_put(
                (col.data,), placed_tag(("shard", padded, i, str(dev.device)), dev),
                lambda i=i, dev=dev: build(i=i, dev=dev))
            for i, dev in enumerate(devices)
        ]
    return out


def _execute_on_mesh(frag: _Fragment, batch: ColumnBatch, plan, session,
                     mesh) -> Optional[ColumnBatch]:
    """A global or grouped fragment over a device mesh: the rows shard
    across the devices, each shard runs the predicate and the segment
    reductions, and the per-group partials fold on the mesh's first device
    (a global aggregate is the one-group case). Integer sums are exact
    chunk sums: the caller's 2^23-row cap keeps every folded chunk within
    int32, and global first-row indices too. None when the fragment cannot
    shard (a literal outside 32 bits, a nullable or full-range int64
    column): the one-device route takes it. Counterpart of
    tpu_exec._execute_on_mesh."""
    from .executor import factorize_group_keys
    from .kernel_cache import mesh_fingerprint
    from ..parallel.dist_agg import build_distributed_grouped_kernel
    from ..parallel.mesh import shard_devices

    n = batch.num_rows
    if not _fragment_literals_fit(frag):  # a mesh never ships Wide64
        return None
    if frag.agg.group_exprs:
        key_cols = [batch.column(e.name) for e in frag.agg.group_exprs]
        key_bufs = tuple(kc.data for kc in key_cols)
        (group_ids, num_groups, first_idx), cacheable = _cached_factorization(
            session, key_cols, key_bufs, "factorize", lambda: factorize_group_keys(key_cols))
    else:
        key_cols, first_idx, group_ids, num_groups = [], None, None, 1
    seg_pad = _seg_pad(num_groups)
    devices = shard_devices(mesh)  # flat or hierarchical (dcn x ici)
    d = len(devices)
    padded = _pad_pow2(n)
    if padded % d:
        padded = -(-padded // d) * d
    per = padded // d
    dev_cols = _upload_shards(batch, _device_refs(frag) & set(batch.columns), padded,
                              session, devices)
    if dev_cols is None:
        return None
    # each shard's valid-row mask, filled on its device
    mask_d = [torch.arange(i * per, (i + 1) * per, device=dev.device) < n
              for i, dev in enumerate(devices)]
    if group_ids is None:  # a global aggregate: group 0, filled on the device
        gids_d = [torch.where(m, 0, seg_pad - 1).to(torch.int32) for m in mask_d]
    else:
        # each shard's slice of the group ids (dump slot past the rows),
        # cached on the key buffers as the one-device route caches them
        gids_d = []
        for i, dev in enumerate(devices):
            part = group_ids[i * per:(i + 1) * per]
            gids_d.append(_group_ids_to_device(session, dev.device, key_bufs, cacheable, part,
                                               len(part), per, seg_pad,
                                               ("mesh_gids", padded, i), None, dev))

    pred_expr = frag.pred
    proj_exprs = tuple((X.expr_output_name(e), e) for e in _device_projections(frag))
    agg_list_spec, names = _agg_list_names(frag)

    def make_valfn(child):
        def fn(cols):
            proj_cols = dict(cols)
            for nm, e in proj_exprs:
                proj_cols[nm] = compile_expr(e, cols)
            return compile_expr(child, proj_cols)

        return fn

    agg_list = [(kind, make_valfn(child) if child is not None else None)
                for kind, child in agg_list_spec]
    pred_fn = (lambda cols: compile_expr(pred_expr, cols)) if pred_expr is not None else None
    key = mesh_fingerprint(
        d, (tuple(zip(mesh.axis_names, mesh.devices.shape)), id(mesh)), seg_pad,
        pred_expr, proj_exprs, agg_list_spec, {k: v[0] for k, v in dev_cols.items()},
    )
    kernel = session.kernel_cache.get_or_build(
        key, lambda: build_distributed_grouped_kernel(mesh, pred_fn, agg_list, seg_pad),
        "mesh_agg",
    )
    with trace.span("kernel:mesh_agg", rows=n, shards=d, groups=num_groups):
        METER.record_dispatch()
        t0 = time.perf_counter()
        counts_full, first_masked, results = _fetch(kernel(dev_cols, gids_d, mask_d))
        _observe_dispatch("mesh_agg", t0)
    session.device_stats.mesh_fragments += 1
    info = getattr(frag.scan, "index_info", None)
    if info is not None:
        from ..rules.rule_utils import log_index_usage

        log_index_usage(session, "MeshBucketedExec", [info.index_name],
                        f"Mesh grouped aggregate: rows sharded over {d} devices "
                        f"({info.index_name})")
    counts = counts_full[:num_groups]
    results = [_combine_chunks_maybe_avg(v, kind, counts_full)
               for v, (kind, _c) in zip(results, agg_list_spec)]
    if frag.agg.group_exprs:
        return _assemble_grouped_output(plan, frag, key_cols, first_idx, counts, results,
                                        agg_list_spec, names, num_groups, first_masked)
    matched = int(counts[0])
    scalar_values = [np.asarray(v)[0] for v in results]
    return _assemble_global_output(plan, matched, scalar_values, agg_list_spec, names)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _decline(session, reason: str) -> None:
    declines = session.device_stats.declines
    declines[reason] = declines.get(reason, 0) + 1
    return None


def try_execute_gpu(plan: LogicalPlan, session) -> Optional[ColumnBatch]:
    """Run a supported fragment on the session's device; None when the
    plan's shape or data is unsupported (the host executor takes over).
    Counterpart of tpu_exec.try_execute_tpu, without its fail-open breaker:
    a device or kernel failure raises. The scan reads the files and row
    groups its pruning keeps, unfiltered (the fragment applies the whole
    predicate), so a repeat gets the chunk cache's buffers and uploads
    nothing; a scan pruned to nothing declines, as the reference's does."""
    from .executor import _exec_file_scan

    frag = _match_fragment(plan)
    if frag is None:
        return None
    if not _fragment_supported(frag):
        return _decline(session, "unsupported_shape")
    if session.conf.exec_exact_f64_aggregates and _fragment_touches_f64(frag):
        return _decline(session, "exact_f64")
    device = session.device  # raises when CUDA was asked for and is absent
    if _has_int_sum(frag, plan):
        est = _parquet_row_count(frag.scan)
        if est is not None and _pad_pow2(est) > _INT_SUM_ROW_CAP:
            return _decline(session, "int_sum_row_cap")
    int64_cols = [fld.name for fld in frag.scan.schema if fld.dtype == "int64"]
    if not _fragment_literals_fit(frag, _wide_candidates(frag, int64_cols)):
        return _decline(session, "literal_out_of_range")
    # the fragment applies the whole predicate: the scan reads without its
    # pushed filter, so a repeat gets the same cached buffers
    scan = frag.scan.copy(pushed_filter=None)
    mesh = _mesh_for(session)
    # an active mesh takes the whole batch: the pipelined route steps aside
    if _pipeline_enabled() and mesh is None:
        from .executor import scan_streamable

        if scan_streamable(scan):
            out = _execute_streaming(frag, scan, plan, session, device)
            if out is not None:
                session.device_stats.device_fragments += 1
                plan_stats.note_route(plan.plan_id, "pipelined")
                plan_stats.note_scan(frag.scan.plan_id, len(scan.files),
                                     sum(f.size for f in scan.files))
                return out
    t0 = time.perf_counter()
    batch = _exec_file_scan(scan, session)
    timing = ScanTiming("device", None, 0, time.perf_counter() - t0, UploadTimer(device))
    if batch.num_rows == 0:
        return _decline(session, "empty")
    if _has_int_sum(frag, plan) and _pad_pow2(batch.num_rows) > _INT_SUM_ROW_CAP:
        return _decline(session, "int_sum_row_cap")
    if frag.pred is not None:
        scols = {fld.name for fld in frag.scan.schema if fld.dtype == STRING}
        if scols & frag.pred.references():
            # this batch's dictionary codes; never cached across batches
            frag.pred = _encode_string_predicates(frag.pred, batch, scols)
            if frag.pred is None:
                return _decline(session, "string_predicate")
    out = None
    if mesh is not None:
        out = _execute_on_mesh(frag, batch, plan, session, mesh)
    if out is None:
        wide_ok = _wide_predicate_cols(frag, batch)
        if not _fragment_literals_fit(frag, wide_ok):
            return _decline(session, "literal_out_of_range")
        if frag.agg.group_exprs:
            out = _execute_grouped(frag, batch, plan, session, device, wide_ok, timing.upload)
        else:
            out = _execute_global(frag, batch, plan, session, device, wide_ok, timing.upload)
    if out is not None:
        session.device_stats.device_fragments += 1
        session.device_stats.last_scan = timing
        plan_stats.note_route(plan.plan_id, "device")
        plan_stats.note_scan(frag.scan.plan_id, len(scan.files),
                             sum(f.size for f in scan.files), rows=batch.num_rows)
    return out


# ---------------------------------------------------------------------------
# top-k (ORDER BY ... LIMIT) and sort (ORDER BY)
# ---------------------------------------------------------------------------

_TOPK_MIN_ROWS = 4096  # the host argpartition is cheaper below this
_SORT_MIN_ROWS = 4096  # the host lexsort is cheaper below this


def _order_decline(session, reason: str) -> None:
    declines = session.device_stats.order_declines
    declines[reason] = declines.get(reason, 0) + 1
    return None


def _build_topk_kernel(k: int, asc: bool):
    """Top k of an order-preserving 32-bit encoding of the key (sign flip
    for ints, sign-magnitude fold for floats, as the reference's
    ``_build_topk_kernel`` has it; -0.0 and +0.0 stay distinct). Rows at or
    past ``n`` encode to the minimum. ``torch.topk`` promises no order among
    ties, so each row's key is one int64: the encoded word (top bit
    flipped, so the signed order is the unsigned one) in the high half and
    ``~index`` in the low half. The keys are then distinct, and the largest
    k in order are the reference's: larger word first, lower index first
    on ties (``lax.top_k``'s rule, which the host's stable order relies
    on)."""

    def kernel(x, n: int):
        rows = x.shape[0]
        if x.dtype.is_floating_point:
            bits = x.view(torch.int32).long() & _U32
            u = torch.where(bits >= 2**31, bits ^ _U32, bits | 2**31)
        else:
            u = x.to(torch.int64) + 2**31
        e = (_U32 - u) if asc else u
        idx = torch.arange(rows, dtype=torch.int64, device=x.device)
        e = torch.where(idx < n, e, 0)
        key = (e - 2**31) * 2**32 + (_U32 - idx)
        return torch.topk(key, k).indices

    return kernel


def try_device_topk(sort_plan, k: int, batch: ColumnBatch, session) -> Optional[ColumnBatch]:
    """Limit(Sort) on the device: the one numeric sort key ships, the top k
    come back as row indices (one fetch), and the host gathers the k rows.
    None (the reason counted in ``session.device_stats.order_declines``)
    for several keys, a derived, string or nullable key, a key that has no
    exact 32-bit form, or a small input. Counterpart of
    tpu_exec.try_device_topk, without its fail-open breaker."""
    from ..ops.join import exact_key32
    from .device_join import _fetch_all
    from .kernel_cache import order_fingerprint

    if k <= 0:
        return None
    if len(sort_plan.orders) != 1:
        return _order_decline(session, "topk_keys")
    e, asc = sort_plan.orders[0]
    if not isinstance(e, X.Col) or e.name not in batch.columns:
        return _order_decline(session, "topk_key_expr")
    col = batch.column(e.name)
    if col.validity is not None or col.dtype == STRING:
        return _order_decline(session, "topk_key_type")
    n = batch.num_rows
    if n < _TOPK_MIN_ROWS or k >= n:
        return _order_decline(session, "topk_small")
    data = exact_key32(col.data)  # sort keys decide order: no lossy downcast
    if data is None:
        return _order_decline(session, "topk_key_inexact")
    device = session.device
    with trace.span("kernel:topk", rows=n, k=int(k)):
        x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        session.device_cache.record_upload(data.nbytes)
        kernel = session.kernel_cache.get_or_build(
            order_fingerprint(kernel_route(device), "topk", int(k), bool(asc), data.dtype.str),
            lambda: _build_topk_kernel(int(k), bool(asc)), "topk",
        )
        METER.record_dispatch()
        t0 = time.perf_counter()
        (idx,) = _fetch_all([kernel(x, n)])
        _observe_dispatch("topk", t0)
    session.device_stats.device_topk += 1
    return batch.take(idx)


def _enc_i32_words(a: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 encoding of an int32 array (sign-bit flip)."""
    return a.view(np.uint32) ^ np.uint32(0x80000000)


def _enc_f32_words(a: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 encoding of a float32 array (sign-magnitude
    fold; -0.0 canonicalizes to +0.0 so tie order matches the host)."""
    bits = (a + np.float32(0.0)).view(np.uint32)
    return np.where(bits >> 31 != 0, ~bits, bits | np.uint32(0x80000000))


def _encode_sort_words(col: Column, asc: bool):
    """One sort key column as 1-3 order-preserving uint32 words whose
    lexicographic order is the column's exact order, or None (strings,
    nulls, NaN, f64 that needs more than three f32 words).

    - int64 splits into the encoded signed high word and the raw low word.
    - f64 splits into three f32 words (hi = f32(x), mid = f32(x - hi),
      lo = f32(x - hi - mid)); each residual subtraction is exact in f64,
      rounding is monotonic, and the check hi + mid + lo == x keeps
      distinct keys distinct, so the words' order is the f64 order.
    - descending flips every word.

    A copy of tpu_exec._encode_sort_words."""
    if col.validity is not None or col.dtype == STRING:
        return None
    d = col.data
    if d.dtype == np.int64:
        hi = (d >> 32).astype(np.int32)
        lo = (d & np.int64(0xFFFFFFFF)).astype(np.uint32)
        words = [_enc_i32_words(hi), lo]
    elif d.dtype in (np.int32, np.int16, np.int8):
        words = [_enc_i32_words(d.astype(np.int32))]
    elif d.dtype == np.bool_:
        words = [_enc_i32_words(d.astype(np.int32))]
    elif d.dtype == np.float32:
        if np.isnan(d).any():
            return None
        words = [_enc_f32_words(d)]
    elif d.dtype == np.float64:
        if not np.isfinite(d).all():
            return None  # inf residuals turn NaN; NaN order is the host's
        with np.errstate(over="ignore", invalid="ignore"):
            hi = d.astype(np.float32)
            if not np.isfinite(hi).all():
                return None  # beyond the f32 range
            r = d - hi.astype(np.float64)
            mid = r.astype(np.float32)
            lo = (r - mid.astype(np.float64)).astype(np.float32)
            exact = (
                hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
            ) == d
        if not exact.all():
            return None  # this data needs more than 72 bits
        words = [_enc_f32_words(hi), _enc_f32_words(mid), _enc_f32_words(lo)]
    else:
        return None
    if not asc:
        words = [~w for w in words]
    return words


def _build_sort_kernel(n_words: int):
    """The stable multi-key sort of ``n_words`` uint32 key words (each
    carried in an int32 tensor): the permutation that orders the rows
    lexicographically by the words, ties by row index, as the reference's
    ``lax.sort(num_keys=n_words + 1)`` over the words and the index does.
    Words widen to int64 (0..2^32-1 keeps its order, which torch's
    signed sorts need) and pack two to a key with the first's top bit
    flipped; stable sorts from the last key to the first give the
    lexicographic order with the index as the final tie-break."""

    def kernel(*words):
        u = [w.long() & _U32 for w in words]
        keys = [(u[i] - 2**31) * 2**32 + u[i + 1] if i + 1 < n_words else u[i]
                for i in range(0, n_words, 2)]
        perm = torch.arange(u[0].shape[0], dtype=torch.int64, device=u[0].device)
        for key in reversed(keys):
            perm = perm[torch.sort(key[perm], stable=True).indices]
        return perm

    return kernel


def try_device_sort(sort_plan, batch: ColumnBatch, session) -> Optional[ColumnBatch]:
    """Full ORDER BY on the device: every key column encodes into
    order-preserving 32-bit words (multi-key and exact f64 included), one
    device sort returns the permutation (one fetch), and the host gathers
    the rows in their original dtypes: the host lexsort's result, tie order
    included. None (the reason counted in ``order_declines``) for a small
    input or a key that cannot encode exactly. Counterpart of
    tpu_exec.try_device_sort, without its fail-open breaker."""
    from .device_join import _fetch_all
    from .kernel_cache import order_fingerprint

    if not sort_plan.orders:
        return None
    n = batch.num_rows
    if n < _SORT_MIN_ROWS:
        return _order_decline(session, "sort_small")
    words: list[np.ndarray] = []
    for e, asc in sort_plan.orders:
        if not isinstance(e, X.Col) or e.name not in batch.columns:
            return _order_decline(session, "sort_key_expr")
        w = _encode_sort_words(batch.column(e.name), asc)
        if w is None:
            return _order_decline(session, "sort_key_type")
        words.extend(w)
    device = session.device
    with trace.span("kernel:sort", rows=n, n_words=len(words)):
        ops = [torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)
               for w in words]
        for w in words:
            session.device_cache.record_upload(w.nbytes)
        kernel = session.kernel_cache.get_or_build(
            order_fingerprint(kernel_route(device), "sort", len(words)),
            lambda: _build_sort_kernel(len(words)), "sort",
        )
        METER.record_dispatch()
        t0 = time.perf_counter()
        (perm,) = _fetch_all([kernel(*ops)])
        _observe_dispatch("sort", t0)
    session.device_stats.device_sort += 1
    # gather with a copy of the permutation: on the card's host, numpy's
    # take read its index array from the pinned fetch buffer several times
    # slower than from ordinary memory (chip_smoke.py's order phase)
    return batch.take(perm.copy())
