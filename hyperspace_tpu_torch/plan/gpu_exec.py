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

Unlike the reference, nothing here catches a device failure: a kernel that
fails to build or launch raises, and the query fails. A fragment declines
only by shape or data (string aggregates, nullable columns, out-of-range
literals, a full-range int64 column that feeds an aggregate). Not ported
in this slice, and so declining to the host: streaming execution and the
mesh.

ORDER BY runs here too: ``try_device_topk`` (Limit over Sort, one exact
32-bit key) and ``try_device_sort`` (any number of keys encoded into
order-preserving 32-bit words), each returning the host's stable
permutation exactly.
"""

from __future__ import annotations

import operator
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


@dataclass
class DeviceTierStats:
    """What the device tier did, per session: filter-aggregate fragments
    it ran; fused join+aggregate queries (plan/device_join.py); which
    bucketed-join path each co-bucketed join took (``join_paths``:
    "batched", "per_bucket" or "stacked_agg"); the plain join's blocking
    fetches, spilled waves and per-bucket device probes; device top-k and
    sort runs; and how often each reason declined a fragment or a join
    that matched (``declines``) or a top-k or sort (``order_declines``)."""

    device_fragments: int = 0
    device_join_fragments: int = 0
    declines: dict = field(default_factory=dict)
    join_paths: dict = field(default_factory=dict)
    plain_join_fetches: int = 0
    join_spills: int = 0
    device_plain_probes: int = 0
    device_topk: int = 0
    device_sort: int = 0
    order_declines: dict = field(default_factory=dict)


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


def pad_to_device(data: np.ndarray, padded: int, device) -> torch.Tensor:
    """Zero-padded device copy of one host column with the device dtype."""
    arr = np.zeros(padded, dtype=_device_dtype(data.dtype))
    arr[: len(data)] = data.astype(arr.dtype)
    return torch.from_numpy(arr).to(device)


def _upload_wide(data: np.ndarray, padded: int, device) -> tuple:
    """Zero-padded device copies of an int64 column's Wide64 word pairs."""
    hi, lo = _wide_words(data)
    return pad_to_device(hi, padded, device), pad_to_device(lo, padded, device)


def _upload_columns(batch: ColumnBatch, names, padded: int, session, device,
                    wide_ok: frozenset = frozenset()):
    """Padded device columns by name, served from the session's device
    cache; None when a column is nullable or exceeds the 32-bit range. A
    column of ``wide_ok`` that exceeds it ships as a (hi, lo) word pair,
    cached apart from a narrowed upload of the same buffer."""
    dev_cols = {}
    for name in sorted(names):
        col = batch.column(name)
        if col.validity is not None:
            return None
        if not _int64_fits(col.data):
            if name not in wide_ok:
                return None
            dev_cols[name] = session.device_cache.get_or_put(
                (col.data,), ("wide", padded, str(device)),
                lambda data=col.data: _upload_wide(data, padded, device),
            )
            continue
        dev_cols[name] = session.device_cache.get_or_put(
            (col.data,), ("pad", padded, str(device)),
            lambda data=col.data: pad_to_device(data, padded, device),
        )
    return dev_cols


def _padded_mask(padded: int, n: int, device) -> torch.Tensor:
    """The valid-rows mask, filled on the device (nothing to upload)."""
    mask = torch.zeros(padded, dtype=torch.bool, device=device)
    mask[:n] = True
    return mask


def _fetch(tree):
    """Device results to host numpy, preserving the tuple structure."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tuple(_fetch(v) for v in tree)


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


def _execute_global(frag, batch, plan, session, device, wide_ok) -> Optional[ColumnBatch]:
    n = batch.num_rows
    padded = _pad_pow2(n)
    dev_cols = _upload_columns(
        batch, _device_refs(frag) & set(batch.columns), padded, session, device, wide_ok
    )
    if dev_cols is None:
        return _decline(session, "nullable_or_out_of_range")
    mask = _padded_mask(padded, n, device)
    pred_expr = frag.pred
    proj_exprs = (
        tuple((X.expr_output_name(e), e) for e in frag.project.exprs)
        if frag.project is not None
        else ()
    )
    agg_list, names = _agg_list_names(frag)
    key = fused_fingerprint(kernel_route(device), pred_expr, proj_exprs, agg_list, dev_cols)
    kernel = session.kernel_cache.get_or_build(
        key, lambda: _build_kernel(pred_expr, proj_exprs, agg_list)
    )
    matched, results = _fetch(kernel(_wrap_wide(dev_cols), mask))
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


def _execute_grouped(frag, batch, plan, session, device, wide_ok) -> Optional[ColumnBatch]:
    """Keys factorize on the host (string keys never ship); the masked
    segment reductions run on the device. The factorization and the device
    group ids are cached on the key buffers' identity, so a warm query
    uploads nothing."""
    from .executor import factorize_group_keys

    n = batch.num_rows
    key_cols = [batch.column(e.name) for e in frag.agg.group_exprs]
    key_bufs = tuple(kc.data for kc in key_cols)
    cacheable = all(kc.validity is None for kc in key_cols)
    if cacheable:
        group_ids, num_groups, first_idx = session.host_derived_cache.get_or_put(
            key_bufs, ("factorize",), lambda: factorize_group_keys(key_cols)
        )
    else:
        group_ids, num_groups, first_idx = factorize_group_keys(key_cols)
    seg_pad = 1 << max(4, int(np.ceil(np.log2(num_groups + 1))))
    padded = _pad_pow2(n)
    dev_cols = _upload_columns(
        batch, _device_refs(frag) & set(batch.columns), padded, session, device, wide_ok
    )
    if dev_cols is None:
        return _decline(session, "nullable_or_out_of_range")

    def build_gids():
        arr = np.full(padded, seg_pad - 1, dtype=np.int32)
        arr[:n] = group_ids.astype(np.int32)
        return torch.from_numpy(arr).to(device)

    if cacheable:
        gids_d = session.device_cache.get_or_put(
            key_bufs, ("gids", padded, seg_pad, str(device)), build_gids
        )
    else:
        gids_d = build_gids()
        session.device_cache.uploaded_bytes += gids_d.numel() * 4
    mask = _padded_mask(padded, n, device)
    pred_expr = frag.pred
    proj_exprs = tuple((X.expr_output_name(e), e) for e in _device_projections(frag))
    agg_list, names = _agg_list_names(frag)
    key = grouped_fingerprint(
        kernel_route(device), seg_pad, pred_expr, proj_exprs, agg_list, dev_cols
    )
    kernel = session.kernel_cache.get_or_build(
        key, lambda: _build_grouped_kernel(pred_expr, proj_exprs, agg_list, seg_pad)
    )
    counts_full, first_masked, results = _fetch(kernel(_wrap_wide(dev_cols), gids_d, mask))
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
    batch = _exec_file_scan(frag.scan.copy(pushed_filter=None), session)
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
    wide_ok = _wide_predicate_cols(frag, batch)
    if not _fragment_literals_fit(frag, wide_ok):
        return _decline(session, "literal_out_of_range")
    if frag.agg.group_exprs:
        out = _execute_grouped(frag, batch, plan, session, device, wide_ok)
    else:
        out = _execute_global(frag, batch, plan, session, device, wide_ok)
    if out is not None:
        session.device_stats.device_fragments += 1
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
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    session.device_cache.uploaded_bytes += data.nbytes
    kernel = session.kernel_cache.get_or_build(
        order_fingerprint(kernel_route(device), "topk", int(k), bool(asc), data.dtype.str),
        lambda: _build_topk_kernel(int(k), bool(asc)),
    )
    (idx,) = _fetch_all([kernel(x, n)])
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
    ops = [torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)
           for w in words]
    session.device_cache.uploaded_bytes += sum(w.nbytes for w in words)
    kernel = session.kernel_cache.get_or_build(
        order_fingerprint(kernel_route(device), "sort", len(words)),
        lambda: _build_sort_kernel(len(words)),
    )
    (perm,) = _fetch_all([kernel(*ops)])
    session.device_stats.device_sort += 1
    # gather with a copy of the permutation: on the card's host, numpy's
    # take read its index array from the pinned fetch buffer several times
    # slower than from ordinary memory (chip_smoke.py's order phase)
    return batch.take(perm.copy())
