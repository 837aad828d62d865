"""Device execution of the co-partitioned bucketed join + aggregate
(counterpart of hyperspace_tpu/plan/device_join.py, single device).

The physical payoff of JoinIndexRule: per bucket, the right side arrives
sorted by the join key from its index file, every left row probes it with
one searchsorted, right attributes gather back per left row, and the
aggregate reduces per right key. The join output never materializes; only
vectors of one value per right key come back to the host (Q3: revenue per
order over a lineitem x orders bucket join).

The reference's bodies (``_build_stacked_kernel``, ``_build_kernel``) are
jnp code that XLA fuses; there is no Pallas kernel in them. Here they are
torch code on tensors: ``stacked_join_body`` for the all-bucket path
(``try_stacked_join_agg``), run per band item at its exact lengths, and
``per_bucket_join_body`` for the per-bucket flow (``try_device_join_agg``),
over power-of-2 pads whose padding rows land in a dump segment.

The all-bucket paths consume their bucket pairs lazily through a band
scheduler (``_BandScheduler``): items group into power-of-2 size bands, a
full band wave dispatches at once, and every wave first reserves its
padded footprint on the device ledger (plan/join_memory.DeviceLedger),
parking and spilling earlier waves instead of declining when the ledger is
full. A bucket above its split row count (the strategy plan's, or
``join_split_rows()``) probes in left chunks; the fused aggregate splits
only when every aggregate is count, min or max. ``HYPERSPACE_PIPELINE=0``
runs one global wave, unsplit. Results are the same bits whatever the
banding, the splits and the spills.

Side filters evaluate in the stacked body over the raw index columns: a
left row failing its filter weighs 0, and right filters fold into an int32
prefix sum, so each left row's weight is the number of matching right rows
that pass. Uploads therefore come from the stable index-chunk buffers, and
the session's device cache serves repeat queries with no upload.

Float sums are deterministic on the card: rows are laid out by segment
(found rows in probe order, then the rest) and reduced with
``segment_reduce``, which adds in a fixed order; no float atomics. Counts
and integer sums use integer ``index_add_``; min and max use
``scatter_reduce``, whose result does not depend on order.

Declines are by shape or data, as in the reference: f64 or out-of-range
keys, nullable or string columns, duplicate right keys when a right column
is gathered. A failed launch or a CUDA error raises.

The PLAIN (not aggregated) join runs here too (``try_batched_plain_join``):
every bucket's sorted keys stack into power-of-2 bands, one batched
``torch.searchsorted`` probes a whole band wave, a second pass expands the
match runs into (left, right) row pairs, and the host gathers both sides
in their original dtypes, so the rows equal the host merge join's, in its
order.

The host twin (``try_host_join_agg``) runs the numpy form of the fused
body; its one-int64-key shape without a residual goes through the native
fused probe (``_native_probe_agg``, native/hs_native.cpp).

Not ported: the mesh paths and their placement (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import expr as X
from .expr import Expr
from ..columnar.table import Column, ColumnBatch, STRING, numpy_dtype
from ..telemetry import attribution as _attr
from ..telemetry import plan_stats, trace
from ..telemetry.metrics import REGISTRY
from ..utils.rpc_meter import METER


# ---------------------------------------------------------------------------
# screens
# ---------------------------------------------------------------------------

def _shippable(col: Column) -> Optional[np.ndarray]:
    """Host array ready for device upload (32 bits at most), or None."""
    if col.dtype == STRING or col.validity is not None:
        return None
    d = col.data
    if d.dtype == np.int64:
        if len(d) and (d.min() < -(2**31) or d.max() >= 2**31):
            return None
        return d.astype(np.int32)
    if d.dtype == np.float64:
        return d.astype(np.float32)
    if d.dtype in (np.int32, np.float32, np.int16, np.int8, np.bool_):
        return d
    return None


def _ship_dtype(col: Column, session) -> Optional[np.dtype]:
    """The device dtype ``_shippable`` gives this column, or None; the
    range check runs once per buffer (cached on its identity), so a warm
    query does not rescan its columns on the host."""
    if col.dtype == STRING or col.validity is not None:
        return None

    def check():
        a = _shippable(col)
        return None if a is None else a.dtype

    return session.host_derived_cache.get_or_put((col.data,), ("ship32",), check)


def _unwrap(e: Expr):
    from .executor import _unwrap_agg

    return _unwrap_agg(e)


def _col_dtype(name: str, lb, rb) -> Optional[str]:
    if name in lb.columns:
        return str(lb.column(name).dtype)
    if name in rb.columns:
        return str(rb.column(name).dtype)
    return None


def _stacked_eligibility(
    agg_plan, lb, rb, lkeys, rkeys, residual, lfilters=(), rfilters=(),
    lcols_avail=None, rcols_avail=None, exact_f64=True,
):
    """Bucket-independent screens for the fused join+aggregate: group
    columns, aggregate specs, residuals, side filters (evaluated over raw
    index columns), schema-level dtype rules. Returns (group_cols,
    agg_specs, left_names, right_gather_names, right_filter_names) or None.
    ``lb``/``rb`` are any occupied bucket pair (dtypes are schema-wide);
    ``l/rcols_avail`` are the side schemas after their ops, used to
    attribute aggregate and residual references to a side."""
    from .gpu_exec import _expr_device_ok, _literals_fit

    if lcols_avail is None:
        lcols_avail = set(lb.columns)
    if rcols_avail is None:
        rcols_avail = set(rb.columns)
    lk_name, rk_name = lkeys[0], rkeys[0]
    group_cols = []
    for g in agg_plan.group_exprs:
        if not isinstance(g, X.Col):
            return None
        nm = g.name
        if nm.lower() in (lk_name.lower(), rk_name.lower()):
            group_cols.append((nm, "key"))
        elif nm in rcols_avail and nm in rb.columns:
            group_cols.append((nm, nm))
        else:
            return None
    if not any(src == "key" for _n, src in group_cols):
        return None

    agg_specs = []
    schema = agg_plan.schema
    for e in agg_plan.agg_exprs:
        name, agg = _unwrap(e)
        if isinstance(agg, X.Count):
            if not isinstance(agg.child, X.Lit) and not _expr_device_ok(agg.child):
                return None
            agg_specs.append((name, "count", None))
            continue
        if not isinstance(agg, (X.Sum, X.Avg, X.Min, X.Max)):
            return None
        if not _expr_device_ok(agg.child) or not _literals_fit(agg.child):
            return None
        if isinstance(agg, (X.Sum, X.Avg)):
            if schema.field(name).dtype not in ("float32", "float64"):
                return None
            if exact_f64 and any(
                _col_dtype(c, lb, rb) == "float64" for c in agg.child.references()
            ):
                # exactF64Aggregates: f64 Sum/Avg inputs take the exact host twin
                return None
        agg_specs.append((name, agg.func, agg.child))
    for r in residual:
        if not _expr_device_ok(r) or not _literals_fit(r):
            return None
    for filters, batch in ((lfilters, lb), (rfilters, rb)):
        for f in filters:
            if not _expr_device_ok(f) or not _literals_fit(f):
                return None
            if not f.references() <= set(batch.columns):
                return None
    if exact_f64:
        # strict mode: predicates over f64 columns would evaluate in f32
        for e in list(residual) + list(lfilters) + list(rfilters):
            if any(_col_dtype(c, lb, rb) == "float64" for c in e.references()):
                return None

    refs: set[str] = set()
    for _n, _k, c in agg_specs:
        if c is not None:
            refs |= c.references()
    for e in agg_plan.agg_exprs:
        _nm, agg = _unwrap(e)
        if isinstance(agg, X.Count) and not isinstance(agg.child, X.Lit):
            refs |= agg.child.references()
    for r in residual:
        refs |= r.references()
    left_refs = {c for c in refs if c in lcols_avail and c in lb.columns}
    right_refs = {c for c in refs if c not in left_refs}
    if not right_refs <= (rcols_avail & set(rb.columns)):
        return None
    lfilter_refs = set().union(*(f.references() for f in lfilters)) if lfilters else set()
    rfilter_refs = set().union(*(f.references() for f in rfilters)) if rfilters else set()
    return (
        group_cols,
        agg_specs,
        sorted(left_refs | lfilter_refs),
        sorted(right_refs),
        sorted(rfilter_refs),
    )


# ---------------------------------------------------------------------------
# the fused body
# ---------------------------------------------------------------------------

def _found_first_order(found: torch.Tensor, seg: torch.Tensor,
                       probe_sorted: bool) -> torch.Tensor:
    """The permutation that lays rows out by segment: the found rows in
    ascending segment order, then the rest (all in the dump segment), each
    part stable. When the left keys are sorted, the found rows' segments
    are already non-decreasing in row order, so two prefix sums give the
    same permutation as the stable sort, without sorting."""
    if not probe_sorted:
        return torch.argsort(seg, stable=True)
    n = found.shape[0]
    pos_found = torch.cumsum(found, 0) - 1
    n_found = pos_found[-1:] + 1
    pos_rest = n_found + torch.cumsum(~found, 0) - 1
    dest = torch.where(found, pos_found, pos_rest)
    order = torch.empty(n, dtype=torch.int64, device=found.device)
    return order.scatter_(0, dest, torch.arange(n, device=found.device))


def stacked_join_body(agg_specs, residual, lfilters, rfilters, right_gather):
    """The fused filter + probe + gather + segment-reduce body of one bucket
    pair (counterpart of device_join._build_stacked_kernel's bucket_body).

    The returned function takes the left keys ``lk`` [n_l], the sorted right
    keys ``rk`` [n_r >= 1] (same dtype), the left and right columns by
    name, and whether ``lk`` is sorted; it returns (counts int32[n_r], one
    tensor of [n_r] per aggregate). Padding is not needed: tensors have
    their exact lengths, so there is nothing to mask beyond the side
    filters."""
    from .gpu_exec import _as_column, _extreme, _is_int, compile_expr

    def body(lk, rk, lcols, rcols, probe_sorted: bool):
        dev = lk.device
        n_r = rk.shape[0]
        lo = torch.searchsorted(rk, lk, side="left")
        hi = torch.searchsorted(rk, lk, side="right")
        posc = torch.clamp(lo, max=n_r - 1)
        if rfilters:
            rmask = _as_column(compile_expr(rfilters[0], rcols), rk)
            for f in rfilters[1:]:
                rmask = rmask & compile_expr(f, rcols)
            # e[i] = right rows passing the filter before position i; the
            # passing matches of a left row are e[hi] - e[lo]
            e = torch.zeros(n_r + 1, dtype=torch.int32, device=dev)
            e[1:] = torch.cumsum(rmask, 0, dtype=torch.int32)
            w = e[hi] - e[lo]
        else:
            w = (hi - lo).to(torch.int32)
        if lfilters:
            lmask = _as_column(compile_expr(lfilters[0], lcols), lk)
            for f in lfilters[1:]:
                lmask = lmask & compile_expr(f, lcols)
            w = torch.where(lmask, w, 0)
        env = dict(lcols)
        env.update({c: rcols[c][posc] for c in right_gather})
        for r in residual:
            w = w * _as_column(compile_expr(r, env), lk).to(torch.int32)
        found = w > 0
        # order-free reductions scatter every row onto its probe position:
        # a row that found nothing adds the identity (0, +inf, -inf), and no
        # slot is hot, where a dump slot would take about half the rows
        counts = torch.zeros(n_r, dtype=torch.int32, device=dev).index_add_(0, posc, w)
        order = lengths = None
        out = []
        for kind, child in agg_specs:
            if kind == "count":
                out.append(counts)
                continue
            vals = _as_column(compile_expr(child, env), lk)
            if kind in ("sum", "avg"):
                if _is_int(vals):
                    # exact integer accumulation (order-free)
                    acc = torch.zeros(n_r, dtype=torch.int64, device=dev)
                    s = acc.index_add_(0, posc, torch.where(found, vals.long() * w, 0))
                    if kind == "avg":
                        s = s.to(torch.float64)
                else:
                    if order is None:
                        # float sums add in a fixed order: rows laid out by
                        # segment, the found rows first, the rest in a last
                        # (dump) segment n_r
                        seg = torch.where(found, posc, n_r)
                        order = _found_first_order(found, seg, probe_sorted)
                        lengths = torch.zeros(n_r + 1, dtype=torch.int64, device=dev)
                        lengths[:n_r].index_add_(0, posc, found.long())
                        lengths[n_r:] = found.shape[0] - lengths[:n_r].sum(0, keepdim=True)
                    wv = torch.where(found, vals * w, 0)
                    s = torch.segment_reduce(wv[order], "sum", lengths=lengths,
                                             unsafe=True)[:n_r]
                out.append(s if kind == "sum" else s / torch.clamp(counts, min=1))
            elif kind in ("min", "max"):
                ident = _extreme(vals.dtype, kind == "min")
                init = torch.full((n_r,), ident, dtype=vals.dtype, device=dev)
                out.append(init.scatter_reduce_(
                    0, posc, torch.where(found, vals, ident),
                    "amin" if kind == "min" else "amax"))
        return counts, tuple(out)

    return body


# ---------------------------------------------------------------------------
# every bucket pair, one fetch
# ---------------------------------------------------------------------------

def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as one run of bytes (a one-element view of a
    wider tensor keeps its stride, which a byte view refuses)."""
    flat = t.reshape(-1)
    if flat.numel() and flat.stride(0) != 1:
        flat = torch.empty_like(flat, memory_format=torch.contiguous_format).copy_(flat)
    return flat.view(torch.uint8)


def _fetch_all(tensors: list) -> list[np.ndarray]:
    """Every device result to the host in ONE transfer: the tensors are
    concatenated as bytes on the device, copied once (into pinned memory,
    several times faster than pageable) and split again, each in its own
    dtype and shape. The copy is one blocking fetch for the RpcMeter, in a
    ``fetch`` span."""
    if not tensors:
        return []
    flat = torch.cat([_as_bytes(t) for t in tensors])
    with trace.span("fetch"), _attr.phase("fetch"):
        if flat.device.type == "cuda":
            pinned = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            host = pinned.copy_(flat).numpy()  # the views keep the buffer alive
        else:
            host = flat.numpy()
        METER.record_fetch(host.nbytes)
        trace.add_attr("nbytes", host.nbytes)
    out, ofs = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(host[ofs:ofs + nbytes].view(dt).reshape(tuple(t.shape)))
        ofs += nbytes
    return out


def _upload(session, device, srcs, tag, build) -> torch.Tensor:
    """A device tensor derived from host buffers ``srcs``, from the
    session's device cache (a warm query uploads nothing)."""
    return session.device_cache.get_or_put(
        srcs, tag + (str(device),),
        lambda: torch.from_numpy(np.array(build())).to(device),
    )


class _AggItem:
    """One stacked-agg band row: a whole bucket pair, or one left chunk of a
    split bucket (the right side repeats per chunk; the chunks' results
    fold exactly on the host, since a bucket splits only when every
    aggregate is count, min or max). ``lo``/``hi`` bound the chunk in the
    bucket's left rows."""

    __slots__ = ("bucket", "lb", "rb", "rorder", "probe_sorted", "lo", "hi")

    def __init__(self, bucket, lb, rb, rorder, probe_sorted, lo, hi):
        self.bucket = bucket
        self.lb = lb
        self.rb = rb
        self.rorder = rorder
        self.probe_sorted = probe_sorted
        self.lo = lo
        self.hi = hi


def try_stacked_join_agg(
    pairs,
    lkeys,
    rkeys,
    residual,
    session,
    agg_plan,
    lfilters=(),
    rfilters=(),
    lcols_avail=None,
    rcols_avail=None,
    banded=True,
    strategy=None,
) -> Optional[ColumnBatch]:
    """Fused join+aggregate over every bucket pair on the session's device,
    with one fetch for the whole query when no wave spills. ``pairs``
    yields ``(bucket, lb, rb, l_sorted, r_sorted)`` with RAW batches (side
    filters not applied; ``lfilters``/``rfilters`` carry them and run in
    the body), consumed lazily: each pair joins its power-of-2 size band as
    it arrives, and a full band wave dispatches while later pairs still
    load. Each wave reserves its footprint on the device ledger first
    (plan/join_memory.DeviceLedger) and parks, spilling earlier waves,
    instead of declining when the ledger is full.

    ``strategy`` (plan/join_memory.JoinMemoryPlan) gives each bucket's
    split row count; None keeps the fixed ``join_split_rows()``. A bucket
    above it splits into left chunks only when every aggregate is count,
    min or max (f32 sums are not decomposition-invariant). ``banded=False``
    (``HYPERSPACE_PIPELINE=0``) runs every pair as ONE wave, unsplit. The
    body runs per item at its exact lengths, so the results are the same
    bits whatever the banding, the splits and the spills.

    Engages only when every occupied pair is eligible; otherwise None (the
    reason is counted in ``session.device_stats.declines``) and the
    caller's per-bucket flow takes over with the pairs it already loaded."""
    from .join_memory import DeviceLedger

    ledger = DeviceLedger("join_agg")
    try:
        return _stacked_join_agg_impl(pairs, lkeys, rkeys, residual, session, agg_plan,
                                      lfilters, rfilters, lcols_avail, rcols_avail,
                                      banded, strategy, ledger)
    finally:
        ledger.close()  # a decline or an error returns every reservation


def _stacked_join_agg_impl(pairs, lkeys, rkeys, residual, session, agg_plan, lfilters,
                           rfilters, lcols_avail, rcols_avail, banded, strategy, ledger):
    from .gpu_exec import _decline, kernel_route
    from .kernel_cache import join_fingerprint

    device = session.device  # raises when CUDA was asked for and is absent
    stats = session.device_stats
    lk_name, rk_name = lkeys[0], rkeys[0]
    st: dict = {"elig": None, "dt": None, "body": None, "first_rb": None}

    def shipped(col: Column, order=None):
        def build():
            a = _shippable(col)
            return a if order is None else a[order]
        return build

    def dispatch(pads, items):
        """Upload what the wave's items need (from the device cache) and
        launch the body per item: [(counts, aggregate tensors)]."""
        _gc, _specs, left_names, _rg, right_names = st["elig"]
        METER.record_dispatch()  # one wave, as the JAX package's stacked kernel
        out = []
        for it in items:
            rtag = ("join_r",) if it.rorder is None else ("join_r_sorted",)
            rsrcs = () if it.rorder is None else (it.rb.column(rk_name).data,)
            lk_col = it.lb.column(lk_name)
            lk_d = _upload(session, device, (lk_col.data,), ("join_l",), shipped(lk_col))
            rk_d = _upload(session, device, (it.rb.column(rk_name).data,) + rsrcs, rtag,
                           shipped(it.rb.column(rk_name), it.rorder))
            lcols = {c: _upload(session, device, (it.lb.column(c).data,), ("join_l",),
                                shipped(it.lb.column(c))) for c in left_names}
            rcols = {c: _upload(session, device, (it.rb.column(c).data,) + rsrcs, rtag,
                                shipped(it.rb.column(c), it.rorder)) for c in right_names}
            if (it.lo, it.hi) != (0, it.lb.num_rows):  # a left chunk: views
                lk_d = lk_d[it.lo:it.hi]
                lcols = {c: t[it.lo:it.hi] for c, t in lcols.items()}
            counts, vals = st["body"](lk_d, rk_d, lcols, rcols, it.probe_sorted)
            out.append((counts,) + tuple(vals))
        return out

    def estimate(pads, items):
        # the wave's 32-bit uploads (keys and shipped columns) and outputs
        _gc, specs, left_names, _rg, right_names = st["elig"]
        pad_l, pad_r = pads
        return 4 * len(items) * (pad_l * (1 + len(left_names))
                                 + pad_r * (1 + len(right_names))
                                 + pad_r * (1 + len(specs)))

    def retire(wave):
        # a spill: this wave's results to the host, folded with the rest
        # at the end, so spilling changes when they come back, not what
        with _attr.phase("fold"):
            flat = _fetch_all([t for rec in wave.rec for t in rec])
        return _regroup(flat, wave.rec)

    sched = _BandScheduler(dispatch, ledger, estimate, retire, banded=banded)
    split_default = join_split_rows() if banded else 0
    n_splits = n_buckets = 0
    splittable = False
    for b, lb, rb, l_sorted, r_sorted in pairs:
        if lb is None or rb is None or not lb.num_rows or not rb.num_rows:
            continue
        if st["elig"] is None:
            elig = _stacked_eligibility(
                agg_plan, lb, rb, lkeys, rkeys, residual, lfilters, rfilters,
                lcols_avail, rcols_avail,
                exact_f64=session.conf.exec_exact_f64_aggregates,
            )
            if elig is None:
                return _decline(session, "join_unsupported_shape")
            group_cols, agg_specs, left_names, right_gather, rfn = elig
            right_names = sorted(set(right_gather) | set(rfn))
            st["elig"] = (group_cols, agg_specs, left_names, right_gather, right_names)
            st["first_rb"] = rb
            splittable = all(k in ("count", "min", "max") for _n, k, _c in agg_specs)
        group_cols, agg_specs, left_names, right_gather, right_names = st["elig"]
        lk_col, rk_col = lb.column(lk_name), rb.column(rk_name)
        if lk_col.data.dtype == np.float64 or rk_col.data.dtype == np.float64:
            return _decline(session, "join_f64_key")  # keys never downcast
        lk_dt, rk_dt = _ship_dtype(lk_col, session), _ship_dtype(rk_col, session)
        # exact dtype equality: searchsorted compares the two key tensors
        if lk_dt is None or rk_dt is None or lk_dt != rk_dt:
            return _decline(session, "join_key_not_shippable")
        if st["dt"] is None:
            st["dt"] = lk_dt
        elif lk_dt != st["dt"]:
            return _decline(session, "join_key_dtype_varies")
        for batch, names in ((lb, left_names), (rb, right_names)):
            if any(_ship_dtype(batch.column(c), session) is None for c in names):
                return _decline(session, "join_column_not_shippable")
        # sortedness is checked once per buffer, not taken from the file
        # count: searchsorted needs sorted right keys, and the body skips
        # its sort only when the left keys are sorted
        rorder = None
        if not (r_sorted and _is_sorted(rk_col.data, session)):
            rorder = session.host_derived_cache.get_or_put(
                (rk_col.data,), ("jorder",),
                lambda a=rk_col.data: np.argsort(a, kind="stable"),
            )
        probe_sorted = l_sorted and _is_sorted(lk_col.data, session)
        dup = session.host_derived_cache.get_or_put(
            (rk_col.data,), ("dupkeys",),
            lambda a=rk_col.data, o=rorder: _has_duplicates(a if o is None else a[o]),
        )
        if dup and (right_gather or any(src != "key" for _n, src in group_cols)):
            # a per-key gather would drop the other matching rows
            return _decline(session, "join_dup_right_keys")
        if st["body"] is None:
            key = join_fingerprint(
                kernel_route(device), st["dt"].str, [(k, c) for _n, k, c in agg_specs],
                residual, lfilters, rfilters,
                (tuple(left_names), tuple(right_names), tuple(right_gather)),
            )
            st["body"] = session.kernel_cache.get_or_build(
                key, lambda: stacked_join_body(
                    [(k, c) for _n, k, c in agg_specs], list(residual), list(lfilters),
                    list(rfilters), right_gather,
                ), "join_stacked_agg",
            )
        n_buckets += 1
        n_l, n_r = lb.num_rows, rb.num_rows
        if strategy is not None:
            strategy.observe_actual(b, n_l, _batch_data_nbytes(lb))
        split = strategy.split_rows(b, splittable) if strategy is not None and banded \
            else split_default
        if split and splittable and n_l > split:
            n_splits += -(-n_l // split) - 1
            for c0 in range(0, n_l, split):
                c1 = min(c0 + split, n_l)
                sched.add(_AggItem(b, lb, rb, rorder, probe_sorted, c0, c1), c1 - c0, n_r)
        else:
            sched.add(_AggItem(b, lb, rb, rorder, probe_sorted, 0, n_l), n_l, n_r)

    if st["elig"] is None:
        return None  # no occupied bucket pair: the caller emits the empty shape
    records = sched.finish()
    stats.join_spills += sched.spills
    stats.join_waves += len(records)
    stats.join_splits += n_splits
    stats.join_parks += ledger.parks
    if sched.declined is None and records:
        REGISTRY.counter("pipeline.join.buckets").inc(n_buckets)
        if n_splits:
            REGISTRY.counter("pipeline.join.splits").inc(n_splits)
    # ONE fetch over every wave that did not spill
    pending = [w for w in records if w.done is None]
    if pending:
        with trace.span("join:fold", waves=len(pending)), _attr.phase("fold"):
            flat = _fetch_all([t for w in pending for rec in w.rec for t in rec])
        ofs = 0
        for w in pending:
            n = sum(len(rec) for rec in w.rec)
            w.done = _regroup(flat[ofs:ofs + n], w.rec)
            w.rec = None
            ofs += n
    sched.release_reservations()
    stats.device_join_fragments += 1
    return _assemble_stacked(records, st["elig"], agg_plan.schema, rk_name, st["first_rb"])


def _regroup(flat: list, recs: list) -> list:
    """Fetched arrays back into one tuple per item, in the wave's order."""
    out, i = [], 0
    for rec in recs:
        out.append(tuple(flat[i:i + len(rec)]))
        i += len(rec)
    return out


def _assemble_stacked(records, elig, schema, rk_name, first_rb) -> ColumnBatch:
    """Fold split chunks exactly (count adds, min and max take the
    extreme) and emit one row per matched right key, bucket by bucket."""
    group_cols, agg_specs, _ln, _rg, _rn = elig
    per_bucket: dict[int, list] = {}
    for wave in records:
        for it, res in zip(wave.items, wave.done):
            slot = per_bucket.get(it.bucket)
            if slot is None:
                per_bucket[it.bucket] = [it, res[0], list(res[1:])]
                continue
            slot[1] = slot[1] + res[0]
            for j, (_nm, kind, _c) in enumerate(agg_specs):
                a, v = slot[2][j], res[1 + j]
                slot[2][j] = (a + v if kind == "count"
                              else np.minimum(a, v) if kind == "min" else np.maximum(a, v))
    parts = []
    for b in sorted(per_bucket):
        it, counts, vals = per_bucket[b]
        kept = np.flatnonzero(counts)  # the right keys some left row matched
        if not len(kept):
            continue
        rows = kept if it.rorder is None else it.rorder[kept]
        out_cols: dict[str, Column] = {
            nm: it.rb.column(rk_name if src == "key" else src).take(rows)
            for nm, src in group_cols
        }
        for (nm, kind, _c), full in zip(agg_specs, vals):
            out_cols[nm] = _agg_column(schema, nm, kind, full[kept])
        parts.append(ColumnBatch(out_cols))
    if not parts:
        empty = np.empty(0, dtype=np.int64)
        out_cols = {nm: first_rb.column(rk_name if src == "key" else src).take(empty)
                    for nm, src in group_cols}
        for nm, kind, _c in agg_specs:
            f = schema.field(nm)
            dtype = "int64" if kind == "count" else (
                f.dtype if f.dtype.startswith("int") else "float64")
            out_cols[nm] = Column(np.empty(0, numpy_dtype(dtype)), dtype)
        return ColumnBatch(out_cols)
    return ColumnBatch.concat(parts)


def _batch_data_nbytes(batch: ColumnBatch) -> int:
    """Decoded bytes of one loaded bucket side (the actual beside the
    footer estimate the plan priced it at)."""
    return sum(c.data.nbytes + (0 if c.validity is None else c.validity.nbytes)
               for c in batch.columns.values())


def _is_sorted(keys: np.ndarray, session) -> bool:
    return session.host_derived_cache.get_or_put(
        (keys,), ("sorted",), lambda: bool(len(keys) < 2 or (keys[1:] >= keys[:-1]).all())
    )


def _has_duplicates(sorted_keys: np.ndarray) -> bool:
    return bool(len(sorted_keys) > 1 and (sorted_keys[1:] == sorted_keys[:-1]).any())


def _agg_column(schema, nm: str, kind: str, vals: np.ndarray) -> Column:
    f = schema.field(nm)
    if kind == "count":
        return Column(vals.astype(np.int64), "int64")
    if f.dtype in ("int64", "int32", "int16", "int8"):
        return Column(vals.astype(np.dtype(f.dtype)), f.dtype)
    return Column(vals.astype(np.float64), "float64")


# ---------------------------------------------------------------------------
# one bucket pair on the device (the per-bucket flow)
# ---------------------------------------------------------------------------

def per_bucket_join_body(agg_specs, residual, left_names, right_names, pad_r: int,
                         dup: bool = False):
    """The per-bucket fused probe + gather + residual + segment reduction
    (counterpart of device_join._build_kernel): rows whose probe misses, or
    fails a residual, and the padding rows land in the dump segment
    ``pad_r``, which is cut off. With ``dup`` (duplicate right keys and
    left-only aggregates) a row weighs ``hi - pos``, its number of matching
    right rows. Counts and integer sums add exactly, float sums in a fixed
    order (rows laid out by segment, ``segment_reduce``), min and max by
    ``scatter_reduce``, so two runs give the same bits.

    The returned function takes ``dev_in``: "lk" [pad_l], "rk" [pad_r]
    (sorted, padded with the dtype's maximum), "mask" bool[pad_l] (the real
    left rows), "n_r" (int), "sorted" (the left keys are sorted), and the
    columns as "l_<name>" [pad_l] and "r_<name>" [pad_r]; it returns
    (counts int32[pad_r], one tensor [pad_r] per aggregate)."""
    from .gpu_exec import _as_column, _extreme, _is_int, compile_expr

    def body(dev_in):
        lk, rk, mask, n_r = dev_in["lk"], dev_in["rk"], dev_in["mask"], dev_in["n_r"]
        dev = lk.device
        pos = torch.searchsorted(rk, lk)
        posc = torch.clamp(pos, 0, pad_r - 1)
        found = mask & (posc < n_r) & (rk[posc] == lk)
        env = {c: dev_in["l_" + c] for c in left_names}
        env.update({c: dev_in["r_" + c][posc] for c in right_names})
        for r in residual:
            found = found & _as_column(compile_expr(r, env), lk)
        if dup:
            hi = torch.clamp(torch.searchsorted(rk, lk, right=True), max=n_r)
            w = torch.where(found, hi - torch.clamp(pos, max=n_r), 0).to(torch.int32)
        else:
            w = found.to(torch.int32)
        seg = torch.where(found, posc, pad_r)
        counts = torch.zeros(pad_r + 1, dtype=torch.int32, device=dev).index_add_(0, seg, w)
        order = lengths = None
        out = []
        for kind, child in agg_specs:
            if kind == "count":
                out.append(counts[:pad_r])
                continue
            vals = _as_column(compile_expr(child, env), lk)
            if kind in ("sum", "avg"):
                if _is_int(vals):
                    acc = torch.zeros(pad_r + 1, dtype=torch.int64, device=dev)
                    s = acc.index_add_(0, seg, torch.where(found, vals.long() * w, 0))[:pad_r]
                    if kind == "avg":
                        s = s.to(torch.float64)
                else:
                    if order is None:
                        order = _found_first_order(found, seg, dev_in["sorted"])
                        lengths = torch.bincount(seg, minlength=pad_r + 1)
                    wv = torch.where(found, vals * w, 0)
                    s = torch.segment_reduce(wv[order], "sum", lengths=lengths,
                                             unsafe=True)[:pad_r]
                out.append(s if kind == "sum" else s / torch.clamp(counts[:pad_r], min=1))
            elif kind in ("min", "max"):
                ident = _extreme(vals.dtype, kind == "min")
                init = torch.full((pad_r + 1,), ident, dtype=vals.dtype, device=dev)
                out.append(init.scatter_reduce_(
                    0, seg, torch.where(found, vals, ident),
                    "amin" if kind == "min" else "amax")[:pad_r])
        return counts[:pad_r], tuple(out)

    return body


def try_device_join_agg(agg_plan, lb: ColumnBatch, rb: ColumnBatch, lkeys: Sequence[str],
                        rkeys: Sequence[str], residual: Sequence[Expr], session,
                        r_sorted: bool, l_sorted: bool = False) -> Optional[ColumnBatch]:
    """One bucket pair's fused join+aggregate on the device, in one fetch;
    None when its shape or data is not the body's (the host twin runs
    then). A CUDA error raises."""
    prep = prepare_device_join_agg(agg_plan, lb, rb, lkeys, rkeys, residual, session,
                                   r_sorted, l_sorted)
    if prep is None:
        return None
    tensors, assemble = prep
    return assemble(_fetch_all(tensors))


def prepare_device_join_agg(agg_plan, lb: ColumnBatch, rb: ColumnBatch,
                            lkeys: Sequence[str], rkeys: Sequence[str],
                            residual: Sequence[Expr], session, r_sorted: bool,
                            l_sorted: bool = False):
    """The screens and the launch of one bucket pair's fused join+aggregate,
    without the fetch: (device result tensors, assemble(fetched) ->
    ColumnBatch), so a caller with many pairs can fetch them together;
    None -> the host twin."""
    if session is None or len(lkeys) != 1 or not session.conf.exec_device_enabled:
        return None
    return _prepare_join_agg_inner(agg_plan, lb, rb, lkeys, rkeys, residual, session,
                                   r_sorted, l_sorted)


def _prepare_join_agg_inner(agg_plan, lb, rb, lkeys, rkeys, residual, session,
                            r_sorted: bool, l_sorted: bool):
    from .gpu_exec import _expr_device_ok, _literals_fit, kernel_route
    from .kernel_cache import bucket_join_fingerprint

    lk_name, rk_name = lkeys[0], rkeys[0]
    group_cols = []  # (output name, "key" or a right column)
    for g in agg_plan.group_exprs:
        if not isinstance(g, X.Col):
            return None
        nm = g.name
        if nm.lower() in (lk_name.lower(), rk_name.lower()):
            group_cols.append((nm, "key"))
        elif nm in rb.columns:
            group_cols.append((nm, nm))
        else:
            return None
    if not any(src == "key" for _n, src in group_cols):
        return None  # key groups are what make a group bucket-local
    agg_specs = []  # (name, kind, child or None)
    schema = agg_plan.schema
    for e in agg_plan.agg_exprs:
        name, agg = _unwrap(e)
        if isinstance(agg, X.Count):
            # device columns are non-null, so count(expr) counts matches
            if not isinstance(agg.child, X.Lit) and not _expr_device_ok(agg.child):
                return None
            agg_specs.append((name, "count", None))
            continue
        if not isinstance(agg, (X.Sum, X.Avg, X.Min, X.Max)):
            return None
        if not _expr_device_ok(agg.child) or not _literals_fit(agg.child):
            return None
        if isinstance(agg, (X.Sum, X.Avg)):
            if schema.field(name).dtype not in ("float32", "float64"):
                return None
            if session.conf.exec_exact_f64_aggregates and any(
                _col_dtype(c, lb, rb) == "float64" for c in agg.child.references()
            ):
                return None  # exactF64Aggregates: the host twin sums in f64
        agg_specs.append((name, agg.func, agg.child))
    for r in residual:
        if not _expr_device_ok(r) or not _literals_fit(r):
            return None
    refs: set[str] = set()
    for _n, _k, c in agg_specs:
        if c is not None:
            refs |= c.references()
    for e in agg_plan.agg_exprs:
        _nm, agg = _unwrap(e)
        if isinstance(agg, X.Count) and not isinstance(agg.child, X.Lit):
            refs |= agg.child.references()
    for r in residual:
        refs |= r.references()
    left_refs = {c for c in refs if c in lb.columns}
    right_refs = refs - left_refs
    if not right_refs <= set(rb.columns):
        return None

    lk_col, rk_col = lb.column(lk_name), rb.column(rk_name)
    if lk_col.data.dtype == np.float64 or rk_col.data.dtype == np.float64:
        return None  # keys never downcast: collapsed f64 keys would match
    lk_arr, rk_arr = _shippable(lk_col), _shippable(rk_col)
    if lk_arr is None or rk_arr is None or lk_arr.dtype.kind != rk_arr.dtype.kind:
        return None
    ship_l, ship_r = {}, {}
    for names, batch, ship in ((left_refs, lb, ship_l), (right_refs, rb, ship_r)):
        for c in names:
            a = _shippable(batch.column(c))
            if a is None:
                return None
            ship[c] = a
    rorder = None
    if not r_sorted:
        rorder = np.argsort(rk_arr, kind="stable")
        rk_arr = rk_arr[rorder]
        ship_r = {c: a[rorder] for c, a in ship_r.items()}
    dup = _has_duplicates(rk_arr)
    if dup and (right_refs or any(src != "key" for _n, src in group_cols)):
        return None  # a per-key gather would drop the other matching rows

    # one key dtype for both sides (searchsorted compares them): a narrower
    # key widens exactly; pads carry its maximum so real keys stay a prefix
    kdt = np.promote_types(lk_arr.dtype, rk_arr.dtype)
    n_l, n_r = lb.num_rows, rb.num_rows
    pad_l, pad_r = _pow2(n_l), _pow2(n_r)
    rk_pad = np.iinfo(kdt).max if kdt.kind == "i" else np.float32(np.inf)
    device = session.device

    def up(a, pad, fill=0, dtype=None):
        host = np.full(pad, fill, dtype=dtype or a.dtype)
        host[: len(a)] = a
        return torch.from_numpy(host).to(device)

    dev_in = {"lk": up(lk_arr, pad_l, 0, kdt), "rk": up(rk_arr, pad_r, rk_pad, kdt),
              "mask": up(np.ones(n_l, dtype=bool), pad_l, False), "n_r": n_r,
              "sorted": bool(l_sorted and _is_sorted(lk_col.data, session))}
    for c, a in ship_l.items():
        dev_in["l_" + c] = up(a, pad_l)
    for c, a in ship_r.items():
        dev_in["r_" + c] = up(a, pad_r)
    agg_list = [(k, c) for _n, k, c in agg_specs]
    key = bucket_join_fingerprint(
        kernel_route(device), "bucket_agg_dup" if dup else "bucket_agg", pad_r, kdt.str,
        agg_list, residual,
        tuple(sorted(("l_" + c, str(a.dtype)) for c, a in ship_l.items()))
        + tuple(sorted(("r_" + c, str(a.dtype)) for c, a in ship_r.items())),
    )
    body = session.kernel_cache.get_or_build(
        key, lambda: per_bucket_join_body(agg_list, list(residual), sorted(ship_l),
                                          sorted(ship_r), pad_r, dup), "join_agg")
    METER.record_dispatch()
    counts_d, vals_d = body(dev_in)

    def assemble(fetched) -> ColumnBatch:
        counts = fetched[0][:n_r]
        keep = np.flatnonzero(counts > 0)
        rows = keep if rorder is None else rorder[keep]
        out_cols: dict[str, Column] = {
            nm: rb.column(rk_name if src == "key" else src).take(rows)
            for nm, src in group_cols
        }
        for (nm, kind, _c), full in zip(agg_specs, fetched[1:]):
            out_cols[nm] = _agg_column(schema, nm, kind, full[:n_r][keep])
        return ColumnBatch(out_cols)

    return [counts_d, *vals_d], assemble


# ---------------------------------------------------------------------------
# host twin
# ---------------------------------------------------------------------------

def try_host_join_agg(
    agg_plan,
    lb: ColumnBatch,
    rb: ColumnBatch,
    lkeys: Sequence[str],
    rkeys: Sequence[str],
    residual: Sequence[Expr],
    session,
    r_sorted: bool,
) -> Optional[ColumnBatch]:
    """Numpy twin of the fused body for one bucket pair: probe the sorted
    unique right side once per left row, gather only the referenced right
    columns, reduce per right key with bincount. Accepts any evaluable
    expression or dtype (string join keys aside) but needs unique right
    keys; a bucket with duplicates falls through to the merge join. Used
    when the device path is off or declines."""
    from .executor import _unwrap_agg

    if len(lkeys) != 1:
        return None
    lk_name, rk_name = lkeys[0], rkeys[0]
    lk_col, rk_col = lb.column(lk_name), rb.column(rk_name)
    if lk_col.dtype == STRING or rk_col.dtype == STRING:
        return None  # per-batch dictionary codes are not comparable across sides
    if lk_col.validity is not None or rk_col.validity is not None:
        return None

    group_cols = []
    for g in agg_plan.group_exprs:
        if not isinstance(g, X.Col):
            return None
        nm = g.name
        if nm.lower() in (lk_name.lower(), rk_name.lower()):
            group_cols.append((nm, "key"))
        elif nm in rb.columns:
            group_cols.append((nm, nm))
        else:
            return None
    if not any(src == "key" for _n, src in group_cols):
        return None
    agg_specs = []
    for e in agg_plan.agg_exprs:
        name, agg = _unwrap_agg(e)
        if not isinstance(agg, (X.Sum, X.Avg, X.Min, X.Max, X.Count)):
            return None
        agg_specs.append((name, agg))

    rk = rk_col.data
    rorder = None
    if not r_sorted:
        rorder = np.argsort(rk, kind="stable")
        rk = rk[rorder]
    if _has_duplicates(rk):
        return None  # a per-key gather would drop rows

    lk = lk_col.data
    # one int64 key, no residual: the native kernel fuses the probe and the
    # per-key sums of left-side Sum/Avg/Count inputs in one pass
    if not residual and lk.dtype == np.int64 and rk.dtype == np.int64:
        out = _native_probe_agg(agg_specs, agg_plan, lb, rb, rk_name, group_cols, lk, rk,
                                rorder)
        if out is not None:
            return out
    n_r = len(rk)
    pos = np.searchsorted(rk, lk)
    posc = np.clip(pos, 0, n_r - 1)
    found = rk[posc] == lk

    refs: set[str] = set()
    for _nm, agg in agg_specs:
        if not (isinstance(agg, X.Count) and isinstance(agg.child, X.Lit)):
            refs |= agg.child.references()
    for r in residual:
        refs |= r.references()
    env_cols = dict(lb.columns)
    for c in refs - set(lb.columns):
        if c not in rb.columns:
            return None
        col = rb.column(c)
        if rorder is not None:
            col = col.take(rorder)
        env_cols[c] = col.take(posc)  # per-left-row gather (masked by found)
    env = ColumnBatch(env_cols)
    for r in residual:
        v = r.eval(env)
        arr = np.asarray(v.data, dtype=bool)
        if v.validity is not None:
            arr = arr & v.validity
        found = found & arr

    counts = np.bincount(posc[found], minlength=n_r).astype(np.int64)
    keep = counts > 0

    agg_cols: dict[str, Column] = {}
    for nm, agg in agg_specs:
        c = _host_grouped_agg(agg, env, posc, found, counts, n_r, keep)
        if c is None:
            return None  # e.g. min/max over a string column
        agg_cols[nm] = c

    out_cols: dict[str, Column] = {}
    for nm, src in group_cols:
        col = rb.column(rk_name if src == "key" else src)
        if rorder is not None:
            col = col.take(rorder)
        out_cols[nm] = col.take(np.flatnonzero(keep))
    out_cols.update(agg_cols)
    return ColumnBatch(out_cols)


def _native_probe_agg(agg_specs, agg_plan, lb, rb, rk_name, group_cols, lk, rk,
                      rorder) -> Optional[ColumnBatch]:
    """The host twin through native.probe_agg_i64, when every aggregate is
    count(*) or a Sum/Avg of left-side columns; None otherwise (the numpy
    form runs). The sums add in left-row order, np.bincount's."""
    from .. import native

    for _nm, agg in agg_specs:  # the whole spec list, before any evaluation
        if isinstance(agg, X.Count) and isinstance(agg.child, X.Lit):
            continue
        if not isinstance(agg, (X.Sum, X.Avg)) or not agg.child.references() <= set(lb.columns):
            return None
    specs, weights = [], []
    for nm, agg in agg_specs:
        if isinstance(agg, X.Count):
            specs.append((nm, "count", -1))
            continue
        v = agg.child.eval(lb)
        if v.validity is not None or v.dtype == STRING:
            return None
        specs.append((nm, agg.func, len(weights)))
        weights.append(v.data.astype(np.float64, copy=False))
    counts, sums = native.probe_agg_i64(lk, rk, weights)
    keep = counts > 0
    out_cols: dict[str, Column] = {}
    for nm, src in group_cols:
        col = rb.column(rk_name if src == "key" else src)
        if rorder is not None:
            col = col.take(rorder)
        out_cols[nm] = col.take(np.flatnonzero(keep))
    kept_counts = counts[keep]
    for nm, kind, wi in specs:
        if kind == "count":
            out_cols[nm] = Column(kept_counts, "int64")
        elif kind == "avg":
            out_cols[nm] = Column(sums[wi][keep] / np.maximum(kept_counts, 1), "float64")
        else:
            f = agg_plan.schema.field(nm)
            s = sums[wi][keep]
            out_cols[nm] = (Column(s.astype(np.int64).astype(np.dtype(f.dtype)), f.dtype)
                            if f.dtype.startswith("int") else Column(s, "float64"))
    return ColumnBatch(out_cols)


def _host_grouped_agg(agg, env, posc, found, counts, n_r, keep):
    """One aggregate over the fused probe (executor._grouped_agg semantics:
    Count counts non-NULL inputs, a group with no valid input is NULL)."""
    if isinstance(agg, X.Count) and isinstance(agg.child, X.Lit):
        return Column(counts[keep], "int64")
    vals = agg.child.eval(env)
    if vals.dtype == STRING:
        return None
    mask = found if vals.validity is None else (found & vals.validity)
    seg = posc[mask]
    counts_valid = np.bincount(seg, minlength=n_r).astype(np.int64)
    if isinstance(agg, X.Count):
        return Column(counts_valid[keep], "int64")
    kept_valid = counts_valid[keep]
    group_validity = None if (kept_valid > 0).all() else kept_valid > 0
    data = vals.data[mask]
    if isinstance(agg, X.Sum):
        s = np.bincount(seg, weights=data.astype(np.float64), minlength=n_r)
        if vals.data.dtype.kind == "i":
            return Column(s[keep].astype(np.int64), "int64", group_validity)
        return Column(s[keep], "float64", group_validity)
    if isinstance(agg, X.Avg):
        s = np.bincount(seg, weights=data.astype(np.float64), minlength=n_r)
        return Column(s[keep] / np.maximum(kept_valid, 1), "float64", group_validity)
    if isinstance(agg, (X.Min, X.Max)):
        is_min = isinstance(agg, X.Min)
        if data.dtype.kind == "f":
            init = np.inf if is_min else -np.inf
        else:
            info = np.iinfo(data.dtype)
            init = info.max if is_min else info.min
        out = np.full(n_r, init, dtype=data.dtype)
        (np.minimum if is_min else np.maximum).at(out, seg, data)
        return Column(out[keep], str(vals.dtype), group_validity)
    return None


# ---------------------------------------------------------------------------
# the plain join: band-stacked probe and run expansion
# ---------------------------------------------------------------------------

_PLAIN_MIN_ROWS = 4096  # below this the host searchsorted probe is cheaper

# buckets per stacked band dispatch: the default 8-bucket layout stays one
# dispatch per band
_JOIN_WAVE = 8


def _pow2(n: int, floor: int = 10) -> int:
    return 1 << max(floor, int(np.ceil(np.log2(max(1, n)))))


# left-side row count above which a bucket splits into left-chunk items
# when no memory plan is active (0 disables): HYPERSPACE_JOIN_SPLIT_ROWS's
# default. Per-left-row probe results are independent of the chunking, so
# chunk results concatenate into exactly the unsplit bucket's.
_JOIN_SPLIT_ROWS = 1 << 18


def join_split_rows() -> int:
    """The split row count when no memory plan is active:
    ``HYPERSPACE_JOIN_SPLIT_ROWS``, else ``_JOIN_SPLIT_ROWS``. With the
    device ledger on, plan/join_memory.plan_join_memory decides per bucket
    instead, and a set knob overrides its grant-derived count."""
    from ..utils import env

    raw = env.read_raw("HYPERSPACE_JOIN_SPLIT_ROWS")
    try:
        return _JOIN_SPLIT_ROWS if raw is None else int(raw)
    except ValueError:
        return _JOIN_SPLIT_ROWS


def _band_pads(n_l: int, n_r: int) -> tuple:
    """The power-of-2 size band a probe item belongs to: its stack pads."""
    return _pow2(n_l), _pow2(n_r)


class _JoinDeclined(Exception):
    """The batched plain join declines by data (int32 pair-count overflow,
    the skew readback guard); ``reason`` names it in the decline counts."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _Wave:
    """One dispatched band wave: its pads, items, device record (the probe
    outputs), its ledger reservation, and once fetched or spilled its host
    results in ``done``."""

    __slots__ = ("pads", "items", "rec", "nbytes", "done")

    def __init__(self, pads, items, rec, nbytes: int = 0):
        self.pads = pads
        self.items = items
        self.rec = rec
        self.nbytes = nbytes
        self.done = None


class _BandScheduler:
    """Groups join items into power-of-2 ``(pad_l, pad_r)`` bands and
    dispatches a band as soon as ``wave`` items wait (CUDA launches are
    asynchronous, so the card works while the host loads and stacks the
    next pairs). With ``banded=False`` (``HYPERSPACE_PIPELINE=0``) every
    item waits for ``finish()`` and dispatches as ONE wave at the global
    pads, which the banded path matches bit for bit.

    Before a wave dispatches, its padded footprint (``estimate(pads,
    items)``) is reserved on the device ledger; when it does not fit, the
    admission parks it and ``spill_one`` retires this join's oldest
    in-flight wave (``retire(wave)`` fetches its results, freeing its
    reservation). A ``_JoinDeclined`` from a spill's retire stops the
    scheduler (``declined``); any other error propagates."""

    def __init__(self, dispatch, ledger, estimate, retire, banded: bool = True,
                 wave: int = _JOIN_WAVE):
        self._dispatch = dispatch  # (pads, items) -> device record
        self._ledger = ledger  # plan/join_memory.DeviceLedger
        self._estimate = estimate  # (pads, items) -> wave footprint bytes
        self._retire = retire  # (_Wave) -> host results (the spill fetch)
        self.banded = banded
        self.wave = wave
        self._groups: dict = {}
        self._max_l = self._max_r = 0
        self.records: list[_Wave] = []
        self.declined: Optional[_JoinDeclined] = None
        self.spills = 0
        self._n_items = 0
        self._item_pads = 0  # the pad rows of every dispatched item

    def add(self, item, n_l: int, n_r: int) -> None:
        self._max_l = max(self._max_l, n_l)
        self._max_r = max(self._max_r, n_r)
        self._n_items += 1
        if not self.banded:
            self._groups.setdefault(None, []).append(item)
            return
        pads = _band_pads(n_l, n_r)
        group = self._groups.setdefault(pads, [])
        group.append(item)
        if len(group) >= self.wave:
            self._flush(pads, group)
            self._groups[pads] = []

    def spill_one(self) -> bool:
        """Retire this join's oldest in-flight wave: fetch its results to
        the host (its device buffers die with the record) and release its
        reservation. False when every dispatched wave is already retired."""
        for w in self.records:
            if w.done is None:
                with trace.span("join:spill", pad_l=w.pads[0], pad_r=w.pads[1],
                                buckets=len(w.items), bytes=w.nbytes):
                    w.done = self._retire(w)
                w.rec = None
                self.spills += 1
                REGISTRY.counter("join.spill.spills").inc()
                plan_stats.note_flag("spilled_waves")
                if w.nbytes:
                    self._ledger.release(w.nbytes)
                    w.nbytes = 0
                return True
        return False

    def release_reservations(self) -> None:
        """Return every outstanding reservation (after the final fetch)."""
        for w in self.records:
            if w.nbytes:
                self._ledger.release(w.nbytes)
                w.nbytes = 0

    def _flush(self, pads, items) -> None:
        if self.declined is not None or not items:
            return
        need = int(self._estimate(pads, items)) if self._ledger.enabled else 0
        try:
            # parks (spilling in-flight waves) instead of declining when the
            # wave does not fit
            self._ledger.admit(need, self.spill_one)
        except _JoinDeclined as e:
            self.declined = e
            return
        with trace.span("join:band", pad_l=pads[0], pad_r=pads[1], buckets=len(items)):
            rec = self._dispatch(pads, items)
        REGISTRY.counter("pipeline.join.bands").inc()
        self._item_pads += len(items) * (pads[0] + pads[1])
        self.records.append(_Wave(pads, items, rec, need))

    def finish(self) -> list:
        if self.banded:
            for pads in sorted(self._groups):
                self._flush(pads, self._groups[pads])
        elif self._groups.get(None):
            self._flush(_band_pads(self._max_l, self._max_r), self._groups[None])
        self._groups = {}
        if self.banded and self._n_items:
            # the pad rows banding avoided against one global pad
            saved = self._n_items * sum(_band_pads(self._max_l, self._max_r)) - self._item_pads
            if saved > 0:
                REGISTRY.counter("pipeline.join.pad_rows_saved").inc(saved)
        return self.records


def _build_plain_probe_kernel():
    """Lower/upper-bound probe of the sorted right keys for every left key:
    (starts, counts) per left row, int32. Pads in ``rk`` carry the dtype's
    maximum, so the real keys stay a sorted prefix; probes clamp to ``n_r``
    (a real key equal to the pad value would otherwise match pads).
    Counterpart of device_join._build_plain_probe_kernel."""

    def kernel(lk, rk, n_r: int):
        lo = torch.clamp(torch.searchsorted(rk, lk, out_int32=True), max=n_r)
        hi = torch.clamp(torch.searchsorted(rk, lk, right=True, out_int32=True), max=n_r)
        return lo, hi - lo

    return kernel


def _build_stacked_probe_kernel():
    """Per-bucket probe, exclusive pair offsets and overflow check over a
    whole band wave at once (``torch.searchsorted`` over the batched
    ``[items, pad]`` sorted keys replaces the reference's vmap). Returns
    (lo int32[W, pad_l], offs int32[W, pad_l], totals int64[W], ok
    bool[W]). ``offs[i]`` is the number of pairs before left row i; pads
    probe to an empty range and add nothing. The reference sums in int32
    and detects a wrap; here the sum is int64 and a bucket is ``ok`` while
    its total stays below 2^31, the same decision. Counterpart of
    device_join._build_stacked_probe_kernel."""

    def kernel(lk, rk, n_r, n_l):
        pad_l = lk.shape[1]
        idx = torch.arange(pad_l, dtype=torch.int32, device=lk.device)
        nr = n_r[:, None]
        lo = torch.minimum(torch.searchsorted(rk, lk, out_int32=True), nr)
        hi = torch.minimum(torch.searchsorted(rk, lk, right=True, out_int32=True), nr)
        cnt = torch.where(idx < n_l[:, None], hi - lo, 0)
        ends = torch.cumsum(cnt, 1, dtype=torch.int64)
        totals = ends[:, -1]
        return lo, (ends - cnt).to(torch.int32), totals, totals < 2**31

    return kernel


def _build_stacked_expand_kernel(out_pad: int):
    """Per-bucket run expansion over a band wave: pair j of item i belongs
    to left row li, the run whose ``[offs[li], offs[li] + cnt)`` holds j
    (``searchsorted(offs, j, right) - 1``; empty runs share their start
    with the next run, and the walk back lands on the non-empty one), and
    to right row ``lo[li] + (j - offs[li])``. Slots at or past the item's
    total hold 0. The fetch is then about the size of the join's output,
    not of its probe domain. Counterpart of
    device_join._build_stacked_expand_kernel."""

    def kernel(lo, offs, totals):
        w, pad_l = offs.shape
        j = torch.arange(out_pad, dtype=torch.int32, device=offs.device)
        jj = j.expand(w, out_pad).contiguous()
        i = torch.searchsorted(offs, jj, right=True, out_int32=True) - 1
        i = torch.clamp(i, 0, pad_l - 1).long()
        ri = torch.gather(lo, 1, i) + (jj - torch.gather(offs, 1, i))
        valid = j[None, :] < totals[:, None]
        return torch.where(valid, i.to(torch.int32), 0), torch.where(valid, ri, 0)

    return kernel


class _ProbeItem:
    """One stacked-probe band row: a whole bucket's sorted left keys, or one
    left chunk of an oversized (split) bucket. ``lo_ofs`` is the chunk's
    offset into the bucket's sorted left keys."""

    __slots__ = ("bucket", "lb", "rb", "lk32", "rk32", "lorder", "rorder",
                 "lk_src", "rk_src", "lo_ofs")

    def __init__(self, bucket, lb, rb, lk32, rk32, lorder, rorder, lk_src,
                 rk_src, lo_ofs=0):
        self.bucket = bucket
        self.lb = lb
        self.rb = rb
        self.lk32 = lk32
        self.rk32 = rk32
        self.lorder = lorder
        self.rorder = rorder
        self.lk_src = lk_src
        self.rk_src = rk_src
        self.lo_ofs = lo_ofs


def _split_probe_items(w, split: int):
    """One work tuple as probe items: the whole bucket, or left chunks of at
    most ``split`` rows when the bucket exceeds it (0 never splits)."""
    b, lb, rb, lk32, rk32, lorder, rorder, lk_src, rk_src = w
    n_l = len(lk32)
    if split and n_l > split:
        for c0 in range(0, n_l, split):
            yield _ProbeItem(b, lb, rb, lk32[c0:c0 + split], rk32, lorder, rorder,
                             lk_src, rk_src, lo_ofs=c0)
    else:
        yield _ProbeItem(b, lb, rb, lk32, rk32, lorder, rorder, lk_src, rk_src)


def _stack_band_keys(items, arr_attr: str, src_attr: str, pad: int, dt, pad_val,
                     session, device):
    """(keys [W, pad], lengths int32[W]) of one band wave on the device,
    cached by the identities of the ORIGINAL key buffers and the per-item
    derivation (chunk offset, length, sort flag): a repeat over the same
    index buffers uploads nothing."""
    srcs = tuple(getattr(it, src_attr) for it in items)
    left = arr_attr == "lk32"
    tag = (
        "jband", arr_attr, pad, dt.str,
        tuple(
            (it.lo_ofs, len(getattr(it, arr_attr)),
             (it.lorder is None) if left else (it.rorder is None))
            for it in items
        ),
        str(device),
    )

    def build():
        stack = np.full((len(items), pad), pad_val, dtype=dt)
        for i, it in enumerate(items):
            a = getattr(it, arr_attr)
            stack[i, : len(a)] = a
        lens = np.array([len(getattr(it, arr_attr)) for it in items], np.int32)
        return torch.from_numpy(stack).to(device), torch.from_numpy(lens).to(device)

    return session.device_cache.get_or_put(srcs, tag, build)


def try_batched_plain_join(work, residual, session, banded=None,
                           strategy=None) -> Optional[dict]:
    """Device plain join over MANY co-partitioned buckets: band-stacked
    probes, then band-stacked run expansions, with exactly TWO blocking
    fetches in all when no wave spills (the totals, then the pairs), each
    into pinned memory. Every probe wave reserves its padded footprint on
    the device ledger first; a wave that does not fit parks and spills
    earlier waves (their own two fetches) instead of declining.

    ``work`` is an iterable of ``(bucket, lb, rb, lk32_sorted, rk32_sorted,
    lorder, rorder, lk_src, rk_src)`` (bucket_join._prep_plain_work),
    consumed lazily: each item joins its band as it arrives and a full
    band wave dispatches its probe while the caller loads the next pairs.
    The src arrays are the ORIGINAL key buffers, whose identities key the
    device cache. ``strategy`` (plan/join_memory.JoinMemoryPlan) gives each
    bucket's split row count; None keeps ``join_split_rows()``.
    ``banded=None`` follows ``HYPERSPACE_PIPELINE``: ``0`` runs ONE wave at
    the global pads, unsplit, which the banded path matches bit for bit.

    Returns {bucket: joined ColumnBatch}, rows in the host merge join's
    order, or None when the join declines by data (counted in
    ``session.device_stats.declines``). A CUDA error raises."""
    from .join_memory import DeviceLedger

    ledger = DeviceLedger("join_plain")
    try:
        return _batched_plain_join_impl(work, residual, session, banded, strategy, ledger)
    finally:
        ledger.close()  # a decline or an error returns every reservation


def _batched_plain_join_impl(work, residual, session, banded, strategy,
                             ledger) -> Optional[dict]:
    from .gpu_exec import _decline, _pipeline_enabled, kernel_route
    from .kernel_cache import plain_join_fingerprint

    if banded is None:
        banded = _pipeline_enabled()
    device = session.device  # raises when CUDA was asked for and is absent
    route = kernel_route(device)
    cache = session.kernel_cache
    stats = session.device_stats
    st: dict = {"dt": None}
    probe = cache.get_or_build(plain_join_fingerprint(route, "stacked_probe"),
                               _build_stacked_probe_kernel, "join_stacked_probe")

    def dispatch_probe(pads, items):
        dt = st["dt"]
        pad_val = np.iinfo(dt).max if dt.kind == "i" else np.float32(np.inf)
        lk_d, n_l = _stack_band_keys(items, "lk32", "lk_src", pads[0], dt, pad_val,
                                     session, device)
        rk_d, n_r = _stack_band_keys(items, "rk32", "rk_src", pads[1], dt, pad_val,
                                     session, device)
        METER.record_dispatch()
        return probe(lk_d, rk_d, n_r, n_l)

    def expansion_plan(wave, totals, ok):
        """(totals, device pairs or None) of one wave from its fetched probe
        totals; raises _JoinDeclined on overflow or heavy skew."""
        if not ok.all():
            raise _JoinDeclined("plain_join_overflow")
        totals = [int(t) for t in totals]
        max_total = max(totals)
        if max_total == 0:
            return totals, None
        out_pad = _pow2(max_total)
        padded_bytes = len(wave.items) * out_pad * 8  # two int32 arrays
        if padded_bytes > 32 * 2**20 and padded_bytes > 4 * sum(totals) * 8:
            # one hot item would pad every row of the wave's readback
            raise _JoinDeclined("plain_join_skew")
        expand = cache.get_or_build(
            plain_join_fingerprint(route, "expand", out_pad),
            lambda: _build_stacked_expand_kernel(out_pad), "join_expand",
        )
        lo_d, offs_d, totals_d, _ok = wave.rec
        METER.record_dispatch()
        return totals, expand(lo_d, offs_d, totals_d)

    def est_probe(pads, items):
        # stacked key uploads and the probe's int32 outputs per left slot
        return len(items) * ((pads[0] + pads[1]) * st["dt"].itemsize + 2 * pads[0] * 4)

    def retire_probe(wave):
        # the spill of one parked admission: this wave's two fetches only
        totals, ok = _fetch_all([wave.rec[2], wave.rec[3]])
        stats.plain_join_fetches += 1
        totals, pairs = expansion_plan(wave, totals, ok)
        if pairs is None:
            return totals, None, None
        li, ri = _fetch_all(list(pairs))
        stats.plain_join_fetches += 1
        return totals, li, ri

    sched = _BandScheduler(dispatch_probe, ledger, est_probe, retire_probe, banded=banded)
    split_default = join_split_rows() if banded else 0
    total_left = n_splits = n_buckets = 0
    for w in work:
        if st["dt"] is None:
            st["dt"] = w[3].dtype
        elif w[3].dtype != st["dt"]:
            return _decline(session, "plain_join_key_dtype_varies")
        total_left += len(w[3])
        n_buckets += 1
        if strategy is not None:
            strategy.observe_actual(w[0], len(w[3]), _batch_data_nbytes(w[1]))
        split = strategy.split_rows(w[0]) if strategy is not None and banded \
            else split_default
        for item in _split_probe_items(w, split):
            if item.lo_ofs == 0 and split and len(w[3]) > split:
                n_splits += -(-len(w[3]) // split) - 1
            sched.add(item, len(item.lk32), len(item.rk32))
    records = sched.finish()
    stats.join_spills += sched.spills
    stats.join_waves += len(records)
    stats.join_splits += n_splits
    stats.join_parks += ledger.parks
    if sched.declined is not None:
        return _decline(session, sched.declined.reason)
    if not records:
        return None  # no occupied pair
    if total_left < _PLAIN_MIN_ROWS:
        return _decline(session, "plain_join_small")
    REGISTRY.counter("pipeline.join.buckets").inc(n_buckets)
    if n_splits:
        REGISTRY.counter("pipeline.join.splits").inc(n_splits)

    try:
        pending = [w for w in records if w.done is None]
        if pending:
            # fetch 1: every unspilled wave's totals and overflow flags
            with trace.span("join:probe", waves=len(pending)):
                flat = _fetch_all([t for w in pending for t in (w.rec[2], w.rec[3])])
            stats.plain_join_fetches += 1
            plans = [expansion_plan(w, flat[2 * i], flat[2 * i + 1])
                     for i, w in enumerate(pending)]
            # fetch 2: every wave's (li, ri) pairs
            with trace.span("join:fold", waves=sum(p is not None for _t, p in plans)), \
                    _attr.phase("fold"):
                pairs = _fetch_all([t for _tot, p in plans if p is not None for t in p])
            if pairs:
                stats.plain_join_fetches += 1
            k = 0
            for w, (totals, p) in zip(pending, plans):
                if p is None:
                    w.done = (totals, None, None)
                else:
                    w.done = (totals, pairs[k], pairs[k + 1])
                    k += 2
                w.rec = None
    except _JoinDeclined as e:
        return _decline(session, e.reason)
    sched.release_reservations()

    # host: gather both sides' columns per bucket, in their original dtypes
    chunks_by_bucket: dict[int, list] = {}
    info_by_bucket: dict[int, _ProbeItem] = {}
    for wave in records:
        totals, li_np, ri_np = wave.done
        for i, it in enumerate(wave.items):
            info_by_bucket.setdefault(it.bucket, it)
            t = totals[i]
            if t == 0:
                continue
            li = li_np[i, :t].astype(np.int64) + it.lo_ofs
            ri = ri_np[i, :t].astype(np.int64)
            chunks_by_bucket.setdefault(it.bucket, []).append((it.lo_ofs, li, ri))
    parts: dict[int, ColumnBatch] = {}
    for b, chunks in chunks_by_bucket.items():
        it = info_by_bucket[b]
        chunks.sort(key=lambda c: c[0])  # chunk order = sorted left order
        li = np.concatenate([c[1] for c in chunks])
        ri = np.concatenate([c[2] for c in chunks])
        if it.lorder is not None:
            li = it.lorder[li]
        if it.rorder is not None:
            ri = it.rorder[ri]
        out = {nm: c.take(li) for nm, c in it.lb.columns.items()}
        out.update({nm: c.take(ri) for nm, c in it.rb.columns.items()})
        joined = ColumnBatch(out)
        for r in residual:
            joined = joined.filter(np.asarray(r.eval(joined).data, dtype=bool))
        parts[b] = joined
    return parts


def try_device_plain_join(lb: ColumnBatch, rb: ColumnBatch, lkeys: Sequence[str],
                          rkeys: Sequence[str], session, l_sorted: bool,
                          r_sorted: bool) -> Optional[ColumnBatch]:
    """One bucket pair's plain join with the probe on the device (the
    per-bucket route, after the batched join declined or for a fused
    aggregate's declined bucket): per-left-row lower bounds and counts over
    the sorted right keys in one fetch; the host expands the runs and
    gathers both sides in their original dtypes, so the rows equal the
    host merge join's, order included. None when the pair is too small or
    its keys do not ship exactly (the host merge join runs)."""
    from ..ops.join import exact_key32

    if len(lkeys) != 1 or session is None or not session.conf.exec_device_enabled:
        return None
    if lb.num_rows < _PLAIN_MIN_ROWS or rb.num_rows == 0:
        return None
    lk_col, rk_col = lb.column(lkeys[0]), rb.column(rkeys[0])
    if lk_col.dtype == STRING or rk_col.dtype == STRING:
        return None
    if lk_col.validity is not None or rk_col.validity is not None:
        return None
    lk32, rk32 = exact_key32(lk_col.data), exact_key32(rk_col.data)
    if lk32 is None or rk32 is None or lk32.dtype != rk32.dtype:
        return None
    return _device_plain_join_inner(lb, rb, lk32, rk32, lk_col.data, rk_col.data,
                                    l_sorted, r_sorted, session)


def _sorted_padded_keys(k32: np.ndarray, src: np.ndarray, is_sorted: bool, pad: int,
                        session, device):
    """(order or None, device copy of the sorted keys padded with the
    dtype's maximum). The argsort and the upload are cached on the SOURCE
    column's buffer identity, so a repeat skips the sort and the transfer."""
    pad_val = np.iinfo(k32.dtype).max if k32.dtype.kind == "i" else np.float32(np.inf)
    order = None
    if not is_sorted:
        # exact_key32 preserves order, so the argsort of the 32-bit keys is
        # the source column's
        order = session.host_derived_cache.get_or_put(
            (src,), ("jorder",), lambda: np.argsort(k32, kind="stable"))

    def build():
        out = np.full(pad, pad_val, dtype=k32.dtype)
        out[: len(k32)] = k32 if order is None else k32[order]
        return torch.from_numpy(out).to(device)

    keys_d = session.device_cache.get_or_put(
        (src,), ("jkey", pad, is_sorted, str(device)), build)
    return order, keys_d


def _device_plain_join_inner(lb, rb, lk32, rk32, lk_src, rk_src, l_sorted: bool,
                             r_sorted: bool, session) -> ColumnBatch:
    from ..ops.join import expand_runs
    from .gpu_exec import kernel_route
    from .kernel_cache import plain_join_fingerprint

    device = session.device
    n_l, n_r = len(lk32), len(rk32)
    # probe in left-sorted order so the pairs come out in the host merge
    # join's order (the host sorts the left side first)
    lorder, lk_d = _sorted_padded_keys(lk32, lk_src, l_sorted, _pow2(n_l), session, device)
    rorder, rk_d = _sorted_padded_keys(rk32, rk_src, r_sorted, _pow2(n_r), session, device)
    probe = session.kernel_cache.get_or_build(
        plain_join_fingerprint(kernel_route(device), "probe"), _build_plain_probe_kernel,
        "join_probe")
    METER.record_dispatch()
    lo, cnt = _fetch_all(list(probe(lk_d, rk_d, n_r)))
    starts = lo[:n_l].astype(np.int64)
    counts = cnt[:n_l].astype(np.int64)
    li = np.repeat(np.arange(n_l, dtype=np.int64), counts)
    ri = expand_runs(starts, counts)
    if lorder is not None:
        li = lorder[li]
    if rorder is not None:
        ri = rorder[ri]
    out = {n: c.take(li) for n, c in lb.columns.items()}
    out.update({n: c.take(ri) for n, c in rb.columns.items()})
    return ColumnBatch(out)
