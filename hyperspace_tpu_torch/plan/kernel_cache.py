"""Cross-query kernel cache (counterpart of hyperspace_tpu/plan/kernel_cache.py).

A device-tier "kernel" is the closure that runs one fragment's body over
device columns: the filter, projections and aggregates, routed through the
hand-written CUDA kernels where the fragment's shape allows. It is keyed by
a canonical fingerprint of the fragment (route, expressions, device dtypes,
shape constants), so a repeated query template reuses its closure. The
route ("cuda" or "plain") is part of the key, because it is decided when
the closure is built.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable


def dtype_signature(dev_cols: dict) -> tuple:
    """Canonical (name, dtype) signature of an upload dict, order-free; a
    Wide64 word pair (a tuple of two tensors) is "wide64", so its kernel
    never serves a narrowed upload of the column."""
    return tuple(sorted((n, "wide64" if isinstance(a, tuple) else str(a.dtype))
                        for n, a in dev_cols.items()))


class KernelCache:
    """Bounded LRU of built kernels."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = maxlen
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get_or_build(self, key, builder: Callable):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        kernel = builder()
        with self._lock:
            self._d[key] = kernel
            while len(self._d) > self.maxlen:
                self._d.popitem(last=False)
        return kernel


def fused_fingerprint(route: str, pred_expr, proj_exprs, agg_list, dev_cols: dict) -> tuple:
    """Global filter-aggregate kernel."""
    return (
        route,
        repr(pred_expr),
        tuple((n, repr(e)) for n, e in proj_exprs),
        tuple((k, repr(c)) for k, c in agg_list),
        dtype_signature(dev_cols),
    )


def grouped_fingerprint(route: str, seg_pad: int, pred_expr, proj_exprs, agg_list,
                        dev_cols: dict) -> tuple:
    """Grouped kernel (seg_pad is baked into the body)."""
    return (
        "grouped",
        route,
        seg_pad,
        repr(pred_expr),
        tuple((nm, repr(e)) for nm, e in proj_exprs),
        tuple((k, repr(c)) for k, c in agg_list),
        dtype_signature(dev_cols),
    )


def join_fingerprint(route: str, key_dtype: str, agg_list, residual, lfilters, rfilters,
                     col_sig: tuple) -> tuple:
    """Fused join+aggregate body of plan/device_join.py."""
    return (
        "join_agg",
        route,
        key_dtype,
        tuple((k, repr(c)) for k, c in agg_list),
        tuple(repr(r) for r in residual),
        tuple(repr(f) for f in lfilters),
        tuple(repr(f) for f in rfilters),
        col_sig,
    )


def plain_join_fingerprint(route: str, kind: str, *shape) -> tuple:
    """Plain-join bodies of plan/device_join.py: the per-bucket probe
    ("probe"), the band-stacked probe ("stacked_probe") and the run
    expansion ("expand", with its baked output pad)."""
    return ("plain_join", kind, route) + tuple(shape)


def order_fingerprint(route: str, kind: str, *params) -> tuple:
    """Device top-k ("topk": k, direction, key dtype) and sort ("sort":
    number of key words) bodies of plan/gpu_exec.py."""
    return ("order", kind, route) + tuple(params)
