"""Sketch predicate converters (counterpart of the parts of
hyperspace_tpu/models/dataskipping/sketches.py that pruning needs:
``_is_col_lit`` and ``MinMaxSketch.convert_predicate``).

A converter turns one predicate leaf into a keep-mask over a small sketch
table, one row per file or row group, with ``<col>__min`` and
``<col>__max`` columns. A row is dropped only when its range cannot hold a
matching value.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ...columnar.table import ColumnBatch, STRING
from ...plan import expr as X
from ...plan.expr import Expr

# a predicate over the sketch table: batch (one row per unit) -> keep mask
SketchPredicate = Callable[[ColumnBatch], np.ndarray]

_FLIP = {X.Lt: X.Gt, X.Le: X.Ge, X.Gt: X.Lt, X.Ge: X.Le, X.Eq: X.Eq, X.Ne: X.Ne}


def _is_col_lit(pred: Expr, col_name: str) -> Optional[tuple[type, Any]]:
    """Match ``col <op> literal`` or ``literal <op> col`` on ``col_name``
    (case-insensitive); (op type as seen from the column, literal value)."""
    if isinstance(pred, tuple(_FLIP)):
        left, right = pred.left, pred.right
        low = col_name.lower()
        if isinstance(left, X.Col) and isinstance(right, X.Lit) and left.name.lower() == low:
            return type(pred), right.value
        if isinstance(right, X.Col) and isinstance(left, X.Lit) and right.name.lower() == low:
            return _FLIP[type(pred)], left.value
    return None


class MinMaxSketch:
    """Per-unit min and max of one column."""

    kind = "MinMaxSketch"

    def __init__(self, expr: str):
        self.expr = expr

    def output_columns(self) -> list[str]:
        return [f"{self.expr}__min", f"{self.expr}__max"]

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        """Eq, Ne, Lt, Le, Gt, Ge against a literal and IN; None for any
        other shape (it cannot bound the predicate)."""
        lo_name, hi_name = self.output_columns()

        def cols(batch):
            lo, hi = batch.column(lo_name), batch.column(hi_name)
            if lo.dtype == STRING:
                return (np.asarray(lo.decode(), dtype=object).astype(str),
                        np.asarray(hi.decode(), dtype=object).astype(str))
            return lo.data, hi.data

        m = _is_col_lit(pred, self.expr)
        if m is not None:
            op, v = m
            if op is X.Eq:
                return lambda b: (lambda lo, hi: (lo <= v) & (hi >= v))(*cols(b))
            if op is X.Ne:  # only a unit whose every value equals v drops
                return lambda b: (lambda lo, hi: ~((lo == v) & (hi == v)))(*cols(b))
            if op is X.Lt:
                return lambda b: cols(b)[0] < v
            if op is X.Le:
                return lambda b: cols(b)[0] <= v
            if op is X.Gt:
                return lambda b: cols(b)[1] > v
            if op is X.Ge:
                return lambda b: cols(b)[1] >= v
        if (isinstance(pred, X.In) and isinstance(pred.child, X.Col)
                and pred.child.name.lower() == self.expr.lower()):
            values = np.asarray(sorted(pred.values))

            def in_mask(b):
                lo, hi = cols(b)
                # the least value >= lo must also be <= hi
                idx = np.clip(np.searchsorted(values, lo, side="left"), 0, len(values) - 1)
                return (values[idx] >= lo) & (values[idx] <= hi)

            return in_mask
        return None

    def __repr__(self):
        return f"MinMax({self.expr})"
