"""Sketches: per-unit summaries for data skipping (counterpart of
hyperspace_tpu/models/dataskipping/sketches.py).

A unit is a source file (the data-skipping index) or a row group of an
index data file (the sidecar sketch store, and row-group pruning over
footer statistics). A sketch aggregates each unit's rows into a few
columns of a small sketch table, one row per unit. At query time it
converts one predicate leaf into a keep-mask over that table: a unit is
dropped only when it cannot hold a matching row. ``convert_predicate``
returns None when the sketch cannot bound the leaf; the index composes
leaves (And, Or) itself.

Sketch kinds and their to_dict forms are part of the on-disk log entry
and are shared with the JAX package; bloom bits are hashed exactly as
there (ops/sketch.py).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ...columnar.table import Column, ColumnBatch, STRING
from ...exceptions import HyperspaceError
from ...ops.sketch import BloomFilter, segment_min_max_np
from ...plan import expr as X
from ...plan.expr import Expr

# a predicate over the sketch table: batch (one row per unit) -> keep mask
SketchPredicate = Callable[[ColumnBatch], np.ndarray]

_FLIP = {X.Lt: X.Gt, X.Le: X.Ge, X.Gt: X.Lt, X.Ge: X.Le, X.Eq: X.Eq, X.Ne: X.Ne}

SKETCH_REGISTRY: dict[str, Callable[[dict], "Sketch"]] = {}


def register_sketch(kind: str, loader: Callable[[dict], "Sketch"]) -> None:
    SKETCH_REGISTRY[kind] = loader


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


def _is_col_in(pred: Expr, col_name: str) -> bool:
    return (isinstance(pred, X.In) and isinstance(pred.child, X.Col)
            and pred.child.name.lower() == col_name.lower())


def _segments(segment_ids: np.ndarray, num_segments: int):
    """(order, bounds): rows of segment s are order[bounds[s]:bounds[s+1]]."""
    order = np.argsort(segment_ids, kind="stable")
    return order, np.searchsorted(segment_ids[order], np.arange(num_segments + 1))


def _range_converter(op, v, cols) -> Optional[SketchPredicate]:
    """Keep-mask of a [lo, hi] range per unit against ``col <op> v``;
    ``cols(batch)`` gives (lo, hi)."""
    if op is X.Eq:
        return lambda b: (lambda lo, hi: (lo <= v) & (hi >= v))(*cols(b))
    if op is X.Lt:
        return lambda b: cols(b)[0] < v
    if op is X.Le:
        return lambda b: cols(b)[0] <= v
    if op is X.Gt:
        return lambda b: cols(b)[1] > v
    if op is X.Ge:
        return lambda b: cols(b)[1] >= v
    return None


def _in_range_converter(values: Sequence, cols) -> SketchPredicate:
    """IN: the least value >= lo must also be <= hi."""
    arr = np.asarray(sorted(values))

    def in_mask(b):
        lo, hi = cols(b)
        idx = np.clip(np.searchsorted(arr, lo, side="left"), 0, len(arr) - 1)
        return (arr[idx] >= lo) & (arr[idx] <= hi)

    return in_mask


class Sketch:
    kind = "?"

    @property
    def expr(self) -> str:
        """The source column this sketch summarizes."""
        raise NotImplementedError

    def indexed_columns(self) -> list[str]:
        return [self.expr]

    def referenced_columns(self) -> list[str]:
        return [self.expr]

    def output_columns(self) -> list[str]:
        raise NotImplementedError

    def aggregate(self, values: Column, segment_ids: np.ndarray,
                  num_segments: int) -> dict[str, Column]:
        """The per-unit aggregation (a segment reduce)."""
        raise NotImplementedError

    def aggregate_batch(self, batch: ColumnBatch, segment_ids: np.ndarray,
                        num_segments: int) -> dict[str, Column]:
        """Batch-level aggregation (the sidecar store's build path); a
        multi-column sketch overrides it."""
        return self.aggregate(batch.column(self.expr), segment_ids, num_segments)

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash((self.kind, self.expr))


class _SingleColumnSketch(Sketch):
    def __init__(self, expr: str):
        self._expr = expr

    @property
    def expr(self) -> str:
        return self._expr

    def to_dict(self) -> dict:
        return {"kind": self.kind, "expr": self._expr}

    @classmethod
    def from_dict(cls, d: dict):
        return cls(d["expr"])


class MinMaxSketch(_SingleColumnSketch):
    """Per-unit min and max of one column."""

    kind = "MinMaxSketch"

    def output_columns(self) -> list[str]:
        return [f"{self._expr}__min", f"{self._expr}__max"]

    def aggregate(self, values, segment_ids, num_segments):
        if values.dtype == STRING:
            # order-correct codes against a sorted vocabulary, then the
            # extremes decode through it
            vals = np.asarray(values.decode(), dtype=object)
            valid = values.validity if values.validity is not None else np.ones(len(vals), bool)
            vals = np.where(valid, vals, "").astype(str)
            vocab, codes = np.unique(vals, return_inverse=True)
            mins, maxs = segment_min_max_np(codes.astype(np.int64), segment_ids, num_segments)
            mn = Column(mins.astype(np.int32), STRING, None, list(vocab))
            mx = Column(maxs.astype(np.int32), STRING, None, list(vocab))
        else:
            mins, maxs = segment_min_max_np(values.data, segment_ids, num_segments)
            mn, mx = Column(mins, values.dtype), Column(maxs, values.dtype)
        lo, hi = self.output_columns()
        return {lo: mn, hi: mx}

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        """Eq, Ne, Lt, Le, Gt, Ge against a literal and IN; None for any
        other shape."""
        lo_name, hi_name = self.output_columns()

        def cols(batch):
            lo, hi = batch.column(lo_name), batch.column(hi_name)
            if lo.dtype == STRING:
                return (np.asarray(lo.decode(), dtype=object).astype(str),
                        np.asarray(hi.decode(), dtype=object).astype(str))
            return lo.data, hi.data

        m = _is_col_lit(pred, self._expr)
        if m is not None:
            op, v = m
            if op is X.Ne:  # only a unit whose every value equals v drops
                return lambda b: (lambda lo, hi: ~((lo == v) & (hi == v)))(*cols(b))
            return _range_converter(op, v, cols)
        if _is_col_in(pred, self._expr):
            return _in_range_converter(pred.values, cols)
        return None

    def __repr__(self):
        return f"MinMax({self._expr})"


class BloomFilterSketch(Sketch):
    """A bloom filter of each unit's values: Eq and IN probes."""

    kind = "BloomFilterSketch"

    def __init__(self, expr: str, expected_distinct: int = 10000, fpp: float = 0.01):
        self._expr = expr
        self.expected_distinct = int(expected_distinct)
        self.fpp = float(fpp)

    @property
    def expr(self) -> str:
        return self._expr

    def output_columns(self) -> list[str]:
        return [f"{self._expr}__bloom"]

    @staticmethod
    def _canonical_words(col: Column) -> list[np.ndarray]:
        """Hash words independent of storage width (build and probe may see
        one value as int32 and int64, or f32 and f64): integers, dates and
        bools widen to int64, floats to float64; strings hash by value."""
        from ...ops.bucketize import key_hash_words

        if col.dtype == STRING:
            return [key_hash_words(col)]
        if col.data.dtype.kind == "f":
            return [col.data.astype(np.float64)]
        return [col.data.astype(np.int64)]

    def aggregate(self, values, segment_ids, num_segments):
        order, bounds = _segments(segment_ids, num_segments)
        blooms = []
        for s in range(num_segments):
            rows = order[bounds[s]: bounds[s + 1]]
            bf = BloomFilter.create(self.expected_distinct, self.fpp)
            if len(rows):
                bf.add_words(self._canonical_words(values.take(rows)))
            blooms.append(json.dumps(bf.to_dict()))
        return {self.output_columns()[0]: Column.from_values(blooms)}

    def _decoded_filters(self, batch: ColumnBatch) -> list[BloomFilter]:
        """Per-unit filters, decoded once per sketch-table batch (the json
        and base64 decode is the cost of repeated planning)."""
        cache = batch.__dict__.setdefault("_bloom_cache", {})
        name = self.output_columns()[0]
        filters = cache.get(name)
        if filters is None:
            filters = [BloomFilter.from_dict(json.loads(blob))
                       for blob in batch.column(name).decode()]
            cache[name] = filters
        return filters

    def _probe(self, batch: ColumnBatch, values: list[Any]) -> np.ndarray:
        words = self._canonical_words(Column.from_values(values))
        filters = self._decoded_filters(batch)
        out = np.zeros(len(filters), dtype=bool)
        for i, bf in enumerate(filters):
            out[i] = bool(bf.might_contain_words(words).any())
        return out

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        m = _is_col_lit(pred, self._expr)
        if m is not None and m[0] is X.Eq:
            v = m[1]
            return lambda b: self._probe(b, [v])
        if _is_col_in(pred, self._expr):
            values = list(pred.values)
            return lambda b: self._probe(b, values)
        return None

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "expr": self._expr,
            "expectedDistinctCountPerFile": self.expected_distinct,
            "fpp": self.fpp,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BloomFilterSketch":
        return cls(d["expr"], d.get("expectedDistinctCountPerFile", 10000), d.get("fpp", 0.01))

    def __repr__(self):
        return f"BloomFilter({self._expr})"


class ValueListSketch(_SingleColumnSketch):
    """Each unit's distinct values (up to MAX_VALUES, else unbounded):
    exact membership skipping for low-cardinality columns."""

    kind = "ValueListSketch"
    MAX_VALUES = 256

    def output_columns(self) -> list[str]:
        return [f"{self._expr}__values"]

    def aggregate(self, values, segment_ids, num_segments):
        decoded = values.decode() if values.dtype == STRING else values.data
        order, bounds = _segments(segment_ids, num_segments)
        out = []
        for s in range(num_segments):
            vals = decoded[order[bounds[s]: bounds[s + 1]]]
            uniq = np.unique(np.asarray(vals, dtype=object).astype(str)
                             if values.dtype == STRING else vals)
            if len(uniq) > self.MAX_VALUES:
                out.append("")  # too many: unbounded for this unit
            else:
                out.append(json.dumps([v.item() if hasattr(v, "item") else v for v in uniq]))
        return {self.output_columns()[0]: Column.from_values(out)}

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        name = self.output_columns()[0]

        def match(b: ColumnBatch, values: list) -> np.ndarray:
            blobs = b.column(name).decode()
            out = np.ones(len(blobs), dtype=bool)
            for i, blob in enumerate(blobs):
                if blob:  # an unbounded unit is kept
                    unit_vals = set(json.loads(blob))
                    out[i] = any(v in unit_vals for v in values)
            return out

        m = _is_col_lit(pred, self._expr)
        if m is not None and m[0] is X.Eq:
            return lambda b: match(b, [m[1]])
        if _is_col_in(pred, self._expr):
            return lambda b: match(b, list(pred.values))
        return None

    def __repr__(self):
        return f"ValueList({self._expr})"


class PartitionSketch(_SingleColumnSketch):
    """Each file's partition value (constant within a file)."""

    kind = "PartitionSketch"

    def output_columns(self) -> list[str]:
        return [f"{self._expr}__part"]

    def aggregate(self, values, segment_ids, num_segments):
        # the first value per segment; an empty segment is NULL rather
        # than a neighbour's value
        if len(values) == 0:
            data = np.zeros(num_segments, dtype=values.data.dtype)
            return {self.output_columns()[0]: Column(
                data, values.dtype, np.zeros(num_segments, bool), values.dictionary)}
        order, bounds = _segments(segment_ids, num_segments)
        non_empty = bounds[1:] > bounds[:-1]
        idx = np.where(non_empty, np.clip(bounds[:-1], 0, len(order) - 1), 0)
        firsts = values.take(order[idx])
        if not non_empty.all():
            firsts = Column(firsts.data, firsts.dtype, non_empty, firsts.dictionary)
        return {self.output_columns()[0]: firsts}

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        name = self.output_columns()[0]

        def vals(b: ColumnBatch):
            c = b.column(name)
            if c.dtype == STRING:
                return np.asarray(c.decode(), dtype=object).astype(str)
            return c.data

        m = _is_col_lit(pred, self._expr)
        if m is not None:
            op, v = m
            fns = {
                X.Eq: lambda a: a == v, X.Ne: lambda a: a != v,
                X.Lt: lambda a: a < v, X.Le: lambda a: a <= v,
                X.Gt: lambda a: a > v, X.Ge: lambda a: a >= v,
            }
            f = fns.get(op)
            if f is not None:
                return lambda b: np.asarray(f(vals(b)), dtype=bool)
        if _is_col_in(pred, self._expr):
            values = list(pred.values)
            return lambda b: np.isin(vals(b), np.asarray(values))
        return None

    def __repr__(self):
        return f"Partition({self._expr})"


class ZRegionSketch(Sketch):
    """Per-unit bounding box over several numeric columns: a multi-column
    range conjunction keeps a unit only when the query's box meets it.
    Columns correlated with a bucket's sort order cluster into narrow
    per-row-group boxes."""

    kind = "ZRegionSketch"

    def __init__(self, exprs: Sequence[str]):
        if not exprs:
            raise HyperspaceError("ZRegionSketch requires at least one column")
        self._exprs = [str(e) for e in exprs]

    @property
    def expr(self) -> str:
        return ",".join(self._exprs)

    def indexed_columns(self) -> list[str]:
        return list(self._exprs)

    def referenced_columns(self) -> list[str]:
        return list(self._exprs)

    def output_columns(self) -> list[str]:
        out = []
        for c in self._exprs:
            out += [f"{c}__rlo", f"{c}__rhi"]
        return out

    def aggregate(self, values, segment_ids, num_segments):
        raise HyperspaceError(
            "ZRegionSketch aggregates whole batches (aggregate_batch); it is "
            "not usable as a single-column DataSkippingIndex sketch"
        )

    def aggregate_batch(self, batch, segment_ids, num_segments):
        out: dict[str, Column] = {}
        for c in self._exprs:
            col = batch.column(c)
            if col.dtype == STRING:
                raise HyperspaceError(f"ZRegionSketch column {c!r} is a string column")
            # a NULL row carries the fill value: it can only widen the box
            mins, maxs = segment_min_max_np(col.data, segment_ids, num_segments)
            out[f"{c}__rlo"] = Column(mins, col.dtype)
            out[f"{c}__rhi"] = Column(maxs, col.dtype)
        return out

    def convert_predicate(self, pred: Expr) -> Optional[SketchPredicate]:
        for c in self._exprs:
            def cols(batch, lo_name=f"{c}__rlo", hi_name=f"{c}__rhi"):
                return batch.column(lo_name).data, batch.column(hi_name).data

            m = _is_col_lit(pred, c)
            if m is not None:
                op, v = m
                if isinstance(v, str):
                    return None  # a string literal against a numeric box
                return _range_converter(op, v, cols)
            if _is_col_in(pred, c):
                if any(isinstance(v, str) for v in pred.values):
                    return None
                return _in_range_converter(pred.values, cols)
        return None

    def to_dict(self) -> dict:
        return {"kind": self.kind, "exprs": list(self._exprs)}

    @classmethod
    def from_dict(cls, d: dict) -> "ZRegionSketch":
        return cls(d["exprs"])

    def __repr__(self):
        return f"ZRegion({self.expr})"


for _cls in (MinMaxSketch, ZRegionSketch, BloomFilterSketch, ValueListSketch,
             PartitionSketch):
    register_sketch(_cls.kind, _cls.from_dict)


def sketch_from_dict(d: dict) -> Sketch:
    loader = SKETCH_REGISTRY.get(d.get("kind"))
    if loader is None:
        raise HyperspaceError(f"Unknown sketch kind: {d.get('kind')!r}")
    return loader(d)
