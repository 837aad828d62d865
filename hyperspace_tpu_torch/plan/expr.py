"""Expression IR for the query frontend and rewrite rules.

Counterpart of hyperspace_tpu/plan/expr.py: column refs, literals,
arithmetic, comparisons, boolean logic, null tests, IN, aliases, and
aggregate functions. Expressions evaluate host-side over ColumnBatch (numpy
vectorized); the device tier (plan/gpu_exec.py) compiles them to torch ops
over padded device columns instead.

Null semantics follow SQL three-valued logic collapsed to two at the filter
boundary (a NULL predicate result does not pass the filter), matching how the
reference's rewrites rely on Spark behavior.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from ..columnar.table import Column, ColumnBatch, STRING
from ..exceptions import HyperspaceError


class Expr:
    def references(self) -> set[str]:
        refs: set[str] = set()
        for c in self.children():
            refs |= c.references()
        return refs

    def children(self) -> list["Expr"]:
        return []

    def eval(self, batch: ColumnBatch) -> Column:
        raise NotImplementedError

    # --- operator sugar ---
    def __eq__(self, other):  # type: ignore[override]
        return Eq(self, _wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return Ne(self, _wrap(other))

    def __lt__(self, other):
        return Lt(self, _wrap(other))

    def __le__(self, other):
        return Le(self, _wrap(other))

    def __gt__(self, other):
        return Gt(self, _wrap(other))

    def __ge__(self, other):
        return Ge(self, _wrap(other))

    def __add__(self, other):
        return Add(self, _wrap(other))

    def __sub__(self, other):
        return Sub(self, _wrap(other))

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    def __truediv__(self, other):
        return Div(self, _wrap(other))

    def __and__(self, other):
        return And(self, _wrap(other))

    def __or__(self, other):
        return Or(self, _wrap(other))

    def __invert__(self):
        return Not(self)

    def __hash__(self):
        return hash(repr(self))

    def is_null(self):
        return IsNull(self)

    def is_not_null(self):
        return IsNotNull(self)

    def isin(self, values: Iterable[Any]):
        return In(self, list(values))

    def alias(self, name: str):
        return Alias(self, name)

    def semantic_eq(self, other: "Expr") -> bool:
        return repr(self) == repr(other)


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def references(self) -> set[str]:
        return {self.name}

    def eval(self, batch: ColumnBatch) -> Column:
        return batch.column(self.name)

    def __repr__(self):
        return self.name


class Lit(Expr):
    def __init__(self, value: Any):
        self.value = value

    def eval(self, batch: ColumnBatch) -> Column:
        n = batch.num_rows
        v = self.value
        if v is None:
            return Column(np.zeros(n, dtype=np.int32), "int32", np.zeros(n, dtype=bool))
        if isinstance(v, bool):
            return Column(np.full(n, v, dtype=np.bool_), "bool")
        if isinstance(v, int):
            return Column(np.full(n, v, dtype=np.int64), "int64")
        if isinstance(v, float):
            return Column(np.full(n, v, dtype=np.float64), "float64")
        if isinstance(v, str):
            return Column(np.zeros(n, dtype=np.int32), STRING, None, [v])
        raise HyperspaceError(f"Unsupported literal: {v!r}")

    def __repr__(self):
        return repr(self.value)


class Alias(Expr):
    def __init__(self, child: Expr, name: str):
        self.child = child
        self.name = name

    def children(self):
        return [self.child]

    def eval(self, batch: ColumnBatch) -> Column:
        return self.child.eval(batch)

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


# ---------------------------------------------------------------------------
# helpers for mixed-type numpy evaluation
# ---------------------------------------------------------------------------

def _compare(op, a: Column, b: Column) -> np.ndarray:
    """``op`` over two columns. Strings compare by their ranks in the sorted
    union of the two dictionaries, so no row decodes to a Python string."""
    if a.dtype != STRING and b.dtype != STRING:
        return op(a.data, b.data)
    if a.dtype != STRING or b.dtype != STRING:
        raise HyperspaceError("Cannot compare string with non-string")
    da = np.asarray(a.dictionary, dtype=object).astype(str)
    db = np.asarray(b.dictionary, dtype=object).astype(str)
    union = np.unique(np.concatenate([da, db]))
    # the smallest integer type that holds a rank keeps the row gathers narrow
    rank_t = np.min_scalar_type(len(union))
    ra = np.searchsorted(union, da).astype(rank_t)
    rb = np.searchsorted(union, db).astype(rank_t)
    return op(ra[a.data], rb[b.data])


def _combine_validity(*cols: Column):
    masks = [c.validity for c in cols if c.validity is not None]
    if not masks:
        return None
    out = masks[0].copy()
    for m in masks[1:]:
        out &= m
    return out


class _Binary(Expr):
    symbol = "?"

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    def children(self):
        return [self.left, self.right]

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class _Comparison(_Binary):
    """Comparisons follow SQL three-valued logic: a NULL operand yields an
    UNKNOWN result, carried as the output column's validity mask (data is
    forced False at unknown positions so downstream ops never read garbage).
    The filter boundary collapses UNKNOWN to 'row excluded'."""

    op = None  # numpy ufunc

    def eval(self, batch: ColumnBatch) -> Column:
        a = self.left.eval(batch)
        b = self.right.eval(batch)
        data = np.asarray(_compare(self.op, a, b), dtype=np.bool_)
        validity = _combine_validity(a, b)
        if validity is not None:
            data = data & validity
        return Column(data, "bool", validity)


class Eq(_Comparison):
    symbol = "="
    op = staticmethod(np.equal)


class Ne(_Comparison):
    symbol = "!="
    op = staticmethod(np.not_equal)


class Lt(_Comparison):
    symbol = "<"
    op = staticmethod(np.less)


class Le(_Comparison):
    symbol = "<="
    op = staticmethod(np.less_equal)


class Gt(_Comparison):
    symbol = ">"
    op = staticmethod(np.greater)


class Ge(_Comparison):
    symbol = ">="
    op = staticmethod(np.greater_equal)


class _Arithmetic(_Binary):
    op = None

    def eval(self, batch: ColumnBatch) -> Column:
        a = self.left.eval(batch)
        b = self.right.eval(batch)
        if STRING in (a.dtype, b.dtype):
            raise HyperspaceError(f"Arithmetic on string column: {self!r}")
        data = self.op(a.data, b.data)
        dtype = str(data.dtype) if str(data.dtype) in (
            "int8", "int16", "int32", "int64", "float32", "float64", "bool"
        ) else "float64"
        return Column(data, dtype, _combine_validity(a, b))


class Add(_Arithmetic):
    symbol = "+"
    op = staticmethod(np.add)


class Sub(_Arithmetic):
    symbol = "-"
    op = staticmethod(np.subtract)


class Mul(_Arithmetic):
    symbol = "*"
    op = staticmethod(np.multiply)


class Div(_Arithmetic):
    symbol = "/"
    op = staticmethod(np.true_divide)


def _bool_parts(c: Column):
    data = np.asarray(c.data, dtype=np.bool_)
    valid = c.validity if c.validity is not None else np.ones(len(data), dtype=bool)
    return data, valid


class And(_Binary):
    symbol = "AND"

    def eval(self, batch: ColumnBatch) -> Column:
        # Kleene AND: known when both known, or either side is a known False.
        ad, av = _bool_parts(self.left.eval(batch))
        bd, bv = _bool_parts(self.right.eval(batch))
        valid = (av & bv) | (av & ~ad) | (bv & ~bd)
        data = ad & bd & valid
        return Column(data, "bool", None if valid.all() else valid)


class Or(_Binary):
    symbol = "OR"

    def eval(self, batch: ColumnBatch) -> Column:
        # Kleene OR: known when both known, or either side is a known True.
        ad, av = _bool_parts(self.left.eval(batch))
        bd, bv = _bool_parts(self.right.eval(batch))
        valid = (av & bv) | (av & ad) | (bv & bd)
        data = (ad | bd) & valid
        return Column(data, "bool", None if valid.all() else valid)


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self):
        return [self.child]

    def eval(self, batch: ColumnBatch) -> Column:
        # Kleene NOT: UNKNOWN stays UNKNOWN.
        d, v = _bool_parts(self.child.eval(batch))
        return Column(~d & v, "bool", None if v.all() else v)

    def __repr__(self):
        return f"NOT {self.child!r}"


class IsNull(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self):
        return [self.child]

    def eval(self, batch: ColumnBatch) -> Column:
        c = self.child.eval(batch)
        if c.validity is None:
            return Column(np.zeros(len(c), dtype=np.bool_), "bool")
        return Column(~c.validity, "bool")

    def __repr__(self):
        return f"{self.child!r} IS NULL"


class IsNotNull(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self):
        return [self.child]

    def eval(self, batch: ColumnBatch) -> Column:
        c = self.child.eval(batch)
        if c.validity is None:
            return Column(np.ones(len(c), dtype=np.bool_), "bool")
        return Column(c.validity.copy(), "bool")

    def __repr__(self):
        return f"{self.child!r} IS NOT NULL"


class In(Expr):
    def __init__(self, child: Expr, values: Sequence[Any]):
        self.child = child
        self.values = list(values)

    def children(self):
        return [self.child]

    def eval(self, batch: ColumnBatch) -> Column:
        c = self.child.eval(batch)
        if c.dtype == STRING:
            vals = c.decode()
            data = np.isin(np.asarray(vals, dtype=object).astype(str), self.values)
        else:
            data = np.isin(c.data, np.asarray(self.values))
        data = np.asarray(data, dtype=np.bool_)
        if c.validity is not None:
            data = data & c.validity
        return Column(data, "bool", c.validity)

    def __repr__(self):
        return f"{self.child!r} IN {tuple(self.values)!r}"


# ---------------------------------------------------------------------------
# Aggregates (evaluated by the executor, not via .eval)
# ---------------------------------------------------------------------------

class AggExpr(Expr):
    func = "?"

    def __init__(self, child: Expr):
        self.child = child

    def children(self):
        return [self.child]

    def __repr__(self):
        return f"{self.func}({self.child!r})"

    def alias_or_default(self) -> str:
        return repr(self)


class Min(AggExpr):
    func = "min"


class Max(AggExpr):
    func = "max"


class Sum(AggExpr):
    func = "sum"


class Count(AggExpr):
    func = "count"


class Avg(AggExpr):
    func = "avg"


# ---------------------------------------------------------------------------
# public helpers
# ---------------------------------------------------------------------------

def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def expr_output_name(e: Expr) -> str:
    if isinstance(e, Alias):
        return e.name
    if isinstance(e, Col):
        return e.name
    return repr(e)


def split_conjunction(e: Expr) -> list[Expr]:
    """Flatten a conjunction into its conjuncts."""
    if isinstance(e, And):
        return split_conjunction(e.left) + split_conjunction(e.right)
    return [e]
