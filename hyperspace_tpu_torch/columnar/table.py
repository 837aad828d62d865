"""ColumnBatch — the in-memory columnar unit of execution.

Counterpart of hyperspace_tpu/columnar/table.py: columnar numpy on the host,
placed on the card as padded torch tensors by the device tier
(plan/gpu_exec.py).

Supported logical dtypes: int8/16/32/64, float32/64, bool, date32 (days since
epoch, stored int32), string (dictionary-encoded: int32 codes + vocabulary).
Nulls are tracked with optional boolean validity masks (True = valid).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

from ..exceptions import HyperspaceError

_NUMPY_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "float32": np.float32,
    "float64": np.float64,
    "bool": np.bool_,
    "date32": np.int32,
    "string": np.int32,  # dictionary codes
}

STRING = "string"
DATE32 = "date32"


def numpy_dtype(logical: str) -> np.dtype:
    try:
        return np.dtype(_NUMPY_DTYPES[logical])
    except KeyError:
        raise HyperspaceError(f"Unsupported dtype: {logical!r}")


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str  # logical dtype string

    def to_dict(self) -> dict:
        return {"name": self.name, "type": self.dtype}


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)
        self._by_name = {f.name: f for f in self.fields}
        if len(self._by_name) != len(self.fields):
            raise HyperspaceError("Duplicate column names in schema")

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def field(self, name: str) -> Field:
        f = self._by_name.get(name)
        if f is None:
            raise HyperspaceError(
                f"Column {name!r} not found; available: {self.names}"
            )
        return f

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def to_list(self) -> list[dict]:
        return [f.to_dict() for f in self.fields]

    @staticmethod
    def from_list(lst: Iterable[Mapping]) -> "Schema":
        return Schema([Field(d["name"], d["type"]) for d in lst])

    def __repr__(self):
        return "Schema(" + ", ".join(f"{f.name}:{f.dtype}" for f in self.fields) + ")"


class Column:
    """One column: numpy data + logical dtype + optional validity + optional
    string dictionary (vocabulary for dictionary-encoded strings)."""

    def __init__(
        self,
        data: np.ndarray,
        dtype: str,
        validity: Optional[np.ndarray] = None,
        dictionary: Optional[list[str]] = None,
    ):
        self.data = data
        self.dtype = dtype
        self.validity = validity  # None => all valid
        self.dictionary = dictionary
        if dtype == STRING and dictionary is None:
            raise HyperspaceError("string column requires a dictionary")

    def __len__(self):
        return len(self.data)

    @property
    def dictionary_is_unique(self) -> bool:
        """True when no value appears under two codes (all in-repo
        constructors guarantee it; externally-built dictionaries are checked
        once and the result cached)."""
        cached = self.__dict__.get("_dict_unique")
        if cached is None:
            cached = self.dictionary is not None and len(set(self.dictionary)) == len(
                self.dictionary
            )
            self.__dict__["_dict_unique"] = cached
        return cached

    @staticmethod
    def from_values(values: Sequence[Any], dtype: str | None = None) -> "Column":
        if dtype is not None and dtype != STRING:
            # explicit non-string dtype: None entries become NULLs, not strings
            validity = np.array([v is not None for v in values], dtype=bool)
            filled = [0 if v is None else v for v in values]
            return Column(
                np.asarray(filled).astype(numpy_dtype(dtype)),
                dtype,
                None if validity.all() else validity,
            )
        arr = np.asarray(values)
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            validity = np.array([v is not None for v in values], dtype=bool)
            non_null = [v for v in values if v is not None]
            if non_null and all(isinstance(v, (int, float, bool)) for v in non_null):
                # numeric values with Nones: infer numeric dtype + validity
                if all(isinstance(v, bool) for v in non_null):
                    inferred = "bool"
                elif all(isinstance(v, int) for v in non_null):
                    inferred = "int64"
                else:
                    inferred = "float64"
                filled = [0 if v is None else v for v in values]
                return Column(
                    np.asarray(filled).astype(numpy_dtype(inferred)),
                    inferred,
                    None if validity.all() else validity,
                )
            # dictionary-encode strings
            strs = [v if v is not None else "" for v in values]
            vocab, codes = np.unique(np.asarray(strs, dtype=str), return_inverse=True)
            return Column(
                codes.astype(np.int32),
                STRING,
                None if validity.all() else validity,
                list(vocab),
            )
        if dtype is None:
            if arr.dtype.kind == "b":
                dtype = "bool"
            elif arr.dtype.kind == "i":
                dtype = str(arr.dtype)
            elif arr.dtype.kind == "f":
                dtype = str(arr.dtype)
            else:
                raise HyperspaceError(f"Cannot infer dtype for {arr.dtype}")
        return Column(arr.astype(numpy_dtype(dtype)), dtype)

    def decode(self) -> np.ndarray:
        """Materialize python-visible values (strings decoded)."""
        if self.dtype == STRING:
            vocab = np.asarray(self.dictionary, dtype=object)
            out = vocab[self.data]
        else:
            out = self.data
        if self.validity is not None:
            out = np.asarray(out, dtype=object)
            out[~self.validity] = None
        return out

    def take(self, indices: np.ndarray) -> "Column":
        return Column(
            self.data[indices],
            self.dtype,
            self.validity[indices] if self.validity is not None else None,
            self.dictionary,
        )

    def slice(self, start: int, stop: int) -> "Column":
        """Contiguous row range as a view of this column's buffers."""
        return Column(
            self.data[start:stop],
            self.dtype,
            self.validity[start:stop] if self.validity is not None else None,
            self.dictionary,
        )

    def filter(self, mask: np.ndarray) -> "Column":
        return Column(
            self.data[mask],
            self.dtype,
            self.validity[mask] if self.validity is not None else None,
            self.dictionary,
        )


def sort_key_values(col: "Column", ascending: bool = True) -> np.ndarray:
    """Order-exact sort keys for one column with Spark NULL placement
    (NULLS FIRST ascending, NULLS LAST descending). Fast path: plain
    ascending numeric columns sort on raw data with no factorization."""
    plain_numeric = col.dtype != STRING and col.validity is None
    if plain_numeric and ascending:
        return col.data
    if plain_numeric and col.data.dtype.kind in ("f", "b"):
        return -col.data.astype(np.float64 if col.data.dtype.kind == "f" else np.int8)
    if plain_numeric and col.data.dtype.itemsize < 8:
        return -col.data.astype(np.int64)  # exact negation for narrow ints
    # strings, nullable, or int64-descending: factorize (exact for all dtypes)
    if col.dtype == STRING:
        # rank through the (small) dictionary instead of factorizing n
        # string objects: any monotone map of the values sorts identically.
        # np.unique collapses duplicate dictionary ENTRIES to one rank, so
        # equal values sort equal even under a non-unique dictionary.
        vocab = np.asarray(col.dictionary if col.dictionary else [""], dtype=str)
        _, rank = np.unique(vocab, return_inverse=True)
        codes = rank.astype(np.int64)[col.data]
        if col.validity is not None:
            # NULL must not collide with a real value's rank; route through
            # the shared null-placement logic below via a sentinel remap
            codes = codes + 1 if ascending else codes
        if not ascending:
            codes = -codes
        if col.validity is not None:
            null_code = 0 if ascending else codes.max(initial=0) + 1
            codes = np.where(col.validity, codes, null_code)
        return codes
    vals = col.data
    _, codes = np.unique(vals, return_inverse=True)
    codes = codes.astype(np.int64)
    if not ascending:
        codes = -codes
    if col.validity is not None:
        null_code = codes.min(initial=0) - 1 if ascending else codes.max(initial=0) + 1
        codes = np.where(col.validity, codes, null_code)
    return codes


class ColumnBatch:
    """Ordered collection of equal-length Columns."""

    def __init__(self, columns: Mapping[str, Column]):
        self.columns: dict[str, Column] = dict(columns)
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise HyperspaceError(f"Ragged columns: {lengths}")
        self._num_rows = lengths.pop() if lengths else 0

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def schema(self) -> Schema:
        return Schema([Field(n, c.dtype) for n, c in self.columns.items()])

    def column(self, name: str) -> Column:
        c = self.columns.get(name)
        if c is None:
            raise HyperspaceError(
                f"Column {name!r} not found; available: {list(self.columns)}"
            )
        return c

    def to_pydict(self) -> dict[str, list]:
        return {n: list(c.decode()) for n, c in self.columns.items()}

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return ColumnBatch({n: self.column(n) for n in names})

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({n: c.filter(mask) for n, c in self.columns.items()})

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({n: c.take(indices) for n, c in self.columns.items()})

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        return ColumnBatch({n: c.slice(start, stop) for n, c in self.columns.items()})

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        """Row-wise concatenation of batches with the same columns; string
        columns merge their dictionaries (sorted union, codes remapped)."""
        batches = [b for b in batches if b is not None]
        if not batches:
            return ColumnBatch({})
        out: dict[str, Column] = {}
        for n in batches[0].schema.names:
            cols = [b.column(n) for b in batches]
            dtype = cols[0].dtype
            mismatched = {c.dtype for c in cols} - {dtype}
            if mismatched:
                raise HyperspaceError(
                    f"Cannot concat column {n!r}: dtype {dtype} vs {sorted(mismatched)}"
                )
            dictionary = None
            if dtype == STRING:
                vocabs = [c.dictionary if c.dictionary else [""] for c in cols]
                dictionary = sorted(set().union(*vocabs))
                lut = {s: i for i, s in enumerate(dictionary)}
                data = np.concatenate([
                    np.fromiter((lut[s] for s in vocab), dtype=np.int32,
                                count=len(vocab))[c.data]
                    for c, vocab in zip(cols, vocabs)
                ])
            else:
                data = np.concatenate([c.data for c in cols])
            validity = None
            if any(c.validity is not None for c in cols):
                validity = np.concatenate([
                    c.validity if c.validity is not None else np.ones(len(c), dtype=bool)
                    for c in cols
                ])
            out[n] = Column(data, dtype, validity, dictionary)
        return ColumnBatch(out)

    def __repr__(self):
        return f"ColumnBatch({self.num_rows} rows, {self.schema})"
