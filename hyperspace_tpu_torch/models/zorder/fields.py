"""Z-order fields: per-column maps from values to z-address bit codes
(counterpart of hyperspace_tpu/models/zorder/fields.py).

A min-max field scales linearly between the column's extremes; a
percentile field buckets by quantile boundaries, for skewed columns
(``index._QUANTILE``). Strings scale by their rank
in the sorted vocabulary. Fields serialize into the index log entry, in
the JSON the JAX package writes.
"""

from __future__ import annotations

import numpy as np

from ...columnar.table import Column, STRING
from ...exceptions import HyperspaceError
from ...ops.zorder import scale_min_max, scale_percentile

DEFAULT_BITS = 16


class ZOrderField:
    kind = "?"

    def __init__(self, name: str, nbits: int = DEFAULT_BITS):
        self.name = name
        self.nbits = int(nbits)

    def codes(self, col: Column) -> np.ndarray:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "ZOrderField":
        cls = _FIELD_KINDS.get(d.get("kind"))
        if cls is None:
            raise HyperspaceError(f"Unknown z-order field kind {d.get('kind')!r}")
        return cls._from_dict(d)


class MinMaxZOrderField(ZOrderField):
    kind = "minmax"

    def __init__(self, name: str, vmin: float, vmax: float, nbits: int = DEFAULT_BITS):
        super().__init__(name, nbits)
        self.vmin = vmin
        self.vmax = vmax

    def codes(self, col: Column) -> np.ndarray:
        return scale_min_max(_numeric_values(col), self.vmin, self.vmax, self.nbits)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "min": self.vmin,
                "max": self.vmax, "nbits": self.nbits}

    @classmethod
    def _from_dict(cls, d: dict) -> "MinMaxZOrderField":
        return cls(d["name"], d["min"], d["max"], d.get("nbits", DEFAULT_BITS))

    @staticmethod
    def from_column(name: str, col: Column, nbits: int = DEFAULT_BITS) -> "MinMaxZOrderField":
        vals = _numeric_values(col)
        if len(vals) == 0:
            return MinMaxZOrderField(name, 0.0, 0.0, nbits)
        return MinMaxZOrderField(name, float(vals.min()), float(vals.max()), nbits)


class PercentileZOrderField(ZOrderField):
    kind = "percentile"

    def __init__(self, name: str, boundaries: list[float], nbits: int = DEFAULT_BITS):
        super().__init__(name, nbits)
        self.boundaries = list(boundaries)

    def codes(self, col: Column) -> np.ndarray:
        return scale_percentile(_numeric_values(col), np.asarray(self.boundaries), self.nbits)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "boundaries": self.boundaries,
                "nbits": self.nbits}

    @classmethod
    def _from_dict(cls, d: dict) -> "PercentileZOrderField":
        return cls(d["name"], d["boundaries"], d.get("nbits", DEFAULT_BITS))

    @staticmethod
    def from_column(name: str, col: Column, nbits: int = DEFAULT_BITS) -> "PercentileZOrderField":
        vals = _numeric_values(col)
        n_bounds = (1 << nbits) - 1
        if len(vals) == 0:
            return PercentileZOrderField(name, [0.0] * n_bounds, nbits)
        qs = np.linspace(0, 1, n_bounds + 2)[1:-1]
        bounds = np.quantile(vals.astype(np.float64), qs)
        return PercentileZOrderField(name, [float(b) for b in bounds], nbits)


_FIELD_KINDS = {
    MinMaxZOrderField.kind: MinMaxZOrderField,
    PercentileZOrderField.kind: PercentileZOrderField,
}


def _numeric_values(col: Column) -> np.ndarray:
    """Order-preserving float64 view of a column: strings by vocabulary
    rank (NULL as ""), numeric NULLs as the smallest valid value."""
    if col.dtype == STRING:
        vals = np.asarray(col.decode(), dtype=object)
        if col.validity is not None:
            vals = vals.copy()
            vals[~col.validity] = ""
        _vocab, codes = np.unique(vals.astype(str), return_inverse=True)
        return codes.astype(np.float64)
    if col.dtype == "bool":
        return col.data.astype(np.float64)
    data = col.data.astype(np.float64)
    if col.validity is not None:
        data = np.where(col.validity, data, np.nan)
        low = np.nanmin(data)
        data = np.nan_to_num(data, nan=float(low) if np.isfinite(low) else 0.0)
    return data


def build_field(name: str, col: Column, use_percentile: bool,
                nbits: int = DEFAULT_BITS) -> ZOrderField:
    """Percentile for numeric columns when enabled (at most 8 bits: 2^nbits
    - 1 boundaries are too many past that), else min-max."""
    if use_percentile and col.dtype not in (STRING, "bool"):
        return PercentileZOrderField.from_column(name, col, min(nbits, 8))
    return MinMaxZOrderField.from_column(name, col, nbits)
