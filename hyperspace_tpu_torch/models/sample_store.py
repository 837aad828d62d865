"""The approximate tier's knobs (counterpart of
hyperspace_tpu/models/sample_store.py, lean: the knob readers only).

The serving plane's degrade policy (serve/qos.choose_degrade_tier) reads
``HYPERSPACE_APPROX`` and ``HYPERSPACE_APPROX_FRACTIONS`` here, as in the
JAX package. The port writes no sample twins and has no sampled execution
yet, so a query the policy degrades runs exact, and its query-log record
says ``engaged: False``.
"""

from __future__ import annotations

from ..utils import env


def approx_mode() -> str:
    """``HYPERSPACE_APPROX``: "0" (default, off) / "1" / "verify"."""
    v = env.env_str("HYPERSPACE_APPROX").strip().lower()
    if v == "verify":
        return "verify"
    if v in ("1", "true", "on"):
        return "1"
    return "0"


def approx_enabled() -> bool:
    return approx_mode() != "0"


def sample_fractions() -> tuple[float, ...]:
    """Configured sampling tiers, ascending, each in (0, 1)."""
    raw = env.env_str("HYPERSPACE_APPROX_FRACTIONS") or "0.01,0.1"
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            f = float(part)
        except ValueError:
            continue
        if 0.0 < f < 1.0:
            out.append(f)
    return tuple(sorted(set(out)))
