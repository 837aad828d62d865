"""Z-order (Morton) address computation, host path (counterpart of
hyperspace_tpu/ops/zorder.py: ``scale_min_max``, ``scale_percentile`` and
``interleave_bits``, and its device form ``interleave_bits_torch``, the
reference's ``interleave_bits_jnp``).

Each field is scaled to an nbits integer code, then the codes' bits are
interleaved round-robin from the most significant bit, so every field
contributes its high bits first: the property that makes a z-curve cluster
multi-column ranges. The index build computes addresses on the host, in
uint64 numpy. The device form takes at most 32 bits, as the reference's
does; no index path calls it, in either package: the tests and the on-card
smoke hold it to the host form.
"""

from __future__ import annotations

import numpy as np

from ..exceptions import HyperspaceError


def scale_min_max(values: np.ndarray, vmin: float, vmax: float, nbits: int) -> np.ndarray:
    """Map values linearly into [0, 2^nbits)."""
    if vmax <= vmin:
        return np.zeros(len(values), dtype=np.uint64)
    span = (1 << nbits) - 1
    scaled = (values.astype(np.float64) - vmin) / (vmax - vmin) * span
    return np.clip(scaled, 0, span).astype(np.uint64)


def scale_percentile(values: np.ndarray, boundaries: np.ndarray, nbits: int) -> np.ndarray:
    """Bucket by quantile boundaries (2^nbits - 1 of them) to fight skew."""
    max_code = (1 << nbits) - 1
    codes = np.searchsorted(boundaries, values, side="right")
    return np.clip(codes, 0, max_code).astype(np.uint64)


def interleave_bits(fields: list[tuple[np.ndarray, int]]) -> np.ndarray:
    """Interleave [(codes uint64, nbits)] into z-addresses: bits are taken
    MSB first, round-robin across fields; a field with fewer bits drops out
    of the rotation once exhausted. At most 64 bits in all."""
    total = sum(nb for _, nb in fields)
    if total > 64:
        raise HyperspaceError(f"z-address needs {total} bits > 64; reduce field bits")
    if not fields:
        raise HyperspaceError("No fields to interleave")
    out = np.zeros(len(fields[0][0]), dtype=np.uint64)
    out_pos = total
    for level in range(max(nb for _, nb in fields)):
        for codes, nbits in fields:
            if level < nbits:
                out_pos -= 1
                bit = (codes >> np.uint64(nbits - 1 - level)) & np.uint64(1)
                out |= bit << np.uint64(out_pos)
    return out


def interleave_bits_torch(fields: list, device):
    """``interleave_bits`` on ``device`` for at most 32 bits in all:
    [(codes, nbits)] with codes host arrays or tensors (only their low
    nbits are read) -> int64 z-addresses in [0, 2^32). Counterpart of
    ``interleave_bits_jnp``."""
    import torch

    from .hashing import words_tensor

    total = sum(nb for _, nb in fields)
    if total > 32:
        raise HyperspaceError(f"device z-address limited to 32 bits, got {total}")
    if not fields:
        raise HyperspaceError("No fields to interleave")
    codes = [(words_tensor(c, device).to(torch.int64), nb) for c, nb in fields]
    out = torch.zeros(codes[0][0].shape, dtype=torch.int64, device=device)
    out_pos = total
    for level in range(max(nb for _, nb in codes)):
        for c, nbits in codes:
            if level < nbits:
                out_pos -= 1
                out |= ((c >> (nbits - 1 - level)) & 1) << out_pos
    return out
