"""Carry device state across from the JAX package.

The JAX package ships a fragment's columns to its device as padded numpy
arrays (tpu_exec._upload_columns: power-of-two length, f64 -> f32, int64 ->
int32 after a range check). ``device_columns`` turns such host columns, or
the JAX package's device arrays brought back to numpy, into the port's
padded device tensors under the same rules, plus the valid-rows mask, so a
fragment body of either package runs on the same state. Index data itself
crosses through the shared on-disk format: an index written by either
package is read by the other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .exceptions import HyperspaceError
from .plan.gpu_exec import _int64_fits, _pad_pow2, _padded_mask, pad_to_device


def device_columns(
    columns: Mapping[str, np.ndarray], device: str | torch.device = "cuda"
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(padded device columns by name, valid-rows mask)."""
    arrays = {name: np.asarray(a) for name, a in columns.items()}
    lengths = {len(a) for a in arrays.values()}
    if len(lengths) != 1:
        raise HyperspaceError(f"columns of unequal length: {sorted(lengths)}")
    n = lengths.pop()
    padded = _pad_pow2(n)
    device = torch.device(device)
    for name, a in arrays.items():
        if not _int64_fits(a):
            raise HyperspaceError(f"column {name!r} exceeds the 32-bit device range")
    cols = {name: pad_to_device(a, padded, device) for name, a in arrays.items()}
    return cols, _padded_mask(padded, n, device)
