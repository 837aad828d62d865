"""Plain PyTorch versions of the hand-written CUDA kernels in
ops/cuda_kernels.py: the same functions as the Pallas TPU kernels of
hyperspace_tpu/ops/pallas_kernels.py, written as ordinary tensor code.

They are what a wrapper in ops/cuda_kernels.py runs for tensors on the CPU,
what the CPU tests hold against the JAX package, and what chip_smoke.py
holds each CUDA kernel against on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def filter_weighted_sum(pred: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(sum of pred*x*y as f32, count(pred) as int32), 0-d tensors."""
    p = pred.to(torch.float32)
    s = (p * x.to(torch.float32) * y.to(torch.float32)).sum()
    return s, pred.sum(dtype=torch.int32)


def filter_sum(pred: torch.Tensor, x: torch.Tensor):
    """(sum of pred*x as f32, count(pred) as int32), 0-d tensors."""
    s = (pred.to(torch.float32) * x.to(torch.float32)).sum()
    return s, pred.sum(dtype=torch.int32)


def filter_grouped_multi_sum(
    pred: torch.Tensor, gids: torch.Tensor, xs: Sequence[torch.Tensor], num_groups: int
):
    """For each g < num_groups: the sum of every x in ``xs`` over rows with
    pred and gid == g (f32[num_groups] each), and the shared count
    (int32[num_groups]). Rows whose gid lies outside [0, num_groups) count
    nowhere."""
    masks = [pred & (gids == g) for g in range(num_groups)]
    counts = torch.stack([m.sum(dtype=torch.int32) for m in masks])
    sums = tuple(
        torch.stack([torch.where(m, x.to(torch.float32), 0.0).sum() for m in masks])
        for x in xs
    )
    return sums, counts


def masked_min_max(x: torch.Tensor, valid: torch.Tensor):
    """(min, max) of x as f32 over the rows where valid, 0-d tensors;
    (+inf, -inf) when no row is valid. A NaN in a valid row propagates
    (amin/amax propagate NaN, as jnp.minimum/jnp.maximum do); invalid rows
    are replaced before the reduction, NaN or not."""
    xf = x.to(torch.float32)
    if xf.shape[0] == 0:
        return (torch.tensor(float("inf"), device=x.device),
                torch.tensor(float("-inf"), device=x.device))
    mn = torch.where(valid, xf, float("inf")).amin()
    mx = torch.where(valid, xf, float("-inf")).amax()
    return mn, mx
