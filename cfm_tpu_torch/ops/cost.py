"""Pairwise cost matrices (counterpart of ``cfm_tpu/ops/cost.py``)."""

from __future__ import annotations

import torch

from cfm_tpu_torch.utils import flatten_batch


def sq_euclidean_cost(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """C[i, j] = ||x0_i - x1_j||^2 as ||x||^2 + ||y||^2 - 2 x.y, clamped at 0.

    Both clouds are first centred by their pooled f32 mean (distances are
    shift-invariant, the dot form is not); the norms are f32 and the cross
    term is an f32-accumulated product of the inputs in their own dtype.
    """
    x0, x1 = flatten_batch(x0), flatten_batch(x1)
    mu = 0.5 * (x0.float().mean(dim=0) + x1.float().mean(dim=0))
    x0 = (x0 - mu).to(x0.dtype)
    x1 = (x1 - mu).to(x1.dtype)
    sq0 = x0.float().square().sum(dim=-1)
    sq1 = x1.float().square().sum(dim=-1)
    cross = x0.float() @ x1.float().T  # low-precision operands are exact in f32
    return torch.clamp(sq0[:, None] + sq1[None, :] - 2.0 * cross, min=0.0)


def euclidean_cost(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """C[i, j] = ||x0_i - x1_j||, the W1 ground cost: sqrt(sq + 1e-30)."""
    return torch.sqrt(sq_euclidean_cost(x0, x1) + 1e-30)
