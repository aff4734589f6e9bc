"""Waddington-OT-style interpolation with growth reweighting, and the EMD
between weighted point clouds (counterpart of ``cfm_tpu/eval/growth.py``).

The EMD of arbitrary weights is an entropic solve at a small regulariser
(the port's dense log-domain ``ops/sinkhorn.sinkhorn``, which reads its
marginal error on the host every 10th iteration). The interpolations draw
from an OT plan by inverse CDF; they take an explicit ``torch.Generator``,
or the uniforms ``u`` themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from cfm_tpu_torch.ops.cost import euclidean_cost, sq_euclidean_cost
from cfm_tpu_torch.ops.sinkhorn import sinkhorn


def earth_mover_distance(p: torch.Tensor, q: torch.Tensor,
                         weights1: Optional[torch.Tensor] = None,
                         weights2: Optional[torch.Tensor] = None, metric: str = "sqeuclidean",
                         reg: float = 0.01, num_iters: int = 2000) -> torch.Tensor:
    """sqrt of the entropic OT cost <plan, M> between two weighted clouds
    (uniform weights by default), M the squared or plain Euclidean cost."""
    a = (torch.full((p.shape[0],), 1.0 / p.shape[0], device=p.device) if weights1 is None
         else weights1 / torch.sum(weights1))
    b = (torch.full((q.shape[0],), 1.0 / q.shape[0], device=q.device) if weights2 is None
         else weights2 / torch.sum(weights2))
    M = sq_euclidean_cost(p, q) if metric == "sqeuclidean" else euclidean_cost(p, q)
    plan = sinkhorn(a, b, M, reg, num_iters=num_iters)
    return torch.sqrt(torch.sum(plan * M))


def interpolate_with_ot(generator: Optional[torch.Generator], p0: torch.Tensor,
                        p1: torch.Tensor, tmap: torch.Tensor, interp_frac: float, size: int,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An interpolated population of ``size`` points from the plan ``tmap``
    with exponential growth correction, p_ij ∝ tmap_ij / (col_sum_j)^(1 - t):
    pairs drawn by inverse CDF over the flattened plan (``u`` (size,) the
    uniforms), placed at (1 - t) x0_i + t x1_j."""
    I, J = tmap.shape
    col_sums = torch.sum(tmap, dim=0)
    p = tmap / torch.pow(torch.clamp(col_sums, min=1e-30), 1.0 - interp_frac)
    p = p.reshape(-1)
    cdf = torch.cumsum(p / torch.sum(p), dim=0)
    if u is None:
        u = torch.rand(size, generator=generator, device=tmap.device)
    choices = torch.clamp(torch.searchsorted(cdf, u.to(tmap.device) * cdf[-1], right=True),
                          0, I * J - 1)
    return (1.0 - interp_frac) * p0[choices // J] + interp_frac * p1[choices % J]


def interpolate_per_point_with_ot(generator: Optional[torch.Generator], p0: torch.Tensor,
                                  p1: torch.Tensor, tmap: torch.Tensor, interp_frac: float,
                                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point interpolation: each x0_i draws its partner j from its
    normalised plan row (``u`` (I, 1) the uniforms). p0 must have a row per
    plan row and p1 a row per plan column."""
    if p0.shape[0] != tmap.shape[0]:
        raise ValueError(f"p0 has {p0.shape[0]} points for a plan of shape {tuple(tmap.shape)}")
    if p1.shape[0] != tmap.shape[1]:
        raise ValueError(f"p1 has {p1.shape[0]} points for a plan of shape {tuple(tmap.shape)}")
    I = p0.shape[0]
    rows = tmap / torch.clamp(torch.sum(tmap, dim=1, keepdim=True), min=1e-30)
    cdf = torch.cumsum(rows, dim=1)
    if u is None:
        u = torch.rand((I, 1), generator=generator, device=tmap.device)
    u = u.to(tmap.device) * cdf[:, -1:]
    j = torch.clamp(torch.sum((cdf < u).int(), dim=1), 0, tmap.shape[1] - 1)
    return (1.0 - interp_frac) * p0 + interp_frac * p1[j]
