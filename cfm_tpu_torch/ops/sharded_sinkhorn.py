"""Row-sharded log-domain Sinkhorn for large minibatch couplings (counterpart
of ``cfm_tpu/ops/sharded_sinkhorn.py``).

The cost matrix is (n, m), batch by batch. Its rows are split over a mesh
axis's ranks:

- each rank holds its rows of x0 and the whole of x1, builds its (n/D, m)
  block of the cost and never holds the whole matrix;
- the f update (a row logsumexp) is local to the rank;
- the g update (a column logsumexp over every row) combines the ranks'
  blocks: an all-reduce of the column MAX, then of the SUM of the shifted
  exponentials, a numerically stable distributed logsumexp.

The JAX function reaches no Pallas kernel (it is dense ``jnp`` under
``shard_map``), so plain PyTorch on the rank's device is its counterpart;
the plan equals ``sinkhorn`` on the gathered batch up to summation order.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from cfm_tpu_torch.ops.cost import sq_euclidean_cost
from cfm_tpu_torch.parallel.mesh import axis_group, axis_index


def _distributed_colwise_logsumexp(logits_block: torch.Tensor, group) -> torch.Tensor:
    """logsumexp over the global row axis of a row-sharded (n/D, m) block:
    the column max all-reduced by MAX, then the shifted exponentials' column
    sums by SUM."""
    global_max = logits_block.max(dim=0).values
    dist.all_reduce(global_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.exp(logits_block - global_max[None, :]).sum(dim=0)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return global_max + torch.log(total)


def sharded_sinkhorn_plan(mesh, x0: torch.Tensor, x1: torch.Tensor, reg: float,
                          num_iters: int = 500, axis: str = "data") -> torch.Tensor:
    """Entropic OT plan for uniform marginals, its rows split over ``axis``.

    x0: this rank's rows (n / D, d), the ranks' rows in rank order along
    ``axis`` making the global x0; x1: the whole (m, d), the same on every
    rank. Returns this rank's rows of the plan (n / D, m): the sampling of
    partners per row can stay on the rank. Two all-reduces an iteration."""
    group = axis_group(mesh, axis)
    n, m = x0.shape[0] * axis_index(mesh, axis)[1], x1.shape[0]
    loga = -math.log(float(n))
    logb = torch.full((m,), -math.log(float(m)), dtype=torch.float32, device=x0.device)
    M_block = sq_euclidean_cost(x0, x1) / reg
    f_block = torch.zeros(x0.shape[0], dtype=torch.float32, device=x0.device)
    g = torch.zeros(m, dtype=torch.float32, device=x0.device)
    for _ in range(num_iters):
        f_block = loga - torch.logsumexp(g[None, :] - M_block, dim=1)
        g = logb - _distributed_colwise_logsumexp(f_block[:, None] - M_block, group)
    return torch.exp(f_block[:, None] + g[None, :] - M_block)
