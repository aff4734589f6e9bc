"""Entropic optimal transport solvers in plain PyTorch (counterpart of
``cfm_tpu/ops/sinkhorn.py``).

None of these is a TPU kernel in the JAX package: they are XLA
``while_loop``s there, and eager loops here on the inputs' device. The
arithmetic follows the JAX package step for step (log-domain updates,
float32, the same start values, update order and stopping rules):

- :func:`sinkhorn` / :func:`sinkhorn_potentials` / :func:`sinkhorn2`:
  balanced log-domain Sinkhorn. The stop test (row-marginal L1 error) is
  made every 10th iteration, as in JAX. On a CUDA tensor the loop reads that
  error back to the host once per check.
- :func:`sinkhorn_unbalanced`: KL-relaxed marginals, one ``reg_m`` or a
  per-side pair; :func:`partial_wasserstein`: entropic partial OT by
  iterated Bregman projections. Both test for convergence every iteration
  (a host read per iteration on a CUDA tensor).
- :func:`round_to_feasible`: Altschuler-Weed-Rigollet rounding onto U(a, b).
- :func:`emd_annealed`: epsilon-annealed Sinkhorn, a polish loop at the
  final epsilon, then rounding: a near-exact plan for general marginals.

The flash solver that never materialises the cost is in
``ops/flash_sinkhorn.py``; its dense twin runs :func:`sinkhorn_potentials`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

_F32 = torch.float32


def _f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` (a fill, no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=_F32).reshape(())
    return torch.full((), float(value), dtype=_F32, device=device)


def sinkhorn(a: torch.Tensor, b: torch.Tensor, M: torch.Tensor, reg, num_iters: int = 1000,
             tol: float = 1e-6) -> torch.Tensor:
    """Balanced entropic OT plan (n, m) by log-domain Sinkhorn: ``pot.sinkhorn``
    semantics in float32, whose default stop threshold is 1e-6."""
    loga, logb = torch.log(a.float()), torch.log(b.float())
    M = M.float()
    f, g = sinkhorn_potentials(loga, logb, M, reg, num_iters=num_iters, tol=tol)
    reg = _f32(reg, M.device)
    return torch.exp((f[:, None] + g[None, :] - M) / reg)


def sinkhorn_potentials(loga: torch.Tensor, logb: torch.Tensor, M: torch.Tensor, reg,
                        num_iters: int = 1000, tol: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-domain fixed-point loop: potentials (f, g) from zero.

    Each iteration sets f from g, then g from the new f. Every 10th
    iteration it measures the implied plan's row-marginal L1 error (the
    columns are exact after the g update) and stops once it is <= ``tol``,
    or after ``num_iters``. The error is read on the host at each check.
    """
    reg = _f32(reg, M.device)
    f, g = torch.zeros_like(loga), torch.zeros_like(logb)
    a = torch.exp(loga)
    err, it = math.inf, 0
    while err > tol and it < num_iters:
        f = reg * (loga - torch.logsumexp((g[None, :] - M) / reg, dim=1))
        g = reg * (logb - torch.logsumexp((f[:, None] - M) / reg, dim=0))
        it += 1
        if it % 10 == 0:
            row = torch.exp(torch.logsumexp((f[:, None] + g[None, :] - M) / reg, dim=1))
            err = float(torch.sum(torch.abs(row - a)))
    return f, g


def sinkhorn2(a, b, M, reg, num_iters: int = 1000, tol: float = 1e-6) -> torch.Tensor:
    """Entropic OT cost <plan, M> (``pot.sinkhorn2``)."""
    return torch.sum(sinkhorn(a, b, M, reg, num_iters=num_iters, tol=tol) * M)


def sinkhorn_unbalanced(a: torch.Tensor, b: torch.Tensor, M: torch.Tensor, reg,
                        reg_m: Union[float, Tuple[float, float]] = 1.0, num_iters: int = 1000,
                        tol: float = 1e-6) -> torch.Tensor:
    """Unbalanced entropic OT (KL-relaxed marginals), log-domain. ``reg_m`` is
    a scalar or a per-marginal pair (row, column); an infinite reg_m makes
    that side a hard constraint."""
    reg_m1, reg_m2 = reg_m if isinstance(reg_m, (tuple, list)) else (reg_m, reg_m)
    dev = M.device
    reg = _f32(reg, dev)

    def fi(rm):
        rm = _f32(rm, dev)
        return torch.where(torch.isinf(rm), torch.ones_like(rm), rm / (rm + reg))

    fi1, fi2 = fi(reg_m1), fi(reg_m2)
    loga, logb = torch.log(a.float()), torch.log(b.float())
    logK = -M.float() / reg
    n, m = M.shape
    logu = -torch.log(_f32(n, dev)).reshape(1).repeat(n)
    logv = -torch.log(_f32(m, dev)).reshape(1).repeat(m)
    err, it = math.inf, 0
    while err > tol and it < num_iters:
        new_logu = fi1 * (loga - torch.logsumexp(logK + logv[None, :], dim=1))
        new_logv = fi2 * (logb - torch.logsumexp(logK + new_logu[:, None], dim=0))
        err = float(torch.max(torch.abs(torch.exp(new_logu) - torch.exp(logu))))
        logu, logv, it = new_logu, new_logv, it + 1
    return torch.exp(logu[:, None] + logK + logv[None, :])


def partial_wasserstein(a: torch.Tensor, b: torch.Tensor, M: torch.Tensor, reg,
                        mass: Optional[float] = None, num_iters: int = 1000,
                        tol: float = 1e-7) -> torch.Tensor:
    """Entropic partial OT moving ``mass`` (default min(sum a, sum b)): project
    in turn onto {row sums <= a}, {column sums <= b} and {total = mass}
    (Benamou et al., as ``pot.partial.entropic_partial_wasserstein``)."""
    a, b = a.float(), b.float()
    dev = M.device
    mass = torch.minimum(a.sum(), b.sum()) if mass is None else _f32(mass, dev)
    K = torch.exp(-M.float() / _f32(reg, dev))
    K = K * (mass / torch.clamp(K.sum(), min=1e-30))
    err, it = math.inf, 0
    while err > tol and it < num_iters:
        row_scale = torch.clamp(a / torch.clamp(K.sum(dim=1), min=1e-30), max=1.0)
        K1 = row_scale[:, None] * K
        col_scale = torch.clamp(b / torch.clamp(K1.sum(dim=0), min=1e-30), max=1.0)
        K2 = K1 * col_scale[None, :]
        K_new = K2 * (mass / torch.clamp(K2.sum(), min=1e-30))
        err = float(torch.max(torch.abs(K_new - K)))
        K, it = K_new, it + 1
    return K


def round_to_feasible(plan: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Round a near-feasible plan onto the transport polytope U(a, b)
    (Altschuler, Weed and Rigollet, 2017): clip the row sums to at most a,
    then the column sums to at most b, then add the rank-one outer product of
    the marginal deficits."""
    a, b, plan = a.float(), b.float(), plan.float()
    row = plan.sum(dim=1)
    plan = plan * torch.clamp(a / torch.clamp(row, min=1e-38), max=1.0)[:, None]
    col = plan.sum(dim=0)
    plan = plan * torch.clamp(b / torch.clamp(col, min=1e-38), max=1.0)[None, :]
    err_a = a - plan.sum(dim=1)
    err_b = b - plan.sum(dim=0)
    total_err = err_a.sum()
    correction = err_a[:, None] * err_b[None, :] / torch.clamp(total_err, min=1e-38)
    return plan + torch.where(total_err > 1e-38, correction, torch.zeros_like(correction))


def emd_annealed(a: torch.Tensor, b: torch.Tensor, M: torch.Tensor, num_phases: int = 10,
                 inner_iters: int = 60, reg_final_rel: float = 1e-4, polish_iters: int = 3000,
                 tol: float = 1e-6) -> torch.Tensor:
    """Near-exact OT plan for general marginals: log-domain Sinkhorn with a
    geometric epsilon schedule (potentials warm-started across phases), a
    polish loop at the final epsilon until the row-marginal L1 error is
    <= ``tol`` (read on the host every iteration), then
    :func:`round_to_feasible`. The marginals are exact; the cost is within
    about 1e-3 relative of the exact optimum on minibatch clouds."""
    a, b, M = a.float(), b.float(), M.float()
    b = b * (a.sum() / torch.clamp(b.sum(), min=1e-38))
    loga = torch.log(torch.clamp(a, min=1e-38))
    logb = torch.log(torch.clamp(b, min=1e-38))
    scale = torch.clamp(M.max() - M.min(), min=1e-12)
    reg_final = scale * reg_final_rel
    reg0 = reg_final if num_phases <= 1 else scale / 4.0
    decay = (reg_final / reg0) ** (1.0 / max(num_phases - 1, 1))

    def update(f, g, reg):
        f = reg * (loga - torch.logsumexp((g[None, :] - M) / reg, dim=1))
        g = reg * (logb - torch.logsumexp((f[:, None] - M) / reg, dim=0))
        return f, g

    f, g, reg = torch.zeros_like(loga), torch.zeros_like(logb), reg0
    for _ in range(num_phases):
        for _ in range(inner_iters):
            f, g = update(f, g, reg)
        reg = reg * decay
    reg_used = reg / decay  # the reg of the final phase
    err, it = math.inf, 0
    while err > tol and it < polish_iters:
        f, g = update(f, g, reg_used)
        row = torch.exp(torch.logsumexp((f[:, None] + g[None, :] - M) / reg_used, dim=1))
        err = float(torch.sum(torch.abs(row - a)))
        it += 1
    plan = torch.exp((f[:, None] + g[None, :] - M) / reg_used)
    return round_to_feasible(plan, a, b)
