"""Minibatch optimal-transport coupling, exact route (counterpart of
``cfm_tpu/coupling.py``).

``OTPlanSampler(method="exact")`` with uniform marginals over equal-sized
batches: the plan is the permutation of an assignment solve. Every sampling
method takes an explicit ``torch.Generator``, or the draws themselves
(``noise=``) so that a test can hand both packages the same numbers. The
degenerate-plan flag is returned as a device tensor and never read on the
host inside a step.

:func:`wasserstein` is the exact W1/W2 distance between equal-sized clouds
through one assignment solve (on the card at n = 2048, the 2-D evaluation's
size, the row-tiled auction kernel).

The entropic methods ("sinkhorn", "unbalanced", "partial"), non-uniform
marginals and the exact solver for unequal sizes are not ported yet
(ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from cfm_tpu_torch.ops.assignment import solve_assignment
from cfm_tpu_torch.ops.cost import sq_euclidean_cost

_NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1 item 6, the entropic branch); "
               "the port has the exact coupling with uniform marginals over equal batches")


def _plan_from_perm(perm: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Permutation -> plan matrix with mass 1/n on (i, perm[i])."""
    plan = torch.zeros((n, m), device=perm.device)
    plan[torch.arange(n, device=perm.device), perm.long()] = 1.0 / n
    return plan


class OTPlanSampler:
    """Sample (x0, x1) pairs from a minibatch OT plan, on the inputs' device."""

    def __init__(self, method: str, normalize_cost: bool = False, warn: bool = True,
                 solver: str = "auto") -> None:
        if method not in ("exact", "sinkhorn", "unbalanced", "partial"):
            raise ValueError(f"Unknown method: {method}")
        if method != "exact":
            raise NotImplementedError(f"OTPlanSampler(method={method!r}) {_NOT_PORTED}")
        self.method = method
        self.normalize_cost, self.warn, self.solver = normalize_cost, warn, solver

    def _cost(self, x0, x1):
        M = sq_euclidean_cost(x0, x1)
        if self.normalize_cost:
            M = M / torch.clamp(M.max(), min=1e-30)
        return M

    def get_map(self, x0: torch.Tensor, x1: torch.Tensor, a=None, b=None,
                return_status: bool = False):
        """The exact plan (n, n); with ``return_status`` also the degenerate
        flag, a 0-d bool tensor that is True when the uniform coupling
        replaced a plan with no mass, non-finite entries or wrong marginals."""
        n, m = x0.shape[0], x1.shape[0]
        if a is not None or b is not None or n != m:
            raise NotImplementedError(f"non-uniform or unequal marginals {_NOT_PORTED}")
        plan = _plan_from_perm(solve_assignment(self._cost(x0, x1), self.solver), n, m)
        a = torch.full((n,), 1.0 / n, device=plan.device)
        bad = (plan.sum().abs() < 1e-8) | ~torch.isfinite(plan).all()
        rel_err = (plan.sum(dim=1) - a).abs().sum() / a.sum()
        bad = bad | ~(rel_err < 0.5)
        if self.warn and plan.device.type == "cpu" and bool(bad):
            warnings.warn("Degenerate OT plan (zero mass or non-finite); falling back "
                          "to the uniform coupling — check reg/batch contents.")
        plan = torch.where(bad, torch.full_like(plan, 1.0 / (n * m)), plan)
        return (plan, bad) if return_status else plan

    @staticmethod
    def sample_map(generator: Optional[torch.Generator], pi: torch.Tensor, batch_size: int,
                   replace: bool = True, noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(i, j) index pairs drawn from the plan ``pi``.

        With replacement: inverse-CDF sampling; ``noise`` (batch_size,) are
        the uniforms in [0, 1), drawn from ``generator`` when not given.
        Without: Gumbel-top-k; ``noise`` (n * m,) is the Gumbel noise.
        """
        n, m = pi.shape
        flat = torch.clamp(pi.reshape(-1), min=0.0)
        if replace:
            if noise is None:
                noise = torch.rand(batch_size, generator=generator, device=pi.device)
            cdf = torch.cumsum(flat, 0)
            u = noise * cdf[-1]
            choices = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, n * m - 1)
        else:
            if noise is None:
                noise = -torch.empty(n * m, device=pi.device).exponential_(
                    generator=generator).log()
            logits = torch.log(torch.clamp(flat, min=1e-38))
            choices = torch.topk(logits + noise, batch_size).indices
        return choices // m, choices % m

    def sample_plan(self, generator: Optional[torch.Generator], x0: torch.Tensor,
                    x1: torch.Tensor, replace: bool = True, return_status: bool = False,
                    noise: Optional[torch.Tensor] = None):
        """Re-pair the minibatch by the OT plan: (x0[i], x1[j][, bad])."""
        pi, bad = self.get_map(x0, x1, return_status=True)
        i, j = self.sample_map(generator, pi, x0.shape[0], replace=replace, noise=noise)
        return (x0[i], x1[j], bad) if return_status else (x0[i], x1[j])

    def sample_plan_exact_order(self, x0: torch.Tensor, x1: torch.Tensor):
        """x0 kept in order, x1 permuted by the optimal assignment."""
        return x0, x1[solve_assignment(self._cost(x0, x1), self.solver)]

    sample_plan_with_scipy = sample_plan_exact_order

    def sample_plan_with_labels(self, generator: Optional[torch.Generator], x0, x1, y0=None,
                                y1=None, replace: bool = True, return_status: bool = False,
                                noise: Optional[torch.Tensor] = None):
        """Coupled resampling that carries labels along."""
        pi, bad = self.get_map(x0, x1, return_status=True)
        i, j = self.sample_map(generator, pi, x0.shape[0], replace=replace, noise=noise)
        out = (x0[i], x1[j], y0[i] if y0 is not None else None,
               y1[j] if y1 is not None else None)
        return out + (bad,) if return_status else out


def wasserstein(x0: torch.Tensor, x1: torch.Tensor, method: Optional[str] = None,
                power: int = 2, solver: str = "auto") -> torch.Tensor:
    """Exact Wasserstein-1 or -2 distance between equal-sized minibatches, a
    0-d tensor on their device: the mean cost of the optimal assignment
    under ||x - y|| (power 1) or ||x - y||^2 (power 2, square-rooted)."""
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, got {power}")
    if method not in (None, "exact"):
        if method == "sinkhorn":
            raise NotImplementedError(f"wasserstein(method='sinkhorn') {_NOT_PORTED}")
        raise ValueError(f"Unknown method: {method}")
    if x0.shape[0] != x1.shape[0]:
        raise NotImplementedError(f"wasserstein between clouds of unequal sizes (the exact "
                                  f"general-marginal solver) {_NOT_PORTED}")
    M = sq_euclidean_cost(x0, x1)
    if power == 1:
        M = torch.sqrt(M + 1e-30)
    ret = M.gather(1, solve_assignment(M, solver)[:, None]).mean()
    return torch.sqrt(ret) if power == 2 else ret
