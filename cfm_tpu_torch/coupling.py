"""Minibatch optimal-transport coupling (counterpart of ``cfm_tpu/coupling.py``).

``OTPlanSampler`` with the JAX package's four methods: "exact" (a
permutation from an assignment solve for equal batches with uniform
marginals, else the exact general-marginal plan of a host LP), "sinkhorn",
"unbalanced" and "partial" (``ops/sinkhorn.py``), for any batch sizes and
marginal weights. Every sampling method takes an explicit
``torch.Generator``, or the draws themselves (``noise=``, ``gumbel=``,
``uniform_j=``) so that a test can hand both packages the same numbers. The
degenerate-plan flag is returned as a device tensor and never read on the
host inside a step.

Large Sinkhorn couplings take the flash route (JAX's predicate,
:func:`_flash_route`: the flash kernel runs, which needs a CUDA tensor, and
the plan has at least 2048^2 entries; or ``flash=True``): the potentials
come from ``ops/flash_sinkhorn.sinkhorn_from_points`` without any (n, m)
tensor, and each row draws its partner by Gumbel-max. A solve whose
potentials are not finite or whose implied rows miss their mass by half or
more falls back to uniform partners, chosen with ``torch.where``.

:func:`wasserstein` is the exact W1/W2 (an assignment solve for equal
sizes, the host LP otherwise; on the card at n = 2048, the 2-D
evaluation's size, the row-tiled auction kernel) or the entropic W2 (the
flash route at 2048^2 on the card).

:meth:`OTPlanSampler.sample_trajectory` chains the plans of adjacent
timepoints of a (bs, T, *dim) population into per-sample trajectories.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from cfm_tpu_torch.ops import flash_sinkhorn as fs
from cfm_tpu_torch.ops.assignment import solve_assignment
from cfm_tpu_torch.ops.cost import sq_euclidean_cost
from cfm_tpu_torch.ops.sinkhorn import partial_wasserstein, sinkhorn, sinkhorn_unbalanced


def _emd_solve(a: np.ndarray, b: np.ndarray, cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact OT plan for general marginals (``pot.emd(a, b, M)``) on the host,
    by scipy's HiGHS LP solver, as ``cfm_tpu/ops/native.emd_solve`` falls
    back to: (plan (n, m) float64, total cost). ``b`` is rescaled to the
    mass of ``a``; a zero total gives the zero plan."""
    import scipy.optimize
    import scipy.sparse as sp

    a, b, cost = (np.ascontiguousarray(v, dtype=np.float64) for v in (a, b, cost))
    n, m = cost.shape
    sa, sb = a.sum(), b.sum()
    if sa <= 0 or sb <= 0:
        return np.zeros((n, m)), 0.0
    b = b * (sa / sb)
    rows = sp.kron(sp.eye(n), np.ones((1, m)))
    cols = sp.kron(np.ones((1, n)), sp.eye(m))
    # The last equality is implied by the others; HiGHS prefers it dropped.
    A_eq = sp.vstack([rows, cols]).tocsr()[:-1]
    b_eq = np.concatenate([a, b])[:-1]
    res = scipy.optimize.linprog(cost.ravel(), A_eq=A_eq, b_eq=b_eq, bounds=(0, None),
                                 method="highs")
    if not res.success:
        raise RuntimeError(f"EMD LP failed: {res.message}")
    return res.x.reshape(n, m), float(res.fun)


def _exact_general_plan(M: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact plan for general marginals, solved on the host (off the
    training path: only unequal batches or weighted marginals take it)."""
    plan, _ = _emd_solve(a.double().cpu().numpy(), b.double().cpu().numpy(),
                         M.double().cpu().numpy())
    return torch.from_numpy(plan).float().to(M.device)


def _plan_from_perm(perm: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Permutation -> plan matrix with mass 1/n on (i, perm[i]); a scalar
    fill, so nothing is copied from the host."""
    plan = torch.zeros((n, m), device=perm.device)
    return plan.scatter_(1, perm.long()[:, None], 1.0 / n)


def _flash_route(n: int, m: int, d: int, device) -> bool:
    """The one auto-routing predicate of ``sample_plan`` and ``wasserstein``:
    the flash kernel runs for these sizes on this device, and the plan has
    at least 2048^2 entries. On the CPU it is always False, as JAX's off the
    TPU."""
    return fs.flash_kernel_supported(n, m, d, device) and n * m >= 2048 * 2048


def _flat_dim(x: torch.Tensor) -> int:
    return int(math.prod(x.shape[1:])) if x.dim() > 1 else 1


class OTPlanSampler:
    """Sample (x0, x1) pairs from a minibatch OT plan, on the inputs' device.

    ``reg`` is the entropic regulariser, ``reg_m`` the unbalanced marginal
    relaxation (scalar or per-side pair), ``num_iters`` the Sinkhorn
    iteration cap; ``flash`` routes ``sample_plan`` through the flash solver
    (True: always, False: never, None: :func:`_flash_route`).
    """

    def __init__(self, method: str, reg: float = 0.05,
                 reg_m: Union[float, Tuple[float, float]] = 1.0, normalize_cost: bool = False,
                 warn: bool = True, solver: str = "auto", num_iters: int = 1000,
                 flash: Optional[bool] = None) -> None:
        if method not in ("exact", "sinkhorn", "unbalanced", "partial"):
            raise ValueError(f"Unknown method: {method}")
        self.method, self.reg, self.reg_m = method, reg, reg_m
        self.normalize_cost, self.warn, self.solver = normalize_cost, warn, solver
        self.num_iters, self.flash = num_iters, flash

    def _cost(self, x0, x1):
        M = sq_euclidean_cost(x0, x1)
        if self.normalize_cost:
            M = M / torch.clamp(M.max(), min=1e-30)
        return M

    def get_map(self, x0: torch.Tensor, x1: torch.Tensor, a: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None, return_status: bool = False):
        """The plan (n, m) for the squared-Euclidean cost, with marginals ``a``
        and ``b`` (default uniform); with ``return_status`` also the
        degenerate flag, a 0-d bool tensor that is True when the uniform
        coupling replaced a plan with no mass, non-finite entries or (for the
        balanced methods) row marginals off by half or more."""
        n, m = x0.shape[0], x1.shape[0]
        uniform_marginals = a is None and b is None
        M = self._cost(x0, x1)
        dev = M.device
        a = torch.full((n,), 1.0 / n, device=dev) if a is None else a.float().to(dev)
        b = torch.full((m,), 1.0 / m, device=dev) if b is None else b.float().to(dev)
        if self.method == "exact":
            if n == m and uniform_marginals:
                plan = _plan_from_perm(solve_assignment(M, self.solver), n, m)
            else:
                plan = _exact_general_plan(M, a, b)
        elif self.method == "sinkhorn":
            plan = sinkhorn(a, b, M, self.reg, num_iters=self.num_iters)
        elif self.method == "unbalanced":
            plan = sinkhorn_unbalanced(a, b, M, self.reg, self.reg_m, num_iters=self.num_iters)
        else:
            plan = partial_wasserstein(a, b, M, self.reg, num_iters=self.num_iters)
        bad = (plan.sum().abs() < 1e-8) | ~torch.isfinite(plan).all()
        if self.method in ("exact", "sinkhorn"):
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

    def _use_flash(self, x0: torch.Tensor, x1: torch.Tensor, replace: bool = True) -> bool:
        """True when :meth:`sample_plan` takes the flash route for these batches."""
        if self.method != "sinkhorn" or not replace or self.normalize_cost:
            return False
        if self.flash is not None:
            return self.flash
        return _flash_route(x0.shape[0], x1.shape[0], _flat_dim(x0), x0.device)

    def sample_plan(self, generator: Optional[torch.Generator], x0: torch.Tensor,
                    x1: torch.Tensor, replace: bool = True, return_status: bool = False,
                    noise: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
                    uniform_j: Optional[torch.Tensor] = None):
        """Re-pair the minibatch by the OT plan: (x0[i], x1[j][, bad]).

        On the flash route (:meth:`_use_flash`) x0 keeps its order and row i
        draws j by Gumbel-max from pi(. | i); ``gumbel`` (n, m) is that
        noise and ``uniform_j`` (n,) the partners of the uniform fallback,
        drawn from ``generator`` in that order when not given. Otherwise
        (i, j) come from :meth:`sample_map` on the plan, with ``noise``.
        """
        if self._use_flash(x0, x1, replace):
            n, m = x0.shape[0], x1.shape[0]
            f, g = fs.sinkhorn_from_points(x0, x1, self.reg, num_iters=self.num_iters)
            j = fs.plan_sample_from_potentials(generator, x0, x1, f, g, self.reg, gumbel=gumbel)
            err = fs.row_marginal_error_from_potentials(x0, x1, f, g, self.reg)
            ok = torch.isfinite(f).all() & torch.isfinite(g).all() & (err < 0.5)
            if uniform_j is None:
                uniform_j = torch.randint(0, m, (n,), generator=generator, device=x0.device)
            j = torch.where(ok, j, uniform_j.to(j.device))
            return (x0, x1[j], ~ok) if return_status else (x0, x1[j])
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

    def sample_trajectory(self, generator: Optional[torch.Generator], X: torch.Tensor,
                          gumbel: Optional[list] = None) -> torch.Tensor:
        """Chain the plans of adjacent timepoints over a (bs, T, *dim)
        population: sample i starts at X[i, 0], and at each timepoint draws
        its next index from its current index's plan row, by Gumbel-max over
        ``log(max(row, 1e-38))`` (a categorical draw). ``gumbel`` holds the
        T - 1 (bs, bs) Gumbel noises, drawn from ``generator`` in timepoint
        order when not given. Returns the re-ordered (bs, T, *dim) batch."""
        bs, times = X.shape[0], X.shape[1]
        indices = [torch.arange(bs, device=X.device)]
        for t in range(times - 1):
            pi = self.get_map(X[:, t], X[:, t + 1])
            logits = torch.log(torch.clamp(pi[indices[-1]], min=1e-38))
            g = (-torch.empty(logits.shape, device=X.device).exponential_(
                generator=generator).log() if gumbel is None else gumbel[t].to(X.device))
            indices.append(torch.argmax(logits + g, dim=1))
        return torch.stack([X[:, t][indices[t]] for t in range(times)], dim=1)


def wasserstein(x0: torch.Tensor, x1: torch.Tensor, method: Optional[str] = None,
                reg: float = 0.05, power: int = 2, solver: str = "auto",
                num_iters: int = 1000) -> torch.Tensor:
    """Wasserstein-1 or -2 distance between minibatches, a 0-d tensor on their
    device.

    "exact" (the default): the optimal assignment's mean cost for equal
    sizes, the host LP's optimal cost otherwise. "sinkhorn": the entropic
    cost <plan, C> with ``reg``; for W2 on the flash route it comes from the
    potentials in row chunks, NaN when the solve is not finite or its rows
    miss their mass by half or more. Power 2 is square-rooted.
    """
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, got {power}")
    if method not in (None, "exact", "sinkhorn"):
        raise ValueError(f"Unknown method: {method}")
    n, m = x0.shape[0], x1.shape[0]
    if method == "sinkhorn" and power == 2 and _flash_route(n, m, _flat_dim(x0), x0.device):
        f, g = fs.sinkhorn_from_points(x0, x1, reg, num_iters=num_iters)
        err = fs.row_marginal_error_from_potentials(x0, x1, f, g, reg)
        ok = torch.isfinite(f).all() & torch.isfinite(g).all() & (err < 0.5)
        cost = fs.transport_cost_from_potentials(x0, x1, f, g, reg)
        return torch.sqrt(torch.where(ok, cost, torch.full_like(cost, float("nan"))))
    M = sq_euclidean_cost(x0, x1)
    if power == 1:
        M = torch.sqrt(M + 1e-30)
    dev = M.device
    a, b = torch.full((n,), 1.0 / n, device=dev), torch.full((m,), 1.0 / m, device=dev)
    if method == "sinkhorn":
        ret = torch.sum(sinkhorn(a, b, M, reg, num_iters=num_iters) * M)
    elif n == m:
        ret = M.gather(1, solve_assignment(M, solver)[:, None]).mean()
    else:
        ret = torch.sum(_exact_general_plan(M, a, b) * M)
    return torch.sqrt(ret) if power == 2 else ret
