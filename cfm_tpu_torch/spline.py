"""Natural cubic splines and spline-CFM multi-marginal paths (counterpart of
``cfm_tpu/spline.py``).

A natural cubic spline is fitted through each sample's OT-chained trajectory
(one knot per timepoint); mu_t = spline(t) and u_t = spline'(t) are the
conditional path and flow. The second derivatives at the knots solve the
natural-spline tridiagonal system, written as a dense (K, K) matrix and
solved by ``torch.linalg.solve`` broadcast over every sample and dimension,
as ``jnp.linalg.solve`` is in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from cfm_tpu_torch.coupling import OTPlanSampler

TimeLike = Union[torch.Tensor, float]


class CubicSpline(NamedTuple):
    """Natural cubic spline through (ts[k], ys[..., k, :]): ts (K,) strictly
    increasing knot times, ys (..., K, D) values, m (..., K, D) second
    derivatives at the knots."""

    ts: torch.Tensor
    ys: torch.Tensor
    m: torch.Tensor

    def evaluate(self, t: TimeLike) -> torch.Tensor:
        """The spline's value at a scalar time or at a batch of times (see
        :func:`_spline_eval`)."""
        return _spline_eval(self, t, derivative=False)

    def derivative(self, t: TimeLike) -> torch.Tensor:
        return _spline_eval(self, t, derivative=True)


def fit_natural_cubic_spline(ts: torch.Tensor, ys: torch.Tensor) -> CubicSpline:
    """Natural cubic splines (y'' = 0 at both ends) along axis -2 of ``ys``
    (..., K, D) through the knot times ``ts`` (K,)."""
    K = ts.shape[0]
    h = ts[1:] - ts[:-1]
    A = torch.zeros((K, K), dtype=ys.dtype, device=ys.device)
    A[0, 0] = A[K - 1, K - 1] = 1.0
    for i in range(1, K - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2.0 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
    d = (ys[..., 1:, :] - ys[..., :-1, :]) / h[:, None]
    rhs = torch.zeros_like(ys)
    rhs[..., 1:K - 1, :] = 6.0 * (d[..., 1:, :] - d[..., :-1, :])
    return CubicSpline(ts=ts, ys=ys, m=torch.linalg.solve(A, rhs))


def _segment(ts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The knot interval [ts[i], ts[i + 1]] holding each t, clamped to the ends."""
    return torch.clamp(torch.searchsorted(ts, t, right=True) - 1, 0, ts.shape[0] - 2)


def _cubic(ts, t, idx, y0, y1, m0, m1, derivative: bool) -> torch.Tensor:
    """The spline's value or slope on the interval ``idx``; t and the knot
    times broadcast against y0, y1, m0, m1."""
    t0, t1 = ts[idx], ts[idx + 1]
    h = t1 - t0
    a = (t1 - t) / h
    b = (t - t0) / h
    if not derivative:
        return a * y0 + b * y1 + ((a ** 3 - a) * m0 + (b ** 3 - b) * m1) * (h ** 2) / 6.0
    return (y1 - y0) / h + ((3 * b ** 2 - 1) * m1 - (3 * a ** 2 - 1) * m0) * h / 6.0


def _spline_eval(sp: CubicSpline, t: TimeLike, derivative: bool) -> torch.Tensor:
    """A scalar t evaluates every spline at t. A batch of times t (B,) pairs
    t[i] with spline i when the splines have a leading batch dimension of B,
    and evaluates one shared spline (no batch dimension, or a batch of one)
    at every t, the result's leading dimension being B. Any other leading
    dimension raises, rather than mispair times and splines."""
    ts, ys, m = sp.ts, sp.ys, sp.m
    t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
    if t.dim() == 0:
        idx = _segment(ts, t)
        return _cubic(ts, t, idx, ys[..., idx, :], ys[..., idx + 1, :], m[..., idx, :],
                      m[..., idx + 1, :], derivative)
    if ys.dim() == 2 or (ys.dim() > 2 and ys.shape[0] == 1 != t.shape[0]):
        shared_ys = ys if ys.dim() == 2 else ys[0]
        shared_m = m if m.dim() == 2 else m[0]
        idx = _segment(ts, t)
        # ys[..., idx, :] puts the batch of times at axis -2; move it first.
        y0, y1, m0, m1 = (v[..., i, :].movedim(-2, 0) for v, i in
                          ((shared_ys, idx), (shared_ys, idx + 1), (shared_m, idx),
                           (shared_m, idx + 1)))
    else:
        if ys.shape[0] != t.shape[0]:
            raise ValueError(f"time batch {t.shape[0]} does not match spline batch {ys.shape[0]}")
        idx = _segment(ts, t)
        rows = torch.arange(t.shape[0], device=t.device)
        y0, y1, m0, m1 = (v[rows, ..., i, :] for v, i in
                          ((ys, idx), (ys, idx + 1), (m, idx), (m, idx + 1)))
    shape = (-1,) + (1,) * (y0.dim() - 1)
    return _cubic(ts, t.reshape(shape), idx.reshape(shape), y0, y1, m0, m1, derivative)


class SplineConditionalFlowMatcher:
    """Spline-CFM: per-sample cubic-spline paths through OT-chained timepoints.

    From a population X (bs, T, *dim) it chains the plans of adjacent
    timepoints (``OTPlanSampler.sample_trajectory``; on the card each exact
    plan at bs <= 512 is one launch of the dense auction kernel), fits a
    natural cubic spline through each chained trajectory, and samples
    (t, xt, ut) with xt = spline(t) + sigma eps and ut = spline'(t).
    """

    def __init__(self, sigma: float = 0.0, ot_method: str = "exact"):
        self.sigma = sigma
        self.ot_sampler = OTPlanSampler(method=ot_method) if ot_method != "none" else None

    def sample_location_and_conditional_flow(
            self, generator: Optional[torch.Generator], X: torch.Tensor,
            ts: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None, gumbel: Optional[Sequence[torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t, xt, ut) for a trajectory batch. ``ts`` are the knot times
        (default 0, 1, ..., T - 1); ``gumbel`` the chaining's noise (see
        ``sample_trajectory``), ``t`` (bs,) the times in [ts[0], ts[-1]) and
        ``eps`` the path noise, drawn from ``generator`` in that order when
        not given."""
        bs, T = X.shape[0], X.shape[1]
        dev = X.device
        knot_ts = (torch.linspace(0.0, float(T - 1), T, device=dev) if ts is None
                   else ts.to(device=dev, dtype=X.dtype))
        traj = (self.ot_sampler.sample_trajectory(generator, X, gumbel=gumbel)
                if self.ot_sampler is not None else X)
        spline = fit_natural_cubic_spline(knot_ts, traj.reshape(bs, T, -1))
        if t is None:
            t = (torch.rand(bs, generator=generator, device=dev, dtype=X.dtype)
                 * (knot_ts[-1] - knot_ts[0]) + knot_ts[0])
        t = t.to(dev)
        mu_t = spline.evaluate(t).reshape((bs,) + X.shape[2:])
        ut = spline.derivative(t).reshape((bs,) + X.shape[2:])
        if eps is None:
            eps = torch.randn(mu_t.shape, generator=generator, device=dev, dtype=X.dtype)
        return t, mu_t + self.sigma * eps.to(dev), ut
