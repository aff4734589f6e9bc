"""Closed-form Schrödinger-bridge Gaussian oracle (counterpart of
``cfm_tpu/eval/sb_oracle.py``).

Source N(-a 1, I), target N(+a 1, I); the entropic bridge marginal at time t
is Gaussian with

    mean_t = (2 a t - a) 1
    cov_t  = (sqrt(4 + sigma^4) t (1 - t) + (1 - t)^2 + t^2) I

The KL of a Gaussian fit of generated samples against it is the end-to-end
check of SB-CFM and [SF]2M.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cfm_tpu_torch.device import DeviceLike


def sb_gaussian_marginal(a: float, sigma: float, t, dim: int,
                         device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed-form SB marginal: (mean (dim,), covariance (dim, dim)),
    float32."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    mean = (2.0 * a * t - a) * torch.ones((dim,), dtype=torch.float32, device=t.device)
    var = math.sqrt(4.0 + sigma ** 4) * t * (1.0 - t) + (1.0 - t) ** 2 + t ** 2
    return mean, var * torch.eye(dim, dtype=torch.float32, device=t.device)


def sample_sb_endpoints(generator: Optional[torch.Generator], n: int, a: float = 0.1,
                        dim: int = 2, device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0, x1) drawn from the two endpoint Gaussians, x0 first, on
    ``device`` (by default the generator's)."""
    if device is None and generator is not None:
        device = generator.device
    x0 = torch.randn((n, dim), generator=generator, device=device) - a
    x1 = torch.randn((n, dim), generator=generator, device=device) + a
    return x0, x1


def gaussian_kl(mean_p: torch.Tensor, cov_p: torch.Tensor, mean_q: torch.Tensor,
                cov_q: torch.Tensor) -> torch.Tensor:
    """KL(N(mean_p, cov_p) || N(mean_q, cov_q)), full covariances."""
    d = mean_p.shape[-1]
    cov_q_inv = torch.linalg.inv(cov_q)
    diff = mean_q - mean_p
    term_trace = torch.trace(cov_q_inv @ cov_p)
    term_quad = diff @ cov_q_inv @ diff
    _, logdet_p = torch.linalg.slogdet(cov_p)
    _, logdet_q = torch.linalg.slogdet(cov_q)
    return 0.5 * (term_trace + term_quad - d + logdet_q - logdet_p)


def sb_marginal_kl(xt: torch.Tensor, a: float, sigma: float, t) -> torch.Tensor:
    """KL of the Gaussian fit of ``xt`` (n, dim) against the SB marginal at
    t, in the direction KL(estimated || closed form). As in JAX, the fit's
    covariance divides by n - 1 at dim > 1 (``cov``) and by n at dim 1
    (``var``)."""
    est_mean = xt.mean(dim=0)
    if xt.shape[1] > 1:
        est_cov = torch.cov(xt.T)
    else:
        est_cov = xt.var(dim=0, correction=0)[None, :]
    mean, cov = sb_gaussian_marginal(a, sigma, t, xt.shape[1], device=xt.device)
    return gaussian_kl(est_mean, est_cov, mean, cov)


def sb_trajectory_kl(trajectory: torch.Tensor, ts, a: float, sigma: float) -> torch.Tensor:
    """The mean KL along a rollout: ``trajectory`` (T, n, dim) at times
    ``ts`` (T,)."""
    ts = torch.as_tensor(ts, dtype=torch.float32)
    kls = [sb_marginal_kl(trajectory[i], a, sigma, ts[i].to(trajectory.device))
           for i in range(ts.shape[0])]
    return torch.mean(torch.stack(kls))
