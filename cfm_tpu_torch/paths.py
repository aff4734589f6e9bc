"""Conditional probability paths and flow matchers (counterpart of
``cfm_tpu/paths.py``): I-CFM, OT-CFM (with its label-carrying sampling for
class-conditional training), Lipman et al.'s target FM, SB-CFM with the
exact coupling, and the variance-preserving interpolant; the score-head
pieces ``compute_lambda`` and ``compute_score_target``.

Every sampling method takes an explicit ``torch.Generator``. The draws can
also be handed in (``t=``, ``eps=``, ``plan_noise=``), which is how the
tests give both packages the same numbers. With a generator, a coupled
matcher draws the plan uniforms first, then t, then the path noise.

SB-CFM's entropic coupling (``ot_method="sinkhorn"``) waits for ROADMAP.md
queue 1 item 6 and raises.
"""

from __future__ import annotations

import copy
import math
import warnings
from typing import Optional, Union

import torch

from cfm_tpu_torch.coupling import OTPlanSampler
from cfm_tpu_torch.utils import pad_t_like_x


class ConditionalFlowMatcher:
    """Independent-coupling CFM: path N(t x1 + (1-t) x0, sigma^2), u_t = x1 - x0."""

    def __init__(self, sigma: Union[float, int] = 0.0):
        self.sigma = sigma

    def compute_mu_t(self, x0, x1, t):
        t = pad_t_like_x(t, x0)
        return t * x1 + (1 - t) * x0

    def compute_sigma_t(self, t):
        return self.sigma

    def sample_xt(self, x0, x1, t, epsilon):
        mu_t = self.compute_mu_t(x0, x1, t)
        sigma_t = pad_t_like_x(self.compute_sigma_t(t), x0)
        return mu_t + sigma_t * epsilon

    def compute_conditional_flow(self, x0, x1, t, xt):
        return x1 - x0

    def sample_noise_like(self, generator: Optional[torch.Generator], x: torch.Tensor):
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def sample_location_and_conditional_flow(
            self, generator: Optional[torch.Generator], x0: torch.Tensor, x1: torch.Tensor,
            t: Optional[torch.Tensor] = None, return_noise: bool = False,
            return_coupling_status: bool = False, eps: Optional[torch.Tensor] = None):
        """(t, xt, ut[, eps][, degenerate]) for a training batch; t and eps
        are drawn from ``generator`` unless given."""
        if t is None:
            t = torch.rand(x0.shape[0], generator=generator, device=x0.device, dtype=x0.dtype)
        if t.shape[0] != x0.shape[0]:
            raise ValueError("t has to have batch size dimension")
        if eps is None:
            eps = self.sample_noise_like(generator, x0)
        xt = self.sample_xt(x0, x1, t, eps)
        ut = self.compute_conditional_flow(x0, x1, t, xt)
        out = (t, xt, ut, eps) if return_noise else (t, xt, ut)
        if return_coupling_status:
            out = out + (torch.zeros((), dtype=torch.bool, device=x0.device),)
        return out

    def compute_lambda(self, t):
        """Score weighting lambda(t) = 2 sigma_t / (sigma^2 + 1e-8)."""
        return 2 * self.compute_sigma_t(t) / (self.sigma ** 2 + 1e-8)

    def compute_score_target(self, xt, x0, x1, t):
        """Conditional score -(xt - mu_t) / (sigma_t^2 + 1e-8)."""
        mu_t = self.compute_mu_t(x0, x1, t)
        sigma_t = pad_t_like_x(self.compute_sigma_t(t), xt)
        return -(xt - mu_t) / (sigma_t ** 2 + 1e-8)


class _CoupledMixin:
    """Coupled sampling shared by the OT matchers."""

    ot_sampler: OTPlanSampler

    def without_coupling(self):
        """A view of this matcher whose sampling skips the OT re-pairing."""
        clone = copy.copy(self)
        clone._skip_coupling = True
        return clone

    def sample_location_and_conditional_flow(
            self, generator, x0, x1, t=None, return_noise: bool = False,
            return_coupling_status: bool = False, eps=None, plan_noise=None):
        """Coupled (t, xt, ut[, eps][, degenerate]); ``plan_noise`` are the
        plan-sampling uniforms (see :meth:`OTPlanSampler.sample_map`)."""
        if getattr(self, "_skip_coupling", False):
            return ConditionalFlowMatcher.sample_location_and_conditional_flow(
                self, generator, x0, x1, t, return_noise, return_coupling_status, eps)
        x0, x1, bad = self.ot_sampler.sample_plan(generator, x0, x1, return_status=True,
                                                  noise=plan_noise)
        out = ConditionalFlowMatcher.sample_location_and_conditional_flow(
            self, generator, x0, x1, t, return_noise, False, eps)
        return out + (bad,) if return_coupling_status else out

    def guided_sample_location_and_conditional_flow(
            self, generator, x0, x1, y0=None, y1=None, t=None, return_noise: bool = False,
            return_coupling_status: bool = False, eps=None, plan_noise=None):
        """Coupled (t, xt, ut, y0, y1[, eps][, degenerate]): the labels are
        re-paired with their samples by the same plan draws. The base
        I-CFM matcher has no such method, as in the JAX package."""
        if getattr(self, "_skip_coupling", False):
            bad = torch.zeros((), dtype=torch.bool, device=x0.device)
        else:
            x0, x1, y0, y1, bad = self.ot_sampler.sample_plan_with_labels(
                generator, x0, x1, y0, y1, return_status=True, noise=plan_noise)
        out = ConditionalFlowMatcher.sample_location_and_conditional_flow(
            self, generator, x0, x1, t, return_noise, False, eps)
        out = out[:3] + (y0, y1) + out[3:]
        return out + (bad,) if return_coupling_status else out


class ExactOptimalTransportConditionalFlowMatcher(_CoupledMixin, ConditionalFlowMatcher):
    """OT-CFM: the I-CFM path on pairs re-drawn from the exact minibatch OT plan."""

    def __init__(self, sigma: Union[float, int] = 0.0, solver: str = "auto"):
        super().__init__(sigma)
        self.ot_sampler = OTPlanSampler(method="exact", solver=solver)


class TargetConditionalFlowMatcher(ConditionalFlowMatcher):
    """Lipman et al. 2023 flow matching: mu_t = t x1, sigma_t = 1 - (1 - sigma) t."""

    def compute_mu_t(self, x0, x1, t):
        return pad_t_like_x(t, x1) * x1

    def compute_sigma_t(self, t):
        return 1 - (1 - self.sigma) * t

    def compute_conditional_flow(self, x0, x1, t, xt):
        """u_t = (x1 - (1 - sigma) xt) / (1 - (1 - sigma) t)."""
        t = pad_t_like_x(t, x1)
        return (x1 - (1 - self.sigma) * xt) / (1 - (1 - self.sigma) * t)


class SchrodingerBridgeConditionalFlowMatcher(_CoupledMixin, ConditionalFlowMatcher):
    """SB-CFM: the Brownian-bridge path sigma_t = sigma sqrt(t (1 - t)) on
    pairs re-drawn from the exact minibatch OT plan;
    u_t = (1 - 2t) / (2t (1 - t) + 1e-8) (xt - mu_t) + x1 - x0."""

    def __init__(self, sigma: Union[float, int] = 1.0, ot_method: str = "exact",
                 solver: str = "auto"):
        if sigma <= 0:
            raise ValueError(f"Sigma must be strictly positive, got {sigma}.")
        elif sigma < 1e-3:
            warnings.warn("Small sigma values may lead to numerical instability.")
        super().__init__(sigma)
        self.ot_method = ot_method
        self.ot_sampler = OTPlanSampler(method=ot_method, solver=solver)

    def compute_sigma_t(self, t):
        return self.sigma * torch.sqrt(t * (1 - t))

    def compute_conditional_flow(self, x0, x1, t, xt):
        t = pad_t_like_x(t, x0)
        mu_t = self.compute_mu_t(x0, x1, t)
        sigma_t_prime_over_sigma_t = (1 - 2 * t) / (2 * t * (1 - t) + 1e-8)
        return sigma_t_prime_over_sigma_t * (xt - mu_t) + x1 - x0


class VariancePreservingConditionalFlowMatcher(ConditionalFlowMatcher):
    """The trigonometric interpolant of Albergo and Vanden-Eijnden:
    mu_t = cos(pi t / 2) x0 + sin(pi t / 2) x1,
    u_t = pi / 2 (cos(pi t / 2) x1 - sin(pi t / 2) x0)."""

    def compute_mu_t(self, x0, x1, t):
        t = pad_t_like_x(t, x0)
        return torch.cos(math.pi / 2 * t) * x0 + torch.sin(math.pi / 2 * t) * x1

    def compute_conditional_flow(self, x0, x1, t, xt):
        t = pad_t_like_x(t, x0)
        return math.pi / 2 * (torch.cos(math.pi / 2 * t) * x1 - torch.sin(math.pi / 2 * t) * x0)
