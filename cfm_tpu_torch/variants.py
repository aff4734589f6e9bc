"""Variant training objectives (counterpart of ``cfm_tpu/variants.py``):
the schedule-driven bridge and the [SF]2M score loss, DSBM (two-way and
one-way), rectified flow, action matching, CNF maximum likelihood, the dual
ICNN OT maps, IPF pair regeneration and the marginal-averaged target.

The losses take ``nn.Module``s where JAX takes ``apply`` functions and
parameter dicts: ``loss_fn(generator, x0, x1, ...)`` returns
``(loss, aux)`` and the caller differentiates it in the modules'
parameters. Every draw comes from an explicit ``torch.Generator`` (t first,
then the path noise, as JAX splits its key) or is handed in (``t=``,
``eps=``, ``idx=``, ``noise=``, ``probes=``), which is how the tests give
both packages the same numbers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import grad, vmap

from cfm_tpu_torch.augment import (AugmentedState, cnf_log_likelihood, hutch_probes,
                                   make_augmented_field, standard_normal_logprob)
from cfm_tpu_torch.integrate import odeint, odeint_adjoint, sdeint
from cfm_tpu_torch.models.mlp import _scalar_grad
from cfm_tpu_torch.schedules import ConstantNoiseScheduler, NoiseScheduler
from cfm_tpu_torch.utils import pad_t_like_x

Sample = Dict[str, torch.Tensor]


def _t_batch(t: float, x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)


def _draw_t(generator, x0, t):
    if t is None:
        t = torch.rand((x0.shape[0],), generator=generator, dtype=x0.dtype, device=x0.device)
    return t.to(device=x0.device, dtype=x0.dtype)


# --------------------------------------------------------------------------
# Schedule-driven bridge (the SF2M generalisation of SB-CFM)
# --------------------------------------------------------------------------


class ScheduleBridgeMatcher:
    """Brownian-bridge path under a noise schedule:

      mu_t    = x0 + (x1 - x0) F(t) / F(1)
      sigma_t = sqrt(F(t) - F(t)^2 / F(1))
      u_t     = (d sigma_t^2 / dt) / (2 sigma_t^2) (x - mu_t) + (x1 - x0) g(t)^2 / F(1)

    With a constant schedule this is the SB-CFM path exactly. The score
    target is the path noise eps."""

    def __init__(self, schedule: Optional[NoiseScheduler] = None, sigma_min: float = 0.1):
        self.schedule = schedule or ConstantNoiseScheduler(sigma_min)

    def sample_location_and_targets(self, generator: Optional[torch.Generator], x0: torch.Tensor,
                                    x1: torch.Tensor, t: Optional[torch.Tensor] = None,
                                    eps: Optional[torch.Tensor] = None) -> Sample:
        t = _draw_t(generator, x0, t)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
        eps = eps.to(device=x0.device, dtype=x0.dtype)
        tx = pad_t_like_x(t, x0)
        s = self.schedule
        ft = s.F(tx)
        fone = s.F(torch.ones((), device=x0.device))
        mu_t = x0 + (x1 - x0) * ft / fone
        sigma_t = torch.sqrt(torch.clamp_min(ft - ft ** 2 / fone, 0.0))
        xt = mu_t + sigma_t * eps
        g_t = s.g(tx)
        g2 = g_t ** 2
        sigma_t_sq_prime = g2 - 2.0 * ft * g2 / fone
        sigma_ratio = sigma_t_sq_prime / (2.0 * sigma_t ** 2 + 1e-8)
        ut = sigma_ratio * (xt - mu_t) + (x1 - x0) * g2 / fone
        return {"t": t, "xt": xt, "ut": ut, "eps": eps, "mu_t": mu_t, "sigma_t": sigma_t,
                "g_t": g_t}


def sf2m_score_loss(st: torch.Tensor, sample: Sample) -> torch.Tensor:
    """The score loss in the sigma-scaled parameterisation:
    mse(-2 sigma_t st / g(t)^2, eps)."""
    scaled = -2.0 * sample["sigma_t"] * st / (sample["g_t"] ** 2 + 1e-8)
    return torch.mean(torch.square(scaled - sample["eps"]))


# --------------------------------------------------------------------------
# DSBM: diffusion Schrödinger bridge matching
# --------------------------------------------------------------------------


def dsbm_targets(x0: torch.Tensor, x1: torch.Tensor, sample: Sample,
                 schedule: NoiseScheduler) -> Tuple[torch.Tensor, ...]:
    """The forward and backward drift targets and their loss scalings:
      fwd = x1 - x0 - g(t) sqrt(t / (1 - t)) eps,  scale 1 / (1 + g^2 t / (1 - t))
      bwd = x0 - x1 - g(t) sqrt((1 - t) / t) eps,  scale 1 / (1 + g^2 (1 - t) / t)"""
    t = pad_t_like_x(sample["t"], x0)
    eps = sample["eps"]
    g = schedule.g(t)
    fwd = x1 - x0 - g * torch.sqrt(t / (1 - t + 1e-6)) * eps
    bwd = x0 - x1 - g * torch.sqrt((1 - t) / (t + 1e-6)) * eps
    fwd_scale = 1.0 / (1.0 + g ** 2 * t / (1 - t + 1e-6))
    bwd_scale = 1.0 / (1.0 + g ** 2 * (1 - t) / (t + 1e-6))
    return fwd, bwd, fwd_scale, bwd_scale


def make_dsbm_loss(fwd_model: nn.Module, bwd_model: nn.Module,
                   schedule: Optional[NoiseScheduler] = None, sigma_min: float = 0.1):
    """The joint forward + backward drift matching loss on one shared bridge
    sample: ``loss_fn(generator, x0, x1, t=None, eps=None)``."""
    bridge = ScheduleBridgeMatcher(schedule, sigma_min)
    sched = bridge.schedule

    def loss_fn(generator, x0, x1, t=None, eps=None):
        sample = bridge.sample_location_and_targets(generator, x0, x1, t=t, eps=eps)
        fwd_t, bwd_t, fwd_s, bwd_s = dsbm_targets(x0, x1, sample, sched)
        vt = fwd_model(sample["t"], sample["xt"])
        st = bwd_model(sample["t"], sample["xt"])
        fwd_loss = torch.mean(fwd_s * torch.square(vt - fwd_t))
        bwd_loss = torch.mean(bwd_s * torch.square(st - bwd_t))
        loss = fwd_loss + bwd_loss
        return loss, {"loss": loss, "fwd_loss": fwd_loss, "bwd_loss": bwd_loss}

    return loss_fn


def dsbm_ode_drift(fwd_model: nn.Module, bwd_model: nn.Module) -> Callable:
    """The probability-flow drift (f - b) / 2 of the learned bridge."""

    def drift(t, x):
        tb = _t_batch(t, x)
        return 0.5 * (fwd_model(tb, x) - bwd_model(tb, x))

    return drift


def make_oneway_dsbm_loss(fwd_model: nn.Module, schedule: Optional[NoiseScheduler] = None,
                          sigma_min: float = 0.1):
    """Forward-drift bridge matching alone, with DSBM's forward target and
    scaling: ``loss_fn(generator, x0, x1, t=None, eps=None)``."""
    bridge = ScheduleBridgeMatcher(schedule, sigma_min)
    sched = bridge.schedule

    def loss_fn(generator, x0, x1, t=None, eps=None):
        sample = bridge.sample_location_and_targets(generator, x0, x1, t=t, eps=eps)
        fwd_t, _, fwd_s, _ = dsbm_targets(x0, x1, sample, sched)
        loss = torch.mean(fwd_s * torch.square(fwd_model(sample["t"], sample["xt"]) - fwd_t))
        return loss, {"loss": loss}

    return loss_fn


# --------------------------------------------------------------------------
# Rectified flow
# --------------------------------------------------------------------------


def _field(model: nn.Module) -> Callable:
    return lambda t, x: model(_t_batch(t, x), x)


@torch.no_grad()
def reflow_pairs(model: nn.Module, x0: torch.Tensor, n_steps: int = 100
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rectification step: x1 := euler ODE(model, x0) over ``n_steps``;
    the pairs (x0, x1) lie on the model's own flow."""
    ts = np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32)
    x1 = odeint(_field(model), x0, ts, method="euler", return_trajectory=False).final
    return x0, x1.detach()


def straightness(model: nn.Module, x0: torch.Tensor, n_steps: int = 20) -> torch.Tensor:
    """The mean squared deviation of the euler flow from the straight line
    between its ends (0 iff the trajectories are straight)."""
    ts = np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32)
    sol = odeint(_field(model), x0, ts, method="euler")
    x1 = sol.final
    tt = torch.from_numpy(ts).to(x0.device).reshape((-1,) + (1,) * x0.dim())
    straight = x0[None] + tt * (x1 - x0)[None]
    return torch.mean(torch.square(sol.ys - straight))


# --------------------------------------------------------------------------
# Action matching
# --------------------------------------------------------------------------


def make_action_matching_loss(energy_model: nn.Module):
    """The energy-based action matching loss

      L = E[ s(0, x0) - s(1, x1) + 1/2 ||ds/dx(t, xt)||^2 + ds/dt(t, xt) ]

    with xt the straight-line interpolant; ``energy_model(t, x)`` returns
    the action per sample, (bs,) or (bs, 1). The two derivatives are each
    sample's own (``torch.func`` over the samples), differentiable in the
    parameters. ``loss_fn(generator, x0, x1, t=None)``."""

    def s_scalar(ti, xi):
        return torch.sum(energy_model(ti[None], xi[None]))

    def loss_fn(generator, x0, x1, t=None):
        t = _draw_t(generator, x0, t)
        tx = pad_t_like_x(t, x0)
        xt = tx * x1 + (1 - tx) * x0
        dsdt, dsdx = vmap(grad(s_scalar, argnums=(0, 1)))(t, xt)
        a0 = energy_model(torch.zeros_like(t), x0).reshape(-1)
        a1 = energy_model(torch.ones_like(t), x1).reshape(-1)
        kinetic = 0.5 * torch.sum(torch.square(dsdx.reshape(x0.shape[0], -1)), dim=1)
        loss = torch.mean(a0 - a1 + kinetic + dsdt.reshape(-1))
        return loss, {"loss": loss}

    return loss_fn


# --------------------------------------------------------------------------
# CNF exact maximum likelihood
# --------------------------------------------------------------------------


def make_cnf_nll_loss(model: nn.Module, n_steps: int = 50, divergence: str = "exact",
                      num_probes: int = 1, adaptive: bool = False, rtol: float = 1e-5,
                      atol: float = 1e-5):
    """The negative log-likelihood by backward trace-augmented integration:
    ``loss_fn(generator, x0, x1, probes=None)`` (x0 unused: the base is
    N(0, I)). ``adaptive=False``: euler over ``n_steps``, differentiated by
    autograd through the steps. ``adaptive=True``: dopri5 on the state
    (x, logp) through ``integrate.odeint_adjoint``, the continuous adjoint,
    at (rtol, atol). Hutchinson probes (bs, k, d) are drawn once a call from
    ``generator`` or handed in, the same at every evaluation."""
    def loss_fn(generator, x0, x1, probes=None):
        del x0
        f = _field(model)
        if divergence == "hutch":
            probes = hutch_probes(probes, generator, x1.shape[0], num_probes, x1[0].numel(), x1)
        if adaptive:
            aug = make_augmented_field(f, divergence=divergence, num_probes=num_probes,
                                       probes=probes)

            def field(params, t, state):
                out = aug(t, AugmentedState(state[0], state[1], {}))
                return out.x, out.logp

            init = (x1, torch.zeros(x1.shape[0], dtype=x1.dtype, device=x1.device))
            x, logp = odeint_adjoint(field, list(model.parameters()), init,
                                     np.array([1.0, 0.0], np.float32), rtol=rtol, atol=atol)
            ll = standard_normal_logprob(x) - logp
        else:
            ll = cnf_log_likelihood(f, x1, n_steps=n_steps, divergence=divergence,
                                    num_probes=num_probes, probes=probes)
        loss = -torch.mean(ll)
        return loss, {"loss": loss, "nll_per_dim": loss / x1[0].numel()}

    return loss_fn


# --------------------------------------------------------------------------
# ICNN dual OT
# --------------------------------------------------------------------------


def make_icnn_losses(f_model: nn.Module, g_model: nn.Module):
    """The minimax dual-ICNN OT losses; the map is T = grad g, f the dual
    potential. Returns ``(g_loss, f_loss, grad_g, w2_estimate)``:

      g_loss(x)           = E_x[f(grad g(x)) - <x, grad g(x)>]   (minimise over g)
      f_loss(x, y)        = E_y[f(y)] - E_x[f(grad g(x))]        (over f; T detached)
      w2_estimate(x, y)   = the dual estimate of W2^2 / 2

    Each returns ``(value, aux)`` but ``grad_g``. Convexity holds by
    construction (``models.ICNN``'s softplus weights)."""

    def grad_g(x):
        return _scalar_grad(lambda xx: g_model(xx)[:, 0], x)

    def g_loss(x):
        Tx = grad_g(x)
        loss = torch.mean(f_model(Tx)[:, 0] - torch.sum(x * Tx, dim=1))
        return loss, {"g_loss": loss}

    def f_loss(x, y):
        Tx = grad_g(x).detach()
        loss = torch.mean(f_model(y)[:, 0]) - torch.mean(f_model(Tx)[:, 0])
        return loss, {"f_loss": loss}

    def w2_estimate(x, y):
        Tx = grad_g(x)
        fTx, fy = f_model(Tx)[:, 0], f_model(y)[:, 0]
        dual = torch.mean(torch.sum(x * Tx, dim=1) - fTx) + torch.mean(fy)
        return 0.5 * (torch.mean(torch.sum(x ** 2, 1)) + torch.mean(torch.sum(y ** 2, 1))) - dual

    return g_loss, f_loss, grad_g, w2_estimate


# --------------------------------------------------------------------------
# IPF pair regeneration and the marginal-averaged target
# --------------------------------------------------------------------------


@torch.no_grad()
def ipf_resample_pairs(generator: Optional[torch.Generator], drift_model: nn.Module,
                       x_start: torch.Tensor, schedule: Optional[NoiseScheduler] = None,
                       sigma_min: float = 0.1, n_steps: int = 100, reverse: bool = False,
                       noise: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The outer loop's pair regeneration: simulate the current SDE from one
    marginal to synthesise the other (Euler-Maruyama, ``n_steps``).

    Forward: dx = f(t, x) dt + g(t) dW from x0 over t: 0 -> 1, returns
    (x0, x1'). Backward (``reverse``): the drift b(t, x), parameterised in
    forward time, is that of the reverse-time process, so dy/ds = b(1 - s, y)
    is integrated on the increasing s-grid from x1; returns (x0', x1).
    Step i's normals are ``noise[i]`` or drawn from ``generator``."""
    sched = schedule or ConstantNoiseScheduler(sigma_min)
    f = _field(drift_model)

    def diffusion(t, x):
        return sched.g(torch.tensor(t, device=x.device)) * torch.ones_like(x)

    ts = np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32)
    if not reverse:
        out = sdeint(f, diffusion, generator, x_start, ts, return_trajectory=False, noise=noise)
        return x_start, out.final.detach()
    one = np.float32(1.0)
    out = sdeint(lambda s, x: f(float(one - np.float32(s)), x),
                 lambda s, x: diffusion(float(one - np.float32(s)), x),
                 generator, x_start, ts, return_trajectory=False, noise=noise)
    return out.final.detach(), x_start


def average_ut(generator: Optional[torch.Generator], x: torch.Tensor, mu_t: torch.Tensor,
               sigma_t: Any, ut: torch.Tensor, avg_size: int,
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The marginal-averaged velocity target when the batch shares one t:
    each sample's target is the p_t(x | z_j)-weighted average of its own and
    ``avg_size - 1`` other conditional velocities, the others' indices
    ``idx`` (bs, avg_size - 1) or drawn uniformly from ``generator``."""
    bs = x.shape[0]
    flat_x, flat_mu = x.reshape(bs, -1), mu_t.reshape(bs, -1)
    d2 = (torch.sum(flat_x ** 2, 1)[:, None] + torch.sum(flat_mu ** 2, 1)[None, :]
          - 2.0 * flat_x @ flat_mu.T)
    sig2 = torch.as_tensor(sigma_t, dtype=torch.float32, device=x.device) ** 2
    log_pt = -0.5 * d2 / torch.clamp_min(sig2, 1e-12)                  # (bs, bs)
    if idx is None:
        gdev = generator.device if generator is not None else x.device
        idx = torch.randint(0, bs, (bs, avg_size - 1), generator=generator, device=gdev)
    idx = torch.cat([idx.to(x.device).long(),
                     torch.arange(bs, device=x.device)[:, None]], dim=1)  # self last
    w = torch.softmax(torch.gather(log_pt, 1, idx), dim=1)              # (bs, avg)
    ut_sub = ut.reshape(bs, -1)[idx]                                     # (bs, avg, d)
    return torch.sum(w[:, :, None] * ut_sub, dim=1).reshape(ut.shape)
