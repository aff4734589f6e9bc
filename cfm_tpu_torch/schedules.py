"""Reference-process noise schedules for bridges and [SF]2M (counterpart of
``cfm_tpu/schedules.py``).

A scheduler defines g(t), the reference SDE's diffusion coefficient, and
F(t) = int_0^t g(s)^2 ds; the Brownian-bridge marginal std is
sigma_t = sqrt(F(t) - F(t)^2 / F(1)). ``g`` and ``F`` cast t to float32, as
the JAX functions do, and keep its device.
"""

from __future__ import annotations

import math
from typing import Union

import torch

TimeLike = Union[torch.Tensor, float]


def _f32(t: TimeLike) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32,
                           device=t.device if isinstance(t, torch.Tensor) else None)


class NoiseScheduler:
    """Base: subclasses define g(t) and F(t)."""

    def g(self, t: TimeLike) -> torch.Tensor:
        raise NotImplementedError

    def F(self, t: TimeLike) -> torch.Tensor:
        raise NotImplementedError

    def _F1(self, t: TimeLike) -> torch.Tensor:
        return self.F(torch.ones((), dtype=torch.float32, device=_f32(t).device))

    def bridge_sigma_t(self, t: TimeLike) -> torch.Tensor:
        """Brownian-bridge std sqrt(F(t) - F(t)^2 / F(1))."""
        F_t, F_1 = self.F(t), self._F1(t)
        return torch.sqrt(torch.clamp_min(F_t - F_t ** 2 / F_1, 0.0))

    def bridge_sigma_t_prime_over_sigma_t(self, t: TimeLike, eps: float = 1e-8) -> torch.Tensor:
        """d/dt log sigma_t for the bridge, the drift scaling of SB paths."""
        F_t, F_1 = self.F(t), self._F1(t)
        g2 = self.g(t) ** 2
        num = g2 * (1.0 - 2.0 * F_t / F_1)
        den = 2.0 * torch.clamp_min(F_t - F_t ** 2 / F_1, eps)
        return num / den


class ConstantNoiseScheduler(NoiseScheduler):
    """g(t) = sigma, F(t) = sigma^2 t: the bridge std sigma sqrt(t (1 - t)),
    the SB-CFM path."""

    def __init__(self, sigma: float):
        self.sigma = sigma

    def g(self, t):
        return self.sigma * torch.ones_like(_f32(t))

    def F(self, t):
        return self.sigma ** 2 * _f32(t)


class LinearDecreasingNoiseScheduler(NoiseScheduler):
    """g(t)^2 decreasing linearly from sigma_max^2 to sigma_min^2."""

    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 1.0):
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def g(self, t):
        g2 = self.sigma_max ** 2 + (self.sigma_min ** 2 - self.sigma_max ** 2) * _f32(t)
        return torch.sqrt(torch.clamp_min(g2, 0.0))

    def F(self, t):
        t = _f32(t)
        return self.sigma_max ** 2 * t + 0.5 * (self.sigma_min ** 2 - self.sigma_max ** 2) * t ** 2


class CosineNoiseScheduler(NoiseScheduler):
    """g(t)^2 = sigma^2 (1 + cos(pi t)) / 2, a smooth decay to zero."""

    def __init__(self, sigma: float = 1.0):
        self.sigma = sigma

    def g(self, t):
        return self.sigma * torch.sqrt((1.0 + torch.cos(math.pi * _f32(t))) / 2.0)

    def F(self, t):
        t = _f32(t)
        return self.sigma ** 2 / 2.0 * (t + torch.sin(math.pi * t) / math.pi)
